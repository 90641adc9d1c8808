"""The correctness check: the program's first view steps against the
plain reference (``reference.py``), from the same initial state, views
and draws, read by ``compare.py``.

The reference is handed what the benchmark made: the initial arrays, the
scene, the seed. It works out again what the program derives from them:
the view order (the trainer's ``torch.randperm`` on a CPU generator seeded
with the training seed) and each bg_edge_ratio render's scores (the next
``torch.rand(H*W)`` of that generator), the padding of a grown capacity,
the projection, tiles, image, gradients, Adam, absgrad, kNN and the
orientation steps.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import compare, reference


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls on or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def inputs(recipe: Dict, seed: int, epoch: int, step0: int, k: int,
           images: torch.Tensor) -> Dict:
    """The first ``k`` steps' views and bg_edge_ratio scores, drawn as the
    trainer draws them from a generator seeded with ``seed``."""
    ctx = reference.epoch_context(recipe, epoch)
    gen = torch.Generator().manual_seed(seed)
    V, H, W = images.shape
    views = torch.randperm(V, generator=gen).tolist()[:k]
    scores = []
    for i in range(k):
        if reference.strategy_of(ctx, step0 + i) == "bg_edge_ratio":
            scores.append(torch.rand(H * W, generator=gen).to(images.device))
        else:
            scores.append(None)
    return {"ctx": ctx, "views": views, "scores": scores}


def reference_side(initial: Dict[str, torch.Tensor], alive0, capacity: int,
                   step0: int, scene, drawn: Dict, dtype) -> Dict:
    """The reference's side over the drawn steps, in ``dtype``; with its
    initial state under ``init``."""
    st = reference.initial_state(initial, alive0, capacity, dtype)
    st["step"] = step0
    init = {g: st[g].clone() for g in compare.GROUPS}
    rec = reference.follow(st, drawn["views"], scene, drawn["ctx"],
                           drawn["scores"])
    return {"losses": rec["loss"], "after_1": rec["after_1"], "after_k": st,
            "knn": rec.get("knn"), "init": init}


def run_check(program_side: Dict, initial, alive0, capacity: int,
              step0: int, scene, drawn: Dict, fires: bool,
              control: bool = False) -> Dict[str, Dict[str, float]]:
    """Readings of the program (and, with ``control``, of the reference
    in float32 with TF32 matmuls) against the float64 reference."""
    with tf32(False):
        ref = reference_side(initial, alive0, capacity, step0, scene, drawn,
                             torch.float64)
    out = {"program": compare.readings(program_side, ref, ref["init"],
                                       fires)}
    if control:
        with tf32(True):
            ctl = reference_side(initial, alive0, capacity, step0, scene,
                                 drawn, torch.float32)
        out["control"] = compare.readings(ctl, ref, ref["init"], fires)
    return out
