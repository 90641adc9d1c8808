"""Op-level trace of the tile-band-sharded render step, on the card.

The port's counterpart of ``scripts/profile_sharded_trace.py``. Traces
``parallel/train_sharded.make_sharded_proj_grad_fn`` (the tile-band
proj-grad: band inputs, band render, band-partial loss, the gradients'
all-reduce) on a ('tiles',) mesh of one rank, in a one-rank process group
that the script sets up itself (NCCL on the card, Gloo on the CPU; the
collectives are the identity at one rank, but the step's structure is
the one that runs on several). The setup (:40-60): ``configs/
ABC_DexiNed.json``, the bench fixture's camera 0, its parameters as the
trainer holds them (means, log scales, quats, logit opacities; the
fixture's opacities lie in [0.0035, 0.986]), the 'whole' strategy,
ground truth zeros. One warm call, then ``--steps`` calls in one
torch.profiler window whose Chrome trace goes to ``<out>/trace.json``;
the op table (ms a step, %, kernel records, host launch records, op)
read from the trace by ``torch_common.trace_ops``, as
``torch_segpair_profile.py`` reads its own (its ``--top`` ops printed,
all of them in the JSON); beside it the loss of an
unsharded proj-grad of the same view (``trainer.make_proj_grad_fn``),
which the sharded loss must equal. The JAX script's tensorboard-plugin op
stats (:81-89) have no counterpart. Prints the table and last a JSON
object.

Usage: python scripts/torch_profile_sharded_trace.py [--steps 20]
       [--top 20] [--out build/harness/shard_trace] [--device cuda|cpu]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain versions. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from torch_common import (
    FIXTURE, OUT_ROOT, RECIPE, card, op_table, print_ops, resolve_device,
    traced_ops)
from torch_tp_dtu_bench import one_rank_world

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.models.gaussians import GaussianModel
from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
from edgegaussians_tpu_torch.parallel.train_sharded import \
    make_sharded_proj_grad_fn
from edgegaussians_tpu_torch.train import trainer


def setup(device, max_n: int = 0, size: int = 0) -> dict:
    """The recipe's config, the fixture's model and camera 0 (its first
    ``max_n`` Gaussians, its intrinsics scaled to ``size`` x ``size``,
    when given), ground truth zeros."""
    cfg = load_config(RECIPE)
    d = np.load(FIXTURE)
    cut = slice(0, max_n or None)
    W, H = int(d["width"]), int(d["height"])
    K = d["Ks"][0].astype(np.float32).copy()
    if size:
        K[:2] *= size / W
        W = H = size
    op = d["opacities"].reshape(-1, 1)[cut].astype(np.float64)
    arrays = {"means": d["means"][cut], "scales": np.log(d["scales"][cut]),
              "quats": d["quats"][cut], "opacities": np.log(op / (1 - op))}
    n = arrays["means"].shape[0]
    model = GaussianModel(n, device=device)
    with torch.no_grad():
        for g, a in arrays.items():
            getattr(model, g).copy_(torch.from_numpy(
                np.asarray(a, np.float32)))
        model.alive.fill_(True)
    gt = torch.zeros((H, W), device=device)
    return {"cfg": cfg, "model": model, "width": W, "height": H,
            "vm": torch.from_numpy(d["viewmats"][0].astype(np.float32)).to(
                device),
            "K": torch.from_numpy(K).to(device), "gt": gt,
            "edge_mask": gt > 0.5}


def call(fn, s: dict):
    """One proj-grad call on the setup: (loss, stats, grads, sink grads)."""
    return fn(s["model"], s["vm"], s["K"], s["gt"], s["edge_mask"], 0, 1.0)


def sharded_fn(s: dict):
    """The tile-band proj-grad on a ('tiles',) mesh of this rank alone
    (inside :func:`one_rank_world`)."""
    return make_sharded_proj_grad_fn(s["cfg"], s["width"], s["height"],
                                     mesh_mod.axis_mesh("tiles", 1))


def profile(s: dict, steps: int, out: str, device) -> dict:
    """The traced steps of the sharded proj-grad and the unsharded loss
    (run inside :func:`one_rank_world`)."""
    fn = sharded_fn(s)
    loss = float(call(fn, s)[0])
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops, wall, counts = traced_ops(lambda: call(fn, s), steps, out, device)
    table = op_table(ops, steps)
    plain = trainer.make_proj_grad_fn(s["cfg"], s["width"], s["height"])
    return {"loss": loss, "unsharded_loss": float(call(plain, s)[0]),
            "ms_per_step": wall * 1e3,
            "total_device_ms": table["total_device_ms"],
            "rows": table["rows"],
            "kernels": {k: v for k, v in counts.items() if v},
            "trace": os.path.join(out, "trace.json")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(OUT_ROOT, "shard_trace"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    s = setup(device)
    with one_rank_world(device):
        res = profile(s, args.steps, args.out, device)
    print(f"trace written: {res['trace']}")
    print_ops(res["rows"][:args.top])
    print(f"total device time: {res['total_device_ms']:.3f} ms/step; "
          f"{res['ms_per_step']:.2f} ms/step wall; loss {res['loss']} "
          f"(unsharded {res['unsharded_loss']}); port kernels launched "
          f"{res['kernels']}")
    print(json.dumps({"steps": args.steps, **res, "platform": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
