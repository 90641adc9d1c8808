"""TP-vs-replicated step time + device memory at DTU scale, on the card.

The port's counterpart of ``scripts/tp_dtu_bench.py``. The Gaussian-axis
(TP) strategy (``parallel/train_tp.py``) divides the per-rank projection
and binning work and memory at DTU / Replica's 131072-Gaussian capacity.
This bench builds the JAX script's synthetic cloud (``default_rng(0)``,
131072 Gaussians at DTU's 1600x1200 pixel geometry, f = 2000; the dense
two-level path at cap 1024, k1 128, 512 overflow tiles, 16 tiles a
Gaussian, no pair budget) and times one full projection-loss + gradient
render (the trainer's proj-grad contract: forward render, backward to
all four parameter groups and the absgrad sink) for:

  - ``--mode ref``: the replicated one-rank path
    (``trainer.make_proj_grad_fn``),
  - ``--mode tp``: the Gaussian-sharded path on a ('gauss',) mesh of
    ``--mesh`` ranks (``train_tp.make_tp_proj_grad_fn``).

It reports ms a render (CUDA events over ``--iters`` renders, median of 3
blocks), beside it ``device_ms`` (the profiler's device time a render: a
render launches more kernels than a stream holds pending, so it cannot be
queued behind a sleeping kernel) and ``launches`` (host launch records a
render), the peak device memory (``torch.cuda.max_memory_allocated``;
each mode in its own process, as the counter is cumulative),
``compile_s`` (the first render's wall time, which includes building the
kernels from ``csrc/`` where they are not built yet, and the card's
start-up) and the loss, so that the two modes can be held to each other:

    python scripts/torch_tp_dtu_bench.py --mode ref
    python scripts/torch_tp_dtu_bench.py --mode tp --mesh 1
    torchrun --nproc_per_node 4 scripts/torch_tp_dtu_bench.py --mode tp \\
        --mesh 4

With ``--mesh 1`` the script runs in one process and sets up its
one-rank world itself (the launcher's variables set by hand, as
``graft_entry.py`` sets them): that measures TP's overhead at axis size
1. A larger mesh runs under torchrun, one card a rank (NCCL), rank 0
printing. ``--backend auto`` (the default) and ``cuda`` run on the card
and raise without one; ``--backend torch`` (or ``--platform cpu``) runs
the plain versions on the CPU, over Gloo. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import time

import numpy as np
import torch

from torch_common import card, measure

from edgegaussians_tpu_torch import backend_device, resolve_backend
from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS, GaussianModel
from edgegaussians_tpu_torch.parallel import distributed
from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
from edgegaussians_tpu_torch.parallel import train_tp
from edgegaussians_tpu_torch.train import trainer


def dtu_config(n: int) -> FrameworkConfig:
    """DTU.json's tile geometry at PidiNet-like splat mass
    (tp_dtu_bench.py:72-78)."""
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model.tile_gaussian_capacity = 1024
    cfg.model.tile_dense_capacity = 128
    cfg.model.tile_overflow_tiles = 512
    cfg.model.max_tiles_per_gaussian = 16
    cfg.model.tile_pair_budget = 0
    return cfg


def cloud(n: int, device) -> GaussianModel:
    """The JAX script's ``default_rng(0)`` cloud in a model of ``n`` rows,
    all live (tp_dtu_bench.py:80-91)."""
    r = np.random.default_rng(0)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    arrays = {
        "means": means,
        "scales": np.log(r.uniform(0.002, 0.02, (n, 3)).astype(np.float32)),
        "quats": r.normal(size=(n, 4)).astype(np.float32),
        "opacities": (np.log(1 / r.uniform(0.2, 0.9, (n, 1))
                             .astype(np.float32) - 1) * -1.0)}
    model = GaussianModel(n, device=device)
    with torch.no_grad():
        for g in GROUPS:
            getattr(model, g).copy_(torch.from_numpy(
                arrays[g].astype(np.float32)))
        model.alive.fill_(True)
    return model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_world(device: torch.device):
    """A process group of this process alone (NCCL on the card, Gloo on
    the CPU), the launcher's variables set by hand for its duration and
    restored after."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        distributed.initialize(device_type=device.type)
        yield
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench(mode: str, n: int, width: int, height: int, iters: int, device,
          mesh_size: int = 1) -> dict:
    """One mode's renders: the JAX script's keys, beside ``ms_per_render``
    its ``device_ms`` and ``launches``. ``tp`` needs the process group of
    ``mesh_size`` ranks to exist."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = dtu_config(n)
    model = cloud(n, device)
    f = 2000.0
    K = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     device=device)
    vm = torch.eye(4, device=device)
    gt = torch.zeros((height, width), device=device)
    edge_mask = gt > 0.5
    if mode == "ref":
        fn = trainer.make_proj_grad_fn(cfg, width, height)
        label = "replicated"
    else:
        mesh = mesh_mod.axis_mesh("gauss", mesh_size)
        fn = train_tp.make_tp_proj_grad_fn(cfg, width, height, mesh)
        label = f"tp@{mesh_size}"

    def run():
        return fn(model, vm, K, gt, edge_mask, 0, 1.0)

    t_c0 = time.time()
    out = run()
    if cuda:
        torch.cuda.synchronize()
    compile_s = time.time() - t_c0
    res, out = measure(run, device, iters)
    dt = res["ms"] / 1e3
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return {
        "mode": label, "platform": card(),
        "backend": "cuda" if cuda else "torch", "n": n, "width": width,
        "height": height, "ms_per_render": round(res["ms"], 3),
        "device_ms": res["device_ms"], "launches": res["launches"],
        "kernels": res["kernels"],
        "mpx_per_s": round(width * height / dt / 1e6, 1),
        "compile_s": round(compile_s, 1),
        "peak_device_mem_gib": (round(peak / 2**30, 3)
                                if peak is not None else None),
        "loss": float(out[0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["ref", "tp"], required=True)
    ap.add_argument("--mesh", type=int, default=1)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--platform", type=str, default=None,
                    choices=["cpu", "gpu", "cuda"],
                    help="cpu: as --backend torch; gpu or cuda: the card")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="auto and cuda: the card (an error without one); "
                         "torch: the plain versions on the CPU")
    args = ap.parse_args(argv)
    backend = args.backend
    if args.platform:
        backend = "torch" if args.platform == "cpu" else "cuda"
    device = backend_device(resolve_backend(backend))
    if args.mode == "ref" or args.mesh == 1 and not distributed.launched():
        ctx = (one_rank_world(device) if args.mode == "tp"
               else contextlib.nullcontext())
        with ctx:
            res = bench(args.mode, args.n, args.width, args.height,
                        args.iters, device, args.mesh)
        print(json.dumps(res))
        return 0
    distributed.initialize(device_type=device.type)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        res = bench(args.mode, args.n, args.width, args.height, args.iters,
                    device, args.mesh)
        lead = distributed.rank() == 0
    finally:
        distributed.shutdown()
    if lead:
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
