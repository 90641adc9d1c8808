"""Scaling-efficiency harness: px/s and tiles/s at mesh sizes 1/2/4/8.

The port's counterpart of ``scripts/scaling_efficiency.py``. Measures the
scale-out strategies of ``parallel/`` against BASELINE.md's ">=85%
tiles/s scaling efficiency" target:

- ``sharded``: the tile-band-sharded epoch (``parallel/train_sharded.py``;
  ``trainer.run_epoch`` over ``make_sharded_proj_grad_fn``): the exact
  per-view trajectory, each render split over the ranks;
- ``dp``: the view-batch step (``parallel/train_dp.py``;
  ``trainer.run_view_batch_epoch`` over ``make_dp_train_step``), one step
  over all the views, which the ranks split; skipped where the views do
  not divide by the size;
- ``tp``: the Gaussian-sharded epoch (``parallel/train_tp.py``;
  ``trainer.run_epoch`` over ``make_tp_proj_grad_fn``); skipped where the
  capacity does not divide by the size.

The scene is the JAX script's (:82-96): ``default_rng(0)`` seeds in a
unit box at z = 2, random images (edge masks > 0.5), f = 0.9 W, identity
cameras, ``FrameworkConfig()`` with the capacity at ``--gaussians``, 256
slots a tile and a dense capacity of 128 (the two-level ``raster_v2``
frame). A size runs as that many ranks under ``torch.distributed.run``
(``torch_common.torchrun``), placed by ``--ranks_on``:

- ``cards`` (the default): one NCCL rank per card; a size above the
  card count is dropped, as the JAX script drops sizes above
  ``len(jax.devices())``;
- ``shared``: Gloo ranks, every one of them on card 0 whatever the card
  count (as ``chip_smoke.py`` phase 7c places them on a one-card host);

and under ``--device cpu`` Gloo ranks on the CPU. Every epoch starts
from the same initial state, as the JAX script calls its jitted epoch on
the same state each time: one warm-up epoch, then ``--steps`` epochs
each timed on rank 0 (CUDA events; the host clock on the CPU) after a
barrier, their mean reported. Rows as the JAX script's (``devices
sec_per_epoch px_per_s tiles_per_s efficiency_vs_1dev``, with
``ranks_on``) under the header ``platform backend width height views
gaussians modes``. Where ranks share one card or the CPU, they share its
cores and its queue, so the efficiency there checks the machinery and is
not a hardware claim (the JSON's ``note`` says so), as the JAX script's
virtual CPU mesh is not.

Usage: python scripts/torch_scaling_efficiency.py [--mesh-sizes 1,2,4,8]
       [--mode sharded|dp|tp|all] [--width 256] [--height 256]
       [--views 8] [--gaussians 4096] [--steps 5]
       [--ranks_on cards|shared] [--device cuda|cpu] [--out FILE]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` (or ``--platform cpu``) runs Gloo ranks on the CPU.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from torch_common import card, resolve_device, torchrun

from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.ops.tiles import tile_grid
from edgegaussians_tpu_torch.parallel import distributed
from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
from edgegaussians_tpu_torch.parallel import train_dp, train_sharded, \
    train_tp
from edgegaussians_tpu_torch.train import trainer

MODES = ("sharded", "dp", "tp")
WORKER_TIMEOUT = 1800


def scene(width: int, height: int, views: int, gaussians: int) -> dict:
    """The JAX script's NumPy draws (:82-90): seeds, images, edge masks,
    intrinsics and cameras."""
    W, H, nv, n = width, height, views, gaussians
    r = np.random.default_rng(0)
    seeds = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = r.random((nv, H, W)).astype(np.float32)
    f = W * 0.9
    Ks = np.tile(np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                          np.float32), (nv, 1, 1))
    vms = np.tile(np.eye(4, dtype=np.float32)[None], (nv, 1, 1))
    return {"seeds": seeds, "images": images, "edge_masks": images > 0.5,
            "Ks": Ks, "viewmats": vms}


def scaling_config(gaussians: int, backend: str = "auto") -> FrameworkConfig:
    """The JAX script's config (:92-96)."""
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = gaussians
    cfg.model.tile_gaussian_capacity = 256
    cfg.model.tile_dense_capacity = 128
    cfg.training.num_epochs = 100
    if backend != "auto":
        cfg.model.rasterizer_backend = backend
    return cfg


def fresh_state(seeds, cfg, device):
    """The initial state, the same on every rank."""
    state = trainer.init_train_state(seeds, cfg, device=device)
    if distributed.is_distributed():
        state.sync = distributed.replicate
        distributed.replicate(state)
    return state


def epoch_fn(mode: str, size: int, cfg, W: int, H: int, views):
    """``run(state)``: one epoch of ``mode`` on a mesh of ``size`` ranks,
    or None where the JAX script skips the size."""
    images, masks, vms, Ks = views
    nv = images.shape[0]
    order = list(range(nv))
    if mode == "sharded":
        pg = train_sharded.make_sharded_proj_grad_fn(
            cfg, W, H, mesh_mod.axis_mesh("tiles", size))
    elif mode == "tp":
        if cfg.model.max_num_gaussians % size:
            return None
        pg = train_tp.make_tp_proj_grad_fn(
            cfg, W, H, mesh_mod.axis_mesh("gauss", size))
    else:
        if nv % size:
            return None
        step = train_dp.make_dp_train_step(
            cfg, W, H, mesh_mod.make_mesh(view_axis=size, tile_axis=1))
        return lambda state: trainer.run_view_batch_epoch(
            state, 0, step, np.random.default_rng(0), nv, images, masks,
            vms, Ks)
    return lambda state: trainer.run_epoch(state, 0, images, masks, vms, Ks,
                                           cfg, pg, view_order=order)


def timed_epoch(run, seeds, cfg, device):
    """(seconds of one epoch from the initial state, the state after)."""
    state = fresh_state(seeds, cfg, device)
    if distributed.is_distributed():
        torch.distributed.barrier()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    run(state)
    if cuda:
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3, state
    return time.perf_counter() - t0, state


def run_modes(modes, size: int, sc: dict, cfg, steps: int, device):
    """Each mode at ``size`` ranks: (its row, or None where skipped; the
    state after its last epoch)."""
    W, H = sc["images"].shape[2], sc["images"].shape[1]
    views = tuple(torch.from_numpy(sc[k]).to(device)
                  for k in ("images", "edge_masks", "viewmats", "Ks"))
    nv = views[0].shape[0]
    tiles_per_view = tile_grid(W, H, cfg.model.tile_size)[2]
    px_per_epoch = nv * W * H
    rows, states = {}, {}
    for mode in modes:
        run = epoch_fn(mode, size, cfg, W, H, views)
        if run is None:
            rows[mode] = None
            continue
        timed_epoch(run, sc["seeds"], cfg, device)          # warm-up
        times = []
        for _ in range(steps):
            dt, state = timed_epoch(run, sc["seeds"], cfg, device)
            times.append(dt)
        dt = float(np.mean(times))
        rows[mode] = {"devices": size, "sec_per_epoch": round(dt, 5),
                      "px_per_s": round(px_per_epoch / dt, 1),
                      "tiles_per_s": round(tiles_per_view * nv / dt, 1)}
        states[mode] = state
    return rows, states


def state_arrays(states: dict) -> dict:
    out = {}
    for mode, state in states.items():
        m = state.model
        for g, p in m.params().items():
            out[f"{mode}:param {g}"] = p.detach().cpu().numpy()
        for g, (mu, nu) in state.opt.moments.items():
            out[f"{mode}:mu {g}"] = mu.cpu().numpy()
            out[f"{mode}:nu {g}"] = nu.cpu().numpy()
        out[f"{mode}:alive"] = m.alive.cpu().numpy()
        out[f"{mode}:absgrads"] = m.absgrads.cpu().numpy()
    return out


def rank_device(device_type: str, ranks_on: str) -> torch.device:
    """This rank's device once the group is joined: the CPU, card 0 for
    ``shared`` ranks (``distributed.initialize`` puts rank r on card
    ``LOCAL_RANK % device_count``), else the rank's own card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if ranks_on == "shared":
        torch.cuda.set_device(0)
    return torch.device("cuda", torch.cuda.current_device())


def worker(args) -> int:
    """One rank of a size's run: every mode, rank 0's rows to
    ``<result_dir>/rows.json``, each rank's states to ``rank<r>.npz``."""
    device_type = "cpu" if args.device == "cpu" else "cuda"
    backend = "nccl" if args.ranks_on == "cards" else "gloo"
    distributed.initialize(backend=backend, device_type=device_type)
    try:
        device = rank_device(device_type, args.ranks_on)
        size = distributed.world_size()
        sc = scene(args.width, args.height, args.views, args.gaussians)
        cfg = scaling_config(args.gaussians, args.backend)
        rows, states = run_modes(modes_of(args.mode), size, sc, cfg,
                                 args.steps, device)
        rank = distributed.rank()
        np.savez(os.path.join(args.result_dir, f"rank{rank}.npz"),
                 **state_arrays(states))
        if rank == 0:
            with open(os.path.join(args.result_dir, "rows.json"), "w") as f:
                json.dump(rows, f)
    finally:
        distributed.shutdown()
    return 0


def modes_of(mode: str):
    return MODES if mode == "all" else (mode,)


def placement(size: int, ranks_on: str, device) -> str:
    """Where a size's ranks go: 'cards', 'shared' (all on card 0), 'cpu',
    or '' where one rank a card cannot be placed."""
    if device.type == "cpu":
        return "cpu"
    if ranks_on == "shared":
        return "shared"
    return "cards" if size <= torch.cuda.device_count() else ""


def spawn(size: int, where: str, argv, result_dir: str) -> str:
    """The ranks of one size through ``torch.distributed.run``."""
    args = [os.path.abspath(__file__), *argv, "--worker", "--ranks_on",
            "cards" if where == "cards" else "shared", "--result_dir",
            result_dir]
    return torchrun(size, f"scaling x{size}", args, WORKER_TIMEOUT)


def scaling(args, argv) -> dict:
    device = resolve_device("cpu" if args.platform == "cpu"
                            else args.device)
    sizes = [int(s) for s in args.mesh_sizes.split(",")]
    places = {s: placement(s, args.ranks_on, device) for s in sizes}
    sizes = [s for s in sizes if places[s]]
    W, H, nv, n = args.width, args.height, args.views, args.gaussians
    results = {"platform": card() if device.type == "cuda" else "cpu",
               "backend": args.backend, "width": W, "height": H,
               "views": nv, "gaussians": n, "modes": {}}
    rows = {m: [] for m in modes_of(args.mode)}
    for size in sizes:
        with tempfile.TemporaryDirectory() as tmp:
            spawn(size, places[size], argv + ["--device", device.type], tmp)
            with open(os.path.join(tmp, "rows.json")) as f:
                got = json.load(f)
        for mode, row in got.items():
            if row is None:
                continue
            row["ranks_on"] = places[size]
            rows[mode].append(row)
            print(f"{mode} x{size} ({places[size]}): "
                  f"{row['sec_per_epoch'] * 1e3:.1f} ms/epoch "
                  f"({row['px_per_s'] / 1e6:.2f} Mpx/s)", flush=True)
    for mode, mode_rows in rows.items():
        if mode_rows:
            base = mode_rows[0]
            for row in mode_rows:
                row["efficiency_vs_1dev"] = round(
                    row["px_per_s"] / (row["devices"] * base["px_per_s"]),
                    4)
        results["modes"][mode] = mode_rows
    shared = sorted({places[s] for s in sizes} & {"shared", "cpu"})
    results["ranks_on"] = {str(s): places[s] for s in sizes}
    if shared:
        results["note"] = (
            "ranks on " + " and ".join(shared) + " share one device's cores "
            "and queue: these efficiencies check the machinery, not the "
            "hardware")
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh-sizes", type=str, default="1,2,4,8")
    ap.add_argument("--mode", choices=["sharded", "dp", "tp", "all"],
                    default="all")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--gaussians", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5,
                    help="timed epochs/steps per size (after 1 warmup)")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "pallas_v1"],
                    help="the compositor (auto: the config's)")
    ap.add_argument("--platform", type=str, default=None,
                    choices=["cpu", "gpu"],
                    help="cpu: as --device cpu")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: Gloo "
                         "ranks on the CPU")
    ap.add_argument("--ranks_on", default="cards",
                    choices=["cards", "shared"],
                    help="cards: one NCCL rank a card; shared: Gloo ranks "
                         "all on card 0")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--result_dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be at least 1")
    if args.worker:
        return worker(args)
    results = scaling(args, argv)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
