"""Entry points of the port: a one-device forward render and a
multi-rank dry run of the training step.

The port's counterpart of ``__graft_entry__.py`` (``entry`` :23,
``dryrun_multichip`` :47):

    python -m edgegaussians_tpu_torch.graft_entry [--ranks N] \\
        [--device cuda|cpu]

renders :func:`entry`'s scene once, then runs :func:`dryrun_multichip` on
``N`` ranks (4 by default). ``--device cuda`` (the default) runs on the
card and exits with an error where torch sees no GPU; ``--device cpu``
runs the plain versions on the CPU. Under a launcher (``torchrun
--nproc_per_node N -m edgegaussians_tpu_torch.graft_entry``) each process
runs one rank of the dry run instead.

The JAX dry run shards over 8 virtual devices in one process; here each
rank is a process of its own, on Gloo, sharing the one card where ranks
outnumber the cards, and the tests and the card run 4 ranks: a 2 x 2
('views', 'tiles') mesh, the flat view-batch mesh over all 4 ranks (the
JAX flat mesh of 2 views gives the same batch loss; a port mesh covers
the whole process group), a 2 x 2 ('views', 'gauss') mesh, and a
('gauss',) mesh of 4.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

# the dry run's ranks: a hung peer or collective fails the run after this
SPAWN_TIMEOUT = 300
# the JAX dry run's tolerance between two shardings of one computation
LOSS_ATOL = 1e-4


def _device(device) -> torch.device:
    """``device`` (None: the card) as a torch device; the card raises
    where torch sees no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' but torch sees no GPU; pass "
                           "device 'cpu' (--device cpu) to run on the CPU")
    return device


def _example_scene(n=256, width=128, height=128, device=None):
    """``__graft_entry__._example_scene``'s arrays, drawn from
    ``default_rng(0)`` in the same order, as tensors on ``device``."""
    r = np.random.default_rng(0)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.05), (n, 3))) \
        .astype(np.float32)
    opac = r.uniform(0.2, 0.9, n).astype(np.float32)
    f = 111.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    vm = np.eye(4, dtype=np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (means, quats, scales, opac, vm, K))


def entry(device=None):
    """(forward, example_args): a forward render of an edge-Gaussian cloud
    through the seg pair path at the JAX entry's settings (:35-41), the
    arguments on ``device`` (the card unless the caller asks for the
    CPU)."""
    from edgegaussians_tpu_torch.ops.rasterize import rasterize

    device = _device(device)
    width = height = 128

    def forward(means, quats, scales, opacities, viewmat, K):
        out = rasterize(means, quats, scales, opacities, viewmat, K,
                        width, height, tile_size=16, capacity=128,
                        dense_capacity=64, overflow_tiles=16,
                        max_tiles_per_gaussian=16, pair_budget=4096,
                        pair_kernel="seg")
        return out.image

    return forward, _example_scene(width=width, height=height,
                                   device=device)


def dryrun_config():
    """The JAX dry run's config (__graft_entry__.py:82-101): capacity 128,
    tile cap 64, dense 32, the seg kernel at a 2048-pair budget, 4 epochs,
    loss alternation, the direction and ratio losses, and a duplication
    after epoch 0."""
    from edgegaussians_tpu_torch.config import FrameworkConfig
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = 128
    cfg.model.tile_gaussian_capacity = 64
    cfg.model.tile_dense_capacity = 32
    cfg.model.tile_pair_budget = 2048
    cfg.model.tile_pair_kernel = "seg"
    cfg.training.num_epochs = 4
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "bg_edge_ratio"
    plc.start_alternating_at_epoch = 0
    plc.less_freq_loss = "whole"
    plc.more_freq_loss = "weighted"
    olc = cfg.training.loss.orientation_losses
    olc.start_dir_loss_at_epoch = 0
    olc.start_ratio_loss_at_epoch = 0
    cfg.model.if_duplicate_high_pos_grad = True
    cfg.model.dup_high_pos_grads_at_epoch = [0]
    return cfg


def _mesh_axes(n_ranks: int):
    """(view axis, tile axis): the JAX dry run's split (:72-73)."""
    tile_axis = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    return n_ranks // tile_axis, tile_axis


def _dryrun_scene(num_views: int, epochs: int, device, width=64, height=64,
                  n_seed=64):
    """The JAX dry run's seeds and views, drawn from ``default_rng(0)`` in
    the same order (:103-112), then the run's own draws, made once so that
    every rank and every stage sees them: each epoch's view order and
    epoch 0's bg_edge_ratio scores (one row per render)."""
    r = np.random.default_rng(0)
    seeds = r.uniform(-0.5, 0.5, (n_seed, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = torch.from_numpy(
        r.random((num_views, height, width)).astype(np.float32)).to(device)
    f = 60.0
    Ks = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                      dtype=torch.float32, device=device) \
        .expand(num_views, 3, 3).contiguous()
    viewmats = torch.eye(4, device=device).expand(num_views, 4, 4) \
        .contiguous()
    draws = np.random.default_rng(1)
    scores = torch.from_numpy(draws.random(
        (num_views, width * height)).astype(np.float32)).to(device)
    orders = [draws.permutation(num_views).tolist() for _ in range(epochs)]
    return seeds, (images, images > 0.5, viewmats, Ks), scores, orders


def _fresh_state(seeds, cfg, device):
    """The dry run's start state, the same on every rank."""
    from edgegaussians_tpu_torch.parallel import distributed
    from edgegaussians_tpu_torch.train import trainer
    state = trainer.init_train_state(seeds, cfg, device=device)
    if distributed.is_distributed():
        state.sync = distributed.replicate
        distributed.replicate(state)
    return state


def _train_epochs(state, cfg, proj_grad, views, scores, orders):
    """The config's epochs, density control after each, as the trainer
    runs them: ([epoch losses], [(alive before density control, alive
    after, whether it fired)])."""
    from edgegaussians_tpu_torch.parallel import distributed
    from edgegaussians_tpu_torch.train import trainer
    images, edge_masks, viewmats, Ks = views
    bg = {r: scores[r] for r in range(images.shape[0])}
    losses, alive = [], []
    for epoch in range(cfg.training.num_epochs):
        stats = trainer.run_epoch(state, epoch, images, edge_masks,
                                  viewmats, Ks, cfg, proj_grad,
                                  view_order=orders[epoch], bg_scores=bg)
        fired = trainer.run_density_control(state, epoch, cfg, viewmats,
                                            Ks, edge_masks)
        if fired and state.sync is not None:
            state.sync(state)
        distributed.check_lockstep(state, f"after epoch {epoch}")
        losses.append(stats.avg_loss)
        alive.append([stats.num_alive, int(state.model.num_alive()), fired])
    return losses, alive


def _check_close(a: float, b: float, what: str) -> None:
    if not abs(a - b) < LOSS_ATOL:
        raise AssertionError(f"{what}: {a} vs {b}")


def _run_rank(device) -> dict:
    """This rank's part of the dry run, on the process group the launcher
    describes (Gloo). Every rank runs every stage and asserts every check;
    returns this rank's losses and kernel launches.

    1. the tile-sharded training run (``parallel/train_sharded.py``) on
       the ('views', 'tiles') mesh: the config's 4 epochs, density control
       after each (the duplication after epoch 0, where alive must not
       fall); the direction and ratio losses fire from epoch 1 (a loss
       applies at epochs past its start epoch, so the JAX dry run's one
       epoch 0 fires neither);
    2. one view-batch step (``parallel/train_dp.py``) on that mesh;
    3. the tile-sharded render and gradient of view 0;
    2b. the view-batch step on the flat mesh and on ('views', 'gauss'):
       each loss within 1e-4 of the composed one's;
    4. the same 4 epochs Gaussian-sharded (``parallel/train_tp.py``) over
       all ranks: each epoch's loss within 1e-4 of stage 1's, alive
       equal.
    """
    from edgegaussians_tpu_torch.ops import knn, rank_sum, raster_v2, segpair
    from edgegaussians_tpu_torch.parallel import distributed
    from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
    from edgegaussians_tpu_torch.parallel.train_dp import (
        make_dp_train_step, make_tile_sharded_render)
    from edgegaussians_tpu_torch.parallel.train_sharded import \
        make_sharded_proj_grad_fn
    from edgegaussians_tpu_torch.parallel.train_tp import \
        make_tp_proj_grad_fn

    mods = (segpair, raster_v2, knn, rank_sum)
    for mod in mods:
        mod.reset_launch_counts()
    n = distributed.world_size()
    view_axis, tile_axis = _mesh_axes(n)
    width = height = 64
    cfg = dryrun_config()
    seeds, views, scores, orders = _dryrun_scene(
        2 * view_axis, cfg.training.num_epochs, device, width, height)
    images = views[0]
    dp_scores = list(scores)
    out = {"rank": distributed.rank(), "ranks": n}

    # 1. tile-sharded epochs with density control
    mesh = mesh_mod.make_mesh(view_axis, tile_axis)
    state = _fresh_state(seeds, cfg, device)
    losses, alive = _train_epochs(
        state, cfg, make_sharded_proj_grad_fn(cfg, width, height, mesh),
        views, scores, orders)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"tile-sharded epoch losses {losses}")
    n0, n1, fired = alive[0]
    if not fired or n1 < n0:
        raise AssertionError(f"density control after epoch 0: fired "
                             f"{fired}, alive {n0} -> {n1}")
    if state.step != cfg.training.num_epochs * images.shape[0]:
        raise AssertionError(f"{state.step} renders")
    out.update(epoch_losses=losses, alive=alive)

    # 2. a view-batch step on views x tiles: the composed mode when the
    # tile axis is > 1
    dp_loss, _ = make_dp_train_step(cfg, width, height, mesh)(
        _fresh_state(seeds, cfg, device), 0, *views, bg_scores=dp_scores)
    out["dp_loss"] = float(dp_loss)
    if not np.isfinite(out["dp_loss"]):
        raise AssertionError(f"view-batch loss {out['dp_loss']}")

    # 3. the tile-sharded render and gradient of view 0
    tile_loss, _, _ = make_tile_sharded_render(cfg, width, height, mesh)(
        _fresh_state(seeds, cfg, device).model, views[2][0], views[3][0],
        images[0])
    out["tile_loss"] = float(tile_loss)
    if not np.isfinite(out["tile_loss"]):
        raise AssertionError(f"tile-sharded loss {out['tile_loss']}")

    # 2b. the composed step against the flat one, and views x gauss
    if tile_axis > 1:
        for key, m in (("flat_loss", mesh_mod.make_mesh(n, 1)),
                       ("dp_tp_loss", mesh_mod.make_views_gauss_mesh(
                           view_axis, tile_axis))):
            loss, _ = make_dp_train_step(cfg, width, height, m)(
                _fresh_state(seeds, cfg, device), 0, *views,
                bg_scores=dp_scores)
            out[key] = float(loss)
        _check_close(out["dp_loss"], out["flat_loss"],
                     "composed views x tiles loss against the flat one")
        _check_close(out["dp_tp_loss"], out["flat_loss"],
                     "composed views x gauss loss against the flat one")

    # 4. the Gaussian-sharded epochs over all ranks
    tp_losses, tp_alive = _train_epochs(
        _fresh_state(seeds, cfg, device), cfg,
        make_tp_proj_grad_fn(cfg, width, height,
                             mesh_mod.axis_mesh("gauss", n), "gauss"),
        views, scores, orders)
    for e, (a, b) in enumerate(zip(tp_losses, losses)):
        _check_close(a, b, f"Gaussian-sharded epoch {e} loss against the "
                           "tile-sharded one")
    if tp_alive != alive:
        raise AssertionError(f"alive {tp_alive} Gaussian-sharded, {alive} "
                             "tile-sharded")
    out["tp_losses"] = tp_losses
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = {k: v for mod in mods
                       for k, v in mod.launch_counts.items()}
    if out["rank"] == 0:
        composed = (f"composed_loss={out['dp_loss']:.6f} (flat "
                    f"{out['flat_loss']:.6f}) dp_tp_loss="
                    f"{out['dp_tp_loss']:.6f} " if tile_axis > 1 else "")
        print(f"dryrun_multichip OK on {n} ranks [kernel="
              f"{cfg.model.tile_pair_kernel} budget="
              f"{cfg.model.tile_pair_budget}]: epoch_loss={losses[0]:.4f} "
              f"alive {alive[0][0]}->{alive[0][1]} dp_loss="
              f"{out['dp_loss']:.4f} {composed}tile_loss="
              f"{out['tile_loss']:.4f} tp_loss={tp_losses[0]:.4f}",
              flush=True)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int, device="cuda", out_dir=None) -> list:
    """Run the dry run (:func:`_run_rank`) on ``n_ranks`` Gloo ranks, each
    a process of this module with the launcher's environment set by hand,
    on ``device`` (the card, shared by the ranks, unless the caller asks
    for the CPU). Every rank must exit 0 within ``SPAWN_TIMEOUT``; returns
    each rank's results (losses, kernel launches), which it writes as
    ``rank<r>.json`` into ``out_dir`` (a temporary directory when None).
    Rank 0's output is printed."""
    device = _device(device)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or tmp
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n_ranks),
                   LOCAL_WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [repo] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        cmd = [sys.executable, "-m", "edgegaussians_tpu_torch.graft_entry",
               "--device", device.type, "--out", out_dir]
        logs = [os.path.join(out_dir, f"rank{r}.log")
                for r in range(n_ranks)]
        procs = []
        try:
            for r in range(n_ranks):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                        cwd=repo, stdout=f, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=SPAWN_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for path in logs:
            with open(path) as f:
                texts.append(f.read())
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"dry run rank {r} exited "
                                   f"{p.returncode}:\n{texts[r][-4000:]}")
        print(texts[0], end="")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def main(argv=None) -> int:
    from edgegaussians_tpu_torch.parallel import distributed
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks of the dry run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions on the CPU")
    ap.add_argument("--out", default=None,
                    help="under a launcher: write rank<r>.json here")
    args = ap.parse_args(argv)
    device = _device(args.device)
    if distributed.launched():
        torch.set_num_threads(1)
        distributed.initialize("gloo", device_type=device.type)
        try:
            out = _run_rank(device)
        finally:
            distributed.shutdown()
        if args.out:
            with open(os.path.join(args.out, f"rank{out['rank']}.json"),
                      "w") as f:
                json.dump(out, f)
        return 0
    fn, example = entry(device)
    img = fn(*example)
    print("entry OK", tuple(img.shape), float(img.sum()))
    dryrun_multichip(args.ranks, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
