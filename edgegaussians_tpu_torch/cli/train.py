"""Training CLI of the port, the counterpart of
``edgegaussians_tpu/cli/train.py``.

Usage:
    python -m edgegaussians_tpu_torch.cli.train \
        --config_file configs/ABC_DexiNed.json --scene_name 00004926 \
        [--force_rerun] [--ckpt_path ...] [--backend auto|cuda|torch]

    torchrun --nproc_per_node N -m edgegaussians_tpu_torch.cli.train \
        --mesh_tiles N ...      # or --mesh_gauss N, --mesh_views V [...]

``--backend auto`` (the default) trains on the card and exits with an
error where torch sees no GPU; ``--backend torch`` trains on the CPU.

Same flags and run layout as the JAX CLI (train_gaussians.py:225-346):
outputs go to ``<output_dir>/<exp_name>_<detector>/<scene>/`` with
``gaussians_all.ply``, the final checkpoint ``epoch<N-1>.npz`` and
``time.txt``, TensorBoard logs to ``<log_dir>/<exp_name>_<detector>/
<scene>/`` where tensorboardX is installed. ``--ckpt_path`` resumes at
the checkpoint's capacity (a staged run's), up to the config's maximum.

The mesh flags (JAX cli/train.py:40-66,120-163) train on the ranks that
torchrun starts, one process per rank: ``--mesh_tiles`` splits each render
into bands of tile rows, ``--mesh_gauss`` into shards of the Gaussians
(not with ``--mesh_tiles``), ``--mesh_views`` runs view batches
(``step_mode: "view_batch"``) and composes with either. The mesh's size
must equal torchrun's ``WORLD_SIZE``. NCCL (the default for CUDA ranks)
takes one card per rank; ranks that share a card need ``--dist_backend
gloo``. Only rank 0 writes ``time.txt``, the checkpoint and the PLY.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from edgegaussians_tpu_torch.cameras import max_pairwise_center_distance
from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers, seed_points as seeds_mod
from edgegaussians_tpu_torch import backend_device, resolve_backend
from edgegaussians_tpu_torch.models.gaussians import export_as_ply
from edgegaussians_tpu_torch.parallel import distributed
from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
from edgegaussians_tpu_torch.train import trainer


def _build_mesh(args, cfg, backend: str, argv):
    """Join torchrun's process group and build the mesh the flags ask
    for: (mesh or None, mesh strategy). Sets ``step_mode: "view_batch"``
    under ``--mesh_views``."""
    inner = max(args.mesh_tiles or args.mesh_gauss, 1)
    n_mesh = (args.mesh_views * inner if args.mesh_views
              else args.mesh_tiles or args.mesh_gauss)
    if n_mesh > 1 and not distributed.launched():
        flags = " ".join(argv if argv is not None else sys.argv[1:])
        raise SystemExit(
            f"a mesh of {n_mesh} ranks runs one process per rank; launch: "
            f"torchrun --nproc_per_node {n_mesh} -m "
            f"edgegaussians_tpu_torch.cli.train {flags}")
    distributed.initialize(args.dist_backend,
                           device_type="cuda" if backend == "cuda"
                           else "cpu")
    world = distributed.world_size()
    if n_mesh == 0:
        if world > 1:
            raise SystemExit(f"{world} ranks launched but no mesh flag: "
                             "pass --mesh_tiles, --mesh_gauss or "
                             "--mesh_views")
        return None, "tiles"
    if n_mesh != world:
        raise SystemExit(f"the mesh holds {n_mesh} ranks but torchrun "
                         f"started {world} (WORLD_SIZE)")
    if args.mesh_views:
        cfg.training.step_mode = "view_batch"
        if args.mesh_gauss:
            mesh = mesh_mod.make_views_gauss_mesh(args.mesh_views, inner)
        else:
            mesh = mesh_mod.make_mesh(args.mesh_views, inner)
        strategy = "tiles"
    else:
        strategy = "gauss" if args.mesh_gauss else "tiles"
        mesh = mesh_mod.axis_mesh(strategy, n_mesh)
    if distributed.rank() == 0:
        print(f"training on {mesh} over {world} rank(s)")
    return mesh, strategy


def scene_inputs(cfg, scene_name):
    """(seed points, scene) of one scene: the seed points drawn as
    train_gaussians.py:246-257 draws them (``default_rng(training.seed)``,
    then random init or the scene's seed file: the JAX CLIs' NumPy draws),
    then the scene loaded. ``cli/sweep.py`` trains each scene from it."""
    rng = np.random.default_rng(cfg.training.seed)
    if cfg.model.init_random_init:
        seed_pts = seeds_mod.init_seed_points_random(
            cfg.model.init_min_num_gaussians,
            cfg.model.random_init_box_center,
            cfg.model.random_init_box_size, rng)
    else:
        _, _, seed_path = parsers.get_paths_from_data_config(cfg.data,
                                                             scene_name)
        seed_pts = seeds_mod.init_seed_points_from_file(
            seed_path, cfg.model.init_min_num_gaussians, rng)
    return seed_pts, parsers.load_scene(cfg.data, scene_name)


def main(argv=None):
    try:
        run(argv)
    finally:
        distributed.shutdown()
    return 0


def run(argv=None):
    """Parse ``argv`` and train; returns this rank's final state (None when
    the run exists already)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", type=str, required=True)
    ap.add_argument("--scene_name", type=str, default=None)
    ap.add_argument("--ckpt_path", type=str, default=None)
    ap.add_argument("--force_rerun", action="store_true")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="auto and cuda: the card (an error without "
                         "one); torch: the CPU")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of "
                         "steady-state epochs here")
    ap.add_argument("--profile_epochs", type=int, default=1,
                    help="number of steady-state epochs to trace")
    ap.add_argument("--mesh_tiles", type=int, default=0,
                    help="split every render+backward into bands of tile "
                         "rows over this many ranks (per-view semantics "
                         "kept; parallel/train_sharded.py)")
    ap.add_argument("--mesh_gauss", type=int, default=0,
                    help="split every render's Gaussians over this many "
                         "ranks (per-view semantics kept; "
                         "parallel/train_tp.py)")
    ap.add_argument("--mesh_views", type=int, default=0,
                    help="view batches over this many ranks (implies "
                         "step_mode='view_batch'; view_batch_size must "
                         "divide by it); composes with --mesh_tiles or "
                         "--mesh_gauss (parallel/train_dp.py)")
    ap.add_argument("--dist_backend", type=str, default=None,
                    choices=["nccl", "gloo"],
                    help="collective backend of a torchrun launch "
                         "(default: nccl for CUDA ranks, gloo for CPU)")
    args = ap.parse_args(argv)
    if args.mesh_gauss and args.mesh_tiles:
        raise SystemExit("--mesh_gauss cannot combine with --mesh_tiles "
                         "(pick ONE per-render sharding axis; either "
                         "composes with --mesh_views)")

    cfg = load_config(args.config_file)
    scene_name = args.scene_name
    backend = resolve_backend(args.backend, cfg.model.rasterizer_backend)
    mesh, mesh_strategy = _build_mesh(args, cfg, backend, argv)
    lead = distributed.rank() == 0

    seed_pts, scene = scene_inputs(cfg, scene_name)

    # optional scene-unit scaling (train_gaussians.py:269-284)
    if cfg.data.scale_scene_unit:
        scale = max_pairwise_center_distance(scene.cameras)
        if seed_pts is not None and len(seed_pts):
            scale = max(scale, seeds_mod.get_scale_from_points(
                seed_pts, 0.05, 0.95))
        seed_pts = seed_pts / scale
        scene = scene.scale_translations(1.0 / scale)

    exp_name = f"{cfg.output.exp_name}_{cfg.data.edge_detection_method}"
    output_dir = os.path.join(cfg.output.output_dir, exp_name, scene_name)
    final_ckpt = os.path.join(
        output_dir, f"epoch{cfg.training.num_epochs - 1}.npz")
    if os.path.exists(final_ckpt) and not args.force_rerun:
        if lead:
            print(f"Model already trained for {cfg.training.num_epochs} "
                  "epochs. Exiting")
        return None
    os.makedirs(output_dir, exist_ok=True)
    log_dir = os.path.join(cfg.output.log_dir, exp_name, scene_name)

    # optional resume: restores optimizer state and step too; checkpoints
    # of either package load (the JAX key layout)
    initial_state = None
    if args.ckpt_path is not None:
        template = trainer.init_train_state(
            seed_pts, cfg, device=backend_device(backend))
        initial_state = trainer.load_checkpoint(args.ckpt_path, template)
        if lead:
            print(f"Resumed from {args.ckpt_path}")

    t0 = time.time()
    state = trainer.train(scene, seed_pts, cfg, backend=backend,
                          log_dir=log_dir, initial_state=initial_state,
                          checkpoint_dir=(output_dir
                                          if cfg.training.checkpoint_interval
                                          else None),
                          profile_dir=args.profile_dir,
                          profile_epochs=args.profile_epochs,
                          mesh=mesh, mesh_strategy=mesh_strategy)
    elapsed = time.time() - t0
    if not lead:
        return state
    print(f"Training took {elapsed} seconds")
    with open(os.path.join(output_dir, "time.txt"), "w") as f:
        f.write(f"Training took {elapsed} seconds")

    trainer.save_checkpoint(state, output_dir, cfg.training.num_epochs - 1)
    if cfg.output.export_ply:
        n = export_as_ply(state.model,
                          os.path.join(output_dir, "gaussians_all.ply"))
        print(f"Exported {n} Gaussians to gaussians_all.ply")
    return state


if __name__ == "__main__":
    raise SystemExit(main())
