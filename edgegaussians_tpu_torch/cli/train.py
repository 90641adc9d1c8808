"""Training CLI of the port, the counterpart of
``edgegaussians_tpu/cli/train.py``.

Usage:
    python -m edgegaussians_tpu_torch.cli.train \
        --config_file configs/ABC_DexiNed.json --scene_name 00004926 \
        [--force_rerun] [--ckpt_path ...] [--backend auto|cuda|torch]

Same flags and run layout as the JAX CLI (train_gaussians.py:225-346):
outputs go to ``<output_dir>/<exp_name>_<detector>/<scene>/`` with
``gaussians_all.ply``, the final checkpoint ``epoch<N-1>.npz`` and
``time.txt``. The mesh flags exist for parity and raise: the
``torch.distributed`` trainers are ROADMAP Queue 1 #12.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from edgegaussians_tpu_torch.cameras import max_pairwise_center_distance
from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers, seed_points as seeds_mod
from edgegaussians_tpu_torch import backend_device, resolve_backend
from edgegaussians_tpu_torch.models.gaussians import export_as_ply
from edgegaussians_tpu_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", type=str, required=True)
    ap.add_argument("--scene_name", type=str, default=None)
    ap.add_argument("--ckpt_path", type=str, default=None)
    ap.add_argument("--force_rerun", action="store_true")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "cuda", "torch"])
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of "
                         "steady-state epochs here")
    ap.add_argument("--profile_epochs", type=int, default=1,
                    help="number of steady-state epochs to trace")
    for flag in ("--mesh_tiles", "--mesh_gauss", "--mesh_views"):
        ap.add_argument(flag, type=int, default=0,
                        help="multi-device training; not ported yet")
    args = ap.parse_args(argv)
    if args.mesh_tiles or args.mesh_gauss or args.mesh_views:
        raise NotImplementedError(
            "--mesh_tiles/--mesh_gauss/--mesh_views: multi-device training "
            "on torch.distributed is not ported yet (ROADMAP Queue 1 #12)")

    cfg = load_config(args.config_file)
    scene_name = args.scene_name
    backend = resolve_backend(args.backend, cfg.model.rasterizer_backend)

    # seed points (train_gaussians.py:246-257), the JAX CLI's NumPy draws
    rng = np.random.default_rng(cfg.training.seed)
    _, _, seed_path = parsers.get_paths_from_data_config(cfg.data, scene_name)
    if cfg.model.init_random_init:
        seed_pts = seeds_mod.init_seed_points_random(
            cfg.model.init_min_num_gaussians,
            cfg.model.random_init_box_center,
            cfg.model.random_init_box_size, rng)
    else:
        seed_pts = seeds_mod.init_seed_points_from_file(
            seed_path, cfg.model.init_min_num_gaussians, rng)

    scene = parsers.load_scene(cfg.data, scene_name)

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
        print(f"Model already trained for {cfg.training.num_epochs} epochs. "
              "Exiting")
        return 0
    os.makedirs(output_dir, exist_ok=True)

    # optional resume: restores optimizer state and step too; checkpoints
    # of either package load (the JAX key layout)
    initial_state = None
    if args.ckpt_path is not None:
        template = trainer.init_train_state(
            seed_pts, cfg, device=backend_device(backend))
        initial_state = trainer.load_checkpoint(args.ckpt_path, template)
        print(f"Resumed from {args.ckpt_path}")

    t0 = time.time()
    state = trainer.train(scene, seed_pts, cfg, backend=backend,
                          initial_state=initial_state,
                          checkpoint_dir=(output_dir
                                          if cfg.training.checkpoint_interval
                                          else None),
                          profile_dir=args.profile_dir,
                          profile_epochs=args.profile_epochs)
    elapsed = time.time() - t0
    print(f"Training took {elapsed} seconds")
    with open(os.path.join(output_dir, "time.txt"), "w") as f:
        f.write(f"Training took {elapsed} seconds")

    trainer.save_checkpoint(state, output_dir, cfg.training.num_epochs - 1)
    if cfg.output.export_ply:
        n = export_as_ply(state.model,
                          os.path.join(output_dir, "gaussians_all.ply"))
        print(f"Exported {n} Gaussians to gaussians_all.ply")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
