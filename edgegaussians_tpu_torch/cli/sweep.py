"""Multi-scene training sweep (BASELINE.json configs[4]), the port's
counterpart of ``edgegaussians_tpu/cli/sweep.py``.

Trains many scenes with one config. Scenes are split across the ranks
that torchrun starts: rank r of ``WORLD_SIZE`` trains scenes r, r +
WORLD_SIZE, ... in order (the JAX sweep's split across processes,
``scenes[pidx::pcnt]``), on card ``LOCAL_RANK % device_count``, so ranks
may share a card. The scenes share nothing: no process group is joined
and no collective runs. Without a launcher the process is rank 0 of 1.

    python -m edgegaussians_tpu_torch.cli.sweep \\
        --config_file configs/ABC_DexiNed.json --scene_names S1,S2,...
    torchrun --nproc_per_node N -m edgegaussians_tpu_torch.cli.sweep ...

``--backend auto`` (the default) and ``cuda`` train on the card and exit
with an error where torch sees no GPU; ``--backend torch`` trains on the
CPU. As in the JAX sweep: each scene's seeds come from
``default_rng(training.seed)`` (random init, or the scene's seed file;
``cli/train.py``'s ``scene_inputs``, without that CLI's optional
scene-unit scaling, which the JAX sweep does not do either),
the run goes to ``<output_dir>/<exp_name>_<detector>/<scene>/
gaussians_all.ply``, a scene whose PLY exists is skipped unless
``--force_rerun``, and rank r writes ``sweep_p<r>.json`` there with each
scene it trained: ``{"seconds", "gaussians"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from edgegaussians_tpu_torch import resolve_backend
from edgegaussians_tpu_torch.cli import train as train_cli
from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.models.gaussians import export_as_ply
from edgegaussians_tpu_torch.train import trainer


def launcher_rank():
    """(rank, world size, local rank) from torchrun's environment; (0, 1,
    0) in a process no launcher started."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", type=str, required=True)
    ap.add_argument("--scene_names", type=str, required=True,
                    help="comma-separated, or 'all' to scan base_dir")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="auto and cuda: the card (an error without "
                         "one); torch: the CPU")
    ap.add_argument("--force_rerun", action="store_true")
    args = ap.parse_args(argv)

    cfg = load_config(args.config_file)
    backend = resolve_backend(args.backend, cfg.model.rasterizer_backend)
    if args.scene_names == "all":
        scenes = sorted(os.listdir(cfg.data.base_dir))
    else:
        scenes = args.scene_names.split(",")

    rank, world, local_rank = launcher_rank()
    if backend == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    my_scenes = scenes[rank::world]
    print(f"process {rank}/{world}: {len(my_scenes)} scenes")

    exp_name = f"{cfg.output.exp_name}_{cfg.data.edge_detection_method}"
    results = {}
    for scene_name in my_scenes:
        output_dir = os.path.join(cfg.output.output_dir, exp_name,
                                  scene_name)
        ply_path = os.path.join(output_dir, "gaussians_all.ply")
        if os.path.exists(ply_path) and not args.force_rerun:
            print(f"{scene_name}: already trained, skipping")
            continue
        seeds, scene = train_cli.scene_inputs(cfg, scene_name)
        t0 = time.time()
        state = trainer.train(scene, seeds, cfg, backend=backend)
        elapsed = time.time() - t0
        os.makedirs(output_dir, exist_ok=True)
        n = export_as_ply(state.model, ply_path)
        results[scene_name] = {"seconds": elapsed, "gaussians": n}
        print(f"{scene_name}: {n} Gaussians in {elapsed:.1f}s")

    summary = os.path.join(cfg.output.output_dir, exp_name,
                           f"sweep_p{rank}.json")
    os.makedirs(os.path.dirname(summary), exist_ok=True)
    with open(summary, "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
