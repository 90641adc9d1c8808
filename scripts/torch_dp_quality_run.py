"""Quality cost of the view-batch (large-batch) mode, on the card.

The port's counterpart of ``scripts/dp_quality_run.py``. The view-batch
step (``parallel/train_dp.py``; ``step_mode: "view_batch"``) takes one
Adam step per batch of views instead of the reference's one step per view
(train_gaussians.py:71-106). This script measures what that trajectory
costs in final quality: it trains the config in view-batch mode with
``view_batch_size = --batch`` through the port's ``cli.train``, runs
extraction + eval with ``--seeds`` extraction seeds, and prints chamfer
and F@5/10/20, then the JAX script's JSON keys (``mode batch wall_s
chamfer f10``) with the run's epoch losses, kernel launches and the card.
A run whose extraction finds no edges reports ``chamfer`` and ``f10`` as
null.

Usage: python scripts/torch_dp_quality_run.py [--batch 10] [--epochs 0]
       [--seeds 3] [--config configs/ABC_DexiNed.json] [--data_dir DIR]
       [--scene_name 00004926] [--gt_base DIR] [--device cuda|cpu]

``--device cuda`` (the default) trains on the card and raises without
one; ``--device cpu`` trains on the CPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from torch_common import (
    OUT_ROOT, add_scan_args, card, derive_config, epoch_losses,
    extract_and_eval, mean_rounded, resolve_device, scene_run_dir,
    train_cli)

def dp_mutation(batch: int, epochs: int = 0):
    """The JAX script's edits of the config (dp_quality_run.py:37-42)."""
    def mutate(raw):
        raw["training"]["step_mode"] = "view_batch"
        raw["training"]["view_batch_size"] = batch
        if epochs:
            raw["training"]["num_epochs"] = epochs
    return mutate


def dp_quality(args) -> dict:
    device = resolve_device(args.device)
    cfg_path = derive_config(args.config, args.out_root, "dp_config",
                             args.data_dir,
                             dp_mutation(args.batch, args.epochs))
    from edgegaussians_tpu_torch.config import load_config
    cfg = load_config(cfg_path)
    log, launches, wall = train_cli(cfg_path, args.scene_name, device)
    run_dir = scene_run_dir(cfg, args.out_root, args.scene_name)
    ply = os.path.join(run_dir, "gaussians_all.ply")
    res = extract_and_eval(ply, cfg, run_dir, scan=args.scene_name,
                           gt_base=args.gt_base, extraction_seeds=args.seeds)

    print("\n=== DP-mode quality run ===")
    print(f"batch={args.batch} epochs={cfg.training.num_epochs} "
          f"wall={wall:.1f}s")
    if res["chamfer"]:
        print(f"chamfer: {np.mean(res['chamfer']):.4f} "
              f"+- {np.std(res['chamfer']):.4f}")
        for k in ("f5", "f10", "f20"):
            print(f"{k}: {np.mean(res[k]):.3f} +- {np.std(res[k]):.3f}")
    else:
        print("extraction produced no edges")
    return {"mode": "view_batch", "batch": args.batch,
            "wall_s": round(wall, 1), "chamfer": mean_rounded(res["chamfer"], 5),
            "f10": mean_rounded(res["f10"], 4), "f5": mean_rounded(res["f5"], 4),
            "f20": mean_rounded(res["f20"], 4),
            "epochs": cfg.training.num_epochs,
            "losses": epoch_losses(log),
            "launches": launches, "platform": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=10,
                    help="view batch size per Adam step (50 views => "
                         "50/batch steps per epoch)")
    ap.add_argument("--epochs", type=int, default=0,
                    help="override num_epochs (0 = shipped value)")
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT,
                                                       "dp_quality"))
    ap.add_argument("--seeds", type=int, default=3)
    add_scan_args(ap)
    args = ap.parse_args(argv)
    print(json.dumps(dp_quality(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
