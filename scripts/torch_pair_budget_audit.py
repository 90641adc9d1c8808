"""Audit tile_pair_budget on a full training run, on the card.

The port's counterpart of ``scripts/pair_budget_audit.py``. The pair
paths (the seg and v4 pair compositors, and the pair-prefix two-level
frame) composite a static budget B of (tile, Gaussian) pairs per view;
pairs past B are DROPPED from renders, so shipping a budget in a config
requires knowing the peak per-view pair count over a whole training run,
not just the final model.

This script trains the config through the port's ``cli.train`` with a
deliberately generous budget, collects the per-epoch ``pairs=``
watermark from the trainer's epoch lines (printed where the render path
counts pairs, ``trainer._reports_pairs``; a config whose path does not is
refused rather than reported as a peak of 0), runs extraction + eval, and
reports:

  - the peak (tile, Gaussian) pair count over all epochs x views,
  - training wall-clock,
  - chamfer / F-scores.

Usage: python scripts/torch_pair_budget_audit.py [--budget 98304]
       [--config configs/ABC_DexiNed.json] [--epochs 400]
       [--data_dir DIR] [--scene_name 00004926] [--gt_base DIR]
       [--device cuda|cpu]

``--device cuda`` (the default) trains on the card and raises without
one; ``--device cpu`` trains on the CPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from torch_common import (
    OUT_ROOT, add_scan_args, card, derive_config, extract_and_eval,
    resolve_device, scene_run_dir, train_cli)

PAIRS = re.compile(r"pairs=(\d+)/")


def audit(args) -> dict:
    """Train, mine the log's pair watermark, score: the JAX script's keys
    and the kernel launches of the run."""
    device = resolve_device(args.device)

    def mutate(raw):
        raw["model"]["tile_pair_budget"] = args.budget
        if args.log_interval:
            raw["training"]["log_interval"] = args.log_interval
        if args.epochs:
            raw["training"]["num_epochs"] = args.epochs

    cfg_path = derive_config(args.config, args.out_root, "audit_config",
                             args.data_dir, mutate)
    from edgegaussians_tpu_torch.config import load_config, resolve_capacity
    from edgegaussians_tpu_torch.train.trainer import _reports_pairs
    cfg = load_config(cfg_path)
    cap = resolve_capacity(cfg.model, cfg.model.init_min_num_gaussians)
    if not _reports_pairs(cfg.model, cap):
        raise SystemExit(
            f"{args.config}: its render path counts no pairs (no pair "
            "budget on a pair path, no two-level frame), so its epoch lines "
            "print no pairs= watermark to audit")
    log, launches, wall = train_cli(cfg_path, args.scene_name, device)

    pairs = [int(p) for p in PAIRS.findall(log)]
    warns = len(re.findall(r"exceed tile_pair_budget", log))
    assert pairs, "no pairs= watermark in the log — pair mode not active?"
    peak = max(pairs)

    run_dir = scene_run_dir(cfg, args.out_root, args.scene_name)
    ply = os.path.join(run_dir, "gaussians_all.ply")
    res = extract_and_eval(ply, cfg, run_dir, scan=args.scene_name,
                           gt_base=args.gt_base,
                           extraction_seeds=args.seeds)

    print("\n=== pair-budget audit ===")
    cadence = args.log_interval or "shipped config value"
    print(f"pair watermark mined from trainer logs at log_interval="
          f"{cadence}; with a cadence > 1 the reported peak only covers "
          "logged epochs (run with --log_interval 1 for the true "
          "whole-run peak)")
    print(f"budget={args.budget} peak_pairs={peak} "
          f"({peak / args.budget:.2f}x of budget) overflow_warnings={warns}")
    print(f"pairs trajectory: first={pairs[0]} "
          f"p50={int(np.median(pairs))} p90={int(np.percentile(pairs, 90))} "
          f"last={pairs[-1]}")
    print(f"train wall: {wall:.1f} s")
    if res["chamfer"]:
        print(f"chamfer: {np.mean(res['chamfer']):.4f} "
              f"+- {np.std(res['chamfer']):.4f}")
        for k in ("f5", "f10", "f20"):
            print(f"{k}: {np.mean(res[k]):.3f} +- {np.std(res[k]):.3f}")
    else:
        print("extraction produced no edges")

    def mean(k, digits):
        return (round(float(np.mean(res[k])), digits) if res[k]
                else None)

    return {"budget": args.budget, "peak_pairs": peak,
            "overflow_warnings": warns, "wall_s": round(wall, 1),
            "chamfer": mean("chamfer", 5), "f10": mean("f10", 4),
            "pairs": pairs, "launches": launches, "platform": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=int, default=98304)
    ap.add_argument("--epochs", type=int, default=0,
                    help="override num_epochs (0 = shipped value)")
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT,
                                                       "pair_audit"))
    ap.add_argument("--log_interval", type=int, default=1,
                    help="trainer log cadence (0 = keep the shipped "
                         "value; 1 gives an every-epoch pair watermark "
                         "but adds a host sync per epoch)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="extraction seeds for the quality check")
    add_scan_args(ap)
    args = ap.parse_args(argv)
    print(json.dumps(audit(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
