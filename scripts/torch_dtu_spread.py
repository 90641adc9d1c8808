"""DTU-scale run-to-run spread over several generated scenes, on the card.

The port's counterpart of ``scripts/dtu_spread.py``. No real DTU scan is
bundled, so quality at DTU scale rests on generated scenes: this script
generates several DTU-shaped scenes (1600x1200, 30 views, PidiNet-style
edge maps with detector noise: per-view dropout, spurious blobs,
response jitter) with the port's ``data/synthetic.py`` (a copy of the
JAX generator, so seed 20 + i gives the JAX script's scene ``dtu_sp{i}``
byte for byte), and drives the shipped DTU pipeline (train -> extraction
-> evaluate, one extraction seed) on each, bounding the run-to-run spread
at that scale.

Per scene the JAX script's row (``scan wall_s chamfer f5 f10``), then
the summary (``rows chamfer_mean chamfer_std f10_mean f10_std``) with,
per scene, its epoch losses and kernel launches and the card. A scene
whose extraction finds no edges reports ``chamfer``, ``f5`` and ``f10``
as null, and the means cover the others. Where the JAX script writes
``synthetic_data/DTU_spread``, ``output_synth/DTU_spread/`` and
``/tmp/dtu_spread_cfg.json`` (and its TensorBoard logs under the
config's ``logs/DTU/``), this one writes ``<out_root>/synthetic_data``,
``<out_root>/output_synth/``, ``<out_root>/dtu_spread_cfg.json`` and
``<out_root>/logs/``, under the git-ignored ``build/`` by default.

Usage: python scripts/torch_dtu_spread.py [--scenes 3] [--epochs 500]
       [--views 30] [--width 1600] [--height 1200] [--pair_budget -1]
       [--skip-generate] [--device cuda|cpu]

``--device cuda`` (the default) trains on the card and raises without
one; ``--device cpu`` trains on the CPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from torch_common import (
    OUT_ROOT, REPO_ROOT, card, epoch_losses, extract_and_eval, mean_rounded,
    resolve_device, train_cli)

DTU_RECIPE = os.path.join(REPO_ROOT, "configs", "DTU.json")
DEFAULT_ROOT = os.path.join(OUT_ROOT, "dtu_spread")


def generate(scan: str, seed: int, args, base: str) -> None:
    """One noisy DTU-shaped scene under ``base`` and its SfM seeds: 4000
    draws of the ground-truth points with ``default_rng(seed + 100)``
    plus N(0, 0.01) (dtu_spread.py:29-46)."""
    from edgegaussians_tpu_torch.data import synthetic
    from edgegaussians_tpu_torch.io import ply as ply_io

    synthetic.generate_scene(
        base, scan, seed=seed, n_views=args.views, width=args.width,
        height=args.height, n_lines=16, n_curves=8,
        edge_detector="PidiNet", sigma_px=1.2,
        noise_dropout=0.15, noise_spurious=10,
        noise_intensity_jitter=0.05)
    gt_ply = os.path.join(base, "groundtruth", "sampled_pts",
                          f"{scan}_0.005.ply")
    pts = ply_io.read_point_cloud(gt_ply)
    rng = np.random.default_rng(seed + 100)
    take = rng.choice(len(pts), size=min(4000, len(pts)), replace=True)
    seeds = pts[take] + rng.normal(0, 0.01, (len(take), 3))
    np.savetxt(os.path.join(base, "data", scan, "sparse_sfm_points.txt"),
               seeds, fmt="%.6f")


def dtu_config(epochs: int, base: str, output_dir: str, log_dir: str,
               pair_budget: int = -1) -> dict:
    """``configs/DTU.json`` with the JAX script's edits (:61-67), and its
    TensorBoard logs under ``log_dir`` (the JAX script keeps the config's
    relative ``logs/DTU/``)."""
    with open(DTU_RECIPE) as f:
        cfg = json.load(f)
    cfg["data"]["base_dir"] = f"{base}/data/"
    cfg["data"]["edge_detection_method"] = "PidiNet"
    cfg["training"]["num_epochs"] = epochs
    cfg["output"]["output_dir"] = os.path.join(output_dir, "")
    cfg["output"]["log_dir"] = os.path.join(log_dir, "")
    if pair_budget >= 0:
        cfg["model"]["tile_pair_budget"] = pair_budget
    return cfg


def dtu_spread(args) -> dict:
    device = resolve_device(args.device)
    base = os.path.join(args.out_root, "synthetic_data")
    cfg = dtu_config(args.epochs, base,
                     os.path.join(args.out_root, "output_synth"),
                     os.path.join(args.out_root, "logs"), args.pair_budget)
    os.makedirs(args.out_root, exist_ok=True)
    cfg_path = os.path.join(args.out_root, "dtu_spread_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    from edgegaussians_tpu_torch.config import load_config
    lcfg = load_config(cfg_path)
    exp = f"{cfg['output']['exp_name']}_PidiNet"
    rows, runs = [], {}
    for i in range(args.scenes):
        scan = f"dtu_sp{i}"
        if not args.skip_generate:
            print(f"[spread] generating {scan}...", flush=True)
            generate(scan, 20 + i, args, base)
        log, launches, wall = train_cli(cfg_path, scan, device)
        run_dir = os.path.join(cfg["output"]["output_dir"], exp, scan)
        ply = os.path.join(run_dir, "gaussians_all.ply")
        res = extract_and_eval(ply, lcfg, run_dir, scan=scan,
                               gt_base=f"{base}/groundtruth",
                               extraction_seeds=1)
        row = {"scan": scan, "wall_s": round(wall, 1),
               "chamfer": mean_rounded(res["chamfer"], 5),
               "f5": mean_rounded(res["f5"], 4),
               "f10": mean_rounded(res["f10"], 4)}
        rows.append(row)
        runs[scan] = {"losses": epoch_losses(log),
                      "launches": launches}
        print(f"[spread] {row}", flush=True)
    ch = [r["chamfer"] for r in rows if r["chamfer"] is not None]
    f10 = [r["f10"] for r in rows if r["f10"] is not None]

    def stat(fn, v, digits):
        return round(float(fn(v)), digits) if v else None

    return {"rows": rows,
            "chamfer_mean": stat(np.mean, ch, 5),
            "chamfer_std": stat(np.std, ch, 5),
            "f10_mean": stat(np.mean, f10, 4),
            "f10_std": stat(np.std, f10, 4),
            "runs": runs, "config": cfg_path, "platform": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--pair_budget", type=int, default=-1,
                    help="override tile_pair_budget (-1 = shipped value)")
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--out_root", default=DEFAULT_ROOT,
                    help="generated scans, outputs and the config go here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    args = ap.parse_args(argv)
    print(json.dumps(dtu_spread(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
