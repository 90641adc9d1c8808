"""A/B spread experiment: 'absolute' vs 'top_fraction' duplication, on the
card.

The port's counterpart of ``scripts/dup_spread_ab.py``. The reference's
'absolute' duplication rule (edge_gs.py:559-568: min-max-normalized
absgrads > 0.5) selects wildly varying fractions per event because the
cutoff sits on a knife edge of the normalized scale. This trains the
config over several training seeds for both strategies in one process
and reports the final-quality spread per arm:

  - ``absolute``: the config as shipped;
  - ``top_fraction``: ``dup_threshold_type: "top_fraction"`` with
    ``dup_threshold_value = --fraction``, set on ``cfg.model``.

Training seed s (0, 1, ... ``--seeds`` - 1) sets ``cfg.training.seed``
and draws the random seed points from ``np.random.default_rng(s)``, as
the JAX script does; each run goes ``trainer.train`` -> ``export_as_ply``
-> ``torch_common.extract_and_eval`` (3 extraction seeds). Per arm the
rows (``seed gaussians wall_s chamfer f10``) and the mean +- std, written
to ``<out_root>/dup_ab_results.json``; the last line is a JSON object of
the rows, the summaries, the card and each run's epoch losses and kernel
launches. A run whose extraction finds no edges reports ``chamfer`` and
``f10`` as null.

Usage: python scripts/torch_dup_spread_ab.py [--seeds 3] [--fraction 0.2]
       [--epochs 0] [--out_root DIR]
       [--config configs/ABC_DexiNed.json] [--data_dir DIR]
       [--scene_name 00004926] [--gt_base DIR] [--device cuda|cpu]

``--epochs`` 0 keeps the shipped ``num_epochs``. ``--device cuda`` (the
default) trains on the card and raises without one; ``--device cpu``
trains on the CPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from torch_common import (
    OUT_ROOT, add_scan_args, backend_of, card, epoch_losses,
    extract_and_eval, kernel_counts, mean_rounded, reset_kernel_counts,
    resolve_device)

from edgegaussians_tpu_torch.config import load_config

def arms(fraction: float) -> dict:
    """Each arm's overrides of ``cfg.model`` (dup_spread_ab.py:61-65)."""
    return {"absolute": {},
            "top_fraction": {"dup_threshold_type": "top_fraction",
                             "dup_threshold_value": fraction}}


def arm_config(config: str, overrides: dict, epochs: int = 0,
               data_dir=None):
    """The config of one arm: ``config`` with ``overrides`` set on its
    model (dup_spread_ab.py:67-69), ``num_epochs`` when ``epochs`` is
    given and the scans read from ``data_dir`` when given."""
    cfg = load_config(config)
    for k, v in overrides.items():
        setattr(cfg.model, k, v)
    if epochs:
        cfg.training.num_epochs = epochs
    if data_dir:
        cfg.data.base_dir = os.path.join(data_dir, "")
    return cfg


def train_one(cfg, seed: int, out_dir: str, scene, device):
    """Train training seed ``seed`` (dup_spread_ab.py:26-47): (the PLY, its
    Gaussians, wall seconds, the logged epoch losses, the kernel
    launches)."""
    from edgegaussians_tpu_torch.data import seed_points as seeds_mod
    from edgegaussians_tpu_torch.models.gaussians import export_as_ply
    from edgegaussians_tpu_torch.train import trainer

    cfg.training.seed = seed
    rng = np.random.default_rng(seed)
    pts = seeds_mod.init_seed_points_random(
        cfg.model.init_min_num_gaussians,
        cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, rng)
    lines = []
    reset_kernel_counts()
    t0 = time.time()
    state = trainer.train(scene, pts, cfg, backend=backend_of(device),
                          log_fn=lines.append)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernel_counts()
    os.makedirs(out_dir, exist_ok=True)
    ply = os.path.join(out_dir, "gaussians_all.ply")
    n = export_as_ply(state.model, ply)
    losses = epoch_losses("\n".join(lines))
    print(f"  trained seed={seed}: {wall:.1f}s, {n} Gaussians", flush=True)
    return ply, n, wall, losses, launches


def summary(rows) -> dict:
    """Mean and std of an arm's rows, over the runs that found edges."""
    out = {}
    for k in ("chamfer", "f10", "gaussians"):
        v = [r[k] for r in rows if r[k] is not None]
        out[f"{k}_mean"] = float(np.mean(v)) if v else None
        out[f"{k}_std"] = float(np.std(v)) if v else None
    return out


def dup_ab(args) -> dict:
    device = resolve_device(args.device)
    from edgegaussians_tpu_torch.data import parsers
    scan = args.scene_name
    scene = None
    results, summaries, extra = {}, {}, {}
    for arm, overrides in arms(args.fraction).items():
        print(f"=== arm {arm} {overrides}", flush=True)
        cfg = arm_config(args.config, overrides, args.epochs, args.data_dir)
        if scene is None:
            scene = parsers.load_scene(cfg.data, scan)
        rows = []
        for seed in range(args.seeds):
            out_dir = os.path.join(args.out_root, arm, f"seed{seed}", scan)
            ply, n, wall, losses, launches = train_one(cfg, seed, out_dir,
                                                       scene, device)
            m = extract_and_eval(ply, cfg, out_dir, scan=scan,
                                 gt_base=args.gt_base, scene=scene)
            chamfer, f10 = mean_rounded(m["chamfer"]), mean_rounded(m["f10"])
            rows.append({"seed": seed, "gaussians": n, "wall_s": wall,
                         "chamfer": chamfer, "f10": f10})
            extra[f"{arm}/seed{seed}"] = {"losses": losses,
                                          "launches": launches}
            if chamfer is None:
                print(f"  seed={seed} gaussians={n}: extraction produced "
                      "no edges", flush=True)
            else:
                print(f"  seed={seed} gaussians={n} chamfer={chamfer:.4f} "
                      f"F@10={f10:.3f}", flush=True)
        results[arm] = rows
        summaries[arm] = s = summary(rows)
        if s["chamfer_mean"] is not None:
            print(f"  {arm}: chamfer {s['chamfer_mean']:.4f} +- "
                  f"{s['chamfer_std']:.4f}  F@10 {s['f10_mean']:.3f} +- "
                  f"{s['f10_std']:.3f}  gaussians {s['gaussians_mean']:.0f} "
                  f"+- {s['gaussians_std']:.0f}", flush=True)
    os.makedirs(args.out_root, exist_ok=True)
    out = os.path.join(args.out_root, "dup_ab_results.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {out}")
    return {"results": results, "summary": summaries, "runs": extra,
            "fraction": args.fraction, "platform": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fraction", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=0,
                    help="override num_epochs (0 = shipped value)")
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT, "dup_ab"))
    add_scan_args(ap)
    args = ap.parse_args(argv)
    print(json.dumps(dup_ab(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
