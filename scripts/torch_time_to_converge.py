"""Time-to-converge experiment: quality vs. training epoch on one scan.

The port's counterpart of ``scripts/time_to_converge.py``. BASELINE.md's
north star is "time-to-converge on ABC scan 00004926", but the reference
always trains the full scheduled 400 epochs (train_gaussians.py:164 — no
early stop, no intermediate eval). This script measures where quality
actually saturates: train the config once through the port's
``cli.train`` with periodic checkpoints, then run the full extraction +
eval pipeline on every checkpoint and print quality against wall-clock.
Each stage prints one JSON line last: the training's wall time,
checkpoints and kernel launches; the rows, and the checkpoints in which
extraction found no edges.

Stage ``train`` runs on the card (``--device cuda``, the default; an
error without one; ``--device cpu`` trains on the CPU); stage ``eval`` is
CPU/NumPy: it rebuilds the checkpoint template from the seed draw
``cli.train`` makes (``default_rng(training.seed)``), loads each
``epoch<N>.npz`` with ``trainer.load_checkpoint``, exports it with
``export_as_ply``, and scores it. Its rows and ``ttc_results.json`` are
the JAX script's. Example:

    python scripts/torch_time_to_converge.py --stage train
    python scripts/torch_time_to_converge.py --stage eval --seeds 3

``--data_dir``, ``--scene_name`` and ``--gt_base`` name another scan (a
``cli.make_synthetic`` one: ``<base>/data`` and ``<base>/groundtruth``).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

import numpy as np

from torch_common import (
    OUT_ROOT, add_scan_args, derive_config, extract_and_eval,
    resolve_device, scene_run_dir, train_cli)

CONFIG_NAME = "ttc_config"


def stage_train(args) -> int:
    device = resolve_device(args.device)

    def mutate(raw):
        raw["training"]["checkpoint_interval"] = args.interval

    cfg_path = derive_config(args.config, args.out_root, CONFIG_NAME,
                             args.data_dir, mutate)
    from edgegaussians_tpu_torch.config import load_config
    # a stale run's epochN.npz would make save_checkpoint fall back to
    # timestamped names that stage_eval ignores (and mtime-based wall
    # times would mix runs) — start clean
    run_dir = scene_run_dir(load_config(cfg_path), args.out_root,
                            args.scene_name)
    for old in glob.glob(os.path.join(run_dir, "epoch*.npz")):
        os.remove(old)
    t0 = time.time()
    _, launches, wall = train_cli(cfg_path, args.scene_name, device)
    with open(os.path.join(args.out_root, "t_start.txt"), "w") as f:
        f.write(str(t0))
    print(json.dumps({"stage": "train", "wall_s": round(wall, 1),
                      "checkpoints": list(checkpoints(run_dir)),
                      "launches": launches}))
    return 0


def checkpoints(run_dir: str):
    eps = {}
    for name in os.listdir(run_dir):
        m = re.fullmatch(r"epoch(\d+)\.npz", name)
        if m:
            eps[int(m.group(1))] = os.path.join(run_dir, name)
    return dict(sorted(eps.items()))


def stage_eval(args) -> int:
    from edgegaussians_tpu_torch.config import load_config
    from edgegaussians_tpu_torch.data import parsers, seed_points as seeds_mod
    from edgegaussians_tpu_torch.models.gaussians import export_as_ply
    from edgegaussians_tpu_torch.train import trainer

    cfg_path = os.path.join(args.out_root, f"{CONFIG_NAME}.json")
    cfg = load_config(cfg_path)
    scan = args.scene_name
    with open(os.path.join(args.out_root, "t_start.txt")) as f:
        t0 = float(f.read())

    # identical seed-point draw as cli.train (same RNG stream) so the
    # checkpoint template has matching shapes
    rng = np.random.default_rng(cfg.training.seed)
    seed_pts = seeds_mod.init_seed_points_random(
        cfg.model.init_min_num_gaussians,
        cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, rng)
    template = trainer.init_train_state(seed_pts, cfg, device="cpu")

    scene = None
    if cfg.filtering.filter_by_projection:
        scene = parsers.load_scene(cfg.data, scan)

    rows, no_edges = [], []
    for epoch, ckpt in checkpoints(scene_run_dir(cfg, args.out_root,
                                                 scan)).items():
        wall = os.path.getmtime(ckpt) - t0
        ts = trainer.load_checkpoint(ckpt, template)
        ep_dir = os.path.join(args.out_root, "eval", f"ep{epoch:04d}", scan)
        os.makedirs(ep_dir, exist_ok=True)
        ply = os.path.join(ep_dir, "gaussians_all.ply")
        n_alive = export_as_ply(ts.model, ply)

        m = extract_and_eval(ply, cfg, ep_dir, scan=scan,
                             gt_base=args.gt_base, scene=scene,
                             extraction_seeds=args.seeds)
        if not m["chamfer"]:
            print(f"epoch {epoch}: extraction produced no edges")
            no_edges.append(epoch)
            continue
        row = {
            "epoch": epoch, "wall_s": round(wall, 1), "alive": n_alive,
            "chamfer": float(np.mean(m["chamfer"])),
            "f5": float(np.mean(m["f5"])),
            "f10": float(np.mean(m["f10"])),
            "f10_min": float(np.min(m["f10"])),
            "f20": float(np.mean(m["f20"])),
        }
        rows.append(row)
        print(f"epoch {row['epoch']:4d}  wall {row['wall_s']:7.1f}s  "
              f"alive {row['alive']:6d}  chamfer {row['chamfer']:.4f}  "
              f"F@5 {row['f5']:.3f}  F@10 {row['f10']:.3f} "
              f"(min {row['f10_min']:.3f})  F@20 {row['f20']:.3f}")

    out = os.path.join(args.out_root, "ttc_results.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    print(json.dumps({"stage": "eval", "rows": rows, "no_edges": no_edges}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=["train", "eval"], required=True)
    ap.add_argument("--out_root", default=os.path.join(OUT_ROOT, "ttc"))
    ap.add_argument("--interval", type=int, default=25)
    ap.add_argument("--seeds", type=int, default=3,
                    help="extraction seeds per checkpoint (averages out "
                         "clustering stochasticity — README.md:84)")
    add_scan_args(ap)
    args = ap.parse_args(argv)
    if args.stage == "train":
        return stage_train(args)
    return stage_eval(args)


if __name__ == "__main__":
    raise SystemExit(main())
