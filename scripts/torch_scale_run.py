"""The DTU or Replica recipe end to end on the PyTorch port: train ->
fit_edges -> evaluate, on the card.

    python3 scripts/torch_scale_run.py [--config configs/DTU.json]
        [--epochs 500] [--backend cuda|torch] [--out build/scale_run]
        [--skip_eval] [--profile_dir DIR]
    python3 scripts/torch_scale_run.py --config configs/Replica.json

The port's counterpart of ``scripts/dtu_scale_run.py``, config-generic:

- ``configs/DTU.json`` trains on the tracked DTU-shaped synthetic scan
  ``synthetic_data/DTU_synth/data/dtu_s0`` (30 views at 1600x1200,
  PidiNet-style edge maps, 2498 SfM seeds in ``sparse_sfm_points.txt``)
  and scores against its ``groundtruth/sampled_pts/dtu_s0_0.005.ply``. It
  reads that directory and writes nothing under it.
- ``configs/Replica.json`` first writes a Replica-layout scan under
  ``--out`` as ``dtu_scale_run.py`` does (seed 7, 16 lines and 8 curves,
  PidiNet, ``sigma_px`` 1.2, 30 views at 1200x680; 4000 seeds drawn from
  the ground-truth cloud by ``default_rng(11)`` with noise 0.01, in
  ``colmap/sparse/sparse.ply``), with the port's copies of
  ``data/synthetic.py`` and ``io/ply.py``.

The recipe is the config's, its data and output paths replaced and
``num_epochs`` set to ``--epochs`` (500 by default, as
``dtu_scale_run.py``: the DTU recipe's own count, and the count of the
JAX package's Replica audit). Training runs through the port's
``cli.train`` (``--backend cuda`` by default: the card, an error
without one), then ``cli.fit_edges`` and ``cli.evaluate``. It prints the
training wall time, the peak (tile, Gaussian) pair count against the
budget, each capacity step, the final live Gaussian count, chamfer and
F@5/10/20, and the card's name and power limit; the training CLI's own
output goes to ``<out>/<config name>/train.log``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DTU_BASE = os.path.join(REPO, "synthetic_data", "DTU_synth")
DTU_SCAN = "dtu_s0"
DETECTOR = "PidiNet"
REPLICA_SCENE = dict(seed=7, n_views=30, width=1200, height=680,
                     n_lines=16, n_curves=8, sigma_px=1.2)
REPLICA_SEEDS, REPLICA_SEED_RNG, REPLICA_SEED_NOISE = 4000, 11, 0.01


def make_replica_scan(base: str, scan: str) -> None:
    """A Replica-layout synthetic scan under ``base`` (dtu_scale_run.py
    generate())."""
    from edgegaussians_tpu_torch.data import synthetic
    from edgegaussians_tpu_torch.io import ply as ply_io
    paths = synthetic.generate_scene(base, scan, edge_detector=DETECTOR,
                                     **REPLICA_SCENE)
    pts = ply_io.read_point_cloud(paths["gt_ply"])
    rng = np.random.default_rng(REPLICA_SEED_RNG)
    take = rng.choice(len(pts), size=min(REPLICA_SEEDS, len(pts)),
                      replace=True)
    seeds = pts[take] + rng.normal(0, REPLICA_SEED_NOISE, (len(take), 3))
    sparse = os.path.join(base, "data", scan, "colmap", "sparse")
    os.makedirs(sparse, exist_ok=True)
    ply_io.write_point_cloud(os.path.join(sparse, "sparse.ply"),
                             seeds.astype(np.float32))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def scale_run(config: str, epochs: int = 500, backend: str = "cuda",
              out: str = os.path.join(REPO, "build", "scale_run"),
              skip_eval: bool = False, profile_dir=None,
              model=None) -> dict:
    """Run the recipe of ``config``; returns its numbers. The training
    CLI's output goes to ``<out>/<config name>/train.log``. ``model``
    updates the config's model section."""
    from edgegaussians_tpu_torch.cli import evaluate, fit_edges
    from edgegaussians_tpu_torch.cli import train as train_cli
    with open(config) as f:
        cfg = json.load(f)
    name = os.path.splitext(os.path.basename(config))[0]
    dataset = cfg["data"]["dataset_name"]
    run_root = os.path.join(out, name)
    if dataset == "DTU":
        base, scan = DTU_BASE, DTU_SCAN
    else:
        base, scan = os.path.join(run_root, "scan"), f"{name.lower()}_s0"
        t0 = time.time()
        make_replica_scan(base, scan)
        print(f"[scale_run] {dataset}-layout scan written in "
              f"{time.time() - t0:.1f}s", flush=True)
    cfg["data"].update(base_dir=os.path.join(base, "data") + "/",
                       edge_detection_method=DETECTOR)
    cfg["training"]["num_epochs"] = epochs
    cfg["model"].update(model or {})
    for k in ("output_dir", "checkpoint_dir", "log_dir"):
        cfg["output"][k] = os.path.join(run_root, k) + "/"
    os.makedirs(run_root, exist_ok=True)
    cfg_path = os.path.join(run_root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = os.path.join(cfg["output"]["output_dir"],
                           f"{cfg['output']['exp_name']}_{DETECTOR}", scan)
    argv = ["--config_file", cfg_path, "--scene_name", scan, "--backend",
            backend, "--force_rerun"]
    if profile_dir:
        argv += ["--profile_dir", profile_dir, "--profile_epochs", "1"]
    log_path = os.path.join(run_root, "train.log")
    t0 = time.time()
    with open(log_path, "w", buffering=1) as f, \
            contextlib.redirect_stdout(f):
        if train_cli.main(argv):
            raise RuntimeError(f"cli.train returned non-zero ({log_path})")
    wall = time.time() - t0
    with open(log_path) as f:
        log = f.read()
    pairs = [int(p) for p in re.findall(r" pairs=(\d+)/", log)]
    steps = re.findall(r"^epoch \d+: capacity \d+ -> \d+ \(alive \d+\)$",
                       log, re.M)
    live = re.search(r"Exported (\d+) Gaussians", log)
    losses = [float(x) for x in re.findall(r"^epoch \d+: loss=(\S+)", log,
                                           re.M)]
    res = {"config": name, "scan": scan, "epochs": epochs,
           "train_wall_s": wall, "peak_pairs": max(pairs, default=None),
           "pair_budget": cfg["model"]["tile_pair_budget"],
           "capacity_steps": steps, "losses": losses,
           "final_live": int(live.group(1)) if live else None,
           "out_dir": out_dir, "config_path": cfg_path, "log": log_path}
    print(f"[scale_run] {name}: training wall {wall:.1f}s for {epochs} "
          f"epochs; peak pairs {res['peak_pairs']} of the "
          f"{res['pair_budget']} budget; capacity steps {steps}; final "
          f"live {res['final_live']}", flush=True)
    if skip_eval:
        return res
    metrics_dir = os.path.join(run_root, "metrics")
    with contextlib.redirect_stdout(io.StringIO()):
        if fit_edges.main(["--config_file", cfg_path, "--scene_name", scan]):
            raise RuntimeError("cli.fit_edges returned non-zero")
        if evaluate.main(["--scan_names", scan, "--gt_base_dir",
                          os.path.join(base, "groundtruth"),
                          "--output_base_dir", os.path.dirname(out_dir),
                          "--use_parametric_edges", "--edge_detector",
                          DETECTOR, "--write_metrics", "--write_metrics_dir",
                          metrics_dir]):
            raise RuntimeError("cli.evaluate returned non-zero")
    written = os.path.join(metrics_dir, "release", DETECTOR)
    with open(os.path.join(written, "pr.pkl"), "rb") as f:
        pr = pickle.load(f)
    with open(os.path.join(written, "acc_comp_chamfer.pkl"), "rb") as f:
        per_scan = pickle.load(f).get(scan, {}).get("edgegaussians")
    if per_scan is None:
        raise RuntimeError(f"{name}: no predictions to evaluate")
    res.update(chamfer=per_scan["chamfer_dist"], acc=per_scan["acc"],
               comp=per_scan["comp"],
               **{f"F@{int(t * 1000)}": pr[f"fscore_{t}"][0]
                  for t in (0.005, 0.01, 0.02)})
    print(f"[scale_run] {name}: chamfer {res['chamfer']} acc {res['acc']} "
          f"comp {res['comp']} F@5/10/20 {res['F@5']} / {res['F@10']} / "
          f"{res['F@20']}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs",
                                                     "DTU.json"))
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="cuda: the card (an error without one); torch: "
                         "the CPU")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "scale_run"))
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--profile_dir", default=None,
                    help="trace epoch 2 with torch.profiler here")
    args = ap.parse_args(argv)
    res = scale_run(args.config, args.epochs, args.backend, args.out,
                    args.skip_eval, args.profile_dir)
    print(json.dumps({k: v for k, v in res.items() if k != "losses"}))
    if args.backend == "cuda":
        print(card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
