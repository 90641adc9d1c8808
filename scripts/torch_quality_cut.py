"""Whole-recipe quality of one package at a cut size: one arm of the
three-way comparison of the JAX package on the CPU, the PyTorch port on
the CPU and the port on the card.

    python3 scripts/torch_quality_cut.py --package jax --device cpu \
        [--train_seeds 1 2 3] [--views 10] [--size 800] [--out DIR]
    python3 scripts/torch_quality_cut.py --package torch --device cpu
    python3 scripts/torch_quality_cut.py --package torch --device cuda
    python3 scripts/torch_quality_cut.py --package torch --device cpu \
        --refit_from jax_cpu_10v800

The scan is SYN01 as ``cli/make_synthetic.py --seed 11`` makes it (seed
11, 8 lines and 4 curves, the same wireframe and ground truth at any view
count), cut to ``--views`` views at ``--size`` x ``--size`` pixels, with
the focal length scaled as ``generate_scene`` scales it (1111.11 x
size / 800). Each package writes it with its own copy of
``data/synthetic.py``. Per training seed the arm trains the unmodified
``configs/ABC_DexiNed.json`` (400 epochs, every event at its epoch; only
``training.seed`` and the data and output paths replaced) through its
package's ``cli.train``, then runs that package's ``cli.fit_edges --seed
0`` and ``cli.evaluate``, and prints one line per seed: the final live
Gaussians, chamfer, F@5, F@10 (and F@20, the training wall time). Last it
prints the mean and standard deviation over the seeds.

``--refit_from TAG`` trains nothing: it copies another arm's trained runs
(``<out>/<TAG>_seed<s>``) and scores them with this package's
``fit_edges`` and ``evaluate``, so that training and the extraction can
be held apart.

At 200 x 200 the recipe's 'absolute' duplication fills the 16384
capacity in every arm, a regime the full-size recipe never enters; at
the default 10 views of 800 x 800 (only the view count cut) the live
counts end where the 50-view runs' do.

``--package torch`` imports nothing of JAX, so the card's machine, which
has no JAX, runs it; ``--package jax`` runs on the CPU only
(``JAX_PLATFORMS=cpu`` is set before JAX loads). Run each arm in its own
process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import re
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RECIPE = os.path.join(REPO, "configs", "ABC_DexiNed.json")
SCAN, SCAN_SEED, CLUSTER_SEED = "SYN01", 11, 0
KEYS = ("chamfer", "F@5", "F@10", "F@20")


def write_config(root: str, seed: int) -> str:
    """The unmodified recipe with its seed and paths replaced."""
    with open(RECIPE) as f:
        cfg = json.load(f)
    cfg["training"]["seed"] = seed
    cfg["data"]["base_dir"] = os.path.join(root, "data") + "/"
    run = os.path.join(root, f"seed{seed}")
    for k in ("output_dir", "checkpoint_dir", "log_dir"):
        cfg["output"][k] = os.path.join(run, k) + "/"
    path = os.path.join(root, f"seed{seed}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def copy_run(src: str, dst: str, seed: int) -> None:
    """A copy at ``dst`` of the trained run under ``src``, its config's
    paths moved there, without the source's fitted edges and scores."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "metrics", "parametric_edges.json"))
    path = os.path.join(dst, f"seed{seed}.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(src, dst))


def run_seed(pkg: str, backend: str, root: str, seed: int,
             train: bool = True) -> dict:
    """Train (unless ``train`` is False: ``root`` holds a trained run),
    fit and score one training seed; returns its numbers."""
    fit_cli = __import__(f"{pkg}.cli.fit_edges", fromlist=["main"])
    eval_cli = __import__(f"{pkg}.cli.evaluate", fromlist=["main"])
    cfg_path = (write_config(root, seed) if train
                else os.path.join(root, f"seed{seed}.json"))
    with open(cfg_path) as f:
        cfg = json.load(f)
    out_dir = os.path.join(
        cfg["output"]["output_dir"],
        f"{cfg['output']['exp_name']}_{cfg['data']['edge_detection_method']}",
        SCAN)
    log_path = os.path.join(root, f"seed{seed}_train.log")
    wall = None
    if train:
        train_cli = __import__(f"{pkg}.cli.train", fromlist=["main"])
        t0 = time.time()
        with open(log_path, "w", buffering=1) as log, \
                contextlib.redirect_stdout(log):
            rc = train_cli.main(["--config_file", cfg_path, "--scene_name",
                                 SCAN, "--backend", backend, "--force_rerun"])
        wall = time.time() - t0
        if rc:
            raise RuntimeError(f"{pkg}.cli.train returned {rc}")
    with open(log_path) as f:
        text = f.read()
    m = re.search(r"Exported (\d+) Gaussians", text)
    if m is None:
        raise RuntimeError(f"no PLY exported; see {log_path}")
    metrics_dir = os.path.join(root, f"seed{seed}", "metrics")
    with contextlib.redirect_stdout(io.StringIO()):
        if fit_cli.main(["--config_file", cfg_path, "--scene_name", SCAN,
                         "--seed", str(CLUSTER_SEED)]):
            raise RuntimeError(f"{pkg}.cli.fit_edges failed")
        if eval_cli.main(["--scan_names", SCAN, "--gt_base_dir",
                          os.path.join(root, "groundtruth"),
                          "--output_base_dir", os.path.dirname(out_dir),
                          "--use_parametric_edges", "--write_metrics",
                          "--write_metrics_dir", metrics_dir]):
            raise RuntimeError(f"{pkg}.cli.evaluate failed")
    written = os.path.join(metrics_dir, "release", "DexiNed")
    with open(os.path.join(written, "pr.pkl"), "rb") as f:
        pr = pickle.load(f)
    with open(os.path.join(written, "acc_comp_chamfer.pkl"), "rb") as f:
        per_scan = pickle.load(f).get(SCAN, {}).get("edgegaussians")
    if per_scan is None:
        raise RuntimeError(f"seed {seed}: no predictions to evaluate")
    return {"live": int(m.group(1)), "chamfer": per_scan["chamfer_dist"],
            **{f"F@{int(t * 1000)}": pr[f"fscore_{t}"][0]
               for t in (0.005, 0.01, 0.02)},
            "train_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--train_seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "quality_cut"))
    ap.add_argument("--refit_from", default=None, metavar="TAG",
                    help="train nothing: copy the trained runs "
                         "<out>/<TAG>_seed<s> (e.g. jax_cpu_10v800) and "
                         "score them with this package's fit_edges and "
                         "evaluate")
    args = ap.parse_args(argv)
    if args.package == "jax":
        if args.device != "cpu":
            raise SystemExit("the JAX arm runs on the CPU only")
        os.environ["JAX_PLATFORMS"] = "cpu"
        pkg, backend = "edgegaussians_tpu", "auto"
    else:
        import torch
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch sees no CUDA device")
        pkg = "edgegaussians_tpu_torch"
        backend = "cuda" if args.device == "cuda" else "torch"
    synthetic = __import__(f"{pkg}.data.synthetic", fromlist=["x"])
    tag = (f"{args.package}_refit_{args.refit_from}" if args.refit_from
           else f"{args.package}_{args.device}_{args.views}v{args.size}")
    results = {}
    for seed in args.train_seeds:
        root = os.path.join(args.out, f"{tag}_seed{seed}")
        if args.refit_from:
            copy_run(os.path.join(args.out, f"{args.refit_from}_seed{seed}"),
                     root, seed)
        else:
            synthetic.generate_scene(root, SCAN, seed=SCAN_SEED,
                                     n_views=args.views, width=args.size,
                                     height=args.size)
        r = results[seed] = run_seed(pkg, backend, root, seed,
                                     train=not args.refit_from)
        print(f"{tag} seed {seed}: live {r['live']} chamfer {r['chamfer']} "
              f"F@5 {r['F@5']} F@10 {r['F@10']} F@20 {r['F@20']} "
              + (f"train {r['train_s']:.1f}s" if r["train_s"] else "refit"),
              flush=True)
    for k in ("live",) + KEYS:
        vals = np.array([r[k] for r in results.values()], float)
        std = vals.std(ddof=1) if len(vals) > 1 else 0.0
        print(f"{tag} {k}: mean {vals.mean()} std {std} over seeds "
              f"{list(results)}", flush=True)
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
