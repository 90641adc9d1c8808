"""Quality spread of the PyTorch port's whole ABC recipe on one GPU.

    python3 scripts/torch_quality_spread.py [--train_seeds 1 2 3]
        [--cluster_seeds 0 1 2]

Generates SYN01, a 50-view 800x800 synthetic scan, as
``cli/make_synthetic.py --seed 11`` does (scan i of ``--seed s`` uses seed
s + i), the scan of the JAX package's quality figures (docs/RESULTS.md),
then per training seed trains the unmodified
``configs/ABC_DexiNed.json`` (only ``training.seed`` replaced) through
``edgegaussians_tpu_torch.cli.train --backend cuda`` and, per clustering
seed, runs the port's ``cli.fit_edges --seed`` and ``cli.evaluate``. Prints
one line per (training seed, clustering seed), then the mean and standard
deviation of chamfer and F@5/10/20 over all of them and over the training
seeds' first clustering seed, and the card's name and power limit.
Needs a CUDA GPU; imports nothing of JAX. Training and scoring are
``chip_smoke.py``'s ``train_cli_run`` and ``downstream``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repo root is on sys.path only now)

KEYS = ("chamfer", "F@5", "F@10", "F@20")
SCAN, SCAN_SEED = "SYN01", 11


def score(tmp: str, scan: str, cfg_path: str, out_dir: str,
          cluster_seed: int) -> dict:
    with contextlib.redirect_stdout(io.StringIO()):
        _, per_scan, pr = chip_smoke.downstream(
            tmp, scan, cfg_path, out_dir, "metrics", cluster_seed)
    if per_scan is None:
        raise RuntimeError(f"no predictions for {scan}")
    return {"chamfer": per_scan["chamfer_dist"], "acc": per_scan["acc"],
            "comp": per_scan["comp"],
            **{f"F@{int(t * 1000)}": pr[f"fscore_{t}"][0]
               for t in (0.005, 0.01, 0.02)}}


def summary(rows, what: str) -> None:
    vals = {k: np.array([r[k] for r in rows]) for k in KEYS}
    print(f"{what} (n={len(rows)}): " + ", ".join(
        f"{k} {vals[k].mean():.5f} +- {vals[k].std():.5f}" for k in KEYS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--cluster_seeds", type=int, nargs="+",
                    default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    rows, firsts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(tmp, SCAN, seed=SCAN_SEED,
                       n_views=chip_smoke.FULL_VIEWS, width=800, height=800)
        for seed in args.train_seeds:
            t0 = time.time()
            text, _, out_dir, cfg_path = chip_smoke.train_cli_run(
                tmp, SCAN, None, f"seed{seed}", views=chip_smoke.FULL_VIEWS,
                echo=False, seed=seed)
            wall = time.time() - t0
            last = [x for x in text.splitlines() if x.startswith("epoch ")][-1]
            for cs in args.cluster_seeds:
                r = score(tmp, SCAN, cfg_path, out_dir, cs)
                rows.append(r)
                if cs == args.cluster_seeds[0]:
                    firsts.append(r)
                print(f"train seed {seed} cluster seed {cs}: " + ", ".join(
                    f"{k} {v:.5f}" for k, v in r.items())
                    + f" (train wall {wall:.1f}s; {last})", flush=True)
    summary(rows, "all runs")
    summary(firsts, "per training seed")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
