"""Multi-scene spread harness: fit_edges + per-scan evaluation over scans
the port trained (``cli.sweep``, ``cli.train`` or the spread scripts).

The port's counterpart of ``scripts/spread_synth.py``. For each scan of
``--scan_names``: the port's ``cli.fit_edges`` (unless ``--skip_fit``),
then ``cli.evaluate.evaluate_scan`` on its parametric edges. Prints the
JAX script's seven columns per scan, their mean and std, and last a JSON
object of every scan's metrics (a scan without predictions is left out,
as the JAX script leaves it out). NumPy on the CPU: it takes no device.

Usage:
    python scripts/torch_spread_synth.py --config_file CFG.json \\
        --gt_base_dir BASE/groundtruth \\
        --output_base_dir OUT/ABC/release_DexiNed \\
        --scan_names SYN01,SYN02,SYN03 [--skip_fit]

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from edgegaussians_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from edgegaussians_tpu_torch.cli import fit_edges as fit_cli  # noqa: E402

# the columns of the table (spread_synth.py:51-52)
KEYS = ["chamfer_dist", "acc", "comp", "precision_0.01", "recall_0.01",
        "fscore_0.01", "fscore_0.02"]


def spread(config_file: str, gt_base_dir: str, output_base_dir: str,
           scans, skip_fit: bool = False) -> dict:
    """Each scan's metrics (spread_synth.py:33-48): evaluate_scan's
    chamfer, accuracy and completeness with the first value of each
    precision / recall / F-score list."""
    rows = {}
    for scan in scans:
        if not skip_fit:
            rc = fit_cli.main(["--config_file", config_file,
                               "--scene_name", scan])
            if rc != 0:
                print(f"{scan}: fit_edges failed rc={rc}")
                continue
        pr = collections.defaultdict(list)
        res = eval_cli.evaluate_scan(scan, gt_base_dir, output_base_dir, pr,
                                     use_parametric_edges=True)
        if res is None:
            print(f"{scan}: no predictions")
            continue
        rows[scan] = {**res, **{k: v[0] for k, v in pr.items()}}
    return rows


def print_table(rows: dict) -> None:
    print("\nscan        " + "  ".join(f"{k:>14s}" for k in KEYS))
    for scan, r in rows.items():
        print(f"{scan:<10s}  " + "  ".join(f"{r[k]:14.4f}" for k in KEYS))
    if rows:
        vals = {k: np.array([r[k] for r in rows.values()]) for k in KEYS}
        print("mean        " + "  ".join(f"{vals[k].mean():14.4f}"
                                         for k in KEYS))
        print("std         " + "  ".join(f"{vals[k].std():14.4f}"
                                         for k in KEYS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--gt_base_dir", required=True)
    ap.add_argument("--output_base_dir", required=True)
    ap.add_argument("--scan_names", required=True)
    ap.add_argument("--skip_fit", action="store_true")
    args = ap.parse_args(argv)
    rows = spread(args.config_file, args.gt_base_dir, args.output_base_dir,
                  args.scan_names.split(","), args.skip_fit)
    print_table(rows)
    print(json.dumps({s: {k: float(v) for k, v in r.items()}
                      for s, r in rows.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
