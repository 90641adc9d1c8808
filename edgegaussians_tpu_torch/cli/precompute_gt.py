"""CLI: pre-sample ABC ground-truth edges for every scan (counterpart of the
reference's pre_compute_ABC_gt_sampled.py:21-34).

The port's counterpart of ``edgegaussians_tpu/cli/precompute_gt.py``, over
the port's copies of ``eval/gt.py`` and ``io/ply.py``:

    python -m edgegaussians_tpu_torch.cli.precompute_gt \\
        --gt_base_dir data/ABC-NEF_Edge/groundtruth [--scan_names A,B]
"""

from __future__ import annotations

import argparse
import os

from edgegaussians_tpu_torch.eval.gt import get_gt_points
from edgegaussians_tpu_torch.io.ply import write_point_cloud


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_base_dir", type=str, required=True)
    ap.add_argument("--sample_resolution", type=float, default=0.005)
    ap.add_argument("--scan_names", type=str, default="all",
                    help="comma-separated or 'all' (from the obj dir)")
    args = ap.parse_args(argv)

    objs_dir = os.path.join(args.gt_base_dir, "obj")
    if args.scan_names == "all":
        scans = sorted({n[:8] for n in os.listdir(objs_dir)})
    else:
        scans = args.scan_names.split(",")

    out_dir = os.path.join(args.gt_base_dir, "sampled_pts")
    os.makedirs(out_dir, exist_ok=True)
    for scan in scans:
        _, pts, _ = get_gt_points(scan, interval=args.sample_resolution,
                                  data_base_dir=args.gt_base_dir)
        if pts is None:
            print(f"{scan}: no sharp edges, skipped")
            continue
        out = os.path.join(out_dir, f"{scan}_{args.sample_resolution}.ply")
        write_point_cloud(out, pts)
        print(f"{scan}: {len(pts)} points -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
