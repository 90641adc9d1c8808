"""Edge-fitting CLI of the port — the counterpart of the reference's
fit_edges.py, with the same flags and output layout as
``edgegaussians_tpu/cli/fit_edges.py``: ``parametric_edges.json`` (and,
on request, the filtered Gaussians and sampled edge points) beside the
trained scan's ``gaussians_all.ply``. NumPy only; it runs on the CPU.

Usage:
    python -m edgegaussians_tpu_torch.cli.fit_edges --config_file configs/ABC_DexiNed.json \
        --scene_name 00004926 [--input_ply ...] [--save_filtered] \
        [--save_sampled_points] [--output_json ...]
"""

from __future__ import annotations

import argparse
import os

from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers
from edgegaussians_tpu_torch.extract.pipeline import extract_edges


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fit parametric edges to trained edge Gaussians")
    ap.add_argument("--config_file", type=str, required=True)
    ap.add_argument("--scene_name", type=str, default=None)
    ap.add_argument("--input_ply", type=str, default=None)
    ap.add_argument("--save_filtered", action="store_true")
    ap.add_argument("--output_json", type=str, default=None)
    ap.add_argument("--save_sampled_points", action="store_true")
    ap.add_argument("--sample_resolution", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=None,
                    help="Clustering RNG seed (reference is unseeded)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config_file)
    exp_name = f"{cfg.output.exp_name}_{cfg.data.edge_detection_method}"
    output_dir = os.path.join(cfg.output.output_dir, exp_name,
                              args.scene_name or "")
    input_ply = args.input_ply or os.path.join(output_dir,
                                               "gaussians_all.ply")

    scene = None
    if cfg.filtering.filter_by_projection:
        scene = parsers.load_scene(cfg.data, args.scene_name)

    res = extract_edges(
        input_ply, cfg, scene=scene, output_dir=output_dir,
        save_filtered=args.save_filtered,
        save_sampled_points=args.save_sampled_points,
        sample_resolution=args.sample_resolution, seed=args.seed)

    print("Clustering complete")
    print(f"Number of clusters: {len(res.clusters)}")
    n_curves = len(res.parametric["curves_ctl_pts"])
    n_lines = len(res.parametric["lines_end_pts"])
    print(f"Fitted {n_curves} curves and {n_lines} lines")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
