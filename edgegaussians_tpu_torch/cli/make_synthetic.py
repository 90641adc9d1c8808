"""Generate synthetic ABC-style scans (see data/synthetic.py).

The port's counterpart of ``edgegaussians_tpu/cli/make_synthetic.py``,
over the port's own copy of ``data/synthetic.py``: the same flags, the
same files from the same seed.

The reference dataset ships a single scan; this CLI fabricates more with
the identical on-disk layout so the train -> fit_edges -> evaluate pipeline
can be exercised (and its metric spread measured) on many scenes:

    python -m edgegaussians_tpu_torch.cli.make_synthetic \\
        --base_dir /tmp/synth --scan_names S1 S2 S3 --seed 7
"""

from __future__ import annotations

import argparse

from edgegaussians_tpu_torch.data import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base_dir", type=str, required=True,
                    help="dataset root (gets data/ and groundtruth/)")
    ap.add_argument("--scan_names", type=str, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; scan i uses seed + i")
    ap.add_argument("--n_views", type=int, default=50)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--n_lines", type=int, default=8)
    ap.add_argument("--n_curves", type=int, default=4)
    ap.add_argument("--edge_detector", type=str, default="DexiNed")
    ap.add_argument("--gt_resolution", type=float, default=0.005)
    ap.add_argument("--noise_dropout", type=float, default=0.0,
                    help="fraction of edge response removed in patches")
    ap.add_argument("--noise_spurious", type=int, default=0,
                    help="false-edge blobs per view")
    ap.add_argument("--noise_intensity_jitter", type=float, default=0.0)
    args = ap.parse_args(argv)

    for i, scan in enumerate(args.scan_names):
        paths = synthetic.generate_scene(
            args.base_dir, scan, seed=args.seed + i, n_views=args.n_views,
            width=args.width, height=args.height, n_lines=args.n_lines,
            n_curves=args.n_curves, edge_detector=args.edge_detector,
            gt_resolution=args.gt_resolution,
            noise_dropout=args.noise_dropout,
            noise_spurious=args.noise_spurious,
            noise_intensity_jitter=args.noise_intensity_jitter)
        print(f"{scan}: wrote {paths['scene_dir']} "
              f"(GT {paths['gt_ply']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
