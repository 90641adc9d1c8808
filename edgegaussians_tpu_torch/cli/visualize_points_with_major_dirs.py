"""CLI: visualize a dirs-PLY (counterpart of the reference's
visualize_points_with_major_dirs.py).

The port's counterpart of
``edgegaussians_tpu/cli/visualize_points_with_major_dirs.py``:

    python -m edgegaussians_tpu_torch.cli.visualize_points_with_major_dirs \\
        --dirs_ply RUN_DIR/pts_with_major_dirs.ply --save_path dirs.png
"""

from __future__ import annotations

import argparse

from edgegaussians_tpu_torch.io.ply import read_pts_with_major_dirs_from_ply
from edgegaussians_tpu_torch.vis.vis_utils import \
    visualize_points_with_major_dirs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dirs_ply", type=str, required=True)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--save_path", type=str, default=None,
                    help="PNG output; omit to open a window")
    args = ap.parse_args(argv)

    pos, dirs = read_pts_with_major_dirs_from_ply(args.dirs_ply)
    visualize_points_with_major_dirs(
        pos, dirs, scale=args.scale, save_path=args.save_path,
        show=args.save_path is None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
