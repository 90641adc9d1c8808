"""Seed-point initialization for the Gaussian model.

The port's own copy of ``edgegaussians_tpu/data/seed_points.py`` (NumPy only): the
port imports nothing of the JAX package, so the two stay in step by
tests/test_torch_common.py's parity tests, not by import.

Re-implements the reference's seeding strategies (reference:
edgegaussians/utils/data_utils.py:30-110) with NumPy RNG threaded explicitly
for reproducibility:

- load from .txt (raw xyz or COLMAP points3D.txt), .ply, or points3D.bin,
- pad up to ``init_min_num_gaussians`` by replicating with 0.1-sigma noise,
- or uniform-random seeding inside a box.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from edgegaussians_tpu_torch.io import colmap as colmap_io
from edgegaussians_tpu_torch.io import ply as ply_io


def init_seed_points_from_file(seed_points_path: str,
                               min_num: int,
                               rng: Optional[np.random.Generator] = None
                               ) -> np.ndarray:
    """Load seed points and pad to ``min_num`` (data_utils.py:30-70)."""
    rng = rng or np.random.default_rng(0)

    if seed_points_path.endswith(".txt"):
        try:
            pts = np.loadtxt(seed_points_path, ndmin=2).astype(np.float64)
            pts = pts[:, :3]
        except Exception:
            points3d = colmap_io.read_points3D_text(seed_points_path)
            pts = colmap_io.points3D_xyz(points3d)
    elif seed_points_path.endswith(".ply"):
        pts = ply_io.read_point_cloud(seed_points_path)
    elif seed_points_path.endswith(".bin"):
        points3d = colmap_io.read_points3D_binary(seed_points_path)
        pts = colmap_io.points3D_xyz(points3d)
    else:
        raise ValueError(f"Unsupported seed-point file: {seed_points_path}")

    n = pts.shape[0]
    if n < min_num:
        # replicate + 0.1-sigma gaussian noise (data_utils.py:57-65)
        rep = int(math.ceil((min_num - n) / n))
        noise = 0.1 * rng.standard_normal((rep * n, 3))
        extra = np.tile(pts, (rep, 1)) + noise
        pts = np.concatenate([pts, extra], axis=0)
    return pts.astype(np.float32)


def init_seed_points_random(num_points: int,
                            box_center: float = 0.5,
                            box_size: float = 1.0,
                            rng: Optional[np.random.Generator] = None
                            ) -> np.ndarray:
    """Uniform box seeding (data_utils.py:72-75)."""
    rng = rng or np.random.default_rng(0)
    pts = box_size * rng.random((num_points, 3)) - box_size / 2 + box_center
    return pts.astype(np.float32)


def get_scale_from_points(points: np.ndarray,
                          min_percentile: float = 0.05,
                          max_percentile: float = 0.95) -> float:
    """Percentile extent of the seed cloud (data_utils.py:105-110)."""
    lo = np.quantile(points, min_percentile, axis=0)
    hi = np.quantile(points, max_percentile, axis=0)
    return float(np.max(hi - lo))


def random_quats(num: int, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
    """Uniform random unit quaternions, wxyz (misc_utils.py:36-51)."""
    rng = rng or np.random.default_rng(0)
    u, v, w = rng.random(num), rng.random(num), rng.random(num)
    return np.stack([
        np.sqrt(1 - u) * np.sin(2 * np.pi * v),
        np.sqrt(1 - u) * np.cos(2 * np.pi * v),
        np.sqrt(u) * np.sin(2 * np.pi * w),
        np.sqrt(u) * np.cos(2 * np.pi * w),
    ], axis=-1).astype(np.float32)
