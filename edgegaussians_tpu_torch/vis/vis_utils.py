"""Visualization utilities (matplotlib 3D + colored-PLY export).

The port's own copy of ``edgegaussians_tpu/vis/vis_utils.py`` (NumPy and
matplotlib): matplotlib is imported inside the functions, so the module
imports where matplotlib is not installed.

Covers the reference's Open3D viewers (edgegaussians/vis/vis_utils.py:9-166)
without a GUI dependency: every view function renders to a PNG (headless) or
an interactive matplotlib window, and cluster/edge geometry can also be
exported as colored PLY point clouds for external viewers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

import numpy as np

from edgegaussians_tpu_torch.io.ply import write_ply


def _cluster_colors(num: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, size=(num, 3))


def _scatter3d(ax, pts, color, size=2.0):
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=[color], s=size)


def _finish(fig, save_path: Optional[str], show: bool):
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    if show:                                       # pragma: no cover
        import matplotlib.pyplot as plt
        plt.show()
    else:
        import matplotlib.pyplot as plt
        plt.close(fig)


def visualize_clusters(points: np.ndarray, clusters: Sequence[Set[int]],
                       save_path: Optional[str] = None, show: bool = False):
    """Clusters in distinct colors (reference vis_utils.py:9-21)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    colors = _cluster_colors(len(clusters))
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for i, cluster in enumerate(clusters):
        _scatter3d(ax, points[sorted(cluster)], colors[i])
    ax.set_title(f"{len(clusters)} clusters")
    _finish(fig, save_path, show)


def export_clusters_as_ply(points: np.ndarray, clusters: Sequence[Set[int]],
                           ply_path: str):
    """Colored per-cluster point cloud for external viewers."""
    colors = _cluster_colors(len(clusters))
    pts, cols = [], []
    for i, cluster in enumerate(clusters):
        p = points[sorted(cluster)]
        pts.append(p)
        cols.append(np.tile(colors[i], (len(p), 1)))
    pts = np.concatenate(pts) if pts else np.zeros((0, 3))
    cols = np.concatenate(cols) if cols else np.zeros((0, 3))
    write_ply(ply_path, {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]})


def visualize_fit_edges(all_line_points: List, all_curve_points: List,
                        save_path: Optional[str] = None, show: bool = False):
    """Fitted lines (one color) + curves (another) — vis_utils.py:23-73."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for pts in all_line_points:
        p = np.asarray(pts).reshape(-1, 3)
        ax.plot(p[:, 0], p[:, 1], p[:, 2], c="tab:blue", linewidth=1.5)
    for pts in all_curve_points:
        p = np.asarray(pts).reshape(-1, 3)
        ax.plot(p[:, 0], p[:, 1], p[:, 2], c="tab:red", linewidth=1.5)
    ax.set_title(f"{len(all_line_points)} lines, "
                 f"{len(all_curve_points)} curves")
    _finish(fig, save_path, show)


def visualize_points_with_major_dirs(points: np.ndarray, dirs: np.ndarray,
                                     scale: float = 0.01,
                                     save_path: Optional[str] = None,
                                     show: bool = False):
    """Points + major-direction segments (vis_utils.py:75-101)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    _scatter3d(ax, points, (0.2, 0.2, 0.2), size=1.5)
    seg0 = points - 0.5 * scale * dirs
    seg1 = points + 0.5 * scale * dirs
    for a, b in zip(seg0, seg1):
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                c="tab:green", linewidth=0.8)
    _finish(fig, save_path, show)


def visualize_cameras(cameras, scale: float = 0.1,
                      save_path: Optional[str] = None, show: bool = False):
    """Camera frusta as origin + axes (vis_utils.py:105-166)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for cam in cameras:
        c = cam.center
        z = cam.R.T @ np.array([0, 0, 1.0])        # optical axis in world
        ax.scatter([c[0]], [c[1]], [c[2]], c="k", s=8)
        ax.plot([c[0], c[0] + scale * z[0]],
                [c[1], c[1] + scale * z[1]],
                [c[2], c[2] + scale * z[2]], c="tab:orange")
    _finish(fig, save_path, show)
