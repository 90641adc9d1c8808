"""Post-training Gaussian filtering (CPU, NumPy).

The port's copy of ``edgegaussians_tpu/extract/filtering.py``. It
re-implements the reference's three sequential filters
(edgegaussians/edge_extraction/filtering.py, applied in fit_edges.py:20-45):

1. statistical outlier removal — the Open3D C++ ``remove_statistical_outlier``
   is just 'mean kNN distance vs. global mean + k*sigma'; implemented here
   with scipy's cKDTree (``eval/neighbors.py``),
2. opacity threshold,
3. projection filter — keep Gaussians whose mean, projected into every view,
   lands on sufficiently many edge pixels (fractional edge intensities are
   *summed*, matching filtering.py:113-117).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _knn_distances(points: np.ndarray, k: int) -> np.ndarray:
    """[N,k] distances to the k nearest neighbors (self excluded)."""
    from edgegaussians_tpu_torch.eval.neighbors import knn_self
    return knn_self(points, k)[0]


def filter_stat_outliers(means: np.ndarray, num_nn: int = 10,
                         std_multiplier: float = 3.0) -> np.ndarray:
    """Open3D remove_statistical_outlier semantics (filtering.py:59-69).

    A point is an inlier iff its mean distance to the ``num_nn`` nearest
    neighbors is below mean + std_multiplier * std of that statistic.
    Returns inlier indices.
    """
    avg = _knn_distances(np.asarray(means, np.float64), num_nn).mean(axis=1)
    thresh = avg.mean() + std_multiplier * avg.std(ddof=1)
    return np.flatnonzero(avg <= thresh)


def filter_by_opacity(opacities: np.ndarray, min_opacity: float) -> np.ndarray:
    """Boolean inlier mask (filtering.py:71-77)."""
    return (np.asarray(opacities).reshape(-1) > min_opacity)


def project2D_single(K, R, T, points3d: np.ndarray) -> np.ndarray:
    """Pinhole projection of [N,3] world points -> [N,2] pixel coords
    (filtering.py:19-28)."""
    X = np.asarray(points3d).reshape(-1, 3)
    x = (np.asarray(K).reshape(3, 3) @
         (np.asarray(R).reshape(3, 3) @ X.T + np.asarray(T).reshape(3, 1))).T
    return (x[:, :2] / x[:, 2:3]).reshape(-1, 2)


def filter_by_projection(gaussian_means: np.ndarray,
                         edge_images: List[np.ndarray],   # [H,W] in [0,1]
                         cameras: List[Dict],             # {'K','R','t','h','w'}
                         visib_thresh: float = 0.1) -> np.ndarray:
    """Mean summed edge intensity at projected means over views
    (filtering.py:80-122). Returns boolean inlier mask."""
    num_gs = gaussian_means.shape[0]
    num_images = len(edge_images)
    visib = np.zeros((num_gs, num_images))

    for i in range(num_images):
        cam = cameras[i]
        uv = project2D_single(cam["K"], cam["R"], cam["t"], gaussian_means)
        uv = np.round(uv).astype(np.int32)
        h, w = cam["h"], cam["w"]
        valid = ((uv[:, 0] >= 0) & (uv[:, 0] < w)
                 & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        em = np.asarray(edge_images[i])
        visib[valid, i] += em[uv[valid, 1], uv[valid, 0]]

    return visib.mean(axis=1) > visib_thresh


def cameras_from_scene(scene) -> Tuple[List[np.ndarray], List[Dict]]:
    """SceneViews -> (edge_images, camera dicts) for the projection filter
    (filtering.py:42-56)."""
    edge_images = [scene.images[i] for i in range(scene.num_views)]
    cameras = []
    for c in scene.cameras:
        vm = c.viewmat
        cameras.append({"K": c.K, "R": vm[:3, :3], "t": vm[:3, 3:],
                        "h": c.height, "w": c.width})
    return edge_images, cameras


def filter_points(pos, scales, quats, opacities, filtering_cfg,
                  scene=None):
    """Sequential filter chain (fit_edges.py:20-45).

    ``scene`` (SceneViews) is required only when filter_by_projection is on.
    Unlike the reference, the configured ``filter_visib_thresh`` is actually
    forwarded (the reference drops it — SURVEY §6.5.8).
    """
    def apply(inlier):
        return (pos[inlier], scales[inlier], quats[inlier],
                opacities[inlier])

    if filtering_cfg.filter_stat_outliers:
        pos, scales, quats, opacities = apply(filter_stat_outliers(
            pos, num_nn=filtering_cfg.filter_stat_outlier_num_nn,
            std_multiplier=filtering_cfg.filter_stat_outlier_std_mult))

    if filtering_cfg.filter_by_opacity:
        pos, scales, quats, opacities = apply(filter_by_opacity(
            opacities, filtering_cfg.filter_opacity_min))

    if filtering_cfg.filter_by_projection:
        if scene is None:
            raise ValueError("filter_by_projection requires scene views")
        edge_images, cameras = cameras_from_scene(scene)
        pos, scales, quats, opacities = apply(filter_by_projection(
            pos, edge_images, cameras,
            visib_thresh=filtering_cfg.filter_visib_thresh))

    return pos, scales, quats, opacities
