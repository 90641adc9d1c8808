"""Nearest-neighbor queries for the CPU extraction/eval path.

The port's copy of ``edgegaussians_tpu/eval/neighbors.py``. It replaces the
reference's native dependencies — point_cloud_utils' C++ KD-tree
(eval_utils.py:416-489), sklearn NearestNeighbors (clustering.py:21) and
Open3D's outlier removal (filtering.py:59-69) — with one interface backed
by scipy's cKDTree, the JAX package's documented fallback when its own C++
KD-tree extension is not built. Both trees are exact, so the answers are
the same; a port of the C++ tree is a CPU speed matter (ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def k_nearest_neighbors(query: np.ndarray, data: np.ndarray, k: int = 1
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """For each query point, the k nearest points in ``data``.

    Returns (distances, indices); squeezed to 1-D when k == 1 — the
    pcu.k_nearest_neighbors contract (eval_utils.py:416-421).
    """
    from scipy.spatial import cKDTree
    query = np.ascontiguousarray(query, dtype=np.float64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    d, i = cKDTree(data).query(query, k=k)
    if k == 1:
        return np.asarray(d).reshape(-1), np.asarray(i).reshape(-1)
    return np.asarray(d), np.asarray(i)


def knn_self(points: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors within one cloud, self excluded ([N,k] each)."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    d, i = k_nearest_neighbors(points, points, k + 1)
    d = d.reshape(len(points), k + 1)
    i = i.reshape(len(points), k + 1)
    return d[:, 1:], i[:, 1:]
