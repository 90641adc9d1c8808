"""Greedy direction-based clustering (CPU, NumPy).

The port's copy of ``edgegaussians_tpu/extract/clustering.py`` (NumPy only).

Re-implements the reference's stochastic region-growing clusterer
(edgegaussians/edge_extraction/clustering.py:15-72): pick a random unvisited
seed, grow along the 5-NN graph where four alignment tests all clear the
angle threshold (|cos| between: neighbor major directions and the seed's,
point-to-point directions and the seed's direction, point-to-point directions
and each neighbor's own direction, neighbor directions and the running mean
cluster direction).

The RNG is an explicit ``numpy.random.Generator`` so runs are reproducible —
the reference seeds nothing and documents run-to-run variance
(README.md:84).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np


def cluster_points_using_directions_greedy(
    points: np.ndarray,                 # [N,3]
    directions: np.ndarray,             # [N,3] unit major directions
    angle_thresh: float = 0.65,
    min_cluster_size: int = 5,
    num_neighbors: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[Set[int]], np.ndarray, np.ndarray]:
    """Returns (valid_clusters, points, directions) — the reference's
    contract (clustering.py:15-72). ``num_neighbors`` matches the
    reference's 5-NN graph minus self."""
    rng = rng or np.random.default_rng()
    n = len(points)
    if n == 0:
        return [], points, directions

    from edgegaussians_tpu_torch.eval.neighbors import knn_self
    _, indices_nn = knn_self(np.asarray(points, np.float64),
                             min(num_neighbors, n - 1))

    unvisited = set(range(n))
    clusters: List[Set[int]] = []

    while unvisited:
        selected = int(rng.choice(list(unvisited)))
        current: Set[int] = {selected}
        cluster_dir = directions[selected]

        while current & unvisited:
            unvisited.discard(selected)
            init_dir = directions[selected]

            nbrs = indices_nn[selected]
            d_between = points[nbrs] - points[selected]
            norms = np.linalg.norm(d_between, axis=1, keepdims=True)
            d_between = d_between / np.maximum(norms, 1e-12)
            dirs_at = directions[nbrs]

            align_dirs = np.abs(dirs_at @ directions[selected])
            align_between_curr = np.abs(d_between @ directions[selected])
            align_between_nbr = np.abs(np.sum(d_between * dirs_at, axis=1))
            align_cluster = np.abs(dirs_at @ cluster_dir)

            valid = ((align_dirs > angle_thresh)
                     & (align_between_curr > angle_thresh)
                     & (align_between_nbr > angle_thresh)
                     & (align_cluster > angle_thresh))

            current |= set(int(i) for i in nbrs[valid])
            aligned = np.array([
                directions[i] if directions[i] @ init_dir > 0
                else -directions[i]
                for i in current])
            cluster_dir = aligned.mean(axis=0)

            frontier = current & unvisited
            if frontier:
                selected = next(iter(frontier))

        clusters.append(current)

    valid_clusters = [c for c in clusters if len(c) > min_cluster_size]
    return valid_clusters, points, directions
