"""Parametric edge fitting: robust line fit + cubic Bezier comparison.

The port's copy of ``edgegaussians_tpu/extract/fitting.py`` (NumPy only).

Re-implements the reference's per-cluster pipeline
(edgegaussians/edge_extraction/fitting.py:78-175):

1. RANSAC line fit (2-point hypotheses, point-to-line residuals —
   vectorized over all trials; replaces skimage's Cython
   ``ransac(LineModelND)`` at fitting.py:94-95),
2. SVD line through the inliers, endpoints at the projection extremes
   (line_fitting — fitting.py:30-52),
3. points ordered along the line; cubic Bezier least squares (the
   reference's 12-parameter ``scipy.curve_fit`` is a *linear* model, so the
   closed-form normal equations give the same optimum — fitting.py:54-73),
4. curve residual (min distance to a 1000-sample dense curve) vs. line
   residual comparison decides curve-vs-line (fitting.py:121-146),
5. ``parametric_edges.json`` with ``curves_ctl_pts`` [Mx4x3] and
   ``lines_end_pts`` [Lx6] (fitting.py:163-175) — the byte contract the
   reference's eval consumes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# monomial -> cubic Bernstein basis (fitting.py:21-23)
BEZIER_W = np.array([[-1, 3, -3, 1],
                     [3, -6, 3, 0],
                     [-3, 3, 0, 0],
                     [1, 0, 0, 0]], dtype=np.float64)


def bezier_curve(tt: np.ndarray, ctrl: np.ndarray) -> np.ndarray:
    """Evaluate a cubic Bezier: [n] params x [4,3] control pts -> [n,3]."""
    tt = np.asarray(tt, np.float64)
    T = np.stack([tt ** 3, tt ** 2, tt, np.ones_like(tt)], axis=1)
    return T @ BEZIER_W @ np.asarray(ctrl, np.float64).reshape(4, 3)


def line_fitting(endpoints: np.ndarray) -> Tuple[np.ndarray, float]:
    """SVD line through points; returns (6-vector endpoints, s0/sum(s))
    (fitting.py:30-52)."""
    endpoints = np.asarray(endpoints, np.float64)
    center = endpoints.mean(axis=0)
    centered = endpoints - center
    _, s, vh = np.linalg.svd(centered, full_matrices=False)
    lam = s[0] / max(np.sum(s), 1e-12)
    direction = vh[0] / np.linalg.norm(vh[0])
    proj = centered @ direction
    line = np.zeros(6)
    line[:3] = center + direction * proj.min()
    line[3:] = center + direction * proj.max()
    return line, lam


def ransac_line(points: np.ndarray, residual_threshold: float,
                max_trials: int = 1000,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Vectorized 2-point RANSAC line fit; returns the best inlier mask.

    All ``max_trials`` hypotheses are evaluated at once as a
    [trials, n] residual matrix (replaces the reference's per-trial Cython
    loop in skimage — fitting.py:94-95; like skimage with
    stop_probability=1, no early exit).
    """
    rng = rng or np.random.default_rng()
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < 2:
        return np.ones(n, dtype=bool)

    i0 = rng.integers(0, n, size=max_trials)
    off = rng.integers(1, n, size=max_trials)
    i1 = (i0 + off) % n                                   # distinct pairs

    origins = pts[i0]                                     # [T,3]
    dirs = pts[i1] - pts[i0]
    norms = np.linalg.norm(dirs, axis=1, keepdims=True)
    ok = norms[:, 0] > 1e-12
    dirs = dirs / np.maximum(norms, 1e-12)

    rel = pts[None, :, :] - origins[:, None, :]           # [T,n,3]
    t = np.einsum("tnk,tk->tn", rel, dirs)
    perp = rel - t[..., None] * dirs[:, None, :]
    resid = np.linalg.norm(perp, axis=-1)                 # [T,n]

    inlier = (resid < residual_threshold) & ok[:, None]
    best = int(np.argmax(inlier.sum(axis=1)))
    mask = inlier[best]
    if mask.sum() < 2:                                    # degenerate fallback
        mask = np.ones(n, dtype=bool)
    return mask


def bezier_fit(xyz: np.ndarray, error_threshold: float = 1.0):
    """Closed-form cubic Bezier least squares over t=linspace(0,1,n)
    (equivalent optimum to the reference's curve_fit — fitting.py:54-73).

    Returns (popt [12], residuals [n,3], fitted_curve [n,3]) or None when
    the RMSE exceeds ``error_threshold``.
    """
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    if n < 4:
        return None
    t = np.linspace(0.0, 1.0, n)
    M = np.stack([t ** 3, t ** 2, t, np.ones_like(t)], axis=1) @ BEZIER_W
    ctrl, *_ = np.linalg.lstsq(M, xyz, rcond=None)        # [4,3]
    fitted = M @ ctrl
    residuals = xyz - fitted
    rmse = np.sqrt(np.mean(np.sum(residuals ** 2, axis=1)))
    if rmse > error_threshold:
        return None
    return ctrl.reshape(-1), residuals, fitted


def fit_edges(clusters: Sequence[Set[int]], pts: np.ndarray,
              dirs: np.ndarray,
              ransac_thresh: float = 0.005,
              line_curve_residual_comp_factor: float = 0.25,
              output_json: Optional[str] = None,
              rng: Optional[np.random.Generator] = None):
    """Fit a line or cubic Bezier to each cluster (fitting.py:78-175).

    Returns (edges, parametric_edges_dict). The JSON schema matches the
    reference exactly: {"curves_ctl_pts": [[4x[3]]...],
    "lines_end_pts": [[6 floats]...]}.
    """
    rng = rng or np.random.default_rng()
    edges: List[Dict] = []

    for i, cluster in enumerate(clusters):
        try:
            pts_curr = pts[sorted(cluster)]
            inliers = ransac_line(pts_curr, ransac_thresh, rng=rng)

            line_eps, _ = line_fitting(pts_curr[inliers])
            main_dir = line_eps[3:] - line_eps[:3]
            main_dir = main_dir / np.linalg.norm(main_dir)
            mean_pt = 0.5 * (line_eps[3:] + line_eps[:3])

            to_point = pts_curr - mean_pt
            lamdas = to_point @ main_dir
            # perpendicular distance to the line (the reference reaches the
            # same quantity through a double cross product — fitting.py:108-117)
            perp = to_point - lamdas[:, None] * main_dir
            mean_residual_line = np.mean(np.linalg.norm(perp, axis=1))

            order = np.argsort(lamdas)
            lamdas_sorted = lamdas[order]
            pts_sorted = pts_curr[order]

            out = bezier_fit(pts_sorted)
            is_curve = False
            if out is not None:
                popt, _, _ = out
                dense = bezier_curve(np.linspace(0, 1, 1000), popt)
                d = np.linalg.norm(
                    pts_sorted[:, None, :] - dense[None, :, :], axis=-1)
                mean_residual_curve = np.mean(d.min(axis=1))
                if mean_residual_curve < (line_curve_residual_comp_factor
                                          * mean_residual_line):
                    edges.append({"type": "curve", "popt": popt,
                                  "all_pts": pts_sorted})
                    is_curve = True
            if not is_curve:
                edges.append({"type": "line",
                              "eps": [line_eps[:3], line_eps[3:]],
                              "all_pts": pts_sorted})
        except Exception:
            print(f"Failed to fit line through cluster {i}")

    parametric = {"curves_ctl_pts": [], "lines_end_pts": []}
    for edge in edges:
        if edge["type"] == "curve":
            ctrl = np.array(edge["popt"]).reshape(4, 3)
            parametric["curves_ctl_pts"].append(
                [ctrl[j].tolist() for j in range(4)])
        else:
            parametric["lines_end_pts"].append(
                edge["eps"][0].tolist() + edge["eps"][1].tolist())

    if output_json is not None:
        with open(output_json, "w") as f:
            json.dump(parametric, f)

    return edges, parametric
