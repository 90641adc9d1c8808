"""ABC-NEF ground-truth parsing and parametric-edge sampling.

The port's copy of ``edgegaussians_tpu/eval/gt.py`` (NumPy only).

Re-implements the reference's GT pipeline (eval_utils.py:15-398):

- :func:`get_gt_points`: parse the scan's CAD .obj + chunk feats/stats JSON,
  keep sharp feature curves, normalize into the 0.5-centered unit cube, and
  sample polyline segments every ``interval`` units,
- :func:`bezier_curve_length`: composite-Simpson arc length,
- :func:`sample_parametric_edges`: sample predicted Bezier curves / line
  segments at a fixed resolution (the reference's
  get_pred_points_and_directions[_from_dict], eval_utils.py:168-398).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from edgegaussians_tpu_torch.extract.fitting import BEZIER_W


def get_gt_points(scan_name: str, edge_type: str = "all",
                  interval: float = 0.005, return_direction: bool = False,
                  data_base_dir: Optional[str] = None):
    """GT sharp-edge samples for one ABC scan (eval_utils.py:15-118).

    Returns (raw points, sampled points, directions) or (None, None, None)
    when the scan has no sharp edges.
    """
    objs_dir = os.path.join(data_base_dir, "obj")
    index_obj_names = {}
    for obj_name in sorted(os.listdir(objs_dir)):
        index_obj_names[obj_name[:8]] = obj_name

    with open(os.path.join(data_base_dir, "chunk_0000_feats.json")) as f:
        feats = json.load(f)
    with open(os.path.join(data_base_dir, "chunk_0000_stats.json")) as f:
        stats = json.load(f)

    (x_min, y_min, z_min, x_max, y_max, z_max,
     x_range, y_range, z_range) = stats[scan_name]["bbox"]
    scale = 1.0 / max(x_range, y_range, z_range)
    poi_center = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2,
                           (z_min + z_max) / 2]) * scale
    set_location = np.array([0.5, 0.5, 0.5]) - poi_center

    vertices = []
    with open(os.path.join(objs_dir, index_obj_names[scan_name]),
              encoding="utf-8") as f:
        for line in f:
            parts = line.split(" ")
            if parts[0] == "v":
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
    vertices = np.asarray(vertices)

    rename = {"BSpline": "curve", "Circle": "curve", "Ellipse": "curve",
              "Line": "line"}
    edge_pts, edge_pts_raw, edge_dirs = [], [], []
    for curve in feats[scan_name]:
        if edge_type != "all" and rename[curve["type"]] != edge_type:
            continue
        if not curve["sharp"]:
            continue
        pts = vertices[np.asarray(curve["vert_indices"], dtype=int)]
        edge_pts_raw.append(pts)
        for a, b in zip(pts[:-1], pts[1:]):
            seg = b - a
            num = int(np.linalg.norm(seg) // interval)
            lin = np.linspace(0, 1, num)
            # reference samples lin*current + (1-lin)*next (b -> a order)
            edge_pts.append(lin[:, None] * a + (1 - lin)[:, None] * b)
            if return_direction and num > 0:
                d = seg / np.linalg.norm(seg)
                edge_dirs.extend([d] * num)

    if not edge_pts_raw:
        return None, None, None

    raw = np.concatenate(edge_pts_raw) * scale + set_location
    sampled = (np.concatenate(edge_pts) * scale + set_location
               if edge_pts else np.zeros((0, 3)))
    return (raw.astype(np.float32), sampled.astype(np.float32),
            np.asarray(edge_dirs))


def bezier_curve_length(control_points: np.ndarray,
                        num_samples: int = 100) -> float:
    """Arc length of a cubic Bezier by composite Simpson on |B'(t)|
    (eval_utils.py:120-165; vectorized)."""
    ctrl = np.asarray(control_points, np.float64).reshape(4, 3)
    # B'(t) = 3[(1-t)^2 (P1-P0) + 2(1-t)t (P2-P1) + t^2 (P3-P2)]
    d0, d1, d2 = ctrl[1] - ctrl[0], ctrl[2] - ctrl[1], ctrl[3] - ctrl[2]

    def speed(t):
        t = np.asarray(t, np.float64)[..., None]
        v = 3 * ((1 - t) ** 2 * d0 + 2 * (1 - t) * t * d1 + t ** 2 * d2)
        return np.linalg.norm(v, axis=-1)

    # composite Simpson over num_samples panels per sub-interval, matching
    # the reference's nested structure (sum of per-interval Simpson rules)
    total = 0.0
    for i in range(num_samples):
        a, b = i / num_samples, (i + 1) / num_samples
        h = (b - a) / num_samples
        ts = a + h * np.arange(num_samples + 1)
        w = np.ones(num_samples + 1)
        w[1:-1:2] = 4.0
        w[2:-1:2] = 2.0
        total += float(np.sum(w * speed(ts)) * h / 3.0)
    return total


def sample_parametric_edges(parametric: Dict, sample_resolution: float = 0.005
                            ) -> Tuple[np.ndarray, np.ndarray, list, list]:
    """Sample curves/lines from a parametric_edges dict
    (eval_utils.py:285-398). Returns (curve_pts [Nc,3], line_pts [Nl,3],
    curve_dirs, line_dirs)."""
    curves = np.asarray(parametric["curves_ctl_pts"],
                        np.float64).reshape(-1, 4, 3)
    lines = np.asarray(parametric["lines_end_pts"],
                       np.float64).reshape(-1, 2, 3)

    curve_pts, curve_dirs = [], []
    for ctrl in curves:
        num = int(bezier_curve_length(ctrl, 100) // sample_resolution)
        if num <= 0:
            continue
        t = np.linspace(0, 1, num)
        T = np.stack([t ** 3, t ** 2, t, np.ones_like(t)], axis=1)
        pts = T @ BEZIER_W @ ctrl
        curve_pts.append(pts)
        dT = np.stack([3 * t ** 2, 2 * t, np.ones_like(t),
                       np.zeros_like(t)], axis=1)
        dv = dT @ BEZIER_W @ ctrl
        dv = dv / np.maximum(np.linalg.norm(dv, axis=1, keepdims=True), 1e-12)
        curve_dirs.extend(list(dv))

    line_pts, line_dirs = [], []
    for eps in lines:
        num = int(np.linalg.norm(eps[0] - eps[1]) // sample_resolution)
        if num <= 0:
            continue
        t = np.linspace(0, 1, num)
        pts = eps[0] + t[:, None] * (eps[1] - eps[0])
        line_pts.append(pts)
        d = eps[1] - eps[0]
        d = d / (np.linalg.norm(d) + 1e-6)
        line_dirs.extend([d] * num)

    cp = (np.concatenate(curve_pts) if curve_pts else np.zeros((0, 3)))
    lp = (np.concatenate(line_pts) if line_pts else np.zeros((0, 3)))
    return cp, lp, curve_dirs, line_dirs


def sample_parametric_edges_file(json_path: str,
                                 sample_resolution: float = 0.005):
    """File variant (eval_utils.py:168-283)."""
    with open(json_path) as f:
        parametric = json.load(f)
    return sample_parametric_edges(parametric, sample_resolution)
