"""Evaluation metrics: Chamfer / Accuracy / Completeness and PR/F/IoU.

The port's copy of ``edgegaussians_tpu/eval/metrics.py`` (NumPy only).

Re-implements the reference's eval core (eval_utils.py:400-563) on the
KD-tree of ``eval/neighbors.py``, including the reference's exact metric
definitions:

- chamfer = Acc + Comp where Acc = mean NN-distance pred->gt and
  Comp = mean NN-distance gt->pred (eval_utils.py:456-509),
- precision/recall at distance thresholds {0.005, 0.01, 0.02} with
  F-score and the reference's IoU variant
  (intersection = min(correct_pred, correct_gt),
  union = |pred| + |gt| - max(...) — eval_utils.py:437-449).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from edgegaussians_tpu_torch.eval.neighbors import k_nearest_neighbors

DEFAULT_THRESHOLDS = (0.005, 0.01, 0.02)


def chamfer_distance(pred: np.ndarray, gt: np.ndarray):
    """Returns (chamfer, acc, comp) — eval_utils.py:456-509."""
    d_pred_to_gt, _ = k_nearest_neighbors(pred, gt, k=1)
    d_gt_to_pred, _ = k_nearest_neighbors(gt, pred, k=1)
    acc = float(np.mean(d_pred_to_gt))
    comp = float(np.mean(d_gt_to_pred))
    return acc + comp, acc, comp


def compute_precision_recall_IOU(pred_sampled: np.ndarray,
                                 gt_points: np.ndarray,
                                 metrics: Dict[str, List[float]],
                                 thresh_list: Sequence[float]
                                 = DEFAULT_THRESHOLDS,
                                 edge_type: str = "all"):
    """Append PR/F/IoU at each threshold to ``metrics``
    (eval_utils.py:400-453)."""
    dists_a_to_b, _ = k_nearest_neighbors(pred_sampled, gt_points, k=1)
    dists_b_to_a, _ = k_nearest_neighbors(gt_points, pred_sampled, k=1)
    for thresh in thresh_list:
        correct_pred = int(np.sum(dists_a_to_b < thresh))
        precision = correct_pred / len(dists_a_to_b)
        metrics[f"precision_{thresh}"].append(precision)

        correct_gt = int(np.sum(dists_b_to_a < thresh))
        recall = correct_gt / len(dists_b_to_a)
        metrics[f"recall_{thresh}"].append(recall)

        denom = precision + recall
        fscore = 2 * precision * recall / denom if denom > 0 else 0.0
        metrics[f"fscore_{thresh}"].append(fscore)

        intersection = min(correct_pred, correct_gt)
        union = (len(dists_a_to_b) + len(dists_b_to_a)
                 - max(correct_pred, correct_gt))
        metrics[f"IOU_{thresh}"].append(intersection / union)
    return metrics


def f_score(precision: float, recall: float) -> float:
    if precision + recall == 0:        # e.g. a barely-trained checkpoint
        return 0.0
    return 2 * precision * recall / (precision + recall)


def empty_metrics(thresh_list: Sequence[float] = DEFAULT_THRESHOLDS
                  ) -> Dict[str, List[float]]:
    """The metric-accumulator dict shape of the reference CLI
    (eval.py:179-199)."""
    keys = ["chamfer", "acc", "comp", "comp_curve", "comp_line",
            "acc_curve", "acc_line"]
    for t in thresh_list:
        keys += [f"precision_{t}", f"recall_{t}", f"fscore_{t}", f"IOU_{t}"]
    return {k: [] for k in keys}


def downsample_point_cloud_average(points: np.ndarray,
                                   num_voxels_per_axis=256,
                                   min_bound=None, max_bound=None
                                   ) -> np.ndarray:
    """Voxel-average downsampling (eval_utils.py:525-563)."""
    points = np.asarray(points, np.float64)
    mn = np.min(points, axis=0) if min_bound is None else np.asarray(min_bound)
    mx = np.max(points, axis=0) if max_bound is None else np.asarray(max_bound)
    if isinstance(num_voxels_per_axis, int):
        nv = np.array([num_voxels_per_axis] * 3)
    else:
        nv = np.asarray(num_voxels_per_axis)
    voxel = (mx - mn) / nv
    voxel = np.where(voxel <= 0, 1.0, voxel)
    ijk = np.floor((points - mn) / voxel).astype(np.int64)
    ijk = np.clip(ijk, 0, nv - 1)
    keys = (ijk[:, 0] * nv[1] + ijk[:, 1]) * nv[2] + ijk[:, 2]
    order = np.argsort(keys)
    keys_sorted = keys[order]
    pts_sorted = points[order]
    boundaries = np.flatnonzero(np.diff(keys_sorted)) + 1
    groups = np.split(pts_sorted, boundaries)
    return np.stack([g.mean(axis=0) for g in groups])
