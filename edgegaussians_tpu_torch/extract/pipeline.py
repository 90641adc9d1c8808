"""Edge-extraction pipeline driver: filter -> cluster -> fit -> sample.

The port's copy of ``edgegaussians_tpu/extract/pipeline.py`` (NumPy only).

The library core of the fit_edges CLI (reference: fit_edges.py:47-141),
separated from argument parsing so tests and notebooks can call it directly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.eval.gt import sample_parametric_edges
from edgegaussians_tpu_torch.extract import clustering, filtering, fitting
from edgegaussians_tpu_torch.io import ply as ply_io


def major_directions_np(scales: np.ndarray, quats: np.ndarray) -> np.ndarray:
    """NumPy major-axis directions (misc_utils.py:96-130): the rotation
    column at the argmax scale, quats wxyz, normalized."""
    q = np.asarray(quats, np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    amax = np.argmax(scales, axis=1)
    return R[np.arange(len(q)), :, amax]


@dataclass
class ExtractionResult:
    positions: np.ndarray
    scales: np.ndarray
    quats: np.ndarray
    opacities: np.ndarray
    major_dirs: np.ndarray
    clusters: list
    edges: list
    parametric: dict
    sampled_points: Optional[np.ndarray] = None


def extract_edges(input_ply: str, cfg: FrameworkConfig,
                  scene=None, output_dir: Optional[str] = None,
                  save_filtered: bool = False,
                  save_sampled_points: bool = False,
                  sample_resolution: Optional[float] = None,
                  seed: Optional[int] = None) -> ExtractionResult:
    """Full extraction for one trained scene (fit_edges.py:47-141)."""
    rng = np.random.default_rng(seed)
    sample_resolution = (sample_resolution
                         or cfg.parametric_fitting.sample_resolution)

    pos, scales, quats, opac = ply_io.read_gaussian_params_from_ply(input_ply)
    pos, scales, quats, opac = filtering.filter_points(
        pos, scales, quats, opac, cfg.filtering, scene=scene)

    major_dirs = major_directions_np(scales, quats)

    if save_filtered and output_dir:
        os.makedirs(output_dir, exist_ok=True)
        ply_io.write_gaussian_params_as_ply(
            pos, scales, quats, opac,
            os.path.join(output_dir, "gaussians_filtered.ply"))
        ply_io.write_pts_with_major_dirs_as_ply(
            pos, major_dirs,
            os.path.join(output_dir, "pts_with_major_dirs.ply"))

    fcfg = cfg.parametric_fitting
    clusters, points, dirs = clustering.cluster_points_using_directions_greedy(
        pos, major_dirs, angle_thresh=fcfg.angle_thresh,
        min_cluster_size=fcfg.min_cluster_size, rng=rng)

    output_json = (os.path.join(output_dir, "parametric_edges.json")
                   if output_dir else None)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    edges, parametric = fitting.fit_edges(
        clusters, pos, major_dirs,
        ransac_thresh=fcfg.line_ransac_thresh,
        line_curve_residual_comp_factor=fcfg.line_curve_residual_comp_factor,
        output_json=output_json, rng=rng)

    sampled = None
    if save_sampled_points:
        cp, lp, _, _ = sample_parametric_edges(parametric, sample_resolution)
        sampled = np.concatenate([cp, lp], axis=0)
        if output_dir:
            ply_io.write_point_cloud(
                os.path.join(output_dir,
                             f"edge_sampled_points_{sample_resolution}.ply"),
                sampled)

    return ExtractionResult(
        positions=pos, scales=scales, quats=quats, opacities=opac,
        major_dirs=major_dirs, clusters=clusters, edges=edges,
        parametric=parametric, sampled_points=sampled)
