"""Synthetic ABC-style scene generator.

The port's own copy of ``edgegaussians_tpu/data/synthetic.py`` (NumPy only): the
port imports nothing of the JAX package, so the two stay in step by
tests/test_torch_common.py's parity tests, not by import.

The reference evaluates against ABC-NEF scans (50 posed views + detector
edge maps + CAD ground-truth edge samples — see eval.py:56-127 and the
bundled ``data/ABC-NEF_Edge`` layout), but ships only ONE scan (00004926).
This module fabricates additional scans with the exact same on-disk layout
so multi-scene robustness/spread can be measured without the full dataset:

- a random parametric wireframe (3D line segments + cubic Bézier curves)
  inside the unit box centered at (0.5, 0.5, 0.5) — the same normalized
  frame the reference's GT loader produces (eval_utils.py:15-118),
- cameras on a sphere looking at the box center (OPENCV model, EMAP
  ``meta_data.json`` schema consumed by the EMAP parser —
  dataparsers.py:96-127),
- soft edge maps rendered by splatting projected edge samples with a
  Gaussian point-spread (a stand-in for DexiNed/PidiNet detector output),
- GT edge samples at the reference's 5 mm resolution written to
  ``groundtruth/sampled_pts/<scan>_<res>.ply`` (the cache path eval.py:56
  reads), plus a ``wireframe.json`` with the exact parametric GT.

Everything is NumPy/CPU — dataset generation is not a hot path.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from edgegaussians_tpu_torch.io.ply import write_point_cloud


# ---------------------------------------------------------------------------
# wireframe sampling


def sample_wireframe(rng: np.random.Generator, n_lines: int = 8,
                     n_curves: int = 4, margin: float = 0.18,
                     min_len: float = 0.25) -> Dict[str, np.ndarray]:
    """Random lines [L,2,3] + cubic Bézier control points [C,4,3].

    All geometry stays inside the unit box with a ``margin`` border so every
    camera sees it fully; segments shorter than ``min_len`` are resampled.
    """
    lo, hi = margin, 1.0 - margin

    def rand_pts(n):
        return rng.uniform(lo, hi, size=(n, 3))

    lines = []
    while len(lines) < n_lines:
        a, b = rand_pts(1)[0], rand_pts(1)[0]
        if np.linalg.norm(b - a) >= min_len:
            lines.append(np.stack([a, b]))
    curves = []
    while len(curves) < n_curves:
        p0, p3 = rand_pts(1)[0], rand_pts(1)[0]
        if np.linalg.norm(p3 - p0) < min_len:
            continue
        # interior control points near the chord => gentle, detectable curves
        t1, t2 = rng.uniform(0.2, 0.4), rng.uniform(0.6, 0.8)
        bend = rng.normal(scale=0.08, size=(2, 3))
        p1 = p0 + t1 * (p3 - p0) + bend[0]
        p2 = p0 + t2 * (p3 - p0) + bend[1]
        ctl = np.clip(np.stack([p0, p1, p2, p3]), lo, hi)
        curves.append(ctl)
    return {"lines": np.array(lines, np.float64),
            "curves": np.array(curves, np.float64)}


def _bezier_points(ctl: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Cubic Bézier [4,3] at parameters t [M] -> [M,3]."""
    u = 1.0 - t
    return (u ** 3)[:, None] * ctl[0] + \
        (3 * u ** 2 * t)[:, None] * ctl[1] + \
        (3 * u * t ** 2)[:, None] * ctl[2] + \
        (t ** 3)[:, None] * ctl[3]


def _resample_polyline(pts: np.ndarray, spacing: float) -> np.ndarray:
    """Arc-length resample of a polyline [M,3] at ``spacing``."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])
    if total < spacing:
        return pts[:1]
    n = max(2, int(np.floor(total / spacing)) + 1)
    si = np.linspace(0.0, total, n)
    out = np.empty((n, 3))
    for d in range(3):
        out[:, d] = np.interp(si, s, pts[:, d])
    return out


def sample_edge_points(wireframe: Dict[str, np.ndarray],
                       spacing: float = 0.005) -> np.ndarray:
    """Arc-length-uniform samples of every edge (the GT cloud the eval
    pipeline compares against — reference eval.py:24 uses 0.005)."""
    chunks = []
    for ln in wireframe["lines"]:
        chunks.append(_resample_polyline(ln, spacing))
    tf = np.linspace(0.0, 1.0, 512)
    for ctl in wireframe["curves"]:
        chunks.append(_resample_polyline(_bezier_points(ctl, tf), spacing))
    return np.concatenate(chunks, axis=0)


# ---------------------------------------------------------------------------
# cameras


def look_at_c2w(eye: np.ndarray, target: np.ndarray,
                up: np.ndarray = np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """OpenCV-convention camera-to-world (x right, y down, z forward)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:            # looking along `up`
        x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def make_cameras(rng: np.random.Generator, n_views: int = 50,
                 width: int = 800, height: int = 800,
                 focal: float = 1111.11,
                 radius: float = 3.8,
                 center: Tuple[float, float, float] = (0.5, 0.5, 0.5)
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Cameras on a jittered spherical spiral around ``center`` (matches the
    bundled scan's geometry: radius ~3.8, f ~1111, 800x800)."""
    center = np.asarray(center, np.float64)
    K = np.array([[focal, 0, (width - 1) / 2.0],
                  [0, focal, (height - 1) / 2.0],
                  [0, 0, 1.0]])
    c2ws = []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        # spiral over elevation in [-60, 60] degrees with azimuth jitter
        frac = (i + 0.5) / n_views
        elev = np.arcsin(np.sin(np.deg2rad(60.0)) * (2 * frac - 1))
        azim = golden * i + rng.normal(scale=0.03)
        r = radius * (1.0 + rng.normal(scale=0.01))
        eye = center + r * np.array([np.cos(elev) * np.cos(azim),
                                     np.cos(elev) * np.sin(azim),
                                     np.sin(elev)])
        c2ws.append(look_at_c2w(eye, center))
    return c2ws, K


# ---------------------------------------------------------------------------
# edge-map rendering


def add_detector_noise(img: np.ndarray, rng: np.random.Generator,
                       dropout: float = 0.0, n_spurious: int = 0,
                       intensity_jitter: float = 0.0,
                       sigma_px: float = 1.0) -> np.ndarray:
    """Degrade a clean edge map the way real detectors do.

    - ``dropout``: fraction of the edge response zeroed in random square
      patches (detectors miss low-contrast segments per-view),
    - ``n_spurious``: random Gaussian blobs added as false edges (texture /
      shading responses),
    - ``intensity_jitter``: multiplicative response noise.
    """
    h, w = img.shape
    out = img.copy()
    if dropout > 0:
        # zero random patches until ~dropout of edge mass is gone
        target = dropout * out.sum()
        removed, tries = 0.0, 0
        while removed < target and tries < 200:
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(8, 25))
            y0, y1 = max(cy - r, 0), min(cy + r, h)
            x0, x1 = max(cx - r, 0), min(cx + r, w)
            removed += out[y0:y1, x0:x1].sum()
            out[y0:y1, x0:x1] = 0.0
            tries += 1
    if n_spurious > 0:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for _ in range(n_spurious):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            s = rng.uniform(sigma_px, 3 * sigma_px)
            amp = rng.uniform(0.4, 1.0)
            blob = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                / (2 * s * s))
            out = np.maximum(out, blob.astype(np.float32))
    if intensity_jitter > 0:
        out = out * (1.0 + intensity_jitter *
                     rng.normal(size=out.shape).astype(np.float32))
    return np.clip(out, 0.0, 1.0)


def render_edge_map(points_w: np.ndarray, c2w: np.ndarray, K: np.ndarray,
                    width: int, height: int,
                    sigma_px: float = 1.0) -> np.ndarray:
    """Soft edge map [H,W] in [0,1]: max-composited Gaussian point spread
    around each projected edge sample (detector-like ~3 px band)."""
    w2c = np.linalg.inv(c2w)
    pc = points_w @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2]
    vis = z > 0.05
    pc = pc[vis]
    u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
    v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    img = np.zeros((height, width), np.float32)
    rad = max(1, int(np.ceil(3 * sigma_px)))
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    inb = (ui >= -rad) & (ui < width + rad) & (vi >= -rad) & (vi < height + rad)
    u, v, ui, vi = u[inb], v[inb], ui[inb], vi[inb]
    inv2s2 = 1.0 / (2.0 * sigma_px * sigma_px)
    for dy in range(-rad, rad + 1):
        yy = vi + dy
        oky = (yy >= 0) & (yy < height)
        for dx in range(-rad, rad + 1):
            xx = ui + dx
            ok = oky & (xx >= 0) & (xx < width)
            d2 = (xx[ok] - u[ok]) ** 2 + (yy[ok] - v[ok]) ** 2
            np.maximum.at(img, (yy[ok], xx[ok]),
                          np.exp(-d2 * inv2s2).astype(np.float32))
    return img


# ---------------------------------------------------------------------------
# scene assembly


def generate_scene(base_dir: str, scan_name: str, seed: int = 0,
                   n_views: int = 50, width: int = 800, height: int = 800,
                   focal: Optional[float] = None, n_lines: int = 8,
                   n_curves: int = 4, gt_resolution: float = 0.005,
                   edge_detector: str = "DexiNed",
                   draw_spacing: float = 0.0015,
                   sigma_px: float = 1.0,
                   noise_dropout: float = 0.0,
                   noise_spurious: int = 0,
                   noise_intensity_jitter: float = 0.0) -> Dict[str, str]:
    """Write a full synthetic scan under ``base_dir`` with the ABC-NEF
    layout the parsers/eval expect:

    - ``<base_dir>/data/<scan>/meta_data.json`` + ``edge_<detector>/*.png``
    - ``<base_dir>/groundtruth/sampled_pts/<scan>_<res>.ply``
    - ``<base_dir>/data/<scan>/wireframe.json`` (exact parametric GT)

    Returns the paths written.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    if focal is None:
        focal = 1111.11 * min(width, height) / 800.0

    wf = sample_wireframe(rng, n_lines=n_lines, n_curves=n_curves)
    gt_pts = sample_edge_points(wf, spacing=gt_resolution)
    draw_pts = sample_edge_points(wf, spacing=draw_spacing)
    c2ws, K = make_cameras(rng, n_views=n_views, width=width, height=height,
                           focal=focal)

    scene_dir = os.path.join(base_dir, "data", scan_name)
    edge_dir = os.path.join(scene_dir, f"edge_{edge_detector}")
    gt_dir = os.path.join(base_dir, "groundtruth", "sampled_pts")
    os.makedirs(edge_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    frames = []
    for i, c2w in enumerate(c2ws):
        img = render_edge_map(draw_pts, c2w, K, width, height,
                              sigma_px=sigma_px)
        if noise_dropout or noise_spurious or noise_intensity_jitter:
            img = add_detector_noise(
                img, rng, dropout=noise_dropout, n_spurious=noise_spurious,
                intensity_jitter=noise_intensity_jitter, sigma_px=sigma_px)
        name = f"{i}_colors.png"
        Image.fromarray((img * 255).astype(np.uint8), mode="L") \
            .save(os.path.join(edge_dir, name))
        frames.append({"rgb_path": name,
                       "camtoworld": c2w.tolist(),
                       "intrinsics": K.tolist()})

    meta_path = os.path.join(scene_dir, "meta_data.json")
    with open(meta_path, "w") as f:
        json.dump({"camera_model": "OPENCV", "height": height,
                   "width": width, "frames": frames}, f)

    gt_ply = os.path.join(gt_dir, f"{scan_name}_{gt_resolution}.ply")
    write_point_cloud(gt_ply, gt_pts.astype(np.float32))

    wf_path = os.path.join(scene_dir, "wireframe.json")
    with open(wf_path, "w") as f:
        json.dump({"lines": wf["lines"].tolist(),
                   "curves": wf["curves"].tolist(),
                   "seed": seed}, f)

    return {"scene_dir": scene_dir, "meta_data": meta_path,
            "edge_dir": edge_dir, "gt_ply": gt_ply, "wireframe": wf_path}
