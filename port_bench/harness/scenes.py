"""The scenes a configuration trains on, and its seed points.

A configuration file names its scene under ``"scene"``:

- ``{"kind": "emap_npz", "file": ...}``: an EMAP scan packed into one
  ``.npz`` (``images`` uint8 [V,H,W] as the edge maps' PNGs hold them,
  ``camtoworld`` [V,4,4], ``intrinsics`` [V,3,3], ``seed_points`` [P,3]);
- ``{"kind": "synthetic", "seed": ..., "views": ..., ...}``: an ABC-style
  wireframe scan drawn by the generator below, a frozen copy of the
  program's ``data/synthetic.py`` (its sampling, cameras and edge-map
  splatting; the PNG round trip is kept as a cast to uint8).

Either gives a :class:`Scene`: float32 edge maps in [0, 1], world-to-camera
matrices and intrinsics, as the program's EMAP parser builds them. Seed
points follow the recipe's rule (``init_random_init``): uniform in the
recipe's box, or the scene's points padded by noisy copies to
``init_min_num_gaussians``; the draws are the benchmark's, from ``--seed``,
made on the device.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class Scene(NamedTuple):
    images: np.ndarray       # [V,H,W] float32 in [0, 1]
    viewmats: np.ndarray     # [V,4,4] float32 world -> camera
    Ks: np.ndarray           # [V,3,3] float32
    points: np.ndarray       # [P,3] the scan's own seed points (may be empty)

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]


def _views(images_u8, c2ws, Ks, points) -> Scene:
    """World-to-camera matrices as the EMAP parser inverts them (R^T,
    -R^T t, in float64, then float32)."""
    vms = []
    for c2w in c2ws:
        c2w = np.asarray(c2w, np.float64)
        vm = np.eye(4)
        vm[:3, :3] = c2w[:3, :3].T
        vm[:3, 3] = -c2w[:3, :3].T @ c2w[:3, 3]
        vms.append(vm)
    return Scene(images=(np.asarray(images_u8) / 255.0).astype(np.float32),
                 viewmats=np.stack(vms).astype(np.float32),
                 Ks=np.asarray(Ks, np.float64).astype(np.float32),
                 points=np.asarray(points, np.float64).reshape(-1, 3))


def load_scene(spec: Dict, root: str, cache_dir: str) -> Scene:
    """The scene a configuration's ``"scene"`` entry names. ``root`` is the
    checkout; a synthetic scan is cached under ``cache_dir`` by its
    parameters, so only a checkout's first run draws it."""
    kind = spec["kind"]
    if kind == "emap_npz":
        with np.load(os.path.join(root, spec["file"])) as z:
            return _views(z["images"], z["camtoworld"], z["intrinsics"],
                          z["seed_points"])
    if kind == "synthetic":
        keys = ("seed", "views", "width", "height", "lines", "curves")
        name = "synthetic_" + "_".join(f"{k}{spec[k]}" for k in keys)
        path = os.path.join(cache_dir, name + ".npz")
        if not os.path.exists(path):
            imgs, c2ws, K = synthetic_scan(**{k: spec[k] for k in keys})
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path + f".{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, images=imgs, camtoworld=np.stack(c2ws),
                                K=K)
            os.replace(tmp, path)
        with np.load(path) as z:
            V = z["images"].shape[0]
            return _views(z["images"], z["camtoworld"],
                          np.repeat(z["K"][None], V, 0), np.zeros((0, 3)))
    raise ValueError(f"unknown scene kind {kind!r}")


def seed_points(scene: Scene, model: Dict, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """[n,3] float32 seed points on ``device`` by the recipe's rule: with
    ``init_random_init``, ``init_min_num_gaussians`` points uniform in the
    cube of side ``random_init_box_size`` about ``random_init_box_center``;
    otherwise the scan's points, padded (where fewer) by
    ceil((min - P) / P) copies with N(0, 0.1^2) noise, as the recipe pads
    them; the draws come from ``gen``."""
    if model["init_random_init"]:
        n = model["init_min_num_gaussians"]
        size, centre = model["random_init_box_size"], \
            model["random_init_box_center"]
        u = torch.rand((n, 3), generator=gen, device=device)
        return (size * u - size / 2 + centre).float()
    pts = torch.as_tensor(scene.points, dtype=torch.float32, device=device)
    n, want = pts.shape[0], model["init_min_num_gaussians"]
    if n >= want:
        return pts
    rep = math.ceil((want - n) / n)
    noise = 0.1 * torch.randn((rep * n, 3), generator=gen, device=device)
    return torch.cat([pts, pts.repeat(rep, 1) + noise])


# --------------------------------------------------------------------------
# the frozen generator of ABC-style scans (the program's data/synthetic.py)


def _sample_wireframe(rng, n_lines, n_curves, margin=0.18, min_len=0.25):
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
        t1, t2 = rng.uniform(0.2, 0.4), rng.uniform(0.6, 0.8)
        bend = rng.normal(scale=0.08, size=(2, 3))
        p1 = p0 + t1 * (p3 - p0) + bend[0]
        p2 = p0 + t2 * (p3 - p0) + bend[1]
        curves.append(np.clip(np.stack([p0, p1, p2, p3]), lo, hi))
    return {"lines": np.array(lines, np.float64),
            "curves": np.array(curves, np.float64)}


def _bezier(ctl, t):
    u = 1.0 - t
    return ((u ** 3)[:, None] * ctl[0] + (3 * u ** 2 * t)[:, None] * ctl[1]
            + (3 * u * t ** 2)[:, None] * ctl[2] + (t ** 3)[:, None] * ctl[3])


def _resample(pts, spacing):
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


def _edge_points(wf, spacing):
    chunks = [_resample(ln, spacing) for ln in wf["lines"]]
    tf = np.linspace(0.0, 1.0, 512)
    chunks += [_resample(_bezier(ctl, tf), spacing) for ctl in wf["curves"]]
    return np.concatenate(chunks, axis=0)


def _look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def _cameras(rng, n_views, width, height, focal, radius=3.8,
             center=(0.5, 0.5, 0.5)):
    center = np.asarray(center, np.float64)
    K = np.array([[focal, 0, (width - 1) / 2.0],
                  [0, focal, (height - 1) / 2.0], [0, 0, 1.0]])
    c2ws = []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        frac = (i + 0.5) / n_views
        elev = np.arcsin(np.sin(np.deg2rad(60.0)) * (2 * frac - 1))
        azim = golden * i + rng.normal(scale=0.03)
        r = radius * (1.0 + rng.normal(scale=0.01))
        eye = center + r * np.array([np.cos(elev) * np.cos(azim),
                                     np.cos(elev) * np.sin(azim),
                                     np.sin(elev)])
        c2ws.append(_look_at(eye, center))
    return c2ws, K


def _edge_map(points_w, c2w, K, width, height, sigma_px=1.0):
    w2c = np.linalg.inv(c2w)
    pc = points_w @ w2c[:3, :3].T + w2c[:3, 3]
    pc = pc[pc[:, 2] > 0.05]
    u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
    v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
    img = np.zeros((height, width), np.float32)
    rad = max(1, int(np.ceil(3 * sigma_px)))
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    inb = ((ui >= -rad) & (ui < width + rad) & (vi >= -rad)
           & (vi < height + rad))
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


def synthetic_scan(seed: int, views: int, width: int, height: int,
                   lines: int, curves: int
                   ) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
    """(edge maps uint8 [V,H,W], camera-to-world matrices, K) of the
    program's ``generate_scene(seed=..., n_views=..., ...)`` with its
    defaults (focal 1111.11 at 800 px, draw spacing 0.0015, sigma 1 px,
    no detector noise)."""
    rng = np.random.default_rng(seed)
    focal = 1111.11 * min(width, height) / 800.0
    wf = _sample_wireframe(rng, lines, curves)
    draw = _edge_points(wf, 0.0015)
    c2ws, K = _cameras(rng, views, width, height, focal)
    imgs = np.stack([(_edge_map(draw, c, K, width, height) * 255)
                     .astype(np.uint8) for c in c2ws])
    return imgs, c2ws, K
