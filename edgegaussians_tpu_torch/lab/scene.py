"""The labs' synthetic scene, the counterpart of ``bench_scene()`` in
``scripts/kernel_lab.py:50-73`` (and the same scene built inline by
``scripts/cumprod_lab.py:199-223``).

N random Gaussians from ``np.random.default_rng(seed)`` in a unit cube 2
units in front of an identity camera (f = 1111), projected and binned
into the two-level frame: ``k1`` slots for every 16x16 tile, ``k2`` more
for the ``t2`` busiest tiles. The JAX labs keep level 1 only; this scene
also returns level 2, whose rows carry level 1's transmittance, so a
chunked compositor's carry between 128-slot chunks really runs (level 1
is one chunk).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from edgegaussians_tpu_torch.ops import composite, tiles
from edgegaussians_tpu_torch.ops.projection import project_gaussians

# the JAX labs' sizes (kernel_lab.py:30-35)
N, WIDTH, HEIGHT, TILE = 20000, 800, 800, 16
K1, K2, T2 = 128, 384, 625
FOCAL = 1111.0


class LabScene(NamedTuple):
    feats1: torch.Tensor    # [T,k1,8] level-1 frame, tile order
    counts1: torch.Tensor   # [T] int32, min(count, k1)
    feats2: torch.Tensor    # [t2,k2,8] level-2 frame
    counts2: torch.Tensor   # [t2] int32, clip(count - k1, 0, k2)
    rows2: torch.Tensor     # [t2] the level-1 row (tile) of each level-2 row
    basis: torch.Tensor     # [8,256] pixel basis


def bench_scene(n: int = N, width: int = WIDTH, height: int = HEIGHT,
                k1: int = K1, k2: int = K2, t2: int = T2, seed: int = 0,
                focal: float = FOCAL, device=None) -> LabScene:
    """The lab frame on ``device``; the defaults are the JAX labs'."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    means = torch.from_numpy(r.uniform(-0.5, 0.5, (n, 3)).astype(f32))
    means = means + torch.tensor([0.0, 0.0, 2.0])
    quats = torch.from_numpy(r.normal(size=(n, 4)).astype(f32))
    scales = torch.from_numpy(np.exp(r.uniform(
        np.log(0.003), np.log(0.03), (n, 3))).astype(f32))
    opac = torch.from_numpy(r.uniform(0.2, 0.95, n).astype(f32))
    K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2],
                      [0, 0, 1]], dtype=torch.float32)
    viewmat = torch.eye(4, dtype=torch.float32)
    means, quats, scales, opac, K, viewmat = (
        x.to(device) for x in (means, quats, scales, opac, K, viewmat))
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, opac, viewmat, K,
                                 width, height)
        bins2 = tiles.bin_gaussians_two_level(proj, width, height, TILE,
                                              k1, k2, t2)
        packed = tiles.pack_gaussian_render_data(proj)[bins2.order]
        origins = tiles.tile_origins(width, height, TILE, device=device)
        fr = composite.two_level_frame(packed, bins2, origins)
    return LabScene(feats1=fr.feats1, counts1=fr.counts1, feats2=fr.feats2,
                    counts2=fr.counts2, rows2=bins2.ovf_ids,
                    basis=tiles.pixel_basis(TILE, device=device))


def live_evaluations(counts: torch.Tensor, k: int) -> int:
    """Live slot-pixel evaluations of a frame: sum of min(count, k) x 256,
    the work a compositor needs (the lab's kernels evaluate every slot)."""
    return int(torch.clamp(counts, max=k).sum()) * 256
