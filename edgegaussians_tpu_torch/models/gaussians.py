"""Gaussian model state (fixed-capacity, masked) as an ``nn.Module``.

Counterpart of ``edgegaussians_tpu/models/gaussians.py``. Parameters live
in fixed-capacity ``[N_max, ...]`` tensors with an ``alive`` mask, so
states compare row by row with the JAX package's, and shapes stay fixed
as density control fills free slots. Parameterization matches the
reference: log scales, logit opacities, wxyz quats (edge_gs.py:78-103).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from edgegaussians_tpu_torch.config import ModelConfig, resolve_capacity
from edgegaussians_tpu_torch.data.seed_points import random_quats
from edgegaussians_tpu_torch.io import ply as ply_io
from edgegaussians_tpu_torch.ops.rasterize import RenderResult, rasterize

GROUPS = ("means", "scales", "quats", "opacities")
_WIDTHS = {"means": 3, "scales": 3, "quats": 4, "opacities": 1}


class GaussianModel(nn.Module):
    """The four optimized parameter groups (edge_gs.py:96-103) plus the
    bookkeeping density control mutates: ``alive`` [N] bool, ``absgrads``
    [N] accumulated |d means2d| and ``absgrad_count`` (edge_gs.py:613)."""

    def __init__(self, capacity: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        for g in GROUPS:
            setattr(self, g, nn.Parameter(
                torch.zeros((capacity, _WIDTHS[g]), **f32)))
        self.register_buffer(
            "alive", torch.zeros(capacity, dtype=torch.bool, device=device))
        self.register_buffer("absgrads", torch.zeros(capacity, **f32))
        self.register_buffer("absgrad_count", torch.ones((), **f32))

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def params(self) -> dict:
        return {g: getattr(self, g) for g in GROUPS}

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def init_state(seed_points: np.ndarray, config: ModelConfig, seed: int = 0,
               capacity: Optional[int] = None, device=None) -> GaussianModel:
    """Populate the model from seed points (edge_gs.py:67-104), with the
    same NumPy draws as the JAX package's ``init_state``, so both start
    from identical states. Scales start at log(init_scales_val),
    opacities at logit(init_opacity_val), quats uniform-random on SO(3)."""
    n = seed_points.shape[0]
    cap = capacity or resolve_capacity(config, n)
    if n > cap:
        raise ValueError(f"{n} seed points exceed capacity {cap}")
    rng = np.random.default_rng(seed)
    means = np.zeros((cap, 3), dtype=np.float32)
    means[:n] = seed_points
    scales = np.full((cap, 3), math.log(config.init_scales_val),
                     dtype=np.float32)
    opacities = np.full(
        (cap, 1), math.log(config.init_opacity_val /
                           (1.0 - config.init_opacity_val)),
        dtype=np.float32)
    alive = np.zeros((cap,), dtype=bool)
    alive[:n] = True
    model = GaussianModel(cap, device=device)
    arrays = {"means": means, "scales": scales,
              "quats": random_quats(cap, rng), "opacities": opacities}
    with torch.no_grad():
        for g, a in arrays.items():
            getattr(model, g).copy_(torch.from_numpy(a))
        model.alive.copy_(torch.from_numpy(alive))
    return model


def linear_scales(model: GaussianModel) -> torch.Tensor:
    return torch.exp(model.scales)


def linear_opacities(model: GaussianModel) -> torch.Tensor:
    return torch.sigmoid(model.opacities[:, 0])


def render_view(model: GaussianModel, viewmat: torch.Tensor,
                K: torch.Tensor, width: int, height: int, *,
                absgrad_sink: Optional[torch.Tensor] = None,
                **render_kwargs) -> RenderResult:
    """Render one camera (edge_gs.py:197-286), applying the exp/sigmoid
    reparameterizations at the rasterizer boundary (edge_gs.py:253-254).
    ``render_kwargs`` are :func:`~edgegaussians_tpu_torch.ops.rasterize.
    rasterize`'s tile settings; ``band_row0`` with ``band_tile_rows``
    renders one band of tile rows (gaussians.py:103-121 of the JAX
    package; band mode in ``ops/rasterize.py``)."""
    return rasterize(
        model.means, model.quats, linear_scales(model),
        linear_opacities(model), viewmat, K, width, height,
        alive=model.alive, absgrad_sink=absgrad_sink, **render_kwargs)


def export_as_ply(model: GaussianModel, ply_path: str) -> int:
    """Write live Gaussians in the reference PLY contract
    (edge_gs.py:635-642): linear scales/opacities, alive rows only.
    Returns the count."""
    with torch.no_grad():
        alive = model.alive.cpu().numpy()
        means = model.means.cpu().numpy()[alive]
        scales = np.exp(model.scales.cpu().numpy())[alive]
        quats = model.quats.cpu().numpy()[alive]
        opac = 1.0 / (1.0 + np.exp(-model.opacities.cpu().numpy()))
    ply_io.write_gaussian_params_as_ply(means, scales, quats, opac[alive],
                                        ply_path)
    return int(alive.sum())


def load_from_ply(ply_path: str, config: ModelConfig,
                  capacity: Optional[int] = None,
                  device=None) -> GaussianModel:
    """Rebuild a model from an exported PLY (inverse of export_as_ply)."""
    pos, scales_lin, quats, opac_lin = ply_io.read_gaussian_params_from_ply(
        ply_path)
    n = pos.shape[0]
    cap = capacity or resolve_capacity(config, n)
    model = init_state(pos, config, capacity=cap, device=device)
    eps = 1e-7
    opac = np.clip(opac_lin, eps, 1 - eps)
    rows = {"scales": np.log(np.maximum(scales_lin, eps)),
            "quats": quats, "opacities": np.log(opac / (1 - opac))}
    with torch.no_grad():
        for g, a in rows.items():
            getattr(model, g)[:n] = torch.from_numpy(
                np.asarray(a, np.float32).reshape(n, -1))
    return model
