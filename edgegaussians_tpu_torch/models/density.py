"""Adaptive density control on the fixed-capacity masked layout.

Counterpart of ``edgegaussians_tpu/models/density.py``. Culling clears the
``alive`` mask; duplication writes clones into free (dead) slots. Every op
works IN PLACE, under ``torch.no_grad()``, on a
:class:`~edgegaussians_tpu_torch.models.gaussians.GaussianModel` and, for
duplication, its :class:`~edgegaussians_tpu_torch.train.optim.OptState`
(the JAX version returns new arrays); shapes never change.
Optimizer-state semantics match the reference: survivors keep their Adam
moments, clones start from zeroed moments (edge_gs.py:431-457), dead
slots keep stale moments until a clone reuses them.

The JAX version's bug-faithful behaviours are kept (density.py:10-18):
every cull clamps all opacity logits to ``reset_opacity_value``;
``percentile_top`` duplication compares min-max normalized grads against
an unnormalized quantile; ``cull_wayward`` does nothing unless
``cull_wayward_apply`` is set.

Duplication noise is a standard-normal ``[dup_factor - 1, capacity, 3]``
draw, scaled by ``init_dup_rand_noise_scale``. The caller passes it (tests
hand in JAX's draw from the same key, density.py:276) or it is drawn from
a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from edgegaussians_tpu_torch.config import ModelConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS, GaussianModel
from edgegaussians_tpu_torch.ops.knn import knn
from edgegaussians_tpu_torch.train.optim import OptState

_BIG = 3.4e38


def masked_quantile(values: torch.Tensor, mask: torch.Tensor, q: float,
                    method: str = "linear") -> torch.Tensor:
    """Quantile over the masked subset (density.py:40-60): 'linear' as
    torch.quantile's default, 'lower' as interpolation='lower'."""
    n = values.shape[0]
    vals = torch.where(mask, values.to(torch.float32),
                       torch.full_like(values, _BIG, dtype=torch.float32))
    s = torch.sort(vals).values
    cnt = mask.sum()
    pos = q * (cnt.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    if method == "lower":
        return s[lo]
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = pos - lo.to(torch.float32)
    v_lo = s[lo]
    v_hi = torch.where(hi < cnt, s[hi], v_lo)
    return v_lo + frac * (v_hi - v_lo)


def _masked_min_max(values, mask):
    v = values.to(torch.float32)
    vmin = torch.where(mask, v, torch.full_like(v, _BIG)).min()
    vmax = torch.where(mask, v, torch.full_like(v, -_BIG)).max()
    return vmin, vmax


@torch.no_grad()
def zero_moment_rows(opt: OptState, slot_mask: torch.Tensor) -> None:
    """Zero mu/nu rows at the given slots (clone init, edge_gs.py:435-448),
    as the JAX version's multiply by the keep mask."""
    keep = (~slot_mask).to(torch.float32)
    for mu, nu in opt.moments.values():
        kf = keep.reshape((-1,) + (1,) * (mu.dim() - 1))
        mu.mul_(kf)
        nu.mul_(kf)


@torch.no_grad()
def reset_opacities(model: GaussianModel, reset_value: float) -> None:
    """Clamp opacity logits to reset_value, in logit space as the
    reference does (edge_gs.py:425-429)."""
    model.opacities.clamp_(max=reset_value)


@torch.no_grad()
def cull(model: GaussianModel, cull_mask: torch.Tensor,
         config: ModelConfig, reset_rest: bool = True) -> None:
    """Clear ``alive`` on the masked slots (edge_gs.py:412-423) and, by
    default, clamp every opacity. Moments of dead slots stay stale."""
    cull_mask = cull_mask & model.alive
    if reset_rest:
        reset_opacities(model, config.reset_opacity_value)
    model.alive &= ~cull_mask


def cull_low_opacity(model: GaussianModel, config: ModelConfig) -> None:
    """edge_gs.py:477-488."""
    opac = torch.sigmoid(model.opacities[:, 0].detach())
    if config.cull_opacity_type == "percentile":
        thresh = masked_quantile(opac, model.alive, config.cull_opacity_value)
    else:
        thresh = config.cull_opacity_value
    cull(model, opac < thresh, config)


@torch.no_grad()
def cull_not_projecting(model: GaussianModel, config: ModelConfig,
                        viewmats: torch.Tensor,
                        Ks: torch.Tensor, edge_masks: torch.Tensor) -> None:
    """Cull Gaussians whose means hit edge pixels in too few views
    (edge_gs.py:578-601); out-of-image projections count as misses.
    ``viewmats [V,4,4]``, ``Ks [V,3,3]``, ``edge_masks [V,H,W]`` bool."""
    v, h, w = edge_masks.shape
    means_h = torch.cat([model.means, torch.ones_like(model.means[:, :1])],
                        dim=1)                                     # [N,4]
    P = torch.einsum("vij,vjk->vik", Ks, viewmats[:, :3, :4])      # [V,3,4]
    px = means_h @ P[:, 0, :].T                                    # [N,V]
    py = means_h @ P[:, 1, :].T
    pw = means_h @ P[:, 2, :].T
    # round half to even, as jnp.rint and the reference's .round()
    xr = torch.round(px / pw).to(torch.int64)
    yr = torch.round(py / pw).to(torch.int64)
    good = (xr >= 0) & (xr < w) & (yr >= 0) & (yr < h)
    flat = torch.clamp(yr, 0, h - 1) * w + torch.clamp(xr, 0, w - 1)
    on_edge = torch.gather(edge_masks.reshape(v, -1), 1, flat.T) & good.T
    visib = on_edge.to(torch.float32).sum(dim=0) / v               # [N]
    cull(model, visib < config.cull_gaussians_not_projecting_threshold,
         config)


@torch.no_grad()
def wayward_mask(model: GaussianModel, config: ModelConfig) -> torch.Tensor:
    """Outlier mask from the kNN of the live means (density.py:165-189):
    ``pca_ratio`` keeps rows whose neighbour directions' smallest/middle
    singular value ratio is at most its ``cull_wayward_threshold_value``
    quantile; ``mean_distance`` / ``max_distance`` flag rows above the
    ``percentile_top`` quantile or the absolute threshold."""
    k = config.cull_wayward_num_neighbors
    means = model.means.detach()
    dists, idx = knn(means, k, mask=model.alive)
    if config.cull_wayward_method == "pca_ratio":
        d = means[:, None, :] - means[idx]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                            min=1e-12)
        d = d - d.mean(dim=1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", d, d) / k
        s = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(cov), min=0.0))
        cns = s[:, 0] / torch.clamp(s[:, 1], min=1e-12)
        thresh = masked_quantile(cns, model.alive,
                                 config.cull_wayward_threshold_value)
        return cns <= thresh
    if config.cull_wayward_method == "max_distance":
        d = dists.amax(dim=-1)
    else:                                             # mean_distance
        d = dists.mean(dim=-1)
    if config.cull_wayward_threshold_type == "percentile_top":
        thresh = masked_quantile(d, model.alive,
                                 1.0 - config.cull_wayward_threshold_value,
                                 method="lower")
        return d > thresh
    return d > config.cull_wayward_threshold_value


def cull_wayward(model: GaussianModel, config: ModelConfig) -> None:
    """The reference computes the wayward mask but never culls (SURVEY
    §6.5.1): a no-op unless ``cull_wayward_apply`` is set."""
    if config.cull_wayward_apply:
        cull(model, wayward_mask(model, config), config)


@torch.no_grad()
def duplicate_high_pos_gradients(model: GaussianModel, opt: OptState,
                                 config: ModelConfig,
                                 noise: Optional[torch.Tensor] = None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> None:
    """Absgrad-driven densification (edge_gs.py:544-576): grads =
    absgrads / absgrad_count, min-max normalized over alive slots,
    thresholded per ``dup_threshold_type``; each selected Gaussian gets
    ``dup_factor - 1`` noisy clones. Resets absgrads afterwards."""
    grads = model.absgrads / model.absgrad_count
    gmin, gmax = _masked_min_max(grads, model.alive)
    grads_n = (grads - gmin) / torch.clamp(gmax - gmin, min=1e-12)
    if config.dup_threshold_type == "percentile_top":
        # bug-faithful: unnormalized quantile vs normalized grads
        num_q = int(round(1.0 / config.dup_threshold_value))
        thresh = masked_quantile(grads, model.alive, (num_q - 1) / num_q,
                                 method="lower")
        dup_mask = (grads_n > thresh) & model.alive
    elif config.dup_threshold_type == "top_fraction":
        thresh = masked_quantile(grads, model.alive,
                                 1.0 - config.dup_threshold_value,
                                 method="lower")
        dup_mask = (grads > thresh) & model.alive
    else:
        dup_mask = (grads_n > config.dup_threshold_value) & model.alive
    _duplicate(model, opt, dup_mask, config.dup_factor,
               config.init_dup_rand_noise_scale, noise, generator)
    model.absgrads.zero_()
    model.absgrad_count.fill_(1.0)


def duplicate_all(model: GaussianModel, opt: OptState, config: ModelConfig,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> None:
    """edge_gs.py:491-496."""
    _duplicate(model, opt, model.alive.clone(), config.dup_factor,
               config.init_dup_rand_noise_scale, noise, generator)


@torch.no_grad()
def _duplicate(model: GaussianModel, opt: OptState, dup_mask: torch.Tensor,
               dup_factor: int, noise_scale: float,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> None:
    """Write ``dup_factor - 1`` noisy clones of each masked Gaussian into
    free slots, lowest free slot first, copy r of the i-th selected
    Gaussian at free rank r * n_sel + i (edge_gs.py:460-474). Clones
    beyond capacity are dropped."""
    cap = model.capacity
    n_copies = dup_factor - 1
    if n_copies <= 0:
        return
    dev = model.means.device
    if noise is None:
        noise = torch.randn((n_copies, cap, 3), generator=generator)
    if tuple(noise.shape) != (n_copies, cap, 3):
        raise ValueError(f"noise: expected shape {(n_copies, cap, 3)}, "
                         f"got {tuple(noise.shape)}")
    noise_all = noise_scale * noise.to(device=dev, dtype=torch.float32)
    free_order = torch.sort(model.alive.to(torch.int32),
                            stable=True).indices               # dead first
    n_free = cap - model.alive.sum()
    sel_rank = torch.cumsum(dup_mask.to(torch.int64), 0) - 1
    n_sel = dup_mask.sum()
    src = {g: getattr(model, g).detach().clone() for g in GROUPS}
    written = torch.zeros(cap, dtype=torch.bool, device=dev)
    for r in range(n_copies):
        free_rank = r * n_sel + sel_rank
        ok = dup_mask & (free_rank < n_free)
        target = free_order[torch.clamp(free_rank, 0, cap - 1)][ok]
        model.means[target] = (src["means"] + noise_all[r])[ok]
        for g in ("scales", "quats", "opacities"):
            getattr(model, g)[target] = src[g][ok]
        model.alive[target] = True
        written[target] = True
    zero_moment_rows(opt, written)
    model.absgrads.masked_fill_(written, 0.0)
