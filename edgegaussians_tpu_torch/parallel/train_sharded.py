"""Per-view training with every render split into tile-row bands.

Counterpart of ``edgegaussians_tpu/parallel/train_sharded.py``. The
reference's loop is per-view SGD (train_gaussians.py:57-131): each render
updates the parameters before the next one, so views cannot run side by
side without changing the trajectory. The axis that scales while keeping
it is the tile axis: every rank of the 'tiles' axis renders one band of
tile rows of the same view, computes its band-partial loss
(``parallel/bands.py``) and gradients, and one all-reduce (SUM) of the
loss, the four gradient groups and the [N,2] absgrad sink gives every
rank the full render's values, before the trainer takes the sink's norm:
absgrad stays the norm of the sum over ALL tiles (edge_gs.py:607-613).

:func:`make_sharded_proj_grad_fn` has the trainer's proj-grad contract
(``train/trainer.py:make_proj_grad_fn``), so ``run_epoch`` runs it as it
is; everything around the projection gradient (Adam, the strategy
alternation, the orientation losses, density control) runs replicated on
every rank, each from its identically seeded generator.

Each band keeps the full pair budget (busy tiles may cluster in one band)
and ``overflow_tiles = min(ovf_full, rows_per * ntx)``; the watermarks
come back as the busiest band's ``max_tile`` and ``num_pairs`` (MAX) and
the bands' ``n_overflow`` and ``num_truncated`` (SUM).
"""

from __future__ import annotations

import torch

from edgegaussians_tpu_torch import resolve_compositor
from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS, render_view
from edgegaussians_tpu_torch.ops.tiles import tile_grid
from edgegaussians_tpu_torch.parallel import bands
from edgegaussians_tpu_torch.parallel.distributed import all_reduce
from edgegaussians_tpu_torch.train.trainer import ProjGradStats


def band_render_kwargs(cfg: FrameworkConfig, width: int, height: int,
                       n_bands: int) -> dict:
    """The render settings of one band of ``n_bands``: the config's, with
    the level-2 tile budget cut to the band's tiles (JAX :73-82)."""
    mcfg = cfg.model
    ntx, _, num_tiles = tile_grid(width, height, mcfg.tile_size)
    rows_per = bands.band_geometry(width, height, mcfg.tile_size,
                                   n_bands)[0]
    ovf_full = mcfg.tile_overflow_tiles or max(num_tiles // 4, 8)
    return dict(
        tile_size=mcfg.tile_size, capacity=mcfg.tile_gaussian_capacity,
        dense_capacity=mcfg.tile_dense_capacity,
        overflow_tiles=min(ovf_full, rows_per * ntx),
        pair_budget=mcfg.tile_pair_budget,
        occupancy_sort=mcfg.tile_occupancy_sort,
        pair_kernel=mcfg.tile_pair_kernel,
        backend=resolve_compositor(mcfg.rasterizer_backend),
        max_tiles_per_gaussian=mcfg.max_tiles_per_gaussian)


def reduce_stats(out, dense_capacity: int, mesh, axes) -> ProjGradStats:
    """One band's render diagnostics reduced over ``axes``: MAX of
    ``max_tile`` and ``num_pairs``, SUM of ``n_overflow`` and
    ``num_truncated``."""
    peak = torch.stack([out.tile_counts.max(), out.num_pairs]).to(
        torch.int64)
    tot = torch.stack([(out.tile_counts > dense_capacity).sum(),
                       out.num_truncated]).to(torch.int64)
    all_reduce(peak, mesh, axes, "max")
    all_reduce(tot, mesh, axes, "sum")
    return ProjGradStats(max_tile=peak[0], n_overflow=tot[0],
                         num_truncated=tot[1], num_pairs=peak[1])


def flat_grads(grads, loss, gsink=None) -> torch.Tensor:
    """The four groups' gradients, the sink gradient (when given) and the
    loss in one flat buffer, so one collective reduces them all."""
    parts = [grads[g].reshape(-1) for g in GROUPS]
    if gsink is not None:
        parts.append(gsink.reshape(-1))
    return torch.cat(parts + [loss.reshape(1)])


def unflat_grads(buf: torch.Tensor, like, with_sink: bool = True):
    """Inverse of :func:`flat_grads`: (grads by group, sink or None,
    loss)."""
    out, i = {}, 0
    for g in GROUPS:
        n = like[g].numel()
        out[g] = buf[i:i + n].reshape(like[g].shape)
        i += n
    sink = None
    if with_sink:
        n = like["means"].shape[0] * 2
        sink = buf[i:i + n].reshape(-1, 2)
        i += n
    return out, sink, buf[i]


def band_loss_and_grads(model, viewmat, K, gt, edge_mask, strategy_idx: int,
                        bg_ratio: float, bg_scores, *, cfg: FrameworkConfig,
                        width: int, height: int, n_bands: int, band: int,
                        render_kwargs: dict):
    """Band ``band`` of ``n_bands`` of one view: its band-partial loss and
    that loss's gradients, not reduced. Returns (loss, render result,
    gradients by group, [N,2] sink gradient)."""
    mcfg = cfg.model
    rows_per, band_h, pad_h = bands.band_geometry(width, height,
                                                  mcfg.tile_size, n_bands)
    row0 = band * rows_per
    y0 = row0 * mcfg.tile_size
    sink = torch.zeros((model.capacity, 2), dtype=torch.float32,
                       device=model.means.device, requires_grad=True)
    out = render_view(model, viewmat, K, width, height, absgrad_sink=sink,
                      antialiased=(mcfg.rasterize_mode == "antialiased"),
                      band_row0=row0, band_tile_rows=rows_per,
                      **render_kwargs)
    pred = torch.clamp(out.image, 0.0, 1.0)
    gt_b, em_b, valid_b = bands.band_inputs(gt, edge_mask, y0, band_h, pad_h,
                                            height, width)
    loss = bands.band_partial_loss(
        pred, gt_b, em_b, valid_b, edge_mask, strategy_idx, bg_ratio,
        bg_scores, loss_type=cfg.training.loss.projection_losses.loss_type,
        height=height, width=width, y0=y0, band_h=band_h, pad_h=pad_h)
    params = model.params()
    *gparams, gsink = torch.autograd.grad(
        loss, [params[g] for g in GROUPS] + [sink])
    return loss.detach(), out, dict(zip(GROUPS, gparams)), gsink


def make_sharded_proj_grad_fn(cfg: FrameworkConfig, width: int, height: int,
                              mesh, axis: str = "tiles"):
    """Tile-band-sharded projection loss and gradients, in the trainer's
    proj-grad contract: every rank returns the full render's loss,
    statistics, gradients and sink gradient."""
    n_bands = mesh.size(axis)
    render_kwargs = band_render_kwargs(cfg, width, height, n_bands)
    dense_capacity = cfg.model.tile_dense_capacity

    def proj_grad(model, viewmat, K, gt, edge_mask, strategy_idx: int,
                  bg_ratio: float, bg_scores=None):
        loss, out, grads, gsink = band_loss_and_grads(
            model, viewmat, K, gt, edge_mask, strategy_idx, bg_ratio,
            bg_scores, cfg=cfg, width=width, height=height, n_bands=n_bands,
            band=mesh.coord(axis), render_kwargs=render_kwargs)
        buf = all_reduce(flat_grads(grads, loss, gsink), mesh, [axis])
        grads, gsink, loss = unflat_grads(buf, model.params())
        stats = reduce_stats(out, dense_capacity, mesh, [axis])
        return loss, stats, grads, gsink

    return proj_grad
