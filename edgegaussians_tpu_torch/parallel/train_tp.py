"""Gaussian-axis (tensor-parallel) sharding of one render.

Counterpart of ``edgegaussians_tpu/parallel/train_tp.py``, for scenes
whose Gaussian count dominates (DTU and Replica grow to 131k). Per render
on a d-rank 'gauss' axis:

1. each rank projects ITS N/d rows of the parameters;
2. :class:`AllGather` collects the packed [N,8] rows, and, outside
   autograd, the depths and radii the binning reads;
3. each rank bins (on detached tensors) and composites ITS band of tile
   rows against the full set (``rasterize_packed`` band mode): the
   compositing shards d ways too;
4. the backward of the gather reduce-scatters (SUM) the packed cotangent,
   so each rank receives the sum over all bands of the cotangent of ITS
   rows, exactly once, and runs its projection's backward locally; the
   full [N] gradients are reassembled by writing each rank's rows into
   zeros and one all-reduce (SUM), with the loss and the sink gradient in
   the same buffer.

The gather is this module's own ``autograd.Function`` on
``all_gather_into_tensor`` / ``reduce_scatter_tensor``, not
``torch.distributed.nn.functional.all_gather``, so that the one reduction
of the cotangent is visible here; tests/test_torch_parallel.py holds its
gradient to the sum over the ranks' cotangents (not ``d`` times it) and
the TP gradients to the single-device ones.

Implements the trainer's proj-grad contract; the capacity must divide by
the axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.ops.projection import (
    ProjectedGaussians, project_gaussians)
from edgegaussians_tpu_torch.ops.rasterize import rasterize_packed
from edgegaussians_tpu_torch.ops.tiles import pack_gaussian_render_data
from edgegaussians_tpu_torch.parallel import bands
from edgegaussians_tpu_torch.parallel.distributed import all_reduce
from edgegaussians_tpu_torch.parallel.train_sharded import (
    band_render_kwargs, flat_grads, reduce_stats, unflat_grads)


class AllGather(torch.autograd.Function):
    """Concatenate every rank's ``[n, ...]`` shard along dim 0, in rank
    order of ``group``; the backward reduce-scatters (SUM) the cotangent,
    so each shard receives the sum of all ranks' cotangents of its rows.
    ``group`` None (a one-rank mesh without a process group) is the
    identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if group is None:
            return x.clone()
        d = dist.get_world_size(group)
        out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.group is None:
            return g, None
        d = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(),
                                   op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:class:`AllGather` of ``x`` over the mesh axis ``axis``."""
    return AllGather.apply(x, mesh.group([axis]))


def tp_loss_and_shard_grads(model, viewmat, K, gt, edge_mask,
                            strategy_idx: int, bg_ratio: float, bg_scores,
                            *, cfg: FrameworkConfig, width: int,
                            height: int, mesh, axis: str, n_bands: int,
                            band: int, render_kwargs: dict):
    """One TP render of band ``band`` of ``n_bands``: this rank's shard of
    the parameters projected, the packed rows gathered over ``axis``, the
    band composited and its partial loss differentiated. Returns (band
    loss, render result, shard gradients by group, this band's [N,2] sink
    gradient, first row of the shard)."""
    mcfg = cfg.model
    n = model.capacity
    d = mesh.size(axis)
    if n % d:
        raise ValueError(f"capacity {n} not divisible by '{axis}' axis "
                         f"size {d}")
    shard_n = n // d
    g0 = mesh.coord(axis) * shard_n
    rows_per, band_h, pad_h = bands.band_geometry(width, height,
                                                  mcfg.tile_size, n_bands)
    row0 = band * rows_per
    y0 = row0 * mcfg.tile_size
    p_sh = {g: getattr(model, g)[g0:g0 + shard_n].detach().requires_grad_()
            for g in GROUPS}
    sink = torch.zeros((n, 2), dtype=torch.float32,
                       device=model.means.device, requires_grad=True)
    proj_sh = project_gaussians(
        p_sh["means"], p_sh["quats"], torch.exp(p_sh["scales"]),
        torch.sigmoid(p_sh["opacities"][:, 0]), viewmat, K, width, height,
        antialiased=(mcfg.rasterize_mode == "antialiased"),
        alive=model.alive[g0:g0 + shard_n])
    packed = all_gather_rows(pack_gaussian_render_data(proj_sh), mesh, axis)
    with torch.no_grad():
        depths = all_gather_rows(proj_sh.depths.detach(), mesh, axis)
        radii = all_gather_rows(proj_sh.radii, mesh, axis)
        pk = packed.detach()
        proj = ProjectedGaussians(
            means2d=pk[:, 3:5], conics=pk[:, 0:3], depths=depths,
            radii=radii, opacities=torch.exp(pk[:, 5]), valid=pk[:, 6] > 0)
    out = rasterize_packed(proj, packed, width, height, absgrad_sink=sink,
                           band_row0=row0, band_tile_rows=rows_per,
                           **render_kwargs)
    pred = torch.clamp(out.image, 0.0, 1.0)
    gt_b, em_b, valid_b = bands.band_inputs(gt, edge_mask, y0, band_h, pad_h,
                                            height, width)
    loss = bands.band_partial_loss(
        pred, gt_b, em_b, valid_b, edge_mask, strategy_idx, bg_ratio,
        bg_scores, loss_type=cfg.training.loss.projection_losses.loss_type,
        height=height, width=width, y0=y0, band_h=band_h, pad_h=pad_h)
    *g_sh, gsink = torch.autograd.grad(loss, [p_sh[g] for g in GROUPS]
                                       + [sink])
    return loss.detach(), out, dict(zip(GROUPS, g_sh)), gsink, g0


def place_shard(g_sh, g0: int, like) -> dict:
    """Each group's shard gradient written into zeros of the full shape at
    rows [g0, g0 + shard rows)."""
    full = {}
    for g in GROUPS:
        z = torch.zeros_like(like[g])
        z[g0:g0 + g_sh[g].shape[0]] = g_sh[g]
        full[g] = z
    return full


def make_tp_proj_grad_fn(cfg: FrameworkConfig, width: int, height: int,
                         mesh, axis: str = "gauss"):
    """Gaussian-axis-sharded projection loss and gradients, in the
    trainer's proj-grad contract (every rank returns the full values)."""
    d = mesh.size(axis)
    render_kwargs = band_render_kwargs(cfg, width, height, d)
    dense_capacity = cfg.model.tile_dense_capacity

    def proj_grad(model, viewmat, K, gt, edge_mask, strategy_idx: int,
                  bg_ratio: float, bg_scores=None):
        loss, out, g_sh, gsink, g0 = tp_loss_and_shard_grads(
            model, viewmat, K, gt, edge_mask, strategy_idx, bg_ratio,
            bg_scores, cfg=cfg, width=width, height=height, mesh=mesh,
            axis=axis, n_bands=d, band=mesh.coord(axis),
            render_kwargs=render_kwargs)
        params = model.params()
        buf = all_reduce(flat_grads(place_shard(g_sh, g0, params), loss,
                                    gsink), mesh, [axis])
        grads, gsink, loss = unflat_grads(buf, params)
        stats = reduce_stats(out, dense_capacity, mesh, [axis])
        return loss, stats, grads, gsink

    return proj_grad
