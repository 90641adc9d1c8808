"""View-batch training (data parallel over views), and a tile-sharded
single-view render.

Counterpart of ``edgegaussians_tpu/parallel/train_dp.py``.

:func:`make_dp_train_step`, the *view batch* mode (``step_mode:
"view_batch"``): one Adam step per batch of views. Each rank of the
'views' axis renders its contiguous share of the (sorted) batch and sums
its views' gradients; one all-reduce gives the batch sum, and the step
applies ``lambda_proj * g / num_views``. The strategy alternates on the
batch-step counter; the direction and ratio losses fire every 5 batch
steps, scaled by the batch's loss sum; absgrad adds each view's sink norm
(JAX :336-416). Large-batch semantics, not the reference's per-view SGD.

- **views x tiles** (mesh ('views','tiles'), 'tiles' > 1): each view's
  render is band-sharded over 'tiles' (band-partial losses,
  ``parallel/bands.py``); each view's [N,2] sink gradient is reduced over
  'tiles' before its norm (absgrad is the norm of the sum over all tiles,
  JAX :247-252), and the gradients over both axes once per batch
  (:304-333).
- **views x gauss** (mesh ('views','gauss')): inside each view row the
  render runs the Gaussian-axis pattern of ``parallel/train_tp.py``;
  gradients accumulate in shard space and are reassembled once per batch.
- **flat** (both inner axes 1): every rank renders whole views.

Every rank draws the whole batch's bg_edge_ratio scores, in batch order,
from its identically seeded generator, so a run does not depend on the
mesh's shape (the JAX package folds the view row into its key, :288-289,
a stream torch cannot reproduce; the tests inject the draws).

:func:`make_tile_sharded_render` and :func:`tileize_image` (JAX
:426-534): the 'whole' loss and its gradients of one view, its tile rows
split over the 'tiles' axis, on the single-level frame.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from edgegaussians_tpu_torch import resolve_compositor
from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.ops import tiles as tiles_mod
from edgegaussians_tpu_torch.ops.composite import TileRender
from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.parallel.distributed import all_reduce
from edgegaussians_tpu_torch.parallel.train_sharded import (
    band_loss_and_grads, band_render_kwargs, flat_grads, unflat_grads)
from edgegaussians_tpu_torch.parallel.train_tp import (
    place_shard, tp_loss_and_shard_grads)
from edgegaussians_tpu_torch.train import optim, trainer
from edgegaussians_tpu_torch.train.optim import annealed


def make_dp_train_step(cfg: FrameworkConfig, width: int, height: int, mesh):
    """The view-batch step on ``mesh`` (axes 'views' and one of 'tiles' /
    'gauss'; a mesh of one rank without a process group runs it in one
    process).

    Returns ``dp_step(state, epoch, images, edge_masks, viewmats, Ks,
    bg_scores=None) -> (batch mean loss, ProjGradStats)``: the batch's
    views on axis 0 (their count divisible by the 'views' axis), every
    rank passing the whole batch; ``bg_scores`` [num_views, H*W] replaces
    the generator's draws. The statistics are the batch's peaks over views
    and ranks (a view's ``n_overflow`` and ``num_truncated`` summed over
    its bands)."""
    mcfg = cfg.model
    pl_cfg = cfg.training.loss.projection_losses
    ol_cfg = cfg.training.loss.orientation_losses
    n_views = mesh.size("views")
    n_tiles, n_gauss = mesh.size("tiles"), mesh.size("gauss")
    if n_tiles > 1 and n_gauss > 1:
        raise ValueError("a mesh shards each render over 'tiles' or "
                         "'gauss', not both")
    band_axis = "tiles" if n_tiles > 1 else "gauss" if n_gauss > 1 else None
    n_bands = max(n_tiles, n_gauss)
    if band_axis:
        render_kwargs = band_render_kwargs(cfg, width, height, n_bands)
        band = mesh.coord(band_axis)
    else:
        proj_grad = trainer.make_proj_grad_fn(cfg, width, height)
    strat_before = trainer._strategy_index(pl_cfg.loss_before_alternating)
    strat_less = trainer._strategy_index(pl_cfg.less_freq_loss)
    strat_more = trainer._strategy_index(pl_cfg.more_freq_loss)
    sampling_ratio = max(int(pl_cfg.sampling_whole_num_epochs_ratio), 1)
    dense_capacity = mcfg.tile_dense_capacity

    def view_grads(model, vm, K, gt, em, strategy_idx, bg_ratio, scores):
        """(loss, grads, [N] sink norm, [4] stats) of one view on this
        rank: band-partial in the composed modes, whose sink gradient and
        counters are reduced over the band axis here."""
        if band_axis is None:
            loss, st, grads, gsink = proj_grad(model, vm, K, gt, em,
                                               strategy_idx, bg_ratio, scores)
            stats = torch.stack([st.max_tile, st.n_overflow,
                                 st.num_truncated, st.num_pairs])
            return loss, grads, torch.linalg.vector_norm(gsink, dim=-1), \
                stats.to(torch.int64)
        kw = dict(cfg=cfg, width=width, height=height, n_bands=n_bands,
                  band=band, render_kwargs=render_kwargs)
        if band_axis == "tiles":
            loss, out, grads, gsink = band_loss_and_grads(
                model, vm, K, gt, em, strategy_idx, bg_ratio, scores, **kw)
        else:
            loss, out, grads, gsink, _ = tp_loss_and_shard_grads(
                model, vm, K, gt, em, strategy_idx, bg_ratio, scores,
                mesh=mesh, axis="gauss", **kw)
        counters = torch.stack([(out.tile_counts > dense_capacity).sum(),
                                out.num_truncated]).to(torch.float32)
        buf = all_reduce(torch.cat([gsink.reshape(-1), counters]), mesh,
                         [band_axis])
        stats = torch.stack([out.tile_counts.max().to(torch.float32),
                             buf[-2], buf[-1],
                             out.num_pairs.to(torch.float32)])
        return loss, grads, torch.linalg.vector_norm(
            buf[:-2].reshape(-1, 2), dim=-1), stats.to(torch.int64)

    def dp_step(state, epoch: int, images, edge_masks, viewmats, Ks,
                bg_scores: Optional[Sequence[torch.Tensor]] = None):
        model = state.model
        nv = images.shape[0]
        if nv % n_views:
            raise ValueError(f"a batch of {nv} views does not divide by the "
                             f"'views' axis size {n_views}")
        lrs = optim.all_lrs(cfg.training.optim, epoch)
        lambda_proj = annealed(pl_cfg.lambda_start, pl_cfg.lambda_end,
                               pl_cfg.lambda_annealing, epoch,
                               cfg.training.num_epochs)
        bg_ratio = annealed(pl_cfg.bg_edge_pixel_ratio_start,
                            pl_cfg.bg_edge_pixel_ratio_end,
                            pl_cfg.bg_edge_pixel_ratio_annealing, epoch,
                            cfg.training.num_epochs)
        # strategy alternation on the batch-step counter
        if epoch > pl_cfg.start_alternating_at_epoch:
            strategy_idx = (strat_less if state.step % sampling_ratio == 0
                            else strat_more)
        else:
            strategy_idx = strat_before
        if strategy_idx == 1 and bg_scores is None:
            bg_scores = [torch.rand(width * height,
                                    generator=state.generator).to(
                                        images.device) for _ in range(nv)]
        per = nv // n_views
        first = mesh.coord("views") * per
        dev = model.means.device
        gsum = lsum = None
        asum = torch.zeros(model.capacity, device=dev)
        peaks = torch.zeros(4, dtype=torch.int64, device=dev)
        for iv in range(first, first + per):
            loss, grads, anorm, stats = view_grads(
                model, viewmats[iv], Ks[iv], images[iv], edge_masks[iv],
                strategy_idx, bg_ratio,
                bg_scores[iv] if strategy_idx == 1 else None)
            if gsum is None:
                gsum, lsum = grads, loss
            else:
                gsum = {g: gsum[g] + grads[g] for g in GROUPS}
                lsum = lsum + loss
            asum = asum + anorm
            peaks = torch.maximum(peaks, stats)
        params = model.params()
        if band_axis == "gauss":
            g0 = mesh.coord("gauss") * (model.capacity // n_gauss)
            gsum = place_shard(gsum, g0, params)
        buf = all_reduce(flat_grads(gsum, lsum), mesh, mesh.dim_names)
        grads, _, loss_sum = unflat_grads(buf, params, with_sink=False)
        all_reduce(asum, mesh, ["views"])
        all_reduce(peaks, mesh, mesh.dim_names, "max")

        optim.apply_updates(model, {g: lambda_proj * grads[g] / nv
                                    for g in GROUPS}, state.opt, lrs)
        state.step += 1
        # direction / ratio every 5 batch steps, scaled by the batch's
        # loss sum (the reference's running sum)
        apply_dir = epoch > ol_cfg.start_dir_loss_at_epoch
        apply_ratio = epoch > ol_cfg.start_ratio_loss_at_epoch
        if state.step % 5 == 0 and (apply_dir or apply_ratio):
            trainer.orientation_step(state, loss_sum, lrs, ol_cfg, apply_dir,
                                     apply_ratio)
            if state.sync is not None:
                state.sync(state)
        with torch.no_grad():
            model.absgrads.add_(asum * (lambda_proj / nv))
            model.absgrad_count.add_(1.0)
        return loss_sum / nv, trainer.ProjGradStats(*peaks)

    return dp_step


def make_tile_sharded_render(cfg: FrameworkConfig, width: int, height: int,
                             mesh):
    """A tile-sharded single-view 'whole' loss and its gradients.

    The tile rows split evenly over the 'tiles' axis: every rank projects
    all Gaussians, bins and composites its rows on the single-level frame,
    sums |pred - gt| over its valid pixels, and one all-reduce gives the
    loss, gradients and sink gradient of the whole view. Returns
    ``loss_and_grad(model, viewmat, K, gt_image) -> (loss, grads by
    group, [N,2] sink gradient)``, each divided by W*H."""
    mcfg = cfg.model
    ts_px = mcfg.tile_size
    ntx, nty, _ = tiles_mod.tile_grid(width, height, ts_px)
    n_shards = mesh.size("tiles")
    if nty % n_shards:
        raise ValueError(f"tile rows {nty} not divisible by mesh axis "
                         f"'tiles'={n_shards}")
    tile_rows = nty // n_shards
    local_h = tile_rows * ts_px
    backend = resolve_compositor(mcfg.rasterizer_backend)

    def loss_and_grad(model, viewmat, K, gt_image):
        dev = model.means.device
        row0 = mesh.coord("tiles") * tile_rows
        gt_tiles, pix_valid = tileize_image(gt_image, width, height, ts_px)
        t0 = row0 * ntx
        gt_tiles = gt_tiles[t0:t0 + tile_rows * ntx]
        pix_valid = pix_valid[t0:t0 + tile_rows * ntx]
        sink = torch.zeros((model.capacity, 2), device=dev,
                           requires_grad=True)
        params = model.params()
        proj = project_gaussians(
            params["means"], params["quats"], torch.exp(params["scales"]),
            torch.sigmoid(params["opacities"][:, 0]), viewmat, K, width,
            height, antialiased=(mcfg.rasterize_mode == "antialiased"),
            alive=model.alive)
        # shift this rank's rows to the top of a local_h-high image, so
        # the binning sees only its tiles
        shift = torch.tensor([0.0, float(row0 * ts_px)], device=dev)
        proj = proj._replace(means2d=proj.means2d - shift)
        # the JAX function bins with the default footprint cap (:468)
        bins = tiles_mod.bin_gaussians(proj, width, local_h, ts_px,
                                       mcfg.tile_gaussian_capacity)
        packed = tiles_mod.pack_gaussian_render_data(proj)
        tile_imgs = TileRender.apply(
            packed[bins.order], bins,
            tiles_mod.tile_origins(width, local_h, ts_px, device=dev),
            tiles_mod.pixel_basis(ts_px, device=dev), sink, backend)
        pred = torch.clamp(tile_imgs, 0.0, 1.0)
        local = torch.sum(torch.abs(pred - gt_tiles) * pix_valid)
        *g, gsink = torch.autograd.grad(local, [params[k] for k in GROUPS]
                                        + [sink])
        buf = all_reduce(flat_grads(dict(zip(GROUPS, g)), local.detach(),
                                    gsink), mesh, ["tiles"])
        scale = 1.0 / float(width * height)
        grads, gsink, loss = unflat_grads(buf * scale, params)
        return loss, grads, gsink

    return loss_and_grad


def tileize_image(image: torch.Tensor, width: int, height: int,
                  tile_size: int):
    """[H,W] image -> ([T,P] tile pixels, [T,P] validity of the pad
    pixels), tiles in row-major order."""
    ntx, nty, _ = tiles_mod.tile_grid(width, height, tile_size)
    ph, pw = nty * tile_size, ntx * tile_size
    pad = (0, pw - width, 0, ph - height)
    img = torch.nn.functional.pad(image, pad)
    valid = torch.nn.functional.pad(
        torch.ones((height, width), dtype=torch.float32,
                   device=image.device), pad)

    def to_tiles(x):
        return x.reshape(nty, tile_size, ntx, tile_size) \
                .permute(0, 2, 1, 3).reshape(nty * ntx, -1)

    return to_tiles(img), to_tiles(valid)
