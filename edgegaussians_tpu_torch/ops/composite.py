"""Per-tile compositing of the dense frame paths, with the absgrad sink.

Counterpart of ``edgegaussians_tpu/ops/composite.py``: the single-level
``tile_render`` (composite.py:55-135) and the two-level
``tile_render_two_level`` (:315-455), as ``torch.autograd.Function``s over
the dense compositors of ``ops/raster_v2.py`` and ``ops/raster_v1.py``
(Hopper kernels on CUDA tensors, the plain versions on CPU tensors).

Both take the depth-rank-permuted packed rows ``packed_sorted [N,8]``,
gather each tile's slots by rank, build the per-slot features, composite,
and in backward return d packed_sorted plus, through the zero ``sink
[N,2]``, each Gaussian's absgrad: the sum over its slots of |d means2d|
(columns 3:5 of the packed rows) on valid slots. Both come out of one
sum of 10-column rows by depth rank (the JAX version's fused
``_scatter_rows``; here ``ops/rank_sum.py``, in slot order and the same
bits on every launch), then absgrad is unpermuted by ``order``. The |.| is
taken per slot inside backward: autograd through the gather would sum
signed values.

The two-level path renders every frame row's first k1 slots, then the
``t2`` busiest tiles' next k2 slots from the first level's ``t_out``;
its backward folds the cotangent with the GLOBAL total of both levels,
which makes each level's gradient account for the other. Its frame is
gathered slot by slot from decoded ranks, or, with pair-prefix tables
(``bins2.pair_rows``), built by scattering the B budget pairs into a zero
``[T*k1 + t2*k2, 8]`` frame (un-hit slots keep validity 0, so alpha 0);
that backward gathers the B pairs' rows of the gradient frame and adds
them by depth rank, pairs past the frame into a drop row ``n``. The JAX
version's dead ``prior`` argument (composite.py:391) and its ``EG_*``
layout knobs are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edgegaussians_tpu_torch.ops import raster_v1, raster_v2
from edgegaussians_tpu_torch.ops.rank_sum import rank_sum
from edgegaussians_tpu_torch.ops.segpair import build_pair_features_vjp
from edgegaussians_tpu_torch.ops.tiles import (
    TileBins, TileBinsTwoLevel, build_tile_features)


def _slot_validf(counts: torch.Tensor, k: int) -> torch.Tensor:
    kk = torch.arange(k, device=counts.device)[None, :]
    return (kk < counts[:, None]).to(torch.float32)


def tile_features_vjp(gathered, origins, validf, dfeats):
    """VJP of :func:`tiles.build_tile_features` w.r.t. ``gathered``: the
    pair-feature VJP per slot, with no gradient into the constant term of
    invalid slots (it is the -1e30 of the ``where``)."""
    T, K, _ = gathered.shape
    d = dfeats.clone()
    d[..., 5] = torch.where((validf * gathered[..., 6]) > 0, d[..., 5],
                            torch.zeros_like(d[..., 5]))
    ox = origins[:, None, 0].expand(T, K).reshape(-1)
    oy = origins[:, None, 1].expand(T, K).reshape(-1)
    dg = build_pair_features_vjp(gathered.reshape(-1, 8), ox, oy,
                                 d.reshape(-1, 8))
    return dg.reshape(T, K, 8)


def scatter_slot_grads(levels, order: torch.Tensor, n: int):
    """[(dgathered [T,K,8], validf [T,K], ranks [T,K])] -> (dpacked [N,8]
    in rank order, dsink [N,2] in Gaussian-id order): one deterministic
    sum (ops/rank_sum.py) of the valid slots' rows [dg, |dg[..., 3:5]|]
    by depth rank (an invalid slot's row is zero)."""
    rows = torch.cat([torch.cat([dg, torch.abs(dg[..., 3:5])
                                 * vf[..., None]], dim=-1).reshape(-1, 10)
                      for dg, vf, _ in levels])
    idx = torch.cat([r.reshape(-1) for _, _, r in levels])
    valid = torch.cat([vf.reshape(-1) > 0 for _, vf, _ in levels])
    acc = rank_sum(rows, idx, n, valid)
    dsink = torch.zeros((n, 2), dtype=rows.dtype, device=rows.device)
    dsink[order] = acc[:, 8:10]
    return acc[:, :8], dsink


class TileRender(torch.autograd.Function):
    """Single-level frame: [T,256] tile intensities in tile order.

    ``apply(packed_sorted [N,8], bins: TileBins, origins [T,2],
    basis [8,256], sink [N,2], compositor)``: every tile composites its
    first min(count, K) slots (composite.py:55-135). ``compositor`` is the
    JAX backend name it stands for: ``"pallas"`` runs ``raster_v2`` over
    each tile's live slots, ``"pallas_v1"`` runs ``raster_v1`` over all K
    slots with the log-space transmittance (composite.py:43-52,94-108).
    """

    @staticmethod
    def forward(ctx, packed_sorted, bins: TileBins, origins, basis, sink,
                compositor="pallas"):
        K = bins.ranks.shape[1]
        counts = torch.clamp(bins.counts, max=K).to(torch.int32)
        gathered = packed_sorted[bins.ranks]                     # [T,K,8]
        validf = bins.valid.to(torch.float32)
        feats = build_tile_features(gathered, origins, validf).contiguous()
        basis = basis.contiguous()
        if compositor == "pallas":
            img = raster_v2.composite_fwd(feats, counts, basis)
        else:
            img = raster_v1.composite_fwd(feats, basis)
        ctx.bins = bins
        ctx.n = packed_sorted.shape[0]
        ctx.compositor = compositor
        ctx.save_for_backward(gathered, validf, origins, feats, counts,
                              basis, img)
        return img

    @staticmethod
    def backward(ctx, g):
        gathered, validf, origins, feats, counts, basis, img = \
            ctx.saved_tensors
        if ctx.compositor == "pallas":
            dfeats = raster_v2.composite_bwd(feats, counts, basis,
                                             g.contiguous(), img)
        else:
            dfeats = raster_v1.composite_bwd(feats, basis, g.contiguous(),
                                             img)
        dg = tile_features_vjp(gathered, origins, validf, dfeats)
        dpacked, dsink = scatter_slot_grads([(dg, validf, ctx.bins.ranks)],
                                        ctx.bins.order, ctx.n)
        return dpacked, None, None, None, dsink, None


def ovf_take(x: torch.Tensor, bins2: TileBinsTwoLevel) -> torch.Tensor:
    """Level-2 rows of a FRAME-ordered [T,...] array (composite.py:298):
    under occupancy sorting the overflow tiles are the first t2 frame
    rows; otherwise they are gathered by tile id."""
    t2 = bins2.ovf_ids.shape[0]
    return x[:t2] if bins2.tile_perm is not None else x[bins2.ovf_ids]


class TwoLevelFrame(NamedTuple):
    """The two levels' gathered rows, slot validity and compositor
    inputs (composite.py:315-349)."""
    g1: torch.Tensor          # [T,k1,8] gathered packed rows, frame order
    g2: torch.Tensor          # [t2,k2,8]
    validf1: torch.Tensor     # [T,k1] f32 slot validity
    validf2: torch.Tensor     # [t2,k2]
    origins2: torch.Tensor    # [t2,2] level-2 tile origins
    feats1: torch.Tensor      # [T,k1,8] contiguous compositor features
    feats2: torch.Tensor      # [t2,k2,8]
    counts1: torch.Tensor     # [T] int32
    counts2: torch.Tensor     # [t2] int32


def _frame_shape(bins2: TileBinsTwoLevel, k1: int, k2: int):
    if bins2.pair_rows is None:
        return bins2.ranks1.shape[1], bins2.ranks2.shape[1]
    if not (k1 > 0 and k2 > 0):
        raise ValueError("pair-prefix bins need k1 and k2 at the render "
                         "call")
    return k1, k2


def pair_prefix_frame(packed_sorted: torch.Tensor, bins2: TileBinsTwoLevel,
                      k1: int, k2: int):
    """The B budget pairs' packed rows scattered into a zero
    ``[T*k1 + t2*k2, 8]`` frame at ``pair_rows`` (composite.py:254-285),
    as (g1 [T,k1,8], g2 [t2,k2,8]). Rows are unique by construction;
    dropped pairs land on one extra row that is cut off."""
    T, t2 = bins2.counts1.shape[0], bins2.ovf_ids.shape[0]
    n = packed_sorted.shape[0]
    rows = T * k1 + t2 * k2
    src = packed_sorted[torch.clamp(bins2.pair_ranks, 0, n - 1)]   # [B,8]
    frame = packed_sorted.new_zeros((rows + 1, packed_sorted.shape[1]))
    frame.index_copy_(0, torch.clamp(bins2.pair_rows, max=rows), src)
    return (frame[:T * k1].reshape(T, k1, -1),
            frame[T * k1:rows].reshape(t2, k2, -1))


def pair_prefix_grads(dg1: torch.Tensor, dg2: torch.Tensor,
                      bins2: TileBinsTwoLevel, n: int):
    """(dpacked [N,8] in rank order, dsink [N,2] in Gaussian-id order)
    from the frame's gradient rows (composite.py:417-434): the B pairs'
    rows gathered from the gradient frame, [d, |d[:,3:5]|] added by depth
    rank; pairs past the frame take the index ``n``, which the sum drops.
    Every gathered row is a live slot, so no validity mask enters
    absgrad."""
    frame = torch.cat([dg1.reshape(-1, dg1.shape[-1]),
                       dg2.reshape(-1, dg2.shape[-1])])
    r_rows = frame.shape[0]
    rows8 = frame[torch.clamp(bins2.pair_rows, 0, r_rows - 1)]
    rows = torch.cat([rows8, torch.abs(rows8[:, 3:5])], dim=-1)
    idx = torch.where(bins2.pair_rows < r_rows, bins2.pair_ranks, n)
    acc = rank_sum(rows, idx, n)
    dsink = rows.new_zeros((n, 2))
    dsink[bins2.order] = acc[:, 8:10]
    return acc[:, :8], dsink


def two_level_frame(packed_sorted: torch.Tensor, bins2: TileBinsTwoLevel,
                    origins_f: torch.Tensor, k1: int = 0,
                    k2: int = 0) -> TwoLevelFrame:
    """Gather both levels' slots, by depth rank or from the pair-prefix
    tables (then with the static ``k1``/``k2``), and build their features
    (``origins_f`` in frame order)."""
    k1, k2 = _frame_shape(bins2, k1, k2)
    counts1 = bins2.counts1.to(torch.int32)
    counts2 = bins2.counts2.to(torch.int32)
    if bins2.pair_rows is not None:
        g1, g2 = pair_prefix_frame(packed_sorted, bins2, k1, k2)
    else:
        g1 = packed_sorted[bins2.ranks1]
        g2 = packed_sorted[bins2.ranks2]
    validf1 = _slot_validf(counts1, k1)
    validf2 = _slot_validf(counts2, k2)
    origins2 = ovf_take(origins_f, bins2)
    return TwoLevelFrame(
        g1=g1, g2=g2, validf1=validf1, validf2=validf2, origins2=origins2,
        feats1=build_tile_features(g1, origins_f, validf1).contiguous(),
        feats2=build_tile_features(g2, origins2, validf2).contiguous(),
        counts1=counts1, counts2=counts2)


def ovf_add(img1: torch.Tensor, img2: torch.Tensor,
            bins2: TileBinsTwoLevel) -> torch.Tensor:
    """Level-1 images plus level 2 on its tiles' frame rows
    (composite.py:308)."""
    images = img1.clone()
    if bins2.tile_perm is not None:
        images[:img2.shape[0]] += img2
    else:
        images.index_add_(0, bins2.ovf_ids, img2)
    return images


class TileRenderTwoLevel(torch.autograd.Function):
    """Two-level frame: [T,256] intensities in FRAME order.

    ``apply(packed_sorted [N,8], bins2: TileBinsTwoLevel, origins_f [T,2]
    (frame order), basis [8,256], sink [N,2], k1, k2)``: every frame row
    composites its first k1 slots, the ``t2`` busiest tiles k2 more from
    the first level's transmittance (composite.py:315-455), both on the
    ``raster_v2`` kernels. Tiles past the overflow budget stay truncated
    at k1. ``k1``/``k2`` are read from the decoded ranks where there are
    any; the pair-prefix frame (``bins2.pair_rows``) needs them passed.
    """

    @staticmethod
    def forward(ctx, packed_sorted, bins2: TileBinsTwoLevel, origins_f,
                basis, sink, k1=0, k2=0):
        basis = basis.contiguous()
        fr = two_level_frame(packed_sorted, bins2, origins_f, k1, k2)
        img1, tout1 = raster_v2.composite_fwd_seg(fr.feats1, fr.counts1,
                                                  basis)
        tin2 = ovf_take(tout1, bins2).contiguous()
        img2, _ = raster_v2.composite_fwd_seg(fr.feats2, fr.counts2, basis,
                                              tin2)
        images = ovf_add(img1, img2, bins2)
        ctx.bins2 = bins2
        ctx.n = packed_sorted.shape[0]
        ctx.save_for_backward(*fr, origins_f, basis, tin2, images)
        return images

    @staticmethod
    def backward(ctx, g):
        *saved, origins_f, basis, tin2, images = ctx.saved_tensors
        fr = TwoLevelFrame(*saved)
        dpacked, dsink = two_level_grads(fr, ctx.bins2, origins_f, basis,
                                         g.contiguous(), tin2, images,
                                         ctx.n)
        return dpacked, None, None, None, dsink, None, None


def two_level_grads(fr: TwoLevelFrame, bins2: TileBinsTwoLevel,
                    origins_f, basis, g, tin2, images, n: int):
    """Both levels' backward, from the upstream g [T,256] in frame order
    and the forward's level-2 t_in and GLOBAL images -> (dpacked [N,8] in
    rank order, dsink [N,2] in Gaussian-id order) (composite.py:378-452).
    """
    dfeats1 = raster_v2.composite_bwd_seg(fr.feats1, fr.counts1, basis, g,
                                          None, images)
    dfeats2 = raster_v2.composite_bwd_seg(
        fr.feats2, fr.counts2, basis, ovf_take(g, bins2).contiguous(), tin2,
        ovf_take(images, bins2).contiguous())
    dg1 = tile_features_vjp(fr.g1, origins_f, fr.validf1, dfeats1)
    dg2 = tile_features_vjp(fr.g2, fr.origins2, fr.validf2, dfeats2)
    if bins2.pair_rows is not None:
        return pair_prefix_grads(dg1, dg2, bins2, n)
    return scatter_slot_grads(
        [(dg1, fr.validf1, bins2.ranks1), (dg2, fr.validf2, bins2.ranks2)],
        bins2.order, n)
