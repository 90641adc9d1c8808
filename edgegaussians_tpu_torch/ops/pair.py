"""v4 block-window pair compositor: the counterpart of ``ops/pallas_pair.py``.

The pair tables come from ``tiles.bin_pairs_frame_order(...,
block_tiles=8)``: frame rows order tiles by descending occupancy, frame
row r composites the depth-ordered run ``[s_f[r], s_f[r] + counts_f[r])``
of the pair arrays, and each block's last row is followed by pad pairs
that align the next block to a 128-pair brick. Pads carry real Gaussians'
features (their ranks are clipped), so every walk takes its length from
``counts_f``, never from the next run start.

The forward composites each run front to back into its tile's 256 pixels
(gsplat rules: sigma guard, 1/255 skip, 0.999 clamp, stop below
transmittance 1e-4). The backward takes the upstream ``g`` and the forward
image ``total`` and uses the v4 kernel's unfolded suffix form
``d alpha = (T_prev - (total - c_inc) / (1 - alpha)) * keep * g``
(pallas_pair.py:255-262), not the seg kernel's folded one.

Two implementations of each direction, chosen by the device of the input:

- ``csrc/pair.cu``, the Hopper kernels, for CUDA tensors: :func:`pair_fwd`
  / :func:`pair_bwd` launch them or raise, and each launch adds one to
  ``launch_counts``;
- :func:`pair_fwd_ref` / :func:`pair_bwd_ref`, plain PyTorch over a padded
  ``[rows, maxrun, 256]`` block in the same suffix form, chunked over frame
  rows, for CPU tensors, and the yardstick the kernels are held to on the
  card.

:class:`PairRender` wraps both in a ``torch.autograd.Function`` with the
contract of ``pair_render`` (pallas_pair.py:412-475). What ``_prep``
(:386-409) builds for Mosaic has no counterpart: no brick relayout, no
per-block window starts, and no padding of the frame rows to a multiple of
the TPU's 8-tile grid block; the kernels take the run starts ``sfp`` and
lengths ``counts_f`` of the T frame rows.
"""

from __future__ import annotations

import ctypes

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.projection import ALPHA_CLAMP
from edgegaussians_tpu_torch.ops.segpair import (
    PIXELS, build_pair_features, check_tensor, pair_grads_to_packed,
    pair_inputs, run_alpha)
from edgegaussians_tpu_torch.ops.tiles import PairBins

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/pair.cu"
# Tiles per block of the v4 tables: the JAX package's TILE_BLOCK
# (pallas_pair.pair_block_tiles()), the block_tiles to bin with.
BLOCK_TILES = 8
# Elements of one [rows, maxrun, 256] intermediate of the plain version:
# its row chunks stay near 64 MB each however many rows the frame has.
_REF_CHUNK_ELEMS = 1 << 24

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {"pair_fwd": 0, "pair_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def pair_prep(packed_sorted: torch.Tensor, pbins: PairBins,
              origins: torch.Tensor):
    """(src [B,8], ox [B], oy [B], feats [B,8], sfp [T] int32, counts_f [T]
    int32): each pair's source row and tile origin, its features, and the
    frame rows' run starts and lengths."""
    src, ox, oy = pair_inputs(packed_sorted, pbins, origins)
    feats = build_pair_features(src, ox, oy).contiguous()
    sfp = pbins.s_f[:-1].to(torch.int32)
    return src, ox, oy, feats, sfp, pbins.counts_f.to(torch.int32)


def _check_inputs(feats, sfp, counts, basis, **planes):
    R = sfp.shape[0]
    dev = feats.device
    check_tensor("feats", feats, torch.float32, (feats.shape[0], 8), dev)
    check_tensor("sfp", sfp, torch.int32, (R,), dev)
    check_tensor("counts", counts, torch.int32, (R,), dev)
    check_tensor("basis", basis, torch.float32, (8, PIXELS), dev)
    for name, x in planes.items():
        check_tensor(name, x, torch.float32, (R, PIXELS), dev)
    return R


# each entry's pointers, then rows and stream
_ARGTYPES = {
    "pair_fwd": (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_void_p),
    "pair_bwd": (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_void_p),
}


def _launch(name, args):
    _build.launch("pair", name, _ARGTYPES[name], args)
    launch_counts[name] += 1


def _device_kind(feats):
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair kernel for device {feats.device}")
    return feats.device.type


def pair_fwd(feats: torch.Tensor, sfp: torch.Tensor, counts: torch.Tensor,
             basis: torch.Tensor) -> torch.Tensor:
    """Composite every frame row's run: feats [B,8] f32, sfp / counts [R]
    int32, basis [8,256] f32 -> [R,256] f32. CUDA tensors launch the
    kernel; CPU tensors take :func:`pair_fwd_ref`."""
    if _device_kind(feats) == "cpu":
        return pair_fwd_ref(feats, sfp, counts, basis)
    R = _check_inputs(feats, sfp, counts, basis)
    img = torch.empty((R, PIXELS), dtype=torch.float32, device=feats.device)
    stream = _build.stream(feats.device)
    _launch("pair_fwd", (feats.data_ptr(), sfp.data_ptr(), counts.data_ptr(),
                         basis.data_ptr(), img.data_ptr(), R, stream))
    return img


def pair_bwd(feats: torch.Tensor, sfp: torch.Tensor, counts: torch.Tensor,
             basis: torch.Tensor, g: torch.Tensor,
             total: torch.Tensor) -> torch.Tensor:
    """Per-pair feature gradients [B,8] from the upstream g [R,256] and the
    forward image ``total`` [R,256]. Rows outside every run (pads, the
    budget tail) are left undefined by the kernel, and the caller masks
    them by pair validity; CPU tensors take :func:`pair_bwd_ref`."""
    if _device_kind(feats) == "cpu":
        return pair_bwd_ref(feats, sfp, counts, basis, g, total)
    R = _check_inputs(feats, sfp, counts, basis, g=g, total=total)
    dfeats = torch.empty_like(feats)
    stream = _build.stream(feats.device)
    _launch("pair_bwd", (feats.data_ptr(), sfp.data_ptr(), counts.data_ptr(),
                         basis.data_ptr(), g.data_ptr(), total.data_ptr(),
                         dfeats.data_ptr(), R, stream))
    return dfeats


def _run_chunks(counts: torch.Tensor):
    """(maxrun, [(r0, r1)]) row chunks of the padded plain version."""
    R = counts.shape[0]
    maxrun = int(counts.max()) if R else 0
    rows = max(1, _REF_CHUNK_ELEMS // max(maxrun * PIXELS, 1))
    return maxrun, [(r, min(r + rows, R)) for r in range(0, R, rows)]


def _chunk_terms(feats, sfp, counts, basis, maxrun):
    """Rows' runs in [R, maxrun] slots -> (alpha, ok, keep, t_prev) over
    [R, maxrun, 256], and the slots' pair index and validity."""
    alpha, ok, t_inc, keep, idx, slot_valid = run_alpha(
        feats, sfp, counts, basis, maxrun)
    return alpha, ok, keep, t_inc / (1.0 - alpha), idx, slot_valid


def pair_fwd_ref(feats: torch.Tensor, sfp: torch.Tensor,
                 counts: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: a cumprod along each padded run."""
    img = torch.zeros((sfp.shape[0], PIXELS), dtype=torch.float32,
                      device=feats.device)
    maxrun, chunks = _run_chunks(counts)
    for r0, r1 in chunks:
        alpha, _, keep, t_prev, _, _ = _chunk_terms(
            feats, sfp[r0:r1], counts[r0:r1], basis, maxrun)
        img[r0:r1] = torch.sum(alpha * t_prev * keep, dim=1)
    return img


def pair_bwd_ref(feats: torch.Tensor, sfp: torch.Tensor,
                 counts: torch.Tensor, basis: torch.Tensor, g: torch.Tensor,
                 total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward in the unfolded suffix form, reduced over
    pixels against the basis. Rows outside every run are zero."""
    dfeats = torch.zeros_like(feats)
    maxrun, chunks = _run_chunks(counts)
    for r0, r1 in chunks:
        alpha, ok, keep, t_prev, idx, slot_valid = _chunk_terms(
            feats, sfp[r0:r1], counts[r0:r1], basis, maxrun)
        c_inc = torch.cumsum(alpha * t_prev * keep, dim=1)
        suffix = total[r0:r1, None, :] - c_inc
        dalpha = (t_prev - suffix / (1.0 - alpha)) * keep * \
            g[r0:r1, None, :]
        dla = torch.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha,
                          torch.zeros_like(alpha))
        dpad = dla @ basis.T                                      # [R,M,8]
        dfeats[idx[slot_valid]] = dpad[slot_valid]
    return dfeats


class PairRender(torch.autograd.Function):
    """Frame-ordered tile intensities [T,256] from the v4 pair tables.

    ``apply(packed_sorted [N,8], pbins, origins [T,2], basis [8,256],
    sink [N,2])``: differentiable in ``packed_sorted``; ``sink`` is a zero
    gradient port whose cotangent reports each Gaussian's accumulated
    |d means2d| (absgrad). The backward masks the kernel's rows by
    ``pair_valid``, runs the feature VJP and adds ``[dsrc, |dsrc[:,3:5]|]``
    by ``pair_ranks`` in one deterministic sum (``ops/rank_sum.py``;
    pallas_pair.py:443-472).
    """

    @staticmethod
    def forward(ctx, packed_sorted, pbins: PairBins, origins, basis, sink):
        src, ox, oy, feats, sfp, counts = pair_prep(packed_sorted, pbins,
                                                    origins)
        basis = basis.contiguous()
        img = pair_fwd(feats, sfp, counts, basis)
        ctx.pbins = pbins
        ctx.n = packed_sorted.shape[0]
        ctx.save_for_backward(src, ox, oy, feats, sfp, counts, basis, img)
        return img

    @staticmethod
    def backward(ctx, g):
        src, ox, oy, feats, sfp, counts, basis, img = ctx.saved_tensors
        dfeats = pair_bwd(feats, sfp, counts, basis, g.contiguous(), img)
        dpacked, dsink = pair_grads_to_packed(dfeats, src, ox, oy,
                                              ctx.pbins, ctx.n)
        return dpacked, None, None, None, dsink
