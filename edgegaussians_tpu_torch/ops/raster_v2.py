"""Dense slot-frame compositor: the counterpart of ``ops/pallas_raster_v2.py``.

Each frame row (tile) holds ``K`` depth-ordered slots of features
``feats [T,K,8]``, of which the first ``counts[row]`` can be live (slots
past the count, and invalid ones, carry a -1e30 constant term from
``tiles.build_tile_features``, so their alpha is exactly 0). The forward
composites each row front to back into its tile's 256 pixels, starting
from a carried transmittance ``t_in`` and returning the one it ends with,
so a capacity range split into two segments composes (the two-level path
renders [0, k1) for every tile, then [k1, k1+k2) for the busiest tiles
from the first segment's ``t_out``). The backward returns d feats from the
algebraic suffix of the all-ones-colour composite, with the cotangent
pre-folded as ``g * (1 - total)`` by the GLOBAL per-tile total of all
segments (pallas_raster_v2.py:146-173, :326).

Same rules as the seg compositor: sigma guard, 1/255 skip, 0.999 clamp,
stop below transmittance 1e-4. Where a pixel saturates, ``t_out`` is below
1e-4 but its value depends on the implementation (the TPU kernel
multiplies through the rest of a 128-slot chunk, the plain version here
through all K, the Hopper kernel on past the stop until the pixel's warp
or the whole CTA leaves the row); a following segment then keeps nothing
either way.

Two implementations of each direction, chosen by the device of the input:

- ``csrc/raster_v2.cu``, the Hopper kernels, for CUDA tensors:
  :func:`composite_fwd_seg` / :func:`composite_bwd_seg` launch them or
  raise, and each launch adds one to ``launch_counts``;
- :func:`composite_fwd_seg_ref` / :func:`composite_bwd_seg_ref`, plain
  PyTorch over chunks of rows, for CPU tensors, and the yardstick the
  kernels are held to on the card.

The JAX wrapper's swap to a ``[T,8,K]`` layout (pallas_raster_v2.py:253)
is for TPU lanes and has no counterpart: the public layout is ``[T,K,8]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu_torch.ops.segpair import PIXELS, check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/raster_v2.cu"
# Elements of one [rows, K, 256] intermediate of the plain version: its
# row chunks stay near 64 MB each however many rows the frame has.
_REF_CHUNK_ELEMS = 1 << 24

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {"raster_v2_fwd": 0, "raster_v2_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_inputs(feats, counts, basis, **rows):
    if feats.dim() != 3:
        raise ValueError(
            f"feats: expected [T,K,8], got {tuple(feats.shape)}")
    T, K, _ = feats.shape
    dev = feats.device
    check_tensor("feats", feats, torch.float32, (T, K, 8), dev)
    check_tensor("counts", counts, torch.int32, (T,), dev)
    check_tensor("basis", basis, torch.float32, (8, PIXELS), dev)
    for name, x in rows.items():
        if x is not None:
            check_tensor(name, x, torch.float32, (T, PIXELS), dev)
    return T, K


# feats, counts, basis, then the [T,256] planes (fwd: t_in, img, t_out;
# bwd: g, total, t_in) and the output; rows, K; stream
_ARGTYPES = {
    "raster_v2_fwd": (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p),
    "raster_v2_bwd": (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p),
}


def _launch(name, args):
    _build.launch("raster_v2", name, _ARGTYPES[name], args)
    launch_counts[name] += 1


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _device_kind(feats):
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no raster_v2 kernel for device {feats.device}")
    return feats.device.type


def composite_fwd_seg(feats: torch.Tensor, counts: torch.Tensor,
                      basis: torch.Tensor,
                      t_in: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment forward: feats [T,K,8] f32, counts [T] int32, basis [8,256]
    f32, t_in [T,256] f32 (None: transmittance 1) -> (img [T,256],
    t_out [T,256]). CUDA tensors launch the kernel; CPU tensors take
    :func:`composite_fwd_seg_ref`."""
    if _device_kind(feats) == "cpu":
        return composite_fwd_seg_ref(feats, counts, basis, t_in)
    T, K = _check_inputs(feats, counts, basis, t_in=t_in)
    img = torch.empty((T, PIXELS), dtype=torch.float32, device=feats.device)
    t_out = torch.empty_like(img)
    stream = _build.stream(feats.device)
    _launch("raster_v2_fwd",
            (feats.data_ptr(), counts.data_ptr(), basis.data_ptr(),
             _ptr(t_in), img.data_ptr(), t_out.data_ptr(), T, K, stream))
    return img, t_out


def composite_bwd_seg(feats: torch.Tensor, counts: torch.Tensor,
                      basis: torch.Tensor, g: torch.Tensor,
                      t_in: Optional[torch.Tensor],
                      total: torch.Tensor) -> torch.Tensor:
    """Segment VJP w.r.t. feats: upstream g [T,256], the segment's
    entering transmittance t_in (None: 1) and the GLOBAL per-tile total
    [T,256] of all segments -> dfeats [T,K,8] (zero on every slot the walk
    does not reach, and in columns 6-7). The kernel folds the cotangent
    ``g * (1 - total)`` itself: one launch a call. CPU tensors take
    :func:`composite_bwd_seg_ref`."""
    if _device_kind(feats) == "cpu":
        return composite_bwd_seg_ref(feats, counts, basis, g, t_in, total)
    g, total = g.contiguous(), total.contiguous()
    T, K = _check_inputs(feats, counts, basis, g=g, total=total, t_in=t_in)
    dfeats = torch.empty_like(feats)
    stream = _build.stream(feats.device)
    _launch("raster_v2_bwd",
            (feats.data_ptr(), counts.data_ptr(), basis.data_ptr(),
             g.data_ptr(), total.data_ptr(), _ptr(t_in), dfeats.data_ptr(),
             T, K, stream))
    return dfeats


def composite_fwd(feats: torch.Tensor, counts: torch.Tensor,
                  basis: torch.Tensor) -> torch.Tensor:
    """Single-segment forward (transmittance 1 in): [T,256] intensities."""
    return composite_fwd_seg(feats, counts, basis)[0]


def composite_bwd(feats: torch.Tensor, counts: torch.Tensor,
                  basis: torch.Tensor, g: torch.Tensor,
                  img: torch.Tensor) -> torch.Tensor:
    """Single-segment VJP, given the forward's output ``img`` (the JAX
    ``composite_bwd`` recomputes it)."""
    return composite_bwd_seg(feats, counts, basis, g, None, img)


def _row_chunks(T: int, K: int):
    rows = max(1, _REF_CHUNK_ELEMS // max(K * PIXELS, 1))
    return [(r, min(r + rows, T)) for r in range(0, T, rows)]


def _chunk_alpha(feats, counts, basis, t_in):
    """Rows' alpha, ok mask and inclusive transmittance, each [R,K,256]."""
    K = feats.shape[1]
    live = (torch.arange(K, device=feats.device)[None, :]
            < counts[:, None])[..., None]                         # [R,K,1]
    logalpha = feats @ basis                                      # [R,K,P]
    ok = (logalpha <= feats[..., 6:7] + SIGMA_GUARD_EPS) & live
    alpha = torch.exp(torch.where(ok, logalpha,
                                  torch.full_like(logalpha, -1e30)))
    ok = ok & (alpha >= ALPHA_THRESHOLD)
    alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_CLAMP),
                        torch.zeros_like(alpha))
    t_inc = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
    return alpha, ok, t_inc


def _ones_if_none(t_in, feats):
    if t_in is not None:
        return t_in
    return torch.ones((feats.shape[0], PIXELS), dtype=torch.float32,
                      device=feats.device)


def composite_fwd_seg_ref(feats: torch.Tensor, counts: torch.Tensor,
                          basis: torch.Tensor,
                          t_in: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: a cumprod along each row's slots (the XLA
    oracle's numerics, composite.py:201-216), over chunks of rows."""
    T, K, _ = feats.shape
    t_in = _ones_if_none(t_in, feats)
    img = torch.zeros((T, PIXELS), dtype=torch.float32, device=feats.device)
    t_out = t_in.clone()
    for r0, r1 in _row_chunks(T, K):
        alpha, _, t_inc = _chunk_alpha(feats[r0:r1], counts[r0:r1], basis,
                                       t_in[r0:r1])
        keep = t_inc >= TRANSMITTANCE_EPS
        img[r0:r1] = torch.sum(alpha * (t_inc / (1.0 - alpha)) * keep, dim=1)
        if K:
            t_out[r0:r1] = t_inc[:, -1]
    return img, t_out


def composite_bwd_seg_ref(feats: torch.Tensor, counts: torch.Tensor,
                          basis: torch.Tensor, g: torch.Tensor,
                          t_in: Optional[torch.Tensor],
                          total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: d log alpha = alpha * gt2 / (1 - alpha) on
    kept slots with ok and alpha < 0.999, gt2 = g * (1 - total), reduced
    over pixels against the basis (pallas_raster_v2.py:161-173)."""
    T, K, _ = feats.shape
    t_in = _ones_if_none(t_in, feats)
    gt2 = g * (1.0 - total)
    dfeats = torch.zeros_like(feats)
    for r0, r1 in _row_chunks(T, K):
        alpha, ok, t_inc = _chunk_alpha(feats[r0:r1], counts[r0:r1], basis,
                                        t_in[r0:r1])
        keep = t_inc >= TRANSMITTANCE_EPS
        dalpha = gt2[r0:r1, None, :] / (1.0 - alpha) * keep
        dla = torch.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha,
                          torch.zeros_like(alpha))
        dfeats[r0:r1] = dla @ basis.T
    return dfeats
