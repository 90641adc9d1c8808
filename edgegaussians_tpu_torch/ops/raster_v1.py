"""v1 log-space dense compositor: the counterpart of ``ops/pallas_raster.py``.

Each tile holds ``K`` depth-ordered slots of features ``feats [T,K,8]``
and there are no counts: invalid slots (past the tile's count, or an
invalid Gaussian inside it) carry a -1e30 constant term from
``tiles.build_tile_features``, so their alpha is exactly 0. The Hopper
kernels find the live slots by that marker (a constant term at or below
-1e29) and walk only those. That is exact, not an approximation: with the
basis's constant row of ones (``tiles.pixel_basis``) a marked slot's log
alpha is about -1e30 on every pixel, so alpha = 0, ``log1p(-0) = -0`` and
walking it adds exact zeros to every sum, for any input whose other five
terms stay finite (and far below 1e29). The transmittance is carried in
log space, as the v1 TPU kernel's ``_alpha_terms`` (pallas_raster.py:
63-87) does: ``lt`` is the running sum of ``log1p(-alpha)``, a slot is
kept while ``lt >= log 1e-4``, and it contributes
``alpha * exp(lt - log1p(-alpha))``. That rounds
differently from v2's product of ``(1 - alpha)`` in the last bits, and is
the contract this module keeps. The backward is the suffix form
``d alpha = (T_prev - (total - c_inc) / (1 - alpha)) * keep * g`` with the
forward image as ``total``.

Two implementations of each direction, chosen by the device of the input:

- ``csrc/raster_v1.cu``, the Hopper kernels, for CUDA tensors:
  :func:`composite_fwd` / :func:`composite_bwd` launch them or raise, and
  each launch adds one to ``launch_counts``;
- :func:`composite_fwd_ref` / :func:`composite_bwd_ref`, plain PyTorch in
  the same log-space form over chunks of tiles (one ``[T,K,256]``
  intermediate of the fixture's single-level frame would be ~2 GB), for
  CPU tensors, and the yardstick the kernels are held to on the card.

The JAX wrapper's swap to a ``[T,8,K]`` layout (pallas_raster.py:140) is
for TPU lanes and has no counterpart: the public layout is ``[T,K,8]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu_torch.ops.raster_v2 import _row_chunks
from edgegaussians_tpu_torch.ops.segpair import PIXELS, check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/raster_v1.cu"
LOG_TRANSMITTANCE_EPS = math.log(TRANSMITTANCE_EPS)
# A slot is dead where its constant term (feature 5) is at or below this:
# the -1e30 marker of tiles.build_tile_features. csrc/raster_v1.cu's find
# holds the same value.
DEAD_MARK = -1e29

# Launches of each kernel since the last reset_launch_counts(); only the
# kernel wrappers below add to these.
launch_counts = {"raster_v1_fwd": 0, "raster_v1_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def live_slots(feats: torch.Tensor) -> torch.Tensor:
    """[T,K] bool: the slots the kernels walk, those without the marker."""
    return feats[..., 5] > DEAD_MARK


def _check_inputs(feats, basis, **planes):
    if feats.dim() != 3:
        raise ValueError(
            f"feats: expected [T,K,8], got {tuple(feats.shape)}")
    T, K, _ = feats.shape
    dev = feats.device
    check_tensor("feats", feats, torch.float32, (T, K, 8), dev)
    check_tensor("basis", basis, torch.float32, (8, PIXELS), dev)
    for name, x in planes.items():
        check_tensor(name, x, torch.float32, (T, PIXELS), dev)
    return T, K


# feats, basis, img; T, K; stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (
    ctypes.c_void_p,)
# feats, basis, g, total, dfeats; T, K; stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 2 + (
    ctypes.c_void_p,)


def _launch(name, argtypes, args):
    _build.launch("raster_v1", name, argtypes, args)
    launch_counts[name] += 1


def _device_kind(feats):
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no raster_v1 kernel for device {feats.device}")
    return feats.device.type


def composite_fwd(feats: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """feats [T,K,8] f32, basis [8,256] f32 -> [T,256] tile intensities.
    CUDA tensors launch the kernel; CPU tensors take
    :func:`composite_fwd_ref`."""
    if _device_kind(feats) == "cpu":
        return composite_fwd_ref(feats, basis)
    T, K = _check_inputs(feats, basis)
    img = torch.empty((T, PIXELS), dtype=torch.float32, device=feats.device)
    stream = _build.stream(feats.device)
    _launch("raster_v1_fwd", _FWD_ARGTYPES,
            (feats.data_ptr(), basis.data_ptr(), img.data_ptr(), T, K,
             stream))
    return img


def composite_bwd(feats: torch.Tensor, basis: torch.Tensor, g: torch.Tensor,
                  total: torch.Tensor) -> torch.Tensor:
    """VJP w.r.t. feats: upstream g [T,256] and the forward image ``total``
    [T,256] -> dfeats [T,K,8] (zero on marked slots, past each pixel's
    walk and in columns 6-7). CPU tensors take :func:`composite_bwd_ref`."""
    if _device_kind(feats) == "cpu":
        return composite_bwd_ref(feats, basis, g, total)
    T, K = _check_inputs(feats, basis, g=g, total=total)
    dfeats = torch.empty_like(feats)
    stream = _build.stream(feats.device)
    _launch("raster_v1_bwd", _BWD_ARGTYPES,
            (feats.data_ptr(), basis.data_ptr(), g.data_ptr(),
             total.data_ptr(), dfeats.data_ptr(), T, K, stream))
    return dfeats


def _chunk_terms(feats, basis):
    """Rows' (alpha, ok, keep, T_prev), each [R,K,256], in log space
    (pallas_raster.py:63-87)."""
    logalpha = feats @ basis                                      # [R,K,P]
    alpha = torch.exp(logalpha)
    ok = (logalpha <= feats[..., 6:7] + SIGMA_GUARD_EPS) & \
        (alpha >= ALPHA_THRESHOLD)
    alpha = torch.where(ok, torch.clamp(alpha, max=ALPHA_CLAMP),
                        torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    log_t_inc = torch.cumsum(log1m, dim=1)
    keep = log_t_inc >= LOG_TRANSMITTANCE_EPS
    return alpha, ok, keep, torch.exp(log_t_inc - log1m)


def composite_fwd_ref(feats: torch.Tensor,
                      basis: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward over chunks of tiles."""
    T, K, _ = feats.shape
    img = torch.zeros((T, PIXELS), dtype=torch.float32, device=feats.device)
    for r0, r1 in _row_chunks(T, K):
        alpha, _, keep, t_prev = _chunk_terms(feats[r0:r1], basis)
        img[r0:r1] = torch.sum(alpha * t_prev * keep, dim=1)
    return img


def composite_bwd_ref(feats: torch.Tensor, basis: torch.Tensor,
                      g: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: the suffix form with ``total``
    (pallas_raster.py:97-114), over chunks of tiles."""
    T, K, _ = feats.shape
    dfeats = torch.zeros_like(feats)
    for r0, r1 in _row_chunks(T, K):
        alpha, ok, keep, t_prev = _chunk_terms(feats[r0:r1], basis)
        contrib = alpha * t_prev * keep
        suffix = total[r0:r1, None, :] - torch.cumsum(contrib, dim=1)
        dalpha = (t_prev - suffix / (1.0 - alpha)) * keep * \
            g[r0:r1, None, :]
        dla = torch.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha,
                          torch.zeros_like(alpha))
        dfeats[r0:r1] = dla @ basis.T
    return dfeats
