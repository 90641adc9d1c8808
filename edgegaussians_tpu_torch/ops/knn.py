"""Exact brute-force k nearest neighbours: the counterpart of ``ops/knn.py``
and ``ops/pallas_knn.py``.

Contract (knn.py:21-50 of the JAX package): for every row of ``points
[N,3]``, its ``k`` nearest rows among the live ones (``mask``), the row
itself excluded by index, in ascending distance, ties to the lower index.
NaN coordinates read as 0. A slot that fewer than ``k`` live rows can fill
carries ``float32 max`` as its distance and index 0 (as ``knn_pallas``
writes). Dead query rows get neighbours too, computed as for live ones, so
the direction loss gathers the same rows in both packages.

Two implementations, chosen by the device of the input:

- ``csrc/knn.cu``, the Hopper kernel, for CUDA tensors and ``k <= 16``
  (the ABC recipe's fetch of 6, Replica's 11, the wayward cull's 15):
  :func:`knn` launches it or raises; each launch adds one to
  ``launch_counts``;
- :func:`knn_ref`, plain PyTorch over chunks of query rows, for CPU
  tensors, and the yardstick the kernel is held to on the card.

Both compute d^2 by direct differences, each product and sum rounded on its
own, so they agree bit for bit; the JAX XLA path's ``|q|^2 + |p|^2 - 2 q.p``
expansion cancels for near neighbours and differs from both by ~1e-4
relative.

A deliberate divergence from the JAX trainer: its default ``approx_knn``
(XLA ``approx_max_k`` at recall 0.95 on the TPU, knn.py:61-74) has no
counterpart. The port is always exact, and has no ``EG_KNN_BACKEND`` /
``EG_KNN_RECALL`` knob. On the CPU the JAX package is exact too.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.segpair import check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/knn.cu"
MAX_K = 16
F32_MAX = torch.finfo(torch.float32).max
# Query rows per chunk of the plain version: a [chunk, N] d^2 block.
_REF_CHUNK = 1024

# Launches of the kernel since the last reset_launch_counts(); only the
# kernel wrapper below adds to it.
launch_counts = {"knn": 0}

# points, mask; n, k; dists, idx, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def reset_launch_counts() -> None:
    launch_counts["knn"] = 0


def knn(points: torch.Tensor, k: int,
        mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest live neighbours of every row: ``points [N,3]`` f32,
    ``mask [N]`` bool (None: all live) -> ``(dists [N,k] f32, idx [N,k]
    int64)``. CUDA tensors launch the kernel; CPU tensors take
    :func:`knn_ref`."""
    if points.device.type == "cpu":
        return knn_ref(points, k, mask)
    if points.device.type != "cuda":
        raise ValueError(f"no knn kernel for device {points.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    n = points.shape[0]
    check_tensor("points", points, torch.float32, (n, 3), points.device)
    if mask is not None:
        check_tensor("mask", mask, torch.bool, (n,), points.device)
    dists = torch.empty((n, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=points.device)
    stream = _build.stream(points.device)
    _build.launch(
        "knn", "knn_topk", _ARGTYPES,
        (points.data_ptr(), None if mask is None else mask.data_ptr(), n, k,
         dists.data_ptr(), idx.data_ptr(), stream))
    launch_counts["knn"] += 1
    return dists, idx


def knn_ref(points: torch.Tensor, k: int,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn`: :func:`knn_ref_rows` over
    chunks of query rows."""
    n = points.shape[0]
    dev = points.device
    dists = torch.full((n, k), F32_MAX, dtype=torch.float32, device=dev)
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    for r0 in range(0, n, _REF_CHUNK):
        r1 = min(r0 + _REF_CHUNK, n)
        dists[r0:r1], idx[r0:r1] = knn_ref_rows(
            points, k, mask, torch.arange(r0, r1, device=dev))
    return dists, idx


def knn_ref_rows(points: torch.Tensor, k: int, mask: Optional[torch.Tensor],
                 rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_ref`'s answer for the query rows ``rows`` [R] (int64)
    against every key: the [R, N] d^2 by direct differences, dead keys and
    the row itself at +inf, then a stable sort, whose tie rule is the
    kernel's -> (dists [R,k], idx [R,k])."""
    pts = torch.nan_to_num(points.to(torch.float32))
    n = pts.shape[0]
    dev = pts.device
    r = rows.shape[0]
    dists = torch.full((r, k), F32_MAX, dtype=torch.float32, device=dev)
    idx = torch.zeros((r, k), dtype=torch.int64, device=dev)
    kk = min(k, n)
    inf = torch.tensor(float("inf"), device=dev)
    diff = pts[rows, None, :] - pts[None, :, :]                   # [R,N,3]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]                   # [R,N]
    if mask is not None:
        dead = ~mask.to(device=dev, dtype=torch.bool)
        d2 = torch.where(dead[None, :], inf, d2)
    d2[torch.arange(r, device=dev), rows] = inf
    s, order = torch.sort(d2, dim=1, stable=True)
    s, order = s[:, :kk], order[:, :kk]
    dry = torch.isinf(s)
    dists[:, :kk] = torch.where(dry, F32_MAX, torch.sqrt(s))
    idx[:, :kk] = torch.where(dry, 0, order)
    return dists, idx
