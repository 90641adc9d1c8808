"""Deterministic per-Gaussian row sums of the compositors' backwards.

Every compositor's backward ends by adding its per-pair (or per-slot)
gradient rows ``[d packed, |d means2d|]`` into per-Gaussian rows by depth
rank: ``ops/segpair.py`` (the seg and v4 pair paths), and
``ops/composite.py`` (the dense frames and the pair-prefix frame). The JAX
package does it with ``_scatter_rows`` (composite.py:140-186), an XLA
scatter-add that is deterministic on the TPU. A float ``index_add_`` on
CUDA is not: its atomics add in another order on every launch, so the
same training run on the card parts ways from its first view step.

:func:`rank_sum` adds each output row's inputs in one fixed order, row
order, which is what ``index_add_`` does on the CPU, and gives the same
bits on every launch. Two implementations, chosen by the device of the
input:

- ``csrc/rank_sum.cu`` for CUDA tensors: the keys sorted by a stable sort
  (``torch.sort``), then one kernel whose thread at the head of each key's
  run walks the run in order. :func:`rank_sum` launches it or raises; each
  launch adds one to ``launch_counts``.
- :func:`rank_sum_ref`, one ``index_add_`` into a zero block with a drop
  row, for CPU tensors (where it adds in row order, so it gives the
  kernel's bits), and the yardstick the kernel is held to on the card.

Dropped rows (``valid`` False, or the index ``n``) add nowhere. The
compositors' dropped rows hold zeros, so dropping them changes a sum at
most from -0 to +0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from edgegaussians_tpu_torch.ops import _build

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/rank_sum.cu"

# Launches of the kernel since the last reset_launch_counts(); only the
# kernel wrapper below adds to it.
launch_counts = {"rank_sum": 0}

# rows, keys, perm; b, n, c; out, stream
_ARGTYPES = ((ctypes.c_void_p,) * 3
             + (ctypes.c_int64, ctypes.c_int, ctypes.c_int)
             + (ctypes.c_void_p, ctypes.c_void_p))


def reset_launch_counts() -> None:
    launch_counts["rank_sum"] = 0


def _keys(idx: torch.Tensor, n: int,
          valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's output row, ``n`` where it is dropped."""
    if valid is None:
        return idx
    return torch.where(valid, idx, n)


def rank_sum(rows: torch.Tensor, idx: torch.Tensor, n: int,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rows [B,C]`` f32 added by ``idx [B]`` (int, in [0, n]) into
    ``[n,C]``, each output row's rows in row order. Rows where ``valid``
    [B] is False, or whose index is ``n``, are dropped. CUDA tensors sort
    the keys and launch the kernel; CPU tensors take
    :func:`rank_sum_ref`."""
    if rows.device.type == "cpu":
        return rank_sum_ref(rows, idx, n, valid)
    if rows.device.type != "cuda":
        raise ValueError(f"no rank_sum kernel for device {rows.device}")
    if rows.dim() != 2 or idx.shape != rows.shape[:1]:
        raise ValueError(f"rows [B,C] and idx [B] expected, got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows: expected torch.float32, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if idx.device != rows.device or (valid is not None
                                     and valid.device != rows.device):
        raise ValueError(f"all inputs must be on {rows.device}")
    if n >= 2 ** 31 - 1:
        raise ValueError(f"{n} output rows do not fit the int32 keys")
    keys, perm = torch.sort(_keys(idx, n, valid).to(torch.int32),
                            stable=True)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    launch_sum(rows, keys, perm, n, out)
    return out


def launch_sum(rows: torch.Tensor, keys: torch.Tensor, perm: torch.Tensor,
               n: int, out: torch.Tensor) -> None:
    """The kernel alone: ``rows [B,C]`` added into the zeroed ``out
    [n,C]`` by the stably sorted int32 ``keys [B]`` and their rows ``perm
    [B]`` (int64), as :func:`rank_sum` calls it."""
    stream = _build.stream(rows.device)
    _build.launch("rank_sum", "rank_sum", _ARGTYPES,
                  (rows.data_ptr(), keys.data_ptr(), perm.data_ptr(),
                   rows.shape[0], n, rows.shape[1], out.data_ptr(), stream))
    launch_counts["rank_sum"] += 1


def rank_sum_ref(rows: torch.Tensor, idx: torch.Tensor, n: int,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rank_sum`: one ``index_add_`` into
    ``[n + 1, C]`` zeros, whose last row takes the dropped rows."""
    acc = rows.new_zeros((n + 1, rows.shape[1]))
    acc.index_add_(0, _keys(idx, n, valid), rows)
    return acc[:n]
