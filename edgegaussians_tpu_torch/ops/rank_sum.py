"""Deterministic per-Gaussian row sums of the compositors' backwards.

Every compositor's backward ends by adding its per-pair (or per-slot)
gradient rows ``[d packed, |d means2d|]`` into per-Gaussian rows by depth
rank: ``ops/segpair.py`` (the seg and v4 pair paths), and
``ops/composite.py`` (the dense frames and the pair-prefix frame). So does
the backward of the direction loss's neighbour gather (:func:`gather_rows`,
``models/losses.py``), whose autograd form adds with atomics across
threads on the CPU and in another order on every launch on the card. The JAX
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

:func:`gather_rows` is ``x[idx]`` whose backward, :func:`gather_backward`,
is the row sum of the cotangent's rows by the flattened ``idx``. On the
card it drops the rows that are all zeros before it sorts: adding a +0 or
-0 row never changes a sum that starts at +0, so the bits are those of
the whole sum, and the direction loss's dead query rows (whose cotangents
are zeros, and whose neighbours are the same few live rows) add no runs
of thousands of rows for one thread each to walk. It counts its launches
apart (``launch_counts["rank_sum_gather"]``).

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

# Launches of the kernel since the last reset_launch_counts(), by the job
# that launched it: the compositors' row sums (rank_sum) and the gather's
# backward (gather_backward); only launch_sum adds to them.
launch_counts = {"rank_sum": 0, "rank_sum_gather": 0}

# rows, keys, perm; b, n, c; out, stream
_ARGTYPES = ((ctypes.c_void_p,) * 3
             + (ctypes.c_int64, ctypes.c_int, ctypes.c_int)
             + (ctypes.c_void_p, ctypes.c_void_p))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _keys(idx: torch.Tensor, n: int,
          valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's output row, ``n`` where it is dropped."""
    if valid is None:
        return idx
    return torch.where(valid, idx, n)


def rank_sum(rows: torch.Tensor, idx: torch.Tensor, n: int,
             valid: Optional[torch.Tensor] = None,
             job: str = "rank_sum") -> torch.Tensor:
    """``rows [B,C]`` f32 added by ``idx [B]`` (int, in [0, n]) into
    ``[n,C]``, each output row's rows in row order. Rows where ``valid``
    [B] is False, or whose index is ``n``, are dropped. CUDA tensors sort
    the keys and launch the kernel, counted under ``job``; CPU tensors
    take :func:`rank_sum_ref`."""
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
    launch_sum(rows, keys, perm, n, out, job)
    return out


def launch_sum(rows: torch.Tensor, keys: torch.Tensor, perm: torch.Tensor,
               n: int, out: torch.Tensor, job: str = "rank_sum") -> None:
    """The kernel alone: ``rows [B,C]`` added into the zeroed ``out
    [n,C]`` by the stably sorted int32 ``keys [B]`` and their rows ``perm
    [B]`` (int64), as :func:`rank_sum` calls it; one launch of ``job``."""
    stream = _build.stream(rows.device)
    _build.launch("rank_sum", "rank_sum", _ARGTYPES,
                  (rows.data_ptr(), keys.data_ptr(), perm.data_ptr(),
                   rows.shape[0], n, rows.shape[1], out.data_ptr(), stream))
    launch_counts[job] += 1


def rank_sum_ref(rows: torch.Tensor, idx: torch.Tensor, n: int,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rank_sum`: one ``index_add_`` into
    ``[n + 1, C]`` zeros, whose last row takes the dropped rows."""
    acc = rows.new_zeros((n + 1, rows.shape[1]))
    acc.index_add_(0, _keys(idx, n, valid), rows)
    return acc[:n]


def nonzero_rows(rows: torch.Tensor) -> torch.Tensor:
    """[B] bool: the rows of ``rows [B,C]`` with an element other than +0
    or -0 (NaN counts as one)."""
    return rows.ne(0).any(dim=1)


def gather_backward(g: torch.Tensor, idx: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The backward of :func:`gather_rows` into ``[n,C]``: the cotangent
    ``g [*idx.shape, C]``'s rows added by the flattened ``idx`` in row
    order. A CUDA tensor's all-zero rows are dropped (the same bits: see
    the module's docstring) and the kernel launches, counted under
    ``rank_sum_gather``; a CPU tensor's sum is :func:`rank_sum_ref` of
    every row."""
    rows = g.reshape(-1, g.shape[-1]).contiguous()
    idx = idx.reshape(-1)
    if rows.device.type == "cpu":
        return rank_sum_ref(rows, idx, n)
    return rank_sum(rows, idx, n, nonzero_rows(rows), job="rank_sum_gather")


class GatherRows(torch.autograd.Function):
    """``x[idx]`` for ``x [N,C]``; the backward is :func:`gather_backward`,
    in row order, so it gives the same bits on every run and every
    device."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_backward(g, idx, ctx.n), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (``x [N,C]`` f32, ``idx`` int of any shape, in [0, N)),
    differentiable in ``x`` through :func:`gather_backward`: a CUDA
    tensor's backward launches the row-sum kernel or raises; a CPU
    tensor's is the plain version, one ``index_add_`` in row order."""
    return GatherRows.apply(x, idx)
