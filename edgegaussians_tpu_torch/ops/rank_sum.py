"""Deterministic per-Gaussian row sums of the compositors' backwards.

Every compositor's backward ends by adding its per-pair (or per-slot)
gradient rows ``[d packed, |d means2d|]`` into per-Gaussian rows by depth
rank: ``ops/segpair.py`` (the seg and v4 pair paths), and
``ops/composite.py`` (the dense frames and the pair-prefix frame). So does
the backward of the direction loss's neighbour gather (:func:`gather_rows`,
``models/losses.py``), whose autograd form adds with atomics across
threads on the CPU and in another order on every launch on the card. The JAX
package does it with ``_scatter_rows`` (composite.py:138), an XLA
scatter-add that is deterministic on the TPU. A float ``index_add_`` on
CUDA is not: its atomics add in another order on every launch, so the
same training run on the card parts ways from its first view step.

:func:`rank_sum` adds each output row's inputs in one fixed order, row
order, which is what ``index_add_`` does on the CPU, and gives the same
bits on every launch. Two implementations, chosen by the device of the
input:

- ``csrc/rank_sum.cu`` for CUDA tensors: a counting sort over the keys'
  known range [0, n) in four launches (count, alloc, fill, then a sum
  that puts each key's rows back in row order and adds them: a lane a
  key of up to 8 rows, a warp a longer one), with integer atomics only
  and a workspace kept per stream. :func:`rank_sum` launches
  it or raises; each call adds one to ``launch_counts``.
- :func:`rank_sum_ref`, one ``index_add_`` into a zero block with a drop
  row, for CPU tensors (where it adds in row order, so it gives the
  kernel's bits), and the yardstick the kernel is held to on the card.

:func:`gather_rows` is ``x[idx]`` whose backward, :func:`gather_backward`,
is the row sum of the cotangent's rows by the flattened ``idx``. On the
card the kernel drops the rows that are all zeros: adding a +0 or -0 row
never changes a sum that starts at +0, so the bits are those of the whole
sum, and the direction loss's dead query rows (whose cotangents are
zeros, and whose neighbours are the same few live rows) add no runs of
thousands of rows for one warp each to sort. It counts its launches
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
# the kernels of one call, in launch order (fill only where there are
# rows)
STAGES = ("rank_sum_count_kernel", "rank_sum_alloc_kernel",
          "rank_sum_fill_kernel", "rank_sum_sum_kernel")

# Calls of the kernels since the last reset_launch_counts(), by the job
# that called them: the compositors' row sums (rank_sum) and the gather's
# backward (gather_backward); only launch() adds to them.
launch_counts = {"rank_sum": 0, "rank_sum_gather": 0}

# rows, idx, idx64, valid, drop_zero; b, n, c; out; keys, list, tmp, cnt,
# seg, cur, big, total; stream
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
              ctypes.c_int) + (ctypes.c_void_p,) * 10)

# (device index, stream handle) -> the workspace of csrc/rank_sum.cu: one
# per stream, as two streams' calls may run at once
_workspaces = {}


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
    [B] is False, or whose index is ``n``, are dropped. CUDA tensors
    launch the kernel, counted under ``job``; CPU tensors take
    :func:`rank_sum_ref`."""
    if rows.device.type == "cpu":
        return rank_sum_ref(rows, idx, n, valid)
    return launch(rows, idx, n, valid, job)


def launch(rows: torch.Tensor, idx: torch.Tensor, n: int,
           valid: Optional[torch.Tensor] = None, job: str = "rank_sum",
           drop_zero_rows: bool = False) -> torch.Tensor:
    """The kernel's call on CUDA tensors, as :func:`rank_sum` and
    :func:`gather_backward` make it: ``rows [B,C]`` f32 (contiguous),
    ``idx [B]`` int64 or int32, ``valid [B]`` bool or None; with
    ``drop_zero_rows`` the rows that are all +0 or -0 are dropped too.
    Adds one to ``launch_counts[job]``."""
    if rows.device.type != "cuda":
        raise ValueError(f"no rank_sum kernel for device {rows.device}")
    if rows.dim() != 2 or idx.shape != rows.shape[:1]:
        raise ValueError(f"rows [B,C] and idx [B] expected, got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows: expected torch.float32, got {rows.dtype}")
    if idx.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"idx: expected torch.int64 or torch.int32, got "
                        f"{idx.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if valid is not None:
        if valid.dtype != torch.bool:
            raise TypeError(f"valid: expected torch.bool, got {valid.dtype}")
        if valid.shape != idx.shape:
            raise ValueError(f"valid: expected shape {tuple(idx.shape)}, "
                             f"got {tuple(valid.shape)}")
    if idx.device != rows.device or (valid is not None
                                     and valid.device != rows.device):
        raise ValueError(f"all inputs must be on {rows.device}")
    b, c = rows.shape
    if n >= 2 ** 30 or b >= 2 ** 31:
        raise ValueError(f"{b} rows into {n} outputs do not fit the "
                         "kernel's int32 keys and row lists")
    out = torch.empty((n, c), dtype=torch.float32, device=rows.device)
    if n == 0 or c == 0:
        return out
    idx = idx.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    stream = _build.stream(rows.device)
    ws = _workspace(rows.device, stream, n, b)
    try:
        _build.launch("rank_sum", "rank_sum", _ARGTYPES, (
            rows.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            None if valid is None else valid.data_ptr(),
            int(drop_zero_rows), b, n, c, out.data_ptr(),
            *(ws[k].data_ptr() for k in ("keys", "list", "tmp", "cnt",
                                         "seg", "cur", "big", "total")),
            stream))
    except RuntimeError:
        # a stage that did not launch leaves cnt short of zeros
        _workspaces.pop((rows.device.index, stream), None)
        raise
    launch_counts[job] += 1
    return out


def _workspace(device: torch.device, stream: int, n: int, b: int) -> dict:
    """This stream's workspace with room for ``n`` keys and ``b`` rows:
    ``cnt`` [n] zeroed where it is made (the kernels leave it zero), the
    rest made with torch.empty; each part made anew, larger, when a call
    needs more."""
    ws = _workspaces.setdefault((device.index, stream), {})
    i32 = dict(dtype=torch.int32, device=device)
    if "cnt" not in ws or ws["cnt"].shape[0] < n:
        ws.update(cnt=torch.zeros(n, **i32), seg=torch.empty(2 * n, **i32),
                  cur=torch.empty(n, **i32), big=torch.empty(n, **i32),
                  total=torch.empty(2, **i32))
    if "keys" not in ws or ws["keys"].shape[0] < b:
        m = max(b, 1)
        ws.update(keys=torch.empty(m, **i32), list=torch.empty(m, **i32),
                  tmp=torch.empty(m, **i32))
    return ws


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
    order. A CUDA tensor's all-zero rows are dropped in the kernel (the
    same bits: see the module's docstring), counted under
    ``rank_sum_gather``; a CPU tensor's sum is :func:`rank_sum_ref` of
    every row."""
    rows = g.reshape(-1, g.shape[-1]).contiguous()
    idx = idx.reshape(-1)
    if rows.device.type == "cpu":
        return rank_sum_ref(rows, idx, n)
    return launch(rows, idx, n, job="rank_sum_gather", drop_zero_rows=True)


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
