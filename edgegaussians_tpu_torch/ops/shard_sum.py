"""The shard-sum probe: ``shard_sum2x(x [rows,128]) -> [1,128] = 2 * sum_i
x[i, :]``, the counterpart of the Pallas probe kernel of
``tests/test_vma.py:205`` and ``scripts/vma_pallas_repro.py:52``.

In the JAX package the probe sits inside a ``shard_map`` over a 'tiles'
axis: every device reduces its shard in a ``fori_loop``, then one ``psum``
gives the whole array's row. It pinned the double-reduction bug class of
sharded steps (a gradient psum'd twice came out 4x on a 4-way mesh,
train_dp.py:134-139). Here each rank runs :func:`shard_sum2x` on its shard
and one ``all_reduce`` (SUM) follows
(``parallel/distributed.sharded_sum2x``); the result must be the whole
array's, not ``world`` times it.

Two implementations, chosen by the device of the input:

- ``csrc/shard_sum.cu`` for CUDA tensors: :func:`shard_sum2x` launches it
  or raises; each launch adds one to ``launch_counts``. One launch spreads
  the rows over the card in fixed blocks of :data:`ROWS_PER_CTA`, each
  CTA writing its partial row to a workspace, and the last CTA to finish
  (an integer ticket tells it) adds the partials in CTA order: no float
  atomics, the same bits on every launch, a summation order that depends
  on the row count alone. The workspace and the ticket are made once per
  (device, stream) and reused, so a call after the first is one launch
  and no fill;
- :func:`shard_sum2x_ref`, plain PyTorch, for CPU tensors, and the
  yardstick the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from edgegaussians_tpu_torch.ops import _build
from edgegaussians_tpu_torch.ops.segpair import check_tensor

KERNEL_SOURCE = "edgegaussians_tpu_torch/csrc/shard_sum.cu"
COLS = 128
# csrc/shard_sum.cu's order of the sum: rows in fixed blocks a CTA, warp w
# of WARPS adding rows w, w + WARPS, ... of its block, then a tree over the
# warps; the last CTA adds the partials in GROUPS contiguous groups, then a
# tree over the groups
ROWS_PER_CTA = 128
WARPS = 16
GROUPS = 16

# Launches of the kernel since the last reset_launch_counts(); only the
# kernel wrapper below adds to it.
launch_counts = {"shard_sum": 0}

# x; rows; out, partials; capacity; ticket, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)

# (device index, stream handle) -> [ticket (int32 [1], 0 between launches),
# partials (f32 [capacity, 128])]: one per stream, as two streams' launches
# may run at once
_workspaces = {}


def reset_launch_counts() -> None:
    launch_counts["shard_sum"] = 0


def shard_sum2x(x: torch.Tensor) -> torch.Tensor:
    """``x [rows, 128]`` f32 -> ``[1, 128]`` f32, twice the column sums.
    CUDA tensors launch the kernel; CPU tensors take
    :func:`shard_sum2x_ref`."""
    if x.device.type == "cpu":
        return shard_sum2x_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no shard_sum kernel for device {x.device}")
    if x.dim() != 2 or x.shape[1] != COLS:
        raise ValueError(f"x: expected [rows, {COLS}], got {tuple(x.shape)}")
    check_tensor("x", x, torch.float32, x.shape, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x: the kernel reads 16-byte vectors, so its data "
                         "must start on a 16-byte boundary")
    out = torch.empty((1, COLS), dtype=torch.float32, device=x.device)
    stream = _build.stream(x.device)
    ticket, partials = _workspace(x.device, stream, blocks(x.shape[0]))
    _build.launch("shard_sum", "shard_sum2x", _ARGTYPES,
                  (x.data_ptr(), x.shape[0], out.data_ptr(),
                   partials.data_ptr(), partials.shape[0], ticket.data_ptr(),
                   stream))
    launch_counts["shard_sum"] += 1
    return out


def blocks(rows: int) -> int:
    """The kernel's CTAs for ``rows`` rows: one per block of
    ROWS_PER_CTA, and one for no rows (it writes the zeros)."""
    return max(1, -(-rows // ROWS_PER_CTA))


def _workspace(device: torch.device, stream: int, n: int) -> list:
    """This stream's [ticket, partials] with room for ``n`` partials: the
    ticket zeroed once, at the stream's first call; the partials grown
    with torch.empty when a call needs more."""
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        ws = _workspaces[(device.index, stream)] = [
            torch.zeros(1, dtype=torch.int32, device=device), None]
    if ws[1] is None or ws[1].shape[0] < n:
        ws[1] = torch.empty((n, COLS), dtype=torch.float32, device=device)
    return ws


def shard_sum2x_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`shard_sum2x`."""
    return (2.0 * x).sum(0, keepdim=True)
