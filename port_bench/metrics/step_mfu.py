"""The traced window's FLOPs (``harness/work.py``) over the seconds in
which the device was busy (the union of its activity intervals in the
trace), as a share of the card's float32 peak: how much of its peak the
device reaches while it works on the step. It bounds what the kernels'
rooflines can claim once a kernel leaves the path."""

from port_bench.harness import peaks, work


def read(ctx):
    win = ctx["trace"]
    if win is None or win.busy_s <= 0:
        return None
    return 100.0 * work.flops(ctx) / win.busy_s / peaks.F32_FLOPS
