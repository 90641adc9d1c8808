"""The FLOPs the window's steps need (``harness/work.py``) over the
window's host seconds, as a share of the H100 SXM's 67 TFLOP/s of float32
outside the tensor cores."""

from port_bench.harness import peaks, work


def read(ctx):
    if ctx["trace"] is not None:
        return None
    return 100.0 * work.flops(ctx) / ctx["window_s"] / peaks.F32_FLOPS
