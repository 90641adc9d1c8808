"""The seg compositor's share of its roofline: the bound of the traced
steps' forward and backward (``harness/peaks.py``, on the benchmark's own
pair and evaluation counts) over the device seconds of their kernels
(``run_fwd_kernel``, ``segpair_bwd_kernel``; ``csrc/segpair.cu``)."""

from port_bench.harness import trace, work

SYMBOLS = ("run_fwd_kernel", "segpair_bwd_kernel")


def read(ctx):
    win = ctx["trace"]
    if win is None:
        return None
    seconds, records = trace.kernel_seconds(win, SYMBOLS)
    if not records:
        return None
    return 100.0 * work.seg_bound_s(ctx) / seconds
