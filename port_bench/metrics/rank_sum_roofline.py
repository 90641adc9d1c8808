"""The row sum's share of its roofline: the bound of the traced steps'
calls (each seg backward's rows and each fire's gather backward rows read
once, the outputs written once; ``harness/work.py``) over the device
seconds of its four stages (``csrc/rank_sum.cu``)."""

from port_bench.harness import trace, work

SYMBOLS = ("rank_sum_sum_kernel", "rank_sum_count_kernel",
           "rank_sum_alloc_kernel", "rank_sum_fill_kernel")


def read(ctx):
    win = ctx["trace"]
    if win is None:
        return None
    seconds, records = trace.kernel_seconds(win, SYMBOLS)
    if not records:
        return None
    return 100.0 * work.rank_sum_bound_s(ctx) / seconds
