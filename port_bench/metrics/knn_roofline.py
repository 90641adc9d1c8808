"""The kNN's share of its roofline: live queries x live keys x 9 flops
and its bytes (``harness/work.py``) over the device seconds of
``knn_kernel`` (``csrc/knn.cu``) in the traced window. Nothing to read
where no step fired."""

from port_bench.harness import trace, work

SYMBOLS = ("knn_kernel",)


def read(ctx):
    win = ctx["trace"]
    if win is None or not ctx["fires"]:
        return None
    seconds, records = trace.kernel_seconds(win, SYMBOLS)
    if not records:
        return None
    return 100.0 * work.knn_bound_s(ctx) / seconds
