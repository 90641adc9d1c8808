"""The work a window's steps need, from the counts a run takes with the
benchmark's own plain projection and tiles (``reference.count_work``) at
the window's start and end, and the bounds of the kernels that do it."""

from __future__ import annotations

from . import peaks


def epochs(ctx) -> float:
    """Epochs of the window (each takes every view once)."""
    return ctx["view_steps"] / len(ctx["evals"])


def flops(ctx) -> float:
    """FLOPs the window's steps need: every pair-pixel evaluation whose
    transmittance is still >= 1e-4, forward and backward, and on fired
    steps the kNN's live queries x live keys."""
    per_eval = peaks.FWD_OPS[0] + peaks.BWD_OPS[0]
    return (epochs(ctx) * sum(ctx["evals"]) * per_eval
            + ctx["fires"] * ctx["live"] ** 2 * peaks.KNN_OPS[0])


def seg_bound_s(ctx) -> float:
    """The seg forward's and backward's bounds over the window's steps."""
    return epochs(ctx) * sum(peaks.seg_bound_s(p, e, ctx["tiles"])
                             for p, e in zip(ctx["pairs"], ctx["evals"]))


def rank_sum_bound_s(ctx) -> float:
    """The row sum's bound over the window's steps: each view step's seg
    backward rows, and each fire's gather backward rows."""
    k = ctx["num_nn"]
    seg = epochs(ctx) * sum(
        peaks.bound_s(peaks.rank_sum_bytes(p, ctx["capacity"], ctx["budget"]),
                      p, (peaks.ROW_SUM_WIDTH, 0)) for p in ctx["pairs"])
    gather = ctx["fires"] * peaks.bound_s(
        peaks.gather_bytes(ctx["live"], k, ctx["capacity"]),
        ctx["live"] * k, (peaks.GATHER_WIDTH, 0))
    return seg + gather


def knn_bound_s(ctx) -> float:
    """The kNN's bound over the window's fires: live queries x live keys,
    the points and mask read and the neighbours written once."""
    return ctx["fires"] * peaks.bound_s(
        peaks.knn_bytes(ctx["capacity"], ctx["num_nn"] + 1),
        ctx["live"] ** 2, peaks.KNN_OPS)
