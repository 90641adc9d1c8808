"""The card's published peaks and the work the step needs, frozen.

Copied from ``chip_smoke.py`` (its constants and ``bound_ms``), so that a
later change to the program cannot move the yardstick. The peaks are the
H100 SXM's from NVIDIA's data sheet, at its full 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the special-function units give 16 results per SM per clock against 128
# f32 FMA lanes: expf and the reciprocal run at F32_FLOPS / 16 a second
SFU_OPS = F32_FLOPS / 16
# per (pair, pixel) evaluation of the seg compositor: log alpha 1 mul + 5
# FMA (11 flops), guard, threshold, clamp, 1 - a, t * (1 - a), a * t, the
# sum (5) and one expf; the backward adds a * gt / (1 - a) (a reciprocal)
# and the six products and six sums of the per-pair reduction
FWD_OPS = (16, 1)            # (flops, special-function ops)
BWD_OPS = (29, 2)
# per (query, live key) of the kNN: 3 subs, 3 muls, 2 adds, the dead-key add
KNN_OPS = (9, 0)
PIXELS = 256                 # one 16 x 16 tile
PAIR_FEATURE_BYTES = 32      # a pair's eight f32 features
ROW_SUM_WIDTH = 10           # a seg backward row: d packed (8) + |d mean2d| (2)
GATHER_WIDTH = 3             # a gather backward row: d means


def bound_s(nbytes: float, evals: float, ops) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rates."""
    flops, sfu = ops
    return max(nbytes / HBM_BYTES_PER_S, evals * flops / F32_FLOPS,
               evals * sfu / SFU_OPS)


def seg_bound_s(pairs: float, evals: float, tiles: int) -> float:
    """The seg forward's and backward's bounds of one view, added: each
    reads the kept pairs' features, the run table, the basis and one
    [T,256] plane (the forward's output, the backward's cotangent) once,
    and the backward writes the pairs' gradients once."""
    common = pairs * PAIR_FEATURE_BYTES + (tiles + 1) * 4 + 8 * PIXELS * 4 \
        + tiles * PIXELS * 4
    return (bound_s(common, evals, FWD_OPS)
            + bound_s(common + pairs * PAIR_FEATURE_BYTES, evals, BWD_OPS))


def rank_sum_bytes(pairs: float, n: int, budget: int) -> float:
    """The seg backward's row sum: the pair-valid mask, each kept pair's
    row and its index read once, the [n, 10] output written once."""
    return (budget + pairs * (ROW_SUM_WIDTH * 4 + 8)
            + n * ROW_SUM_WIDTH * 4)


def gather_bytes(live: int, k: int, n: int) -> float:
    """The direction loss's gather backward: every [n*k, 3] cotangent row
    read once (to find the zero ones), the live rows' indices, the [n, 3]
    output written once."""
    return n * k * GATHER_WIDTH * 4 + live * k * 8 + n * GATHER_WIDTH * 4


def knn_bytes(n: int, k: int) -> float:
    """The kNN: the [n,3] points and the mask read once, [n,k] distances
    and indices written once."""
    return n * 12 + n + n * k * 12
