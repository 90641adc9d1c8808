"""The numbers the correctness check compares, and how they are read.

A side (the program, or a copy of the reference in another precision) is
held to the float64 reference over the first K view steps of set-up, all
from the same initial state, views and draws:

- ``loss``: the largest relative gap of a step's projection loss;
- ``grad``: the first step's gradient as Adam received it, read from each
  group's first moment after the step (m / (1 - beta1), the moments
  starting at zero): the worst group's gap of norms, over the larger of
  the reference's norm of that group and of the median group; a group
  whose reference gradient is under a thousandth of the median group's
  is zero to rounding (the quats of isotropic Gaussians) and is left
  out, here and in ``change``;
- ``absgrad``: the relative gap of the norms of the absgrad accumulators
  after the first step;
- ``change``: each group's change after K steps, by the worst group as
  ``grad`` is, without the groups ``grad`` leaves out (they would move
  by round-off alone);
- on cells whose window fires the orientation losses, where the K-th step
  is the first fire: ``moment``, the geometry groups' first moments after
  it, by the worst group (they carry the direction and ratio gradients,
  which Adam's normalised step hides in ``change``), and ``knn``, the
  share of live rows whose neighbour set differs from the reference's.

A side is a dict: ``losses`` (K floats), ``after_1`` and ``after_k`` (the
state after step 1 and step K, in :func:`program.snapshot`'s keys), and
``knn`` ([capacity or live, k] neighbour ids, or None).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

GROUPS = ("means", "scales", "quats", "opacities")
GEO = ("means", "scales", "quats")
B1 = 0.9
STILL = 1e-3          # a group's gradient under this share of the median's


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def worst(values) -> float:
    """The largest of ``values``, and NaN where any is NaN (Python's
    ``max`` keeps a NaN only where it comes first)."""
    values = list(values)
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values) if values else 0.0


def worst_gap(side: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              groups) -> float:
    r = {g: _norm(ref[g]) for g in groups}
    med = statistics.median(r.values())
    return worst(abs(_norm(side[g]) - r[g]) / max(r[g], med, 1e-300)
                 for g in groups)


def first_grads(after_1: Dict) -> Dict[str, torch.Tensor]:
    return {g: after_1["m_" + g].double() / (1 - B1) for g in GROUPS}


def readings(side: Dict, ref: Dict, init: Dict[str, torch.Tensor],
             fires: bool) -> Dict[str, float]:
    out = {"loss": worst(abs(a - b) / max(abs(b), 1e-300)
                         for a, b in zip(side["losses"], ref["losses"]))}
    g_side, g_ref = first_grads(side["after_1"]), first_grads(ref["after_1"])
    med = statistics.median(_norm(g_ref[g]) for g in GROUPS)
    moving = [g for g in GROUPS if _norm(g_ref[g]) >= STILL * med]
    out["grad"] = worst_gap(g_side, g_ref, moving)
    a_ref = _norm(ref["after_1"]["absgrads"])
    out["absgrad"] = abs(_norm(side["after_1"]["absgrads"]) - a_ref) / \
        max(a_ref, 1e-300)

    def change(s):
        return {g: s["after_k"][g].double() - init[g].double()
                for g in GROUPS}

    out["change"] = worst_gap(change(side), change(ref), moving)
    if fires:
        out["moment"] = worst_gap(
            {g: side["after_k"]["m_" + g] for g in GEO},
            {g: ref["after_k"]["m_" + g] for g in GEO}, GEO)
        out["knn"] = knn_mismatch(side["knn"], ref["knn"],
                                  ref["after_k"]["alive"])
    return out


def knn_mismatch(side: Optional[torch.Tensor], ref: torch.Tensor,
                 alive: torch.Tensor) -> float:
    """Share of live rows whose neighbour set differs. ``ref`` holds the
    live rows' sets in row order; ``side`` every row's or the live
    rows'. A side that fetched none reads 1."""
    if side is None:
        return 1.0
    if side.shape[0] != ref.shape[0]:
        side = side[torch.nonzero(alive.to(side.device)).squeeze(1)]
    a = torch.sort(side.to(ref.device), dim=1).values
    b = torch.sort(ref, dim=1).values
    return float((a != b).any(dim=1).double().mean())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number without a limit, a limit
    without a number, or a NaN, fails)."""
    return (set(numbers) == set(limits)
            and all(numbers[k] <= limits[k] for k in numbers))
