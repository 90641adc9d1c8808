"""Scatter lab: backward-scatter variants on the lab's shapes, on the card.

The port's counterpart of ``scripts/scatter_lab.py``. The fused
dpacked + absgrad scatter ends every compositor backward: rows of the
two-level frame ([T, K1, 8] and [t2, K2, 8] slot gradients, with
|d means2d| as two more columns) added into per-Gaussian rows by depth
rank. The JAX lab prices row count and layout for XLA's scatter; here
each variant is ``index_add_`` into ``[N + 1, C]`` zeros cut to N rows
(the counterpart of ``.at[idx].add(mode="drop")``: index N is the drop
row), and G is the port's production row sum:

  A  concat L1+L2 frames -> one add of T*K1 + t2*K2 rows, 10 columns
  B  two adds (L1, then L2) into one block
  C  8-column rows (no absgrad columns): column-width sensitivity
  D  16-column rows (10 padded to 16): alignment sensitivity
  E  the L2 frame compacted by the bin-time counts (valid slots only)
     into P2cap rows, then one add of T*K1 + P2cap rows
  F  both frames compacted, P1cap + P2cap rows
  G  sort + permute + segment sum: ``ops/rank_sum.rank_sum`` (the
     ``rank_sum`` kernel after a stable ``torch.sort`` on the card), and
     ``G_plain``, its plain version ``rank_sum_ref``

The scene is the JAX lab's (:32-38, :53-64): 20000 random Gaussians at
800x800, f = 1111, tile 16, K1 128, K2 384, t2 625, 64 tiles a Gaussian
at most, binned by the port's ``ops/tiles.bin_gaussians_two_level``, and
random backward rows ``dg1`` [T,K1,8], ``dg2`` [t2,K2,8] from the same
generator. A slot past its tile's count decodes to a clipped rank (the
JAX lab's too), so A-F add those rows where they land; G passes the
slots' validity, as the compositors' backward does, and drops them. Each
variant is timed by ``torch_common.measure`` (``ms`` by CUDA events,
``device_ms``, ``launches``) on those rows; its error is taken on the
masked rows (slots past each tile's count zeroed in both frames, as the
JAX lab masks L2 for E) against A on the rows the variant keeps, relative
to that reference's max-abs: E and F keep the first P2cap (and P1cap)
valid slots, and at the JAX lab's own scene level 2 holds 141904 valid
slots for a P2cap of 32768, so E and F drop the rest (``dropped_rows``)
and add less than A does. ``repeat_bits`` says whether two calls on the
same rows give the same bits (``index_add_`` adds with float atomics on
the card, the row sum in row order). Prints a table and last a JSON
object of it.

Usage: python scripts/torch_scatter_lab.py [--device cuda|cpu]

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain versions. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from torch_common import card, measure, resolve_device

from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.ops.rank_sum import rank_sum, rank_sum_ref
from edgegaussians_tpu_torch.ops.tiles import bin_gaussians_two_level

# scatter_lab.py:32-38 and the compaction caps of E and F (:129, :168)
N = 20000
W = H = 800
TILE = 16
K1 = 128
K2 = 384
T2 = 625
M = 64
P2CAP = 32768
P1CAP = 262144
REPS = 30                   # calls a timing block, as the JAX lab times


def lab_scene(n: int = N, width: int = W, height: int = H,
              tile: int = TILE, k1: int = K1, k2: int = K2, t2: int = T2,
              m: int = M, device=torch.device("cpu")) -> dict:
    """The JAX lab's scene (:53-64) at these sizes: the Gaussians, their
    two-level bins and the random backward rows, drawn in the JAX lab's
    order from ``default_rng(0)``."""
    r = np.random.default_rng(0)
    means = (r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
             + np.array([0, 0, 2.0], np.float32))
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.003), np.log(0.03),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.2, 0.95, n).astype(np.float32)
    f = 1111.0
    K = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    vm = torch.eye(4, device=device)

    def t(a):
        return torch.from_numpy(a).to(device)

    with torch.no_grad():
        proj = project_gaussians(t(means), t(quats), t(scales), t(opac), vm,
                                 K, width, height)
        bins = bin_gaussians_two_level(proj, width, height, tile, k1, k2, t2,
                                       max_tiles_per_gaussian=m)
    T = bins.ranks1.shape[0]
    dg1 = t(r.normal(size=(T, k1, 8)).astype(np.float32))
    dg2 = t(r.normal(size=(t2, k2, 8)).astype(np.float32))
    return {"n": n, "k1": k1, "k2": k2, "t2": t2, "bins": bins,
            "dg1": dg1, "dg2": dg2}


def slot_masks(sc: dict, cap1=None, cap2=None):
    """[T,K1,1] and [t2,K2,1] float masks of the slots inside each tile's
    count (the JAX lab's ``v2`` at :156-161, and its level-1 twin); with a
    compaction cap, of the first ``cap`` such slots in slot order, those
    that E and F keep."""
    b = sc["bins"]
    out = []
    for counts, k, cap in ((b.counts1, sc["k1"], cap1),
                           (b.counts2, sc["k2"], cap2)):
        kk = torch.arange(k, device=counts.device)[None, :]
        m = kk < counts[:, None]
        if cap is not None:
            base = torch.cumsum(counts, 0) - counts
            m &= base[:, None] + kk < cap
        out.append(m.to(torch.float32)[..., None])
    return tuple(out)


def add_rows(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``rows`` added by ``idx`` into [n, C]; index n is dropped."""
    acc = rows.new_zeros((n + 1, rows.shape[1]))
    return acc.index_add_(0, idx, rows)[:n]


def compaction(counts: torch.Tensor, ranks: torch.Tensor, k: int, cap: int,
               n: int):
    """The first ``cap`` valid slots of a frame in slot order, found from
    the bin-time counts (scatter_lab.py:130-143): (each one's flat frame
    slot, its rank, n for the entries past the valid ones)."""
    csum = torch.cumsum(counts.to(torch.int64), 0)
    jj = torch.arange(cap, dtype=torch.int64, device=counts.device)
    tile_of = torch.clamp(torch.searchsorted(csum, jj, right=True),
                          max=counts.shape[0] - 1)
    base = torch.where(tile_of > 0, csum[torch.clamp(tile_of - 1, min=0)],
                       0)
    src = tile_of * k + (jj - base)
    valid = jj < csum[-1]
    src = torch.where(valid, src, 0)
    return src, torch.where(valid, ranks.reshape(-1)[src], n)


def variants(sc: dict, p1cap: int = P1CAP, p2cap: int = P2CAP) -> dict:
    """name -> (label, fn(dg1, dg2) -> the per-Gaussian rows, the caps of
    the slots it keeps: (level 1's, level 2's), None for all)."""
    b, n = sc["bins"], sc["n"]
    v1, v2 = slot_masks(sc)
    valid = torch.cat([v1.reshape(-1), v2.reshape(-1)]) > 0
    ranks1, ranks2 = b.ranks1, b.ranks2
    T = ranks1.shape[0]
    src2, idx2c = compaction(b.counts2, ranks2, sc["k2"], p2cap, n)
    src1, idx1c = compaction(b.counts1, ranks1, sc["k1"], p1cap, n)

    def with_abs(g):
        return torch.cat([g, g[..., 3:5].abs()], -1).reshape(-1, 10)

    def all_idx():
        return torch.cat([ranks1.reshape(-1), ranks2.reshape(-1)])

    def var_a(dg1, dg2):
        return add_rows(torch.cat([with_abs(dg1), with_abs(dg2)]),
                        all_idx(), n)

    def var_b(dg1, dg2):
        acc = dg1.new_zeros((n + 1, 10))
        acc.index_add_(0, ranks1.reshape(-1), with_abs(dg1))
        return acc.index_add_(0, ranks2.reshape(-1), with_abs(dg2))[:n]

    def var_c(dg1, dg2):
        return add_rows(torch.cat([dg1.reshape(-1, 8), dg2.reshape(-1, 8)]),
                        all_idx(), n)

    def var_d(dg1, dg2):
        def pad(g):
            z = g.new_zeros(g.shape[:-1] + (6,))
            return torch.cat([g, g[..., 3:5].abs(), z], -1).reshape(-1, 16)
        return add_rows(torch.cat([pad(dg1), pad(dg2)]), all_idx(), n)

    def var_e(dg1, dg2):
        rows2 = dg2.reshape(-1, 8)[src2]
        rows = torch.cat([with_abs(dg1), with_abs(rows2)])
        return add_rows(rows, torch.cat([ranks1.reshape(-1), idx2c]), n)

    def var_f(dg1, dg2):
        rows1 = dg1.reshape(-1, 8)[src1]
        rows2 = dg2.reshape(-1, 8)[src2]
        rows = torch.cat([with_abs(rows1), with_abs(rows2)])
        return add_rows(rows, torch.cat([idx1c, idx2c]), n)

    # the slots' validity, as the compositors' backward passes it
    # (composite.scatter_slot_grads)
    def var_g(dg1, dg2):
        return rank_sum(torch.cat([with_abs(dg1), with_abs(dg2)]),
                        all_idx(), n, valid)

    def var_g_plain(dg1, dg2):
        return rank_sum_ref(torch.cat([with_abs(dg1), with_abs(dg2)]),
                            all_idx(), n, valid)

    rows_l2 = ranks2.numel()
    every = (None, None)
    return {
        "A": ("current fused 10-col scatter", var_a, every),
        "B": ("two separate scatters", var_b, every),
        "C": ("8-col scatter", var_c, every),
        "D": ("16-col scatter", var_d, every),
        "E": (f"L2 compacted ({T * sc['k1']}+{p2cap} rows; L2 "
              f"{rows_l2} slots)", var_e, (None, p2cap)),
        "F": (f"both compacted ({p1cap}+{p2cap} rows)", var_f,
              (p1cap, p2cap)),
        "G": ("sort+permute+segment sum (ops/rank_sum.rank_sum)", var_g,
              every),
        "G_plain": ("its plain version (rank_sum_ref: one index_add_)",
                    var_g_plain, every),
    }


def errors(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |got - ref| over the columns a variant shares with A (C has the
    first 8; D's 6 padding columns must stay zero)."""
    if name == "C":
        return float((got - ref[:, :8]).abs().max())
    if name == "D":
        if bool(got[:, 10:].any()):
            raise AssertionError("D: its padding columns are not zero")
        got = got[:, :10]
    return float((got - ref).abs().max())


def scatter_lab(device, reps: int = REPS, sizes: dict = None,
                p1cap: int = P1CAP, p2cap: int = P2CAP) -> dict:
    sc = lab_scene(device=device, **(sizes or {}))
    b = sc["bins"]
    T = b.ranks1.shape[0]
    head = {"T": T, "K1": sc["k1"], "t2": sc["t2"], "K2": sc["k2"],
            "rows": T * sc["k1"] + sc["t2"] * sc["k2"],
            "counts1_sum": int(b.counts1.sum()),
            "counts2_sum": int(b.counts2.sum()), "p1cap": p1cap,
            "p2cap": p2cap}
    print(" ".join(f"{k}={v}" for k, v in head.items()))
    dg1, dg2 = sc["dg1"], sc["dg2"]
    v1, v2 = slot_masks(sc)
    m1, m2 = dg1 * v1, dg2 * v2
    valid = int(v1.sum() + v2.sum())
    table = variants(sc, p1cap, p2cap)
    var_a = table["A"][1]
    with torch.no_grad():
        ref_max = float(var_a(m1, m2).abs().max())
        out = {}
        for name, (label, fn, caps) in table.items():
            timing, _ = measure(lambda: fn(dg1, dg2), device, reps)
            k1, k2 = slot_masks(sc, *caps)
            ref = var_a(dg1 * k1, dg2 * k2)
            first, second = fn(m1, m2), fn(m1, m2)
            err = errors(name, first, ref)
            row = {"label": label, **timing, "max_err": err,
                   "rel_err": err / max(float(ref.abs().max()), 1e-30),
                   "dropped_rows": valid - int(k1.sum() + k2.sum()),
                   "repeat_bits": bool(torch.equal(first, second))}
            out[name] = row
            dev = row["device_ms"]
            print(f"{name:8s} {label:52s} {row['ms']:8.3f} ms  device "
                  + ("-" if dev is None else f"{dev:.4f}")
                  + f" ms  err {err:.2e}  dropped {row['dropped_rows']}  "
                  f"same bits twice {row['repeat_bits']}", flush=True)
    return {**head, "ref_max_abs": ref_max, "variants": out,
            "platform": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(scatter_lab(device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
