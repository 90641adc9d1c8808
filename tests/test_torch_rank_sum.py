"""The deterministic per-Gaussian row sum of the compositors' backwards
(edgegaussians_tpu_torch/ops/rank_sum.py) on the CPU, where it runs its
plain version; the Hopper kernel (csrc/rank_sum.cu) is held to it by
tests/test_torch_kernels.py, on a GPU.

- Against a float64 segment sum: each output element within
  (k - 1) * 2^-24 * sum |x| + 1e-30 of the exact sum of its k inputs, the
  error bound of k - 1 f32 additions in any order.
- The kernel's algebra, modelled on the CPU (a count of each key's rows,
  a segment a key, the segments filled in a random order, each segment
  put back in row order as the kernel does, then added in that order),
  equals the plain version bit for bit, also on one key of 5000 rows,
  one output, every row dropped, no rows, and the gather's all-zero and
  NaN rows: so the kernel, which makes the same f32 additions, owes the
  CPU path its bits.
- At the three call sites (``segpair.pair_grads_to_packed``,
  ``composite.scatter_slot_grads``, ``composite.pair_prefix_grads``),
  dpacked and dsink equal what the ``index_add_`` they replaced gave,
  bit for bit (``torch.equal``: a dropped zero row can turn -0 into +0).
  The parity tests of those paths against the JAX package
  (tests/test_torch_segpair.py, test_torch_pair.py, test_torch_dense.py,
  test_torch_prefix.py, test_torch_raster_v1.py, test_torch_trajectory.py)
  run through them unchanged.
"""

import numpy as np
import pytest
import torch

from edgegaussians_tpu_torch.ops import composite, pair, segpair, tiles
from edgegaussians_tpu_torch.ops.projection import project_gaussians
from edgegaussians_tpu_torch.ops.rank_sum import rank_sum, rank_sum_ref

torch.set_num_threads(2)

U32 = 2.0 ** -24


def _case(seed, b, n, c=10, order="random", drop=0.2, spread=3.0):
    """(rows [b,c] f32 over ~6 decades, idx [b] int64 in [0, n], valid
    [b]): a quarter of the outputs get no row; ``order`` "sorted",
    "reverse" or "shuffled" gives the rows by key in that order."""
    r = np.random.default_rng(seed)
    live = r.choice(n, size=max(1, (3 * n) // 4), replace=False)
    idx = live[r.integers(0, live.shape[0], b)]
    idx[r.random(b) < 0.05] = n                    # the drop row
    if order == "sorted":
        idx = np.sort(idx)
    elif order == "reverse":
        idx = np.sort(idx)[::-1].copy()
    elif order == "shuffled":
        idx = r.permutation(np.sort(idx))
    rows = (r.standard_normal((b, c))
            * np.exp(r.uniform(-spread, spread, (b, 1)) * np.log(10)))
    valid = r.random(b) >= drop
    return (torch.from_numpy(rows.astype(np.float32)),
            torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(valid))


def _oracle(rows, idx, n, valid):
    """float64 segment sum of the kept rows, and the bound of each output
    element: (count - 1) * 2^-24 * sum |x|."""
    keep = valid & (idx < n)
    x = rows[keep].double()
    k = idx[keep]
    total = torch.zeros((n, rows.shape[1]), dtype=torch.float64)
    total.index_add_(0, k, x)
    mag = torch.zeros_like(total).index_add_(0, k, x.abs())
    count = torch.zeros(n, dtype=torch.float64).index_add_(
        0, k, torch.ones_like(k, dtype=torch.float64))
    bound = (torch.clamp(count - 1, min=0)[:, None] * U32 * mag + 1e-30)
    return total, bound


# csrc/rank_sum.cu's constants: keys a CTA of the alloc stage, runs one
# lane orders and adds, runs a warp orders in registers, radix bits a pass
ALLOC_KEYS = 1024
THREAD_RUN = 8
SHORT_RUN = 32
RADIX_BITS = 8


def _order_run(seg):
    """The sum stage's ordering of one key's row numbers (distinct): up to
    THREAD_RUN rows, an odd-even transposition network over THREAD_RUN
    slots padded with INT_MAX; up to SHORT_RUN, each row put at its rank,
    the count of smaller rows; past that, stable LSD radix passes of
    RADIX_BITS bits over (row - least row), each a stable partition by its
    digit."""
    n = seg.shape[0]
    if n <= THREAD_RUN:
        v = np.full(THREAD_RUN, np.iinfo(np.int32).max, np.int64)
        v[:n] = seg
        for rnd in range(THREAD_RUN):
            for q in range(rnd & 1, THREAD_RUN - 1, 2):
                v[q], v[q + 1] = min(v[q], v[q + 1]), max(v[q], v[q + 1])
        return v[:n]
    if n <= SHORT_RUN:
        out = np.empty_like(seg)
        out[(seg[None, :] < seg[:, None]).sum(1)] = seg
        return out
    lo = int(seg.min())
    for shift in range(0, int(seg.max() - lo).bit_length(), RADIX_BITS):
        digit = ((seg - lo) >> shift) & ((1 << RADIX_BITS) - 1)
        seg = seg[np.argsort(digit, kind="stable")]
    return seg


def _kernel_model(rows, idx, n, valid, drop_zero=False, seed=0):
    """The kernel's four stages on the CPU: (1) count each kept row's key;
    (2) give each key a segment of that many slots, the alloc stage's CTAs
    of ALLOC_KEYS keys taking theirs in a seeded random order, as their
    atomics on the running total may; (3) fill each segment with its rows'
    numbers, the kept rows arriving in a seeded random order; (4) order
    each segment as the sum stage does, then add its rows in that order,
    0 + r_0 + r_1 + ..., one f32 add at a time (zeros where a key has no
    row)."""
    r = np.random.default_rng(seed)
    i = idx.numpy().astype(np.int64)
    keep = (i >= 0) & (i < n)
    if valid is not None:
        keep &= valid.numpy()
    if drop_zero:
        keep &= (rows.numpy() != 0).any(1)
    keys = np.where(keep, i, n)
    cnt = np.bincount(keys[keep], minlength=n)                    # (1)
    start = np.empty(n, np.int64)                                 # (2)
    total = 0
    for blk in r.permutation(-(-n // ALLOC_KEYS)):
        part = slice(blk * ALLOC_KEYS, (blk + 1) * ALLOC_KEYS)
        start[part] = total + np.cumsum(cnt[part]) - cnt[part]
        total += int(cnt[part].sum())
    arrived = r.permutation(np.flatnonzero(keep))                 # (3)
    k = keys[arrived]
    by_key = np.argsort(k, kind="stable")
    ks = k[by_key]
    within = np.arange(ks.shape[0]) - np.searchsorted(ks, ks)
    slots = np.empty(total, np.int64)
    slots[start[ks] + within] = arrived[by_key]
    for key in np.flatnonzero(cnt):                               # (4)
        run = slice(start[key], start[key] + cnt[key])
        slots[run] = _order_run(slots[run])
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32)
    lens = torch.from_numpy(cnt)
    first = torch.from_numpy(start)
    order = torch.from_numpy(slots)
    for j in range(int(cnt.max()) if n and total else 0):
        on = lens > j
        out[on] = out[on] + rows[order[first[on] + j]]
    return out


def _gather_case(seed=9, b=6000, n=400, c=3):
    """Gather-backward rows: a third all +0 or -0 (the dead query rows'
    cotangents), a few NaN; one output reached by -0 rows alone, one by a
    NaN row."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, n - 2, b)
    rows = r.standard_normal((b, c)).astype(np.float32)
    dead = r.random(b) < 0.35
    rows[dead] = np.where(r.random((int(dead.sum()), c)) < 0.5, 0.0, -0.0)
    idx[:5], rows[:5] = n - 2, -0.0
    idx[5], rows[5, 1] = n - 1, np.nan
    rows[r.choice(b, 7, replace=False), r.integers(0, c, 7)] = np.nan
    return torch.from_numpy(rows), torch.from_numpy(idx)


def _edge_case(name):
    """(rows, idx, n, valid, drop_zero) of the edge cases the kernel's
    paths must get right: runs past the shared-memory sort (one key of
    5000 rows) and inside it (~130 rows a key), one output, every row
    dropped, no rows, and the gather's zero and NaN rows."""
    if name == "gather_zeros_nan":
        rows, idx = _gather_case()
        return rows, idx, 400, None, True
    spec = EDGE_CASES[name]
    rows, idx, valid = _case(spec["seed"], spec["b"], spec["n"],
                             drop=spec.get("drop", 0.2))
    if "key" in spec:
        idx = torch.full_like(idx, spec["key"])
    return rows, idx, spec["n"], valid, False


CASES = {
    "collisions": dict(seed=0, b=4000, n=300),
    "sorted": dict(seed=1, b=3000, n=500, order="sorted"),
    "reverse": dict(seed=2, b=3000, n=500, order="reverse"),
    "shuffled": dict(seed=3, b=3000, n=500, order="shuffled"),
    "wide": dict(seed=4, b=20000, n=16384, c=10, spread=6.0),
    "no_drop": dict(seed=5, b=2000, n=64, drop=0.0),
}
EDGE_CASES = {
    "one_key_5000": dict(seed=10, b=5000, n=64, key=17, drop=0.0),
    "medium_runs": dict(seed=11, b=6000, n=48),
    "n_one": dict(seed=12, b=3000, n=1),
    "all_dropped": dict(seed=13, b=2000, n=100, drop=1.0),
    "empty": dict(seed=14, b=0, n=16),
    "gather_zeros_nan": None,
}


@pytest.mark.parametrize("name", list(CASES))
def test_rank_sum_plain_version_against_a_float64_oracle(name):
    rows, idx, valid = _case(**CASES[name])
    n = CASES[name]["n"]
    got = rank_sum(rows, idx, n, valid)
    assert got.shape == (n, rows.shape[1]) and got.dtype == torch.float32
    total, bound = _oracle(rows, idx, n, valid)
    assert bool(((got.double() - total).abs() <= bound).all())
    # outputs no kept row reaches are exact zeros
    reached = torch.zeros(n, dtype=torch.bool)
    reached[idx[valid & (idx < n)]] = True
    assert int((~reached).sum()) > 0 and bool((got[~reached] == 0).all())


@pytest.mark.parametrize("name", list(CASES) + list(EDGE_CASES))
def test_rank_sum_kernel_model_is_the_plain_version_bit_for_bit(name):
    """The model of the kernel's stages, its atomics' order drawn from two
    seeds, gives the plain version's bits; the gather's case drops its
    all-zero rows as the kernel does, the plain version adds every row."""
    if name in CASES:
        rows, idx, valid = _case(**CASES[name])
        n, drop_zero = CASES[name]["n"], False
    else:
        rows, idx, n, valid, drop_zero = _edge_case(name)
    plain = rank_sum_ref(rows, idx, n, None if drop_zero else valid)
    assert plain.shape == (n, rows.shape[1])
    for seed in (0, 1):
        model = _kernel_model(rows, idx, n, valid, drop_zero, seed)
        assert torch.equal(plain.view(torch.int32), model.view(torch.int32))


def test_rank_sum_stages_are_the_kernels_of_its_source():
    """ops/rank_sum.STAGES names csrc/rank_sum.cu's kernels, each once, in
    the order its entry launches them."""
    import re
    from edgegaussians_tpu_torch.ops import _build, rank_sum as rs
    src = (_build.CSRC / "rank_sum.cu").read_text()
    defined = re.findall(r"^(rank_sum_\w+_kernel)\(", src, re.M)
    launched = re.findall(r"^\s+(rank_sum_\w+_kernel)<<<", src, re.M)
    assert sorted(defined) == sorted(rs.STAGES)
    assert tuple(launched) == rs.STAGES


def test_rank_sum_drop_row_and_no_valid_mask():
    """Without ``valid``, the index n drops a row; an empty input gives
    zeros."""
    rows, idx, _ = _case(6, 1000, 40)
    assert bool((idx == 40).any())
    got = rank_sum(rows, idx, 40)
    keep = idx < 40
    torch.testing.assert_close(got, rank_sum(rows[keep], idx[keep], 40),
                               rtol=0, atol=0)
    empty = rank_sum(rows[:0], idx[:0], 7)
    assert empty.shape == (7, 10) and bool((empty == 0).all())


def _old_index_add(rows, idx, n, extra_row=False):
    acc = rows.new_zeros((n + int(extra_row), rows.shape[1]))
    acc.index_add_(0, idx, rows)
    return acc[:n]


def _scene(seed=0, n=300, w=64, h=48):
    r = np.random.default_rng(seed)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] = 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.08),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.05, 0.9, n).astype(np.float32)
    K = np.array([[55.0, 0, w / 2], [0, 55.0, h / 2], [0, 0, 1]], np.float32)
    args = [torch.from_numpy(x) for x in (means, quats, scales, opac,
                                          np.eye(4, dtype=np.float32), K)]
    return project_gaussians(*args, w, h), w, h


def test_seg_and_pair_sites_give_the_old_index_add_bits():
    """pair_grads_to_packed (seg and v4 tables): the invalid pairs' rows
    (zeros, ranks clipped into range) no longer enter the sum; the result
    is index_add_'s over every row."""
    proj, w, h = _scene()
    packed = tiles.pack_gaussian_render_data(proj)
    n = packed.shape[0]
    origins = tiles.tile_origins(w, h, 16)
    for block in (0, pair.BLOCK_TILES):
        pb = tiles.bin_pairs_frame_order(proj, w, h, 16, 128, 2048,
                                         block_tiles=block)
        src, ox, oy = segpair.pair_inputs(packed[pb.order], pb, origins)
        assert int((~pb.pair_valid).sum()) > 0
        r = np.random.default_rng(block)
        dfeats = torch.from_numpy(r.standard_normal(
            (src.shape[0], 8)).astype(np.float32))
        dpacked, dsink = segpair.pair_grads_to_packed(dfeats, src, ox, oy,
                                                      pb, n)
        d = torch.where(pb.pair_valid[:, None], dfeats,
                        torch.zeros_like(dfeats))
        dsrc = segpair.build_pair_features_vjp(src, ox, oy, d)
        acc = _old_index_add(torch.cat([dsrc, dsrc[:, 3:5].abs()], -1),
                             pb.pair_ranks, n)
        assert torch.equal(dpacked, acc[:, :8])
        old_sink = torch.zeros((n, 2))
        old_sink[pb.order] = acc[:, 8:10]
        assert torch.equal(dsink, old_sink)


@pytest.mark.parametrize("pair_budget", [0, 2048])
def test_dense_sites_give_the_old_index_add_bits(pair_budget):
    """scatter_slot_grads (decoded two-level frame: invalid slots' zero
    rows dropped) and pair_prefix_grads (pairs past the frame on the drop
    row n) against the index_add_ each replaced."""
    proj, w, h = _scene(seed=1)
    packed = tiles.pack_gaussian_render_data(proj)
    n = packed.shape[0]
    k1, k2, t2 = 16, 32, 3
    bins2 = tiles.bin_gaussians_two_level(
        proj, w, h, 16, k1, k2, t2, occupancy_sort=True,
        pair_budget=pair_budget)
    origins_f = tiles.tile_origins(w, h, 16)[bins2.tile_perm]
    fr = composite.two_level_frame(packed[bins2.order], bins2, origins_f,
                                   k1, k2)
    r = np.random.default_rng(pair_budget)
    d1 = torch.from_numpy(r.standard_normal(fr.feats1.shape)
                          .astype(np.float32)) * fr.validf1[..., None]
    d2 = torch.from_numpy(r.standard_normal(fr.feats2.shape)
                          .astype(np.float32)) * fr.validf2[..., None]
    dg1 = composite.tile_features_vjp(fr.g1, origins_f, fr.validf1, d1)
    dg2 = composite.tile_features_vjp(fr.g2, fr.origins2, fr.validf2, d2)
    if pair_budget:
        dpacked, dsink = composite.pair_prefix_grads(dg1, dg2, bins2, n)
        frame = torch.cat([dg1.reshape(-1, 8), dg2.reshape(-1, 8)])
        rows8 = frame[torch.clamp(bins2.pair_rows, 0, frame.shape[0] - 1)]
        idx = torch.where(bins2.pair_rows < frame.shape[0],
                          bins2.pair_ranks, n)
        assert bool((idx == n).any())
        acc = _old_index_add(torch.cat([rows8, rows8[:, 3:5].abs()], -1),
                             idx, n, extra_row=True)
    else:
        levels = [(dg1, fr.validf1, bins2.ranks1),
                  (dg2, fr.validf2, bins2.ranks2)]
        dpacked, dsink = composite.scatter_slot_grads(levels, bins2.order, n)
        rows = torch.cat([torch.cat([dg, dg[..., 3:5].abs() * vf[..., None]],
                                    -1).reshape(-1, 10)
                          for dg, vf, _ in levels])
        assert bool((torch.cat([fr.validf1.reshape(-1),
                                fr.validf2.reshape(-1)]) == 0).any())
        acc = _old_index_add(rows, torch.cat([rk.reshape(-1)
                                              for _, _, rk in levels]), n)
    assert torch.equal(dpacked, acc[:, :8])
    old_sink = torch.zeros((n, 2))
    old_sink[bins2.order] = acc[:, 8:10]
    assert torch.equal(dsink, old_sink)
