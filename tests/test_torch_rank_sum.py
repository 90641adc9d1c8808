"""The deterministic per-Gaussian row sum of the compositors' backwards
(edgegaussians_tpu_torch/ops/rank_sum.py) on the CPU, where it runs its
plain version; the Hopper kernel (csrc/rank_sum.cu) is held to it by
tests/test_torch_kernels.py, on a GPU.

- Against a float64 segment sum: each output element within
  (k - 1) * 2^-24 * sum |x| + 1e-30 of the exact sum of its k inputs, the
  error bound of k - 1 f32 additions in any order.
- The kernel's algebra, modelled on the CPU (a stable sort of the keys,
  then the head of each key's run adding the run in order), equals the
  plain version bit for bit: so the kernel, which makes the same f32
  additions, owes the CPU path its bits.
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


def _kernel_model(rows, idx, n, valid):
    """The kernel's walk on the CPU: keys sorted by a stable sort, then
    at the head of each key's run, 0 + r_0 + r_1 + ... in run order."""
    keys = torch.where(valid, idx, torch.full_like(idx, n))
    sk, perm = torch.sort(keys, stable=True)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32)
    heads = torch.nonzero(torch.cat([torch.ones(1, dtype=torch.bool),
                                     sk[1:] != sk[:-1]])).flatten()
    ends = torch.cat([heads[1:], torch.tensor([sk.shape[0]])])
    lens = ends - heads
    keep = sk[heads] < n
    heads, lens, key = heads[keep], lens[keep], sk[heads][keep]
    acc = torch.zeros((key.shape[0], rows.shape[1]), dtype=torch.float32)
    for j in range(int(lens.max()) if lens.numel() else 0):
        on = lens > j
        acc[on] = acc[on] + rows[perm[heads[on] + j]]
    out[key] = acc
    return out


CASES = {
    "collisions": dict(seed=0, b=4000, n=300),
    "sorted": dict(seed=1, b=3000, n=500, order="sorted"),
    "reverse": dict(seed=2, b=3000, n=500, order="reverse"),
    "shuffled": dict(seed=3, b=3000, n=500, order="shuffled"),
    "wide": dict(seed=4, b=20000, n=16384, c=10, spread=6.0),
    "no_drop": dict(seed=5, b=2000, n=64, drop=0.0),
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


@pytest.mark.parametrize("name", list(CASES))
def test_rank_sum_kernel_model_is_the_plain_version_bit_for_bit(name):
    rows, idx, valid = _case(**CASES[name])
    n = CASES[name]["n"]
    plain = rank_sum_ref(rows, idx, n, valid)
    model = _kernel_model(rows, idx, n, valid)
    assert torch.equal(plain.view(torch.int32), model.view(torch.int32))


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
