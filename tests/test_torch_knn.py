"""The port's kNN (edgegaussians_tpu_torch/ops/knn.py) held to the JAX
package's: ``knn`` on its XLA path (exact on the CPU) and ``knn_pallas``
in interpret mode, on the same NumPy clouds.

Tolerances, as tests/test_pallas_knn.py holds its kernel to the XLA path:
the port computes d^2 by direct differences, the XLA path by the
``|q|^2 + |p|^2 - 2 q.p`` expansion, so sorted distances agree within
rtol 3e-4, atol 3e-5, an index may differ only where the two candidates'
distances are within 2^-10 relative (a near-tie), and fewer than 1% of the
indices may differ. Dry slots (fewer than k live neighbours) are held by
their own rule: the port writes float32 max and index 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.ops.knn import knn as jknn
from edgegaussians_tpu.ops.pallas_knn import knn_pallas
from edgegaussians_tpu_torch.ops import knn as knn_mod

torch.set_num_threads(2)
F32_MAX = np.finfo(np.float32).max


def _cloud(n, seed, dead_every=0, nan_rows=()):
    r = np.random.default_rng(seed)
    pts = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    for i in nan_rows:
        pts[i, i % 3] = np.nan
    mask = np.ones(n, bool)
    if dead_every:
        mask[::dead_every] = False
    return pts, mask


def _assert_neighbor_parity(d_t, i_t, d_j, i_j, dry_ref):
    d_t, i_t = d_t.numpy(), i_t.numpy()
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    assert i_t.dtype == np.int64
    wet = ~dry_ref
    np.testing.assert_allclose(np.sort(np.where(wet, d_t, 0), 1),
                               np.sort(np.where(wet, d_j, 0), 1),
                               rtol=3e-4, atol=3e-5)
    neq = (i_t != i_j) & wet
    if neq.any():
        rel = np.abs(d_t[neq] - d_j[neq]) / np.maximum(d_j[neq], 1e-9)
        assert rel.max() <= 2 ** -10, rel.max()
        assert neq.sum() < 0.01 * wet.sum(), neq.mean()
    # dry slots: float32 max and index 0 in the port
    assert np.all(d_t[dry_ref] == F32_MAX) and np.all(i_t[dry_ref] == 0)


@pytest.mark.parametrize("k", [3, 6, 11, 15])
def test_plain_knn_matches_jax_xla(k):
    """Masks, NaN rows (read as the origin, as query and as key) and dead
    query rows, which get neighbours as live ones do."""
    pts, mask = _cloud(700, seed=k, dead_every=3, nan_rows=(5, 6, 100))
    d_j, i_j = jknn(jnp.asarray(pts), k, mask=jnp.asarray(mask))
    d_t, i_t = knn_mod.knn(torch.from_numpy(pts), k,
                           mask=torch.from_numpy(mask))
    assert d_t.shape == i_t.shape == (700, k)
    _assert_neighbor_parity(d_t, i_t, d_j, i_j, np.zeros((700, k), bool))
    it = i_t.numpy()
    assert mask[it].all()
    assert not np.any(it == np.arange(700)[:, None])


def test_plain_knn_dry_rows_match_jax():
    """4 live rows, k 6: live rows find 3 neighbours, dead rows 4; the
    rest are dry (the XLA path writes sqrt(float32 max) there)."""
    pts, _ = _cloud(50, seed=2)
    mask = np.zeros(50, bool)
    mask[[3, 17, 30, 41]] = True
    d_j, i_j = jknn(jnp.asarray(pts), 6, mask=jnp.asarray(mask))
    d_t, i_t = knn_mod.knn(torch.from_numpy(pts), 6,
                           mask=torch.from_numpy(mask))
    n_wet = np.where(mask, 3, 4)
    dry = np.arange(6)[None, :] >= n_wet[:, None]
    assert np.all(np.asarray(d_j)[dry] > 1e19)
    _assert_neighbor_parity(d_t, i_t, d_j, i_j, dry)


@pytest.mark.parametrize("n,k", [(2100, 8), (700, 5)])
def test_plain_knn_matches_knn_pallas_interpret(n, k):
    """Against the TPU kernel in interpret mode, across a 2048-key block
    boundary; its selection packs the index into the low 11 mantissa bits
    of d^2, hence the near-tie rule."""
    pts, mask = _cloud(n, seed=n, dead_every=4)
    d_j, i_j = knn_pallas(jnp.asarray(pts), k, mask=jnp.asarray(mask),
                          interpret=True)
    d_t, i_t = knn_mod.knn(torch.from_numpy(pts), k,
                           mask=torch.from_numpy(mask))
    _assert_neighbor_parity(d_t, i_t, d_j, i_j, np.zeros((n, k), bool))


def test_self_is_excluded_by_index_and_ties_go_to_the_lower_index():
    """A duplicate of a row is its neighbour at distance 0 (self is
    excluded by index, not by distance); on a lattice, equal distances
    come in ascending index, the kernel's rule."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    pts = np.concatenate([g, g[:1]])            # row 64 duplicates row 0
    d, i = knn_mod.knn(torch.from_numpy(pts), 7)
    d, i = d.numpy(), i.numpy()
    assert i[0, 0] == 64 and d[0, 0] == 0 and i[64, 0] == 0
    assert np.all(np.diff(d, axis=1) >= 0)
    tie = np.diff(d, axis=1) == 0
    assert tie.any() and np.all(np.diff(i, axis=1)[tie] > 0)
    d_j, i_j = jknn(jnp.asarray(pts), 7)
    np.testing.assert_allclose(d, np.asarray(d_j), rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    pts, mask = _cloud(300, seed=9, dead_every=5)
    before = knn_mod.launch_counts["knn"]
    t = torch.from_numpy(pts)
    got = knn_mod.knn(t, 17, mask=torch.from_numpy(mask))   # k > 16: plain
    ref = knn_mod.knn_ref(t, 17, mask=torch.from_numpy(mask))
    assert knn_mod.launch_counts["knn"] == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _slice_merge_model(points, k, mask, slices):
    """The kernel's rule in plain PyTorch: knn_ref's d^2 against each of
    ``slices`` contiguous key slices, slice s = [s n // slices, (s + 1) n
    // slices), each slice's k best by a stable sort, then the slices'
    lists merged by (d^2, index)."""
    p = torch.nan_to_num(points)
    n = p.shape[0]
    diff = p[:, None, :] - p[None, :, :]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d2 = torch.where(mask[None, :], d2, torch.tensor(float("inf")))
    d2.fill_diagonal_(float("inf"))
    cand_d, cand_i = [], []
    for s in range(slices):
        lo = n * s // slices
        hi = n * (s + 1) // slices
        ds, order = torch.sort(d2[:, lo:hi], dim=1, stable=True)
        cand_d.append(ds[:, :k])
        cand_i.append(order[:, :k] + lo)
    cd, ci = torch.cat(cand_d, 1), torch.cat(cand_i, 1)
    # (d^2, index) lexicographically: by index, then stably by d^2
    o = torch.argsort(ci, dim=1, stable=True)
    cd, ci = cd.gather(1, o), ci.gather(1, o)
    o = torch.argsort(cd, dim=1, stable=True)[:, :k]
    cd, ci = cd.gather(1, o), ci.gather(1, o)
    dists = torch.full((n, k), F32_MAX, dtype=torch.float32)
    idx = torch.zeros((n, k), dtype=torch.int64)
    dry = torch.isinf(cd)
    dists[:, :cd.shape[1]] = torch.where(dry, F32_MAX, torch.sqrt(cd))
    idx[:, :ci.shape[1]] = torch.where(dry, 0, ci)
    return dists, idx


@pytest.mark.parametrize("k", [1, 6, 16])
@pytest.mark.parametrize("n,seed", [(1003, 0), (512, 1), (61, 2), (5, 3)])
@pytest.mark.parametrize("slices", [3, 8])
def test_slice_and_merge_rule_equals_knn_ref(n, seed, k, slices):
    """Per-slice top-k lists merged by (d^2, index) give knn_ref's
    answer bit for bit, for any slice count (csrc/knn.cu has 8):
    duplicates whose copies lie in other slices (the lower index wins the
    tie), dead keys, a NaN row, and n not a multiple of the slice count
    (n = 5 leaves slices empty)."""
    pts, mask = _cloud(n, seed, dead_every=7, nan_rows=(n // 3,))
    r = np.random.default_rng(seed + 100)
    src = r.choice(n, n // 4, replace=False)
    pts[(src + n // 2) % n] = pts[src]              # copies across slices
    pts[n - 1] = pts[0]                             # first and last slice
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    d_m, i_m = _slice_merge_model(p, k, m, slices)
    d_r, i_r = knn_mod.knn_ref(p, k, mask=m)
    assert torch.equal(i_m, i_r)
    assert torch.equal(d_m, d_r)
    if n > 5:
        assert bool((d_r == 0).any())               # the ties are there


@pytest.mark.parametrize("masked", [False, True])
def test_knn_ref_rows_is_knn_ref_on_those_rows(masked):
    """The helper the chip smoke test holds a sample of query rows with
    gives knn_ref's rows, in any order, repeats included."""
    pts, mask = _cloud(700, seed=4, dead_every=3 if masked else 0)
    p = torch.from_numpy(pts)
    m = torch.from_numpy(mask) if masked else None
    rows = torch.tensor([699, 0, 350, 350, 1, 698])
    d_r, i_r = knn_mod.knn_ref(p, 6, mask=m)
    d, i = knn_mod.knn_ref_rows(p, 6, m, rows)
    assert torch.equal(d, d_r[rows]) and torch.equal(i, i_r[rows])
