"""The port's v4 block-window pair path held to the JAX package: the
``block_tiles > 0`` tables of ``ops/tiles.py`` (exact, field by field),
the plain compositor of ``ops/pair.py`` through ``PairRender`` against
``pallas_pair.pair_render`` in interpret mode, and the whole render with
``pair_kernel=True`` against JAX ``rasterize(..., pair_kernel=True,
backend="jax")``, which runs the v4 kernel in interpret mode. The Hopper
kernels are held to these plain versions by tests/test_torch_kernels.py,
on a GPU.

Tolerances: image atol 2e-5; dpacked, parameter gradients and absgrad
atol 3e-4 + rtol 2e-3 (tests/test_pallas_segpair.py:65-66). The TPU
kernel takes the log-alpha products as an MXU matmul, its transmittance
as a Hillis-Steele cumprod and its contributions as ``t_inc / (1 -
alpha)``, the port as an FMA chain and a sequential product; the suffix
``(total - c_inc) / (1 - alpha)`` magnifies those last-bit differences up
to 1000x at alpha near 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_segpair import _cluster_scene, _scene
from test_torch_kernels import PAIR_SHAPES, _pair_shape
from test_torch_segpair import (
    _overflow_scene_64x48, _to_torch_bins, _weighted_loss)

from edgegaussians_tpu.ops import tiles as jtiles
from edgegaussians_tpu.ops.pallas_pair import pair_render
from edgegaussians_tpu.ops.projection import project_gaussians as jproject
from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu_torch.ops import pair, tiles
from edgegaussians_tpu_torch.ops.projection import ProjectedGaussians
from edgegaussians_tpu_torch.ops.rasterize import rasterize

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
SCENES = {"scene": _scene, "cluster": lambda: _cluster_scene(
    width=64, height=48), "overflow": _overflow_scene_64x48}


def _torch_proj(proj):
    return ProjectedGaussians(*[torch.tensor(np.asarray(x)) for x in proj])


@pytest.mark.parametrize("pos,vals,budget,expected", [
    # tests/test_pallas_pair.py:35: empty segments, a tail past the end
    ([0, 0, 3, 3, 7, 9], [2.0, 5.0, 5.0, 1.0, 0.5], 12,
     [5, 5, 5, 1, 1, 1, 1, 0.5, 0.5, 0, 0, 0]),
    # positions at and past the budget are dropped
    ([1, 4, 6, 8], [3.0, -2.0, 7.0], 6, [0, 3, 3, 3, -2, -2]),
])
def test_step_over_pairs_matches_jax(pos, vals, budget, expected):
    out_j = np.asarray(jtiles.step_over_pairs(
        jnp.asarray(pos, jnp.int32), jnp.asarray(vals), budget))
    out_t = tiles.step_over_pairs(torch.tensor(pos), torch.tensor(vals),
                                  budget)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(expected,
                                                           np.float32))
    ints = tiles.step_over_pairs(torch.tensor(pos), torch.tensor(vals),
                                 budget, torch.int64)
    assert ints.dtype == torch.int64


# (cap, budget): the budget covers every pair; a budget that drops pairs
# (and zeroes a busy tile's last run); a tiny cap that truncates runs
TABLE_CASES = {"covered": (64, 4096), "dropping": (256, 200),
               "tiny_cap": (8, 4096)}


@pytest.mark.parametrize("block_tiles", [4, 8])
@pytest.mark.parametrize("case", list(TABLE_CASES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_block_pair_tables_match_jax(scene, case, block_tiles):
    """Every integer field equal; ``pair_ranks`` where valid (elsewhere
    both sides hold a clipped rank of no meaning)."""
    *args, w, h = SCENES[scene]()
    cap, budget = TABLE_CASES[case]
    proj = jproject(*args, w, h)
    kw = dict(max_tiles_per_gaussian=16, block_tiles=block_tiles)
    bj = jtiles.bin_pairs_frame_order(proj, w, h, 16, cap, budget, **kw)
    bt = tiles.bin_pairs_frame_order(_torch_proj(proj), w, h, 16, cap,
                                     budget, **kw)
    valid = np.asarray(bj.pair_valid)
    for name in bt._fields:
        t, j = getattr(bt, name).numpy(), np.asarray(getattr(bj, name))
        if name == "pair_ranks":
            t, j = t[valid], j[valid]
        np.testing.assert_array_equal(t, j, err_msg=name)
    if case == "dropping":
        assert int(bt.num_pairs) > budget
    if case == "tiny_cap":
        assert int(bt.counts.max()) > cap
    assert int(bt.counts_f.sum()) == int(valid.sum()) > 0


def test_block_pair_tables_align_blocks_to_bricks():
    """tests/test_pallas_pair.py:128 on the port: every block of TB frame
    rows starts at a 128-pair brick boundary, pads sit only on block-last
    rows, and pad pairs are invalid."""
    *args, w, h = _scene(n=500, seed=7)
    proj = _torch_proj(jproject(*args, w, h))
    TB = 4
    pb = tiles.bin_pairs_frame_order(proj, w, h, 16, 64, 4096,
                                     block_tiles=TB)
    T = tiles.tile_grid(w, h, 16)[2]
    s_f, counts_f = pb.s_f.numpy(), pb.counts_f.numpy()
    assert all(s_f[b0] % 128 == 0 for b0 in range(0, T, TB))
    pads = np.diff(s_f) - counts_f
    assert (pads >= 0).all() and pads.sum() > 0
    non_last = np.ones(T, bool)
    non_last[TB - 1::TB] = False
    non_last[T - 1] = False
    assert (pads[non_last] == 0).all()
    pv = pb.pair_valid.numpy()
    assert pv.sum() == counts_f.sum()
    assert (pb.pair_ranks.numpy()[pv] < 500).all()
    # counts_f are the raw-occupancy runs clipped at the cap
    np.testing.assert_array_equal(
        counts_f, np.minimum(pb.counts.numpy()[pb.perm.numpy()], 64))


def test_block_pair_tables_refuse_ranks_without_pad_headroom():
    n = tiles.RANK_MASK - 126
    proj = ProjectedGaussians(
        means2d=torch.zeros((n, 2)), depths=torch.ones(n),
        conics=torch.zeros((n, 3)), radii=torch.zeros(n, dtype=torch.int32),
        opacities=torch.ones(n), valid=torch.zeros(n, dtype=torch.bool))
    with pytest.raises(ValueError, match="headroom"):
        tiles.bin_pairs_frame_order(proj, 64, 48, 16, 64, 512,
                                    max_tiles_per_gaussian=1, block_tiles=8)
    # the seg tables take the same count
    tiles.bin_pairs_frame_order(proj, 64, 48, 16, 64, 512,
                                max_tiles_per_gaussian=1)


# (scene, cap, budget): covered budget, runs of ~400 pairs that cross the
# TPU kernel's 128-pair chunks, a dropping budget, a tiny cap
RENDER_CASES = {
    "scene": ("scene", 256, 4096),
    "cluster": ("cluster", 512, 4096),
    "overflow": ("overflow", 256, 200),
    "tiny_cap": ("scene", 8, 4096),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_pair_render_plain_matches_jax(case):
    scene, cap, budget = RENDER_CASES[case]
    *args, w, h = SCENES[scene]()
    proj = jproject(*args, w, h)
    n = proj.depths.shape[0]
    pb = jtiles.bin_pairs_frame_order(proj, w, h, 16, cap, budget,
                                      max_tiles_per_gaussian=16,
                                      block_tiles=pair.BLOCK_TILES)
    packed_sorted = jtiles.pack_gaussian_render_data(proj)[pb.order]
    origins = jtiles.tile_origins(w, h, 16)
    basis = jtiles.pixel_basis(16)
    T = origins.shape[0]
    g = np.random.default_rng(1).uniform(-1, 1, (T, 256)).astype(np.float32)

    img_j, vjp = jax.vjp(
        lambda ps, sk: pair_render(ps, pb, origins, basis, sk, cap, True),
        packed_sorted, jnp.zeros((n, 2), jnp.float32))
    dps_j, dsink_j = vjp(jnp.asarray(g))

    ps_t = torch.tensor(np.asarray(packed_sorted), requires_grad=True)
    sink_t = torch.zeros((n, 2), requires_grad=True)
    img_t = pair.PairRender.apply(
        ps_t, _to_torch_bins(pb), torch.tensor(np.asarray(origins)),
        torch.tensor(np.asarray(basis)), sink_t)
    dps_t, dsink_t = torch.autograd.grad((img_t * torch.from_numpy(g)).sum(),
                                         [ps_t, sink_t])
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=IMG_ATOL)
    assert float(img_t.detach().max()) > 0.5
    for name, a, b in (("dpacked", dps_j, dps_t), ("absgrad", dsink_j,
                                                   dsink_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_pair_plain_backward_is_the_gradient_of_plain_forward():
    """The unfolded suffix form equals autograd through the cumprod
    forward, on the cluster scene's v4 tables (pads present). Tolerance
    1e-4 of the max-abs: the same f32 steps in another order, through
    ``suffix / (1 - alpha)``."""
    *args, w, h = _cluster_scene(width=64, height=48)
    proj = _torch_proj(jproject(*args, w, h))
    pb = tiles.bin_pairs_frame_order(proj, w, h, 16, 512, 4096,
                                     block_tiles=pair.BLOCK_TILES)
    packed = tiles.pack_gaussian_render_data(proj)[pb.order]
    *_, feats, sfp, counts = pair.pair_prep(
        packed, pb, tiles.tile_origins(w, h, 16))
    assert int((pb.s_f[1:] - pb.s_f[:-1] - pb.counts_f).sum()) > 0
    basis = tiles.pixel_basis(16)
    g = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (sfp.shape[0], 256)).astype(np.float32))
    f = feats.clone().requires_grad_()
    img = pair.pair_fwd_ref(f, sfp, counts, basis)
    (d_auto,) = torch.autograd.grad((img * g).sum(), [f])
    d_suffix = pair.pair_bwd_ref(feats, sfp, counts, basis, g, img.detach())
    scale = float(d_auto[:, :6].abs().max())
    torch.testing.assert_close(d_suffix[:, :6], d_auto[:, :6], rtol=0,
                               atol=1e-4 * scale)
    # rows outside every run (pads, the budget tail) are zero
    assert torch.all(d_suffix[~pb.pair_valid] == 0)


@pytest.mark.parametrize("name", list(PAIR_SHAPES))
def test_pair_plain_backward_is_the_gradient_on_the_kernel_test_shapes(
        name):
    """The unfolded suffix form against autograd through the cumprod
    forward on the GPU tests' shapes (tests/test_torch_kernels.py
    PAIR_SHAPES: runs around the kernels' groups and batches, empty runs,
    pads of real features, every pixel stopping on group and batch
    edges), the yardstick those tests hold the kernels to. Tolerance as
    above; rows outside every run and past a stop are zero."""
    feats, sfp, counts, walked, stops = _pair_shape(name)
    basis = tiles.pixel_basis(16)
    g = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (sfp.shape[0], 256)).astype(np.float32))
    f = feats.clone().requires_grad_()
    img = pair.pair_fwd_ref(f, sfp, counts, basis)
    (d_auto,) = torch.autograd.grad((img * g).sum(), [f])
    d_suffix = pair.pair_bwd_ref(feats, sfp, counts, basis, g, img.detach())
    scale = float(d_auto[:, :6].abs().max())
    assert scale > 0
    torch.testing.assert_close(d_suffix[:, :6], d_auto[:, :6], rtol=0,
                               atol=1e-4 * scale)
    assert torch.all(d_suffix[~walked] == 0)
    for row, k in stops:
        s0, n = int(sfp[row]), int(counts[row])
        assert torch.all(d_suffix[s0 + k:s0 + n] == 0)


RASTER_CASES = {
    "scene": ("scene", 256, 4096),
    "overflow": ("overflow", 256, 200),
    # tests/test_pallas_pair.py:88: the pair path composites only the
    # nearest cap Gaussians per tile
    "capacity_truncation": ("truncation", 8, 8192),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_rasterize_pair_kernel_matches_jax(case):
    scene, cap, budget = RASTER_CASES[case]
    make = (lambda: _scene(n=400, seed=3)) if scene == "truncation" \
        else SCENES[scene]
    *args, w, h = make()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    kw = dict(tile_size=16, capacity=cap, pair_budget=budget,
              max_tiles_per_gaussian=16)

    def jloss(m, q, s, o, sink):
        out = jrasterize(m, q, s, o, vm, K, w, h, backend="jax",
                         pair_kernel=True, absgrad_sink=sink, **kw)
        return _weighted_loss(out.image, jnp), out

    (lj, out_j), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, quats, scales, opac, jnp.zeros((n, 2), jnp.float32))

    params = [torch.tensor(np.asarray(a), requires_grad=True)
              for a in (means, quats, scales, opac)]
    sink = torch.zeros((n, 2), requires_grad=True)
    out_t = rasterize(*params, torch.tensor(np.asarray(vm)),
                      torch.tensor(np.asarray(K)), w, h, absgrad_sink=sink,
                      pair_kernel=True, **kw)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    assert int(out_t.num_pairs) == int(out_j.num_pairs)
    if case == "overflow":
        assert int(out_t.num_pairs) > budget
    if case == "capacity_truncation":
        assert int(out_t.tile_counts.max()) > cap
    np.testing.assert_array_equal(out_t.tile_counts.numpy(),
                                  np.asarray(out_j.tile_counts))
    np.testing.assert_allclose(out_t.image.detach().numpy(),
                               np.asarray(out_j.image), atol=IMG_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = ("means", "quats", "scales", "opacities", "absgrad")
    for name, a, b in zip(names, gj, gt):
        assert np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert float(gt[4].abs().max()) > 0
