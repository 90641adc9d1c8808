"""The port's seg compositor (edgegaussians_tpu_torch/ops/segpair.py) and
whole rasterizer held to the JAX package. (The Hopper kernels are held to
these plain versions by tests/test_torch_kernels.py, on a GPU.)

On the CPU, ``SegpairRender`` runs its plain PyTorch versions; the JAX
side runs ``segpair_render`` in interpret mode (``backend="jax"``), as the
JAX package's own tests do. Tolerances are those of
tests/test_pallas_segpair.py:65-66: image atol 2e-5; dpacked, absgrad and
parameter gradients atol 3e-4 and rtol 2e-3. The JAX kernel forms its
one-hot segment sums as two bf16 MXU passes (~7.5e-6 relative error,
pallas_segpair.py:225-234) where the port sums in f32, and both sum the
log-alpha products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_segpair import _cluster_scene, _scene

from edgegaussians_tpu.ops import tiles as jtiles
from edgegaussians_tpu.ops.pallas_segpair import segpair_render
from edgegaussians_tpu.ops.projection import project_gaussians as jproject
from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu_torch.ops import segpair, tiles
from edgegaussians_tpu_torch.ops.rasterize import rasterize

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3

# (scene, cap, budget); budgets cover each scene's pairs and keep every
# JAX interpret-mode compile to one grid step (shapes shared across cases)
COMPOSITOR_CASES = {
    "scene": (lambda: _scene(), 256, 1024),
    # 400-pair runs on two tiles: transmittance crosses 128-pair bricks
    "cluster": (lambda: _cluster_scene(width=64, height=48), 512, 1024),
    "budget_not_multiple_of_128": (lambda: _scene(seed=5), 256, 900),
}


def _to_torch_bins(pb):
    return tiles.PairBins(*[torch.tensor(np.asarray(x)).to(
        torch.bool if np.asarray(x).dtype == bool else torch.int64)
        for x in pb])


@pytest.mark.parametrize("case", list(COMPOSITOR_CASES))
def test_segpair_render_plain_matches_jax(case):
    make, cap, budget = COMPOSITOR_CASES[case]
    *args, w, h = make()
    proj = jproject(*args, w, h)
    n = proj.depths.shape[0]
    pb = jtiles.bin_pairs_frame_order(proj, w, h, 16, cap, budget,
                                      block_tiles=0)
    assert int(pb.num_pairs) <= budget
    packed_sorted = jtiles.pack_gaussian_render_data(proj)[pb.order]
    origins = jtiles.tile_origins(w, h, 16)
    basis = jtiles.pixel_basis(16)
    T = origins.shape[0]
    g = np.random.default_rng(1).uniform(-1, 1, (T, 256)).astype(np.float32)

    img_j, vjp = jax.vjp(
        lambda ps, sk: segpair_render(ps, pb, origins, basis, sk, cap, True),
        packed_sorted, jnp.zeros((n, 2), jnp.float32))
    dps_j, dsink_j = vjp(jnp.asarray(g))

    ps_t = torch.tensor(np.asarray(packed_sorted), requires_grad=True)
    sink_t = torch.zeros((n, 2), requires_grad=True)
    img_t = segpair.SegpairRender.apply(
        ps_t, _to_torch_bins(pb), torch.tensor(np.asarray(origins)),
        torch.tensor(np.asarray(basis)), sink_t)
    dps_t, dsink_t = torch.autograd.grad((img_t * torch.from_numpy(g)).sum(),
                                         [ps_t, sink_t])
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=IMG_ATOL)
    for name, a, b in (("dpacked", dps_j, dps_t), ("absgrad", dsink_j,
                                                   dsink_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def _weighted_loss(img, xp):
    img = xp.clip(img, 0, 1) if xp is jnp else torch.clamp(img, 0, 1)
    idx = (jnp.arange(img.size, dtype=jnp.float32) if xp is jnp else
           torch.arange(img.numel(), dtype=torch.float32))
    return xp.sum(img * ((idx.reshape(img.shape) % 7) / 7.0 + 0.3))


def _overflow_scene_64x48(sparse_per_tile=10, pile=120, seed=11):
    """tests/test_pallas_segpair.py's _overflow_scene on a 4x3-tile image
    (the shape the other cases compile for): sparse tiles, plus a pile on
    the LARGEST tile id, whose sort-1 run starts last."""
    r = np.random.default_rng(seed)
    pts = [np.stack([tx * 16 + r.uniform(4, 12, sparse_per_tile),
                     ty * 16 + r.uniform(4, 12, sparse_per_tile)], axis=1)
           for ty in range(3) for tx in range(4) if (ty, tx) != (2, 3)]
    pts.append(np.stack([r.uniform(52, 60, pile), r.uniform(36, 44, pile)],
                        axis=1))
    px = np.concatenate(pts).astype(np.float32)
    n = px.shape[0]
    f, z = 64.0, 2.0
    means = np.concatenate([(px - [32.0, 24.0]) * (z / f),
                            np.full((n, 1), z)], axis=1).astype(np.float32)
    quats = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n, 1))
    K = np.array([[f, 0, 32], [0, f, 24], [0, 0, 1]], np.float32)
    return tuple(jnp.asarray(a) for a in (
        means, quats, np.full((n, 3), 0.015, np.float32),
        np.full((n,), 0.5, np.float32), np.eye(4, dtype=np.float32),
        K)) + (64, 48)


RASTER_CASES = {
    "scene": (lambda: _scene(), 256, 1024),
    # budget < pairs: the sort-1 prefix cut zeroes a high-occupancy tile's
    # kept count (the regime of the JAX seg kernel's NaN, ADVICE r4)
    "overflow": (_overflow_scene_64x48, 256, 64),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_rasterize_seg_matches_jax(case):
    make, cap, budget = RASTER_CASES[case]
    *args, w, h = make()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    kw = dict(tile_size=16, capacity=cap, pair_budget=budget,
              pair_kernel="seg")

    def jloss(m, q, s, o, sink):
        out = jrasterize(m, q, s, o, vm, K, w, h, backend="jax",
                         absgrad_sink=sink, **kw)
        return _weighted_loss(out.image, jnp), out

    (lj, out_j), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, quats, scales, opac, jnp.zeros((n, 2), jnp.float32))

    params = [torch.tensor(np.asarray(a), requires_grad=True)
              for a in (means, quats, scales, opac)]
    sink = torch.zeros((n, 2), requires_grad=True)
    out_t = rasterize(*params, torch.tensor(np.asarray(vm)),
                      torch.tensor(np.asarray(K)), w, h, absgrad_sink=sink,
                      **kw)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    assert int(out_t.num_pairs) == int(out_j.num_pairs)
    if case == "overflow":
        assert int(out_t.num_pairs) > budget
        assert int(out_t.tile_counts[-1]) == out_t.tile_counts.max() > 0
    assert int(out_t.num_visible) == int(out_j.num_visible)
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


def _cluster_features():
    """Features and run table of the cluster scene (runs of 400 pairs)."""
    *args, w, h = _cluster_scene(width=64, height=48)
    proj = jproject(*args, w, h)
    pb = jtiles.bin_pairs_frame_order(proj, w, h, 16, 512, 1024,
                                      block_tiles=0)
    pbt = _to_torch_bins(pb)
    packed = torch.tensor(np.asarray(
        jtiles.pack_gaussian_render_data(proj)))[pbt.order]
    src, ox, oy = segpair.pair_inputs(
        packed, pbt, tiles.tile_origins(w, h, 16))
    feats = segpair.build_pair_features(src, ox, oy)
    return (feats.contiguous(), pbt.s_f.to(torch.int32),
            tiles.pixel_basis(16))


def test_plain_backward_is_the_gradient_of_plain_forward():
    """The algebraic suffix (d log alpha = alpha g (1-img)/(1-alpha) on kept
    lanes) equals autograd through the cumprod forward. Tolerance 1e-5 of
    the max-abs: the two take the same f32 steps in another order."""
    feats, s_f, basis = _cluster_features()
    T = s_f.shape[0] - 1
    g = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (T, 256)).astype(np.float32))
    f = feats.clone().requires_grad_()
    img = segpair.segpair_fwd_ref(f, s_f, basis)
    (d_auto,) = torch.autograd.grad((img * g).sum(), [f])
    d_alg = segpair.segpair_bwd_ref(feats, s_f, basis,
                                    (g * (1 - img.detach())).contiguous())
    scale = d_auto[:, :6].abs().max()
    torch.testing.assert_close(d_alg[:, :6], d_auto[:, :6], rtol=0,
                               atol=1e-5 * float(scale))
    assert torch.all(d_alg[:, 6:] == 0)


def test_build_pair_features_vjp_matches_autograd():
    r = np.random.default_rng(4)
    src = torch.tensor(r.normal(size=(50, 8)).astype(np.float32),
                       requires_grad=True)
    ox, oy = (torch.tensor(r.uniform(0, 64, 50).astype(np.float32))
              for _ in range(2))
    d = torch.tensor(r.normal(size=(50, 8)).astype(np.float32))
    (auto,) = torch.autograd.grad(
        (segpair.build_pair_features(src, ox, oy) * d).sum(), [src])
    closed = segpair.build_pair_features_vjp(src.detach(), ox, oy, d)
    torch.testing.assert_close(closed, auto, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kwargs,err", [
    # band mode takes both band_row0 and band_tile_rows, on every path:
    # the pair-prefix two-level frame,
    (dict(pair_kernel=False, pair_budget=1024, dense_capacity=4,
          band_tile_rows=1), ValueError),
    (dict(pair_kernel="seg", pair_budget=0, band_row0=0), ValueError),
    # the v4 pair path,
    (dict(pair_kernel=True, pair_budget=1024, band_row0=0), ValueError),
    (dict(pair_kernel="segg", pair_budget=1024), ValueError),
    # the seg path
    (dict(pair_kernel="seg", pair_budget=1024, band_tile_rows=1),
     ValueError),
    # the JAX package's XLA oracle has no counterpart
    (dict(pair_budget=0, backend="jax"), ValueError),
    (dict(pair_budget=0, backend="reference"), ValueError),
])
def test_unported_rasterizer_branches_raise(kwargs, err):
    *args, w, h = _scene(n=8)
    with pytest.raises(err):
        rasterize(*[torch.tensor(np.asarray(a)) for a in args], w, h, **kwargs)
