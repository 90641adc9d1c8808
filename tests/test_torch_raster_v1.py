"""The port's v1 log-space compositor (edgegaussians_tpu_torch/ops/
raster_v1.py) and the single-level render on it, held to the JAX
package's ``pallas_raster`` kernels (interpret mode) and its
``rasterize(..., backend="pallas_v1")``. The Hopper kernels are held to
these plain versions by tests/test_torch_kernels.py, on a GPU.

Tolerances:
- compositor image atol 1e-5: the same f32 steps per pixel; the log-alpha
  sum (matmul order) and the log-transmittance cumsum (sequential vs the
  TPU kernel's Hillis-Steele scan) round in another order;
- dfeats atol 1e-4 of the JAX max-abs: per-slot sums over 256 pixels of
  terms up to ~1e3 (the basis holds px^2), in another order, and the
  suffix taken from the forward image where the TPU kernel takes its own
  cumsum's last entry: a last-bit difference of the total reaches d alpha
  through ``suffix / (1 - alpha)``, up to 1000x at alpha near 0.999;
- whole-render image atol 2e-5; gradients of the four groups and absgrad
  atol 3e-4 + rtol 2e-3 (tests/test_pallas_segpair.py:65-66).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_raster import _random_feats
from test_pallas_segpair import _cluster_scene, _scene
from test_torch_segpair import _overflow_scene_64x48, _weighted_loss

from edgegaussians_tpu.ops import pallas_raster
from edgegaussians_tpu.ops import tiles as jtiles
from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu_torch.ops import raster_v1, tiles
from edgegaussians_tpu_torch.ops.rasterize import rasterize

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3


class _Rng:
    """tests/test_pallas_raster.py's ``np_rng`` fixture."""

    def __init__(self, seed):
        self.r = np.random.default_rng(seed)

    def uniform(self, lo, hi, shape):
        return jnp.asarray(self.r.uniform(lo, hi, shape), jnp.float32)


# (seed, t, k, valid_frac): the JAX test's shape, a long frame that crosses
# both plain-version chunk rows and the kernels' staging batches, a dense
# one where many pixels saturate, and the fixture's capacity at its live
# share (~2%; the marked slots interleaved with the live ones, plus
# SPARSE_DEAD's tail and whole rows)
FRAMES = {"jax_test": (7, 8, 64, 0.8), "long": (3, 6, 300, 0.9),
          "saturated": (5, 4, 256, 1.0), "sparse": (11, 6, 768, 0.02)}
SPARSE_DEAD = dict(tail=600, rows=(1, 4))


def _frame(name):
    """FRAMES[name]'s features (jnp [t,k,8]); the sparse frame also carries
    the -1e30 marker on every slot from SPARSE_DEAD's tail on and on all
    slots of its rows."""
    seed, t, k, frac = FRAMES[name]
    feats = _random_feats(_Rng(seed), t=t, k=k, valid_frac=frac)
    if name == "sparse":
        feats = feats.at[:, SPARSE_DEAD["tail"]:, 5].set(-1e30)
        feats = feats.at[jnp.asarray(SPARSE_DEAD["rows"]), :, 5].set(-1e30)
    return feats


def _in_order(feats, basis, g, total):
    """(img, dfeats) by the plain versions' algebra (raster_v1._chunk_terms
    and the suffix form), with sums whose rounding removing a slot cannot
    change: the image the running sum's last entry (the slots added in
    depth order, as the kernels add them) and the pixel sums in float64,
    rounded once (an f32 matmul groups its terms by the slot count)."""
    T, K, _ = feats.shape
    if K == 0:
        return torch.zeros((T, 256)), torch.zeros_like(feats)
    alpha, ok, keep, t_prev = raster_v1._chunk_terms(feats, basis)
    c_inc = torch.cumsum(alpha * t_prev * keep, dim=1)
    dalpha = (t_prev - (total[:, None, :] - c_inc) / (1.0 - alpha)) * \
        keep * g[:, None, :]
    dla = torch.where(ok & (alpha < raster_v1.ALPHA_CLAMP), alpha * dalpha,
                      torch.zeros_like(alpha))
    return c_inc[:, -1], (dla.double() @ basis.T.double()).float()


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_v1_plain_matches_pallas_interpret(name):
    seed, t, k, frac = FRAMES[name]
    feats = _frame(name)
    basis = jtiles.pixel_basis(16)
    g = np.random.default_rng(seed + 1).uniform(
        -1, 1, (t, 256)).astype(np.float32)
    img_j = pallas_raster.composite_fwd(feats, basis, interpret=True)
    d_j = pallas_raster.composite_bwd(feats, basis, jnp.asarray(g),
                                      interpret=True)
    ft = torch.tensor(np.asarray(feats))
    tb = torch.tensor(np.asarray(basis))
    img_t = raster_v1.composite_fwd(ft, tb)
    d_t = raster_v1.composite_bwd(ft, tb, torch.from_numpy(g), img_t)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5)
    scale = float(np.abs(np.asarray(d_j)).max())
    assert scale > 0
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-4 * scale)
    assert np.all(d_t.numpy()[..., 6:] == 0)
    if name == "saturated":
        assert float(img_t.max()) > 0.999
    if name == "sparse":
        marked = ~raster_v1.live_slots(ft)
        assert 0.0 < float((~marked).float().mean()) < 0.03
        assert bool(marked[:, SPARSE_DEAD["tail"]:].all())
        assert np.all(img_t.numpy()[list(SPARSE_DEAD["rows"])] == 0)


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_v1_plain_gives_marked_slots_zero_dfeats(name):
    """Every marked slot's dfeats row is exactly zero in the plain
    backward, all eight columns, whatever the upstream g: the rows the
    kernels write as zeros without walking the slot."""
    ft = torch.tensor(np.asarray(_frame(name)))
    basis = tiles.pixel_basis(16)
    g = torch.from_numpy(np.random.default_rng(FRAMES[name][0] + 2).uniform(
        -1, 1, (ft.shape[0], 256)).astype(np.float32))
    img = raster_v1.composite_fwd_ref(ft, basis)
    d = raster_v1.composite_bwd_ref(ft, basis, g, img)
    marked = ~raster_v1.live_slots(ft)
    assert bool((d[marked] == 0).all())
    assert bool((d[~marked] != 0).any())


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_v1_plain_skipping_marked_slots_is_exact(name):
    """Removing a row's marked slots leaves the image and the live slots'
    dfeats bit for bit as they were: a marked slot has alpha 0 on every
    pixel, so log1p(-0) = -0 and every running sum takes an exact zero
    from it. This is what the kernels' walk over the live slots alone
    rests on. Summed as the kernels sum (``_in_order``), which agrees with
    the plain versions within the header's tolerances."""
    ft = torch.tensor(np.asarray(_frame(name)))
    basis = tiles.pixel_basis(16)
    g = torch.from_numpy(np.random.default_rng(FRAMES[name][0] + 3).uniform(
        -1, 1, (ft.shape[0], 256)).astype(np.float32))
    img_r = raster_v1.composite_fwd_ref(ft, basis)
    img, d = _in_order(ft, basis, g, img_r)
    torch.testing.assert_close(img, img_r, rtol=0, atol=1e-5)
    d_r = raster_v1.composite_bwd_ref(ft, basis, g, img_r)
    torch.testing.assert_close(d, d_r, rtol=0,
                               atol=1e-4 * float(d_r.abs().max()))
    img, d = _in_order(ft, basis, g, img)
    live = raster_v1.live_slots(ft)
    for r in range(ft.shape[0]):
        one = ft[r][live[r]][None].contiguous()
        img_live, d_live = _in_order(one, basis, g[r:r + 1], img[r:r + 1])
        assert torch.equal(img_live[0], img[r]), r
        assert torch.equal(d_live[0], d[r][live[r]]), r
        if not one.shape[1]:
            assert bool((img[r] == 0).all())


def test_raster_v1_plain_backward_is_the_gradient_of_plain_forward():
    """The suffix form equals autograd through the log-space forward.
    Tolerance 1e-5 of the max-abs: the same f32 steps in another order."""
    feats = torch.tensor(np.asarray(_random_feats(_Rng(2), t=6, k=96)))
    basis = tiles.pixel_basis(16)
    g = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (6, 256)).astype(np.float32))
    f = feats.clone().requires_grad_()
    img = raster_v1.composite_fwd_ref(f, basis)
    (d_auto,) = torch.autograd.grad((img * g).sum(), [f])
    d_suffix = raster_v1.composite_bwd_ref(feats, basis, g, img.detach())
    scale = float(d_auto[..., :6].abs().max())
    torch.testing.assert_close(d_suffix[..., :6], d_auto[..., :6], rtol=0,
                               atol=1e-5 * scale)


SCENES = {"scene": (_scene, 64), "cluster": (
    lambda: _cluster_scene(width=64, height=48), 48),
    # a truncating capacity: tiles past it keep their nearest 24
    "overflow": (_overflow_scene_64x48, 24)}


@pytest.mark.parametrize("case", list(SCENES))
def test_rasterize_v1_matches_jax(case):
    make, cap = SCENES[case]
    *args, w, h = make()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    kw = dict(tile_size=16, capacity=cap, max_tiles_per_gaussian=16)

    def jloss(m, q, s, o, sink):
        out = jrasterize(m, q, s, o, vm, K, w, h, backend="pallas_v1",
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
                      pair_budget=0, backend="pallas_v1", **kw)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    np.testing.assert_array_equal(out_t.tile_counts.numpy(),
                                  np.asarray(out_j.tile_counts))
    if case == "overflow":
        assert int(out_t.tile_counts.max()) > cap
    np.testing.assert_allclose(out_t.image.detach().numpy(),
                               np.asarray(out_j.image), atol=IMG_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = ("means", "quats", "scales", "opacities", "absgrad")
    for name, a, b in zip(names, gj, gt):
        assert np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert float(gt[4].abs().max()) > 0


def test_backend_v1_changes_only_the_single_level_frame():
    """'pallas_v1' runs the v1 kernels on the single-level frame only: the
    two-level and pair paths render as with 'pallas' (composite.py:336,
    384), and the XLA oracle's names are refused."""
    *args, w, h = _scene(n=120)
    t = [torch.tensor(np.asarray(a)) for a in args]
    for kw in (dict(capacity=64, dense_capacity=16, pair_budget=0),
               dict(capacity=64, pair_budget=2048, pair_kernel="seg"),
               dict(capacity=64, pair_budget=2048, pair_kernel=True)):
        a = rasterize(*t, w, h, backend="pallas", **kw).image
        b = rasterize(*t, w, h, backend="pallas_v1", **kw).image
        assert torch.equal(a, b), kw
    single_v2 = rasterize(*t, w, h, capacity=64, pair_budget=0).image
    single_v1 = rasterize(*t, w, h, capacity=64, pair_budget=0,
                          backend="pallas_v1").image
    assert not torch.equal(single_v1, single_v2)
    torch.testing.assert_close(single_v1, single_v2, rtol=0, atol=2e-5)
    for name in ("jax", "reference", "pallas_v3"):
        with pytest.raises(ValueError, match="pallas_v1"):
            rasterize(*t, w, h, capacity=64, pair_budget=0, backend=name)
