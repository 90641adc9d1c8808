"""The port's dense frame paths held to the JAX package: slot binning
(``ops/tiles.py``), the dense compositor's plain versions
(``ops/raster_v2.py``) and the single- and two-level renders
(``ops/composite.py`` through ``ops/rasterize.py``). The Hopper kernels
are held to these plain versions by tests/test_torch_kernels.py, on a GPU.

Inputs are made with NumPy from a seed and handed to both packages; the
binning tests feed both the same JAX projection, so integer fields must
be equal. Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU.

Tolerances:
- compositor image atol 1e-5: the same f32 steps per pixel, in another
  order (matmul vs FMA chain for log alpha, cumprod order);
- ``t_out`` is compared where the JAX value is >= 1e-4; below that its
  value depends on the implementation (ops/raster_v2.py), so both sides
  are only held below 1e-4;
- whole-render image atol 2e-5; gradients of the four groups and absgrad
  atol 3e-4 + rtol 2e-3, the JAX package's own seg-vs-dense tolerances
  (tests/test_pallas_segpair.py:65-66).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_segpair import _cluster_scene, _scene
from test_torch_kernels import _random_frame
from test_torch_segpair import _overflow_scene_64x48, _weighted_loss

from edgegaussians_tpu.ops import pallas_raster_v2 as jv2
from edgegaussians_tpu.ops import tiles as jtiles
from edgegaussians_tpu.ops.composite import _composite_jax_seg
from edgegaussians_tpu.ops.projection import project_gaussians as jproject
from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu_torch.ops import raster_v2, tiles
from edgegaussians_tpu_torch.ops.projection import ProjectedGaussians
from edgegaussians_tpu_torch.ops.rasterize import rasterize

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
SCENES = {"scene": _scene, "cluster": lambda: _cluster_scene(
    width=64, height=48), "overflow": _overflow_scene_64x48}


def _torch_proj(proj):
    return ProjectedGaussians(*[torch.tensor(np.asarray(x)) for x in proj])


def _eq(name, t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("case", list(SCENES))
def test_bin_gaussians_matches_jax(case):
    *args, w, h = SCENES[case]()
    proj = jproject(*args, w, h)
    bj = jtiles.bin_gaussians(proj, w, h, 16, 24, max_tiles_per_gaussian=16)
    bt = tiles.bin_gaussians(_torch_proj(proj), w, h, 16, 24,
                             max_tiles_per_gaussian=16)
    for name in bt._fields:
        _eq(name, getattr(bt, name), getattr(bj, name))
    assert int(bt.counts.max()) > 24          # some tiles are truncated


@pytest.mark.parametrize("occupancy_sort", [False, True])
@pytest.mark.parametrize("case", list(SCENES))
def test_bin_gaussians_two_level_matches_jax(case, occupancy_sort):
    *args, w, h = SCENES[case]()
    proj = jproject(*args, w, h)
    kw = dict(k1=16, k2=48, t2=5, max_tiles_per_gaussian=16,
              occupancy_sort=occupancy_sort)
    bj = jtiles.bin_gaussians_two_level(proj, w, h, 16, **kw)
    bt = tiles.bin_gaussians_two_level(_torch_proj(proj), w, h, 16, **kw)
    for name in bt._fields:
        if getattr(bt, name) is None:   # tile_perm unsorted, pair tables
            assert getattr(bj, name) is None, name
            continue
        _eq(name, getattr(bt, name), getattr(bj, name))
    assert (bt.tile_perm is None) == (not occupancy_sort)
    assert int(bt.counts2.max()) > 0          # level 2 has work


def _check_t_out(t_out, ref):
    live = ref >= 1e-4
    np.testing.assert_allclose(t_out[live], ref[live], rtol=1e-5, atol=1e-7)
    assert np.all(t_out[~live] < 1e-4) and np.all(ref[~live] < 1e-4)


def test_raster_v2_plain_matches_pallas_interpret():
    feats, counts, t_in, g = _random_frame(0)
    basis = jtiles.pixel_basis(16)
    img_j, tout_j = jv2.composite_fwd_seg(
        jnp.asarray(feats), jnp.asarray(counts), basis, jnp.asarray(t_in),
        interpret=True)
    img_o, tout_o = _composite_jax_seg(jnp.asarray(feats), basis,
                                       jnp.asarray(t_in))
    tb = torch.tensor(np.asarray(basis))
    ft, ct, tt = map(torch.from_numpy, (feats, counts, t_in))
    img_t, tout_t = raster_v2.composite_fwd_seg(ft, ct, tb, tt)
    for img_ref, tout_ref in ((img_j, tout_j), (img_o, tout_o)):
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_ref),
                                   atol=1e-5)
        _check_t_out(tout_t.numpy(), np.asarray(tout_ref))
    assert float(img_t.max()) > 0.5 and np.any(tout_t.numpy() < 1e-4)

    # backward with a GLOBAL total beyond this segment's own image
    total = np.clip(np.asarray(img_j) + 0.1, 0, 1).astype(np.float32)
    d_j = jv2.composite_bwd_seg(
        jnp.asarray(feats), jnp.asarray(counts), basis, jnp.asarray(g),
        jnp.asarray(t_in), None, jnp.asarray(total), interpret=True)
    d_t = raster_v2.composite_bwd_seg(ft, ct, tb, torch.from_numpy(g), tt,
                                      torch.from_numpy(total))
    # per-slot sums over 256 pixels of terms up to ~1e3 (the basis holds
    # px^2): atol 1e-5 of the max-abs, f32 summation order
    scale = float(np.abs(np.asarray(d_j)).max())
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5 * scale)
    past = np.arange(feats.shape[1])[None, :] >= counts[:, None]
    assert np.all(d_t.numpy()[past] == 0)
    assert np.all(d_t.numpy()[..., 6:] == 0)


def test_raster_v2_plain_segments_compose():
    """[0, k1) then [k1, K) from the first segment's t_out gives the
    single-pass image (pallas_raster_v2.py:236-239)."""
    feats, counts, _, _ = _random_frame(1, t=8)
    ft, ct = torch.from_numpy(feats), torch.from_numpy(counts)
    basis = tiles.pixel_basis(16)
    img, _ = raster_v2.composite_fwd_seg(ft, ct, basis)
    k1 = 100
    img1, tout1 = raster_v2.composite_fwd_seg(
        ft[:, :k1].contiguous(), torch.clamp(ct, max=k1), basis)
    img2, _ = raster_v2.composite_fwd_seg(
        ft[:, k1:].contiguous(), torch.clamp(ct - k1, min=0), basis, tout1)
    torch.testing.assert_close(img1 + img2, img, rtol=0, atol=1e-5)


# (case, rasterize kwargs): two-level with occupancy sort (the recipes'
# fallback), without it (level 2 gathered by tile id), and single-level
# with truncated tiles
RENDER_CASES = {
    "two_level_occ": ("cluster", dict(capacity=64, dense_capacity=16,
                                      overflow_tiles=3, occupancy_sort=True)),
    "two_level": ("scene", dict(capacity=64, dense_capacity=16,
                                overflow_tiles=4)),
    "two_level_overflow": ("overflow", dict(capacity=96, dense_capacity=8,
                                            overflow_tiles=2,
                                            occupancy_sort=True)),
    "single": ("cluster", dict(capacity=48)),
}


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_rasterize_dense_matches_jax(case, backend):
    scene, kw = RENDER_CASES[case]
    *args, w, h = SCENES[scene]()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    kw = dict(kw, tile_size=16, max_tiles_per_gaussian=16)

    def jloss(m, q, s, o, sink):
        out = jrasterize(m, q, s, o, vm, K, w, h, backend=backend,
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
                      pair_budget=0, **kw)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    counts = out_t.tile_counts.numpy()
    _eq("tile_counts", out_t.tile_counts, out_j.tile_counts)
    assert int(out_t.num_pairs) == int(counts.sum())
    if out_j.num_pairs is not None:
        assert int(out_t.num_pairs) == int(out_j.num_pairs)
    assert int(out_t.num_truncated) == int(out_j.num_truncated)
    assert counts.max() > kw.get("dense_capacity", kw["capacity"])
    np.testing.assert_allclose(out_t.image.detach().numpy(),
                               np.asarray(out_j.image), atol=IMG_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = ("means", "quats", "scales", "opacities", "absgrad")
    for name, a, b in zip(names, gj, gt):
        assert np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert float(gt[4].abs().max()) > 0
