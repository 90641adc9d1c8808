"""The two-level frame's pair-prefix path held to the JAX package: the
``pair_budget > 0`` tables of ``tiles.bin_gaussians_two_level`` (exact)
and the render built from them (``ops/composite.py``'s pair-prefix frame
on the ``raster_v2`` compositor) against JAX ``rasterize(...,
dense_capacity=..., pair_budget=..., pair_kernel=False)``.

Tolerances: whole-render image atol 2e-5; gradients of the four groups and
absgrad atol 3e-4 + rtol 2e-3, the JAX package's own seg-vs-dense
tolerances (tests/test_pallas_segpair.py:65-66).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_segpair import _cluster_scene, _scene
from test_torch_segpair import _overflow_scene_64x48, _weighted_loss

from edgegaussians_tpu.ops import tiles as jtiles
from edgegaussians_tpu.ops.projection import project_gaussians as jproject
from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu_torch.ops import tiles
from edgegaussians_tpu_torch.ops.projection import ProjectedGaussians
from edgegaussians_tpu_torch.ops.rasterize import rasterize

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
SCENES = {"scene": _scene, "cluster": lambda: _cluster_scene(
    width=64, height=48), "overflow": _overflow_scene_64x48}


def _torch_proj(proj):
    return ProjectedGaussians(*[torch.tensor(np.asarray(x)) for x in proj])


@pytest.mark.parametrize("budget", [4096, 100])
@pytest.mark.parametrize("occupancy_sort", [False, True])
@pytest.mark.parametrize("case", list(SCENES))
def test_pair_prefix_tables_match_jax(case, occupancy_sort, budget):
    """Every field equal, ``pair_rows``/``pair_ranks`` included (pairs
    past a tile's slots, the budget or the pair count land at
    ``p + PAIR_DROP_OFF``); budget 100 drops pairs in every scene."""
    *args, w, h = SCENES[case]()
    proj = jproject(*args, w, h)
    kw = dict(k1=16, k2=48, t2=5, max_tiles_per_gaussian=16,
              occupancy_sort=occupancy_sort, pair_budget=budget)
    bj = jtiles.bin_gaussians_two_level(proj, w, h, 16, **kw)
    bt = tiles.bin_gaussians_two_level(_torch_proj(proj), w, h, 16, **kw)
    assert bt.ranks1 is None and bt.ranks2 is None
    for name in bt._fields:
        t, j = getattr(bt, name), getattr(bj, name)
        if t is None:
            assert j is None, name
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    rows = bt.pair_rows.numpy()
    frame = tiles.tile_grid(w, h, 16)[2] * 16 + 5 * 48
    assert (rows < frame).any()
    if case == "cluster":           # runs past k1 + k2: dropped slots
        assert (rows >= tiles.PAIR_DROP_OFF).any()
    if budget == 100:
        assert int(bt.num_pairs) > budget


# (scene, rasterize kwargs): occupancy-sorted frame (the recipes'
# two-level layout), tile-order frame with level 2 gathered by tile id,
# and a budget below the pair count
RENDER_CASES = {
    "occ": ("cluster", dict(capacity=64, dense_capacity=16, overflow_tiles=3,
                            occupancy_sort=True, pair_budget=4096)),
    "tile_order": ("scene", dict(capacity=64, dense_capacity=16,
                                 overflow_tiles=4, pair_budget=4096)),
    "dropping": ("overflow", dict(capacity=96, dense_capacity=8,
                                  overflow_tiles=2, occupancy_sort=True,
                                  pair_budget=150)),
}


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_rasterize_pair_prefix_matches_jax(case, backend):
    scene, kw = RENDER_CASES[case]
    *args, w, h = SCENES[scene]()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    kw = dict(kw, tile_size=16, max_tiles_per_gaussian=16, pair_kernel=False)

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
                      **kw)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    assert int(out_t.num_pairs) == int(out_j.num_pairs)
    if case == "dropping":
        assert int(out_t.num_pairs) > kw["pair_budget"]
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


def test_pair_prefix_matches_decoded_two_level_frame():
    """With a budget that covers every pair the pair-prefix frame holds
    the decoded frame's live slots: the same image and gradients (exact
    arithmetic on the same inputs up to the index_add_ order, rtol 1e-5)."""
    *args, w, h = _cluster_scene(width=64, height=48)
    t = [torch.tensor(np.asarray(a)) for a in args]
    kw = dict(capacity=64, dense_capacity=16, overflow_tiles=3,
              occupancy_sort=True)
    outs = []
    for budget in (0, 8192):
        params = [x.clone().requires_grad_() for x in t[:4]]
        img = rasterize(*params, t[4], t[5], w, h, pair_budget=budget,
                        pair_kernel=False, **kw).image
        outs.append([img.detach()] + list(torch.autograd.grad(
            _weighted_loss(img, torch), params)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
