"""Band mode of the port's rasterizer and the band-partial losses, held to
the JAX package, with no process group.

- A band render (``rasterize(band_row0=..., band_tile_rows=...)``) on the
  seg, v4 pair, two-level and single-level (v2 and v1) paths against JAX
  ``rasterize`` in band mode (Pallas kernels in interpret mode), on a
  64x80 image of 5 tile rows split into 2 bands of 3 rows, so the last
  band pads one row past the image: image atol 2e-5; gradients of the
  four groups and absgrad atol 3e-4 + rtol 2e-3, the JAX package's own
  seg-vs-dense tolerances (tests/test_pallas_segpair.py:65-66). The band
  image also equals the port's full render's rows (atol 1e-6: the same
  pairs in the same order per tile; on the two-level path with a level-2
  budget that holds every overflowing tile, since a band's busiest tiles
  are not the image's).
- ``parallel/bands.py`` against JAX ``parallel/bands.py`` for the three
  strategies (the bg_edge_ratio scores are the JAX key's draws): rtol
  1e-5 on the same predictions.
- The sum over bands of the port's band losses, gradients and sinks
  equals the port's single-device proj-grad (loss rtol 1e-5; gradients
  atol 1e-6 + rtol 1e-4, sums in another order), and absgrad, the norm of
  the summed sinks, equals the single-device one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_segpair import _scene
from test_torch_segpair import _weighted_loss

from edgegaussians_tpu.ops.rasterize import rasterize as jrasterize
from edgegaussians_tpu.parallel import bands as jbands
from edgegaussians_tpu_torch.config import FrameworkConfig
from edgegaussians_tpu_torch.models.gaussians import init_state
from edgegaussians_tpu_torch.ops.rasterize import rasterize
from edgegaussians_tpu_torch.parallel import bands
from edgegaussians_tpu_torch.parallel.train_sharded import (
    band_loss_and_grads, band_render_kwargs)
from edgegaussians_tpu_torch.train import trainer

torch.set_num_threads(2)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
W, H, TS = 64, 80, 16
N_BANDS = 2
ROWS_PER = 3                    # cdiv(5 tile rows, 2 bands)

# port kwargs, port compositor, JAX backend running the same compositor
PATHS = {
    "seg": (dict(capacity=64, pair_budget=2048, pair_kernel="seg"),
            "pallas", "jax"),
    "pair_v4": (dict(capacity=64, pair_budget=2048, pair_kernel=True),
                "pallas", "jax"),
    "two_level": (dict(capacity=64, dense_capacity=16, overflow_tiles=3,
                       occupancy_sort=True, pair_budget=0),
                  "pallas", "jax"),
    "single_v2": (dict(capacity=64, pair_budget=0), "pallas", "pallas"),
    "single_v1": (dict(capacity=64, pair_budget=0), "pallas_v1",
                  "pallas_v1"),
}


def _band_scene():
    return _scene(n=300, width=W, height=H, seed=4)


@pytest.mark.parametrize("band", [0, 1])
@pytest.mark.parametrize("path", list(PATHS))
def test_band_render_matches_jax(path, band):
    kw, compositor, jbackend = PATHS[path]
    *args, w, h = _band_scene()
    means, quats, scales, opac, vm, K = args
    n = means.shape[0]
    row0 = band * ROWS_PER

    def jloss(m, q, s, o, sink):
        out = jrasterize(m, q, s, o, vm, K, w, h, tile_size=TS,
                         backend=jbackend, absgrad_sink=sink,
                         max_tiles_per_gaussian=16,
                         band_row0=jnp.int32(row0), band_tile_rows=ROWS_PER,
                         **kw)
        return _weighted_loss(out.image, jnp), out

    (lj, out_j), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, quats, scales, opac, jnp.zeros((n, 2), jnp.float32))

    params = [torch.tensor(np.asarray(a), requires_grad=True)
              for a in (means, quats, scales, opac)]
    sink = torch.zeros((n, 2), requires_grad=True)
    # the band origin as a 0-d tensor, as the sharded steps may pass it
    out_t = rasterize(*params, torch.tensor(np.asarray(vm)),
                      torch.tensor(np.asarray(K)), w, h, tile_size=TS,
                      backend=compositor, absgrad_sink=sink,
                      max_tiles_per_gaussian=16,
                      band_row0=torch.tensor(row0),
                      band_tile_rows=ROWS_PER, **kw)
    assert out_t.image.shape == (ROWS_PER * TS, w)
    lt = _weighted_loss(out_t.image, torch)
    gt = torch.autograd.grad(lt, params + [sink])

    np.testing.assert_array_equal(out_t.tile_counts.numpy(),
                                  np.asarray(out_j.tile_counts))
    assert int(out_t.num_truncated) == int(out_j.num_truncated)
    np.testing.assert_allclose(out_t.image.detach().numpy(),
                               np.asarray(out_j.image), atol=IMG_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = ("means", "quats", "scales", "opacities", "absgrad")
    for name, a, b in zip(names, gj, gt):
        assert np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert float(gt[4].abs().max()) > 0, "the band holds no Gaussian"

    # the band is the matching rows of the port's full render; on the
    # two-level path only where the level-2 budget holds every overflowing
    # tile of both (a band's busiest tiles are not the image's)
    if "overflow_tiles" in kw:
        kw = dict(kw, overflow_tiles=(W // TS) * (H // TS))
    with torch.no_grad():
        t = [torch.tensor(np.asarray(a)) for a in args]
        render = dict(tile_size=TS, backend=compositor,
                      max_tiles_per_gaussian=16, **kw)
        band_img = rasterize(*t, w, h, band_row0=row0,
                             band_tile_rows=ROWS_PER, **render).image
        full = rasterize(*t, w, h, **render).image
    y0 = row0 * TS
    rows = full[y0:y0 + ROWS_PER * TS]
    np.testing.assert_allclose(band_img[:rows.shape[0]].numpy(),
                               rows.numpy(), atol=1e-6)


def test_band_mode_needs_both_arguments():
    *args, w, h = _band_scene()
    t = [torch.tensor(np.asarray(a)) for a in args]
    with pytest.raises(ValueError, match="both"):
        rasterize(*t, w, h, band_row0=1)


def _image_pair(seed=7):
    r = np.random.default_rng(seed)
    pred = r.random((H, W)).astype(np.float32)
    gt = r.random((H, W)).astype(np.float32)
    return pred, gt, gt >= 0.5


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_band_partial_losses_match_jax(loss_type):
    """Each band's inputs and partial loss, three strategies, against
    JAX; the partials sum to the full-image loss."""
    pred, gt, em = _image_pair()
    rows_per, band_h, pad_h = bands.band_geometry(W, H, TS, N_BANDS)
    assert (rows_per, band_h, pad_h) == jbands.band_geometry(W, H, TS,
                                                             N_BANDS)
    key = jax.random.PRNGKey(3)
    scores = torch.tensor(np.asarray(jax.random.uniform(key, (H * W,))))
    bg_ratio = 1.5
    sums = np.zeros(3)
    for band in range(N_BANDS):
        y0 = band * band_h
        jin = jbands.band_inputs(jnp.asarray(gt), jnp.asarray(em), y0,
                                 band_h, pad_h, H, W)
        tin = bands.band_inputs(torch.tensor(gt), torch.tensor(em), y0,
                                band_h, pad_h, H, W)
        for a, b in zip(jin, tin):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        # the band's prediction rows, padded as a band render pads them
        pred_b = np.zeros((band_h, W), np.float32)
        part = pred[y0:y0 + band_h]
        pred_b[:part.shape[0]] = part
        pred_b[part.shape[0]:] = 0.25
        for s in range(3):
            lj = jbands.band_partial_loss(
                jnp.asarray(pred_b), *jin, jnp.asarray(em), jnp.int32(s),
                jnp.float32(bg_ratio), key, loss_type=loss_type, height=H,
                width=W, y0=y0, band_h=band_h, pad_h=pad_h)
            lt = bands.band_partial_loss(
                torch.tensor(pred_b), *tin, torch.tensor(em), s, bg_ratio,
                scores, loss_type=loss_type, height=H, width=W, y0=y0,
                band_h=band_h, pad_h=pad_h)
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5,
                                       err_msg=f"band {band} strategy {s}")
            sums[s] += float(lt)
    from edgegaussians_tpu_torch.models import losses
    p, g, e = torch.tensor(pred), torch.tensor(gt), torch.tensor(em)
    full = [losses.projection_loss_whole(p, g, loss_type),
            losses.projection_loss_bg_edge_ratio(p, g, e, bg_ratio, scores),
            losses.projection_loss_weighted(p, g,
                                            losses.compute_weight_mask(e))]
    np.testing.assert_allclose(sums, [float(x) for x in full], rtol=1e-5)


SEG_MODEL = dict(max_num_gaussians=320, tile_gaussian_capacity=64,
                 max_tiles_per_gaussian=16, tile_pair_budget=4096,
                 tile_pair_kernel="seg")


@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_sum_equals_single_device_proj_grad(n_bands):
    """Sum over bands of the port's band-partial losses, gradients and
    sinks against its single-device proj-grad, the three strategies; 4
    bands of 2 rows leave the last band all padding."""
    cfg = FrameworkConfig()
    for k, v in SEG_MODEL.items():
        setattr(cfg.model, k, v)
    r = np.random.default_rng(9)
    seeds = r.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    model = init_state(seeds, cfg.model, seed=1)
    with torch.no_grad():
        model.scales.fill_(float(np.log(0.03)))
        model.opacities.fill_(0.0)
    f = 55.0
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    vm = torch.eye(4)
    gt = torch.tensor(r.random((H, W)).astype(np.float32))
    em = gt >= 0.5
    scores = torch.rand(H * W, generator=torch.Generator().manual_seed(2))
    single = trainer.make_proj_grad_fn(cfg, W, H)
    kw = band_render_kwargs(cfg, W, H, n_bands)
    for s in range(3):
        l_ref, st_ref, g_ref, sink_ref = single(model, vm, K, gt, em, s, 1.0,
                                                scores)
        loss, sink = 0.0, torch.zeros_like(sink_ref)
        grads = {g: torch.zeros_like(x) for g, x in g_ref.items()}
        pairs = 0
        for band in range(n_bands):
            l, out, g, gs = band_loss_and_grads(
                model, vm, K, gt, em, s, 1.0, scores, cfg=cfg, width=W,
                height=H, n_bands=n_bands, band=band, render_kwargs=kw)
            loss += float(l)
            sink += gs
            pairs += int(out.num_pairs)
            for k in grads:
                grads[k] += g[k]
        assert pairs == int(st_ref.num_pairs)
        np.testing.assert_allclose(loss, float(l_ref), rtol=1e-5)
        for k in grads:
            np.testing.assert_allclose(grads[k].numpy(), g_ref[k].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(sink, dim=-1).numpy(),
            torch.linalg.vector_norm(sink_ref, dim=-1).numpy(),
            atol=1e-6, rtol=1e-4)
        assert float(sink.abs().max()) > 0
