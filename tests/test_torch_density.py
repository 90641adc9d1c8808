"""The port's density control (edgegaussians_tpu_torch/models/density.py)
held to the JAX package's, op by op, on the same random state.

States are made with NumPy from a seed: a fixed-capacity model with dead
slots scattered through it, random absgrads and Adam moments. The
duplication noise is JAX's draw from the test's key, handed to the port.
Alive masks must be equal; parameters, moments and absgrads within 1e-6
(the ops copy, add noise and mask: the same f32 operations on both
sides). Absgrads are drawn away from the 'absolute' threshold's knife
edge (density.py:220-224).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import ModelConfig as JModelConfig
from edgegaussians_tpu.models import density as jdensity
from edgegaussians_tpu.models.gaussians import GaussianParams, GaussianState
from edgegaussians_tpu_torch.config import ModelConfig
from edgegaussians_tpu_torch.models import density
from edgegaussians_tpu_torch.models.gaussians import GROUPS, GaussianModel
from edgegaussians_tpu_torch.train.optim import OptState

CAP = 64
_WIDTHS = {"means": 3, "scales": 3, "quats": 4, "opacities": 1}


def _arrays(seed=0, alive_frac=0.6):
    r = np.random.default_rng(seed)
    a = {g: r.normal(size=(CAP, w)).astype(np.float32)
         for g, w in _WIDTHS.items()}
    a["means"] = r.uniform(0.0, 1.0, (CAP, 3)).astype(np.float32)
    a["opacities"] = r.uniform(-4.0, 2.0, (CAP, 1)).astype(np.float32)
    a["alive"] = r.uniform(size=CAP) < alive_frac
    # normalized absgrads spread over [0, 1] with a gap around 0.5
    u = r.uniform(size=CAP)
    u = np.where(np.abs(u - 0.5) < 0.05, u + 0.1, u)
    a["absgrads"] = (u * 3.0).astype(np.float32)
    a["absgrad_count"] = np.float32(4.0)
    for g, w in _WIDTHS.items():
        a["mu." + g] = r.normal(size=(CAP, w)).astype(np.float32)
        a["nu." + g] = r.uniform(0, 1, (CAP, w)).astype(np.float32)
    return a


def _jax_state(a):
    gs = GaussianState(
        params=GaussianParams(**{g: jnp.asarray(a[g]) for g in GROUPS}),
        alive=jnp.asarray(a["alive"]), absgrads=jnp.asarray(a["absgrads"]),
        absgrad_count=jnp.asarray(a["absgrad_count"]))
    moments = jdensity.AdamMoments(**{
        g: (jnp.asarray(a["mu." + g]), jnp.asarray(a["nu." + g]))
        for g in GROUPS})
    return gs, moments


def _port_state(a):
    model = GaussianModel(CAP)
    with torch.no_grad():
        for g in GROUPS:
            getattr(model, g).copy_(torch.from_numpy(a[g]))
        model.alive.copy_(torch.from_numpy(a["alive"]))
        model.absgrads.copy_(torch.from_numpy(a["absgrads"]))
        model.absgrad_count.fill_(float(a["absgrad_count"]))
    opt = OptState(moments={g: (torch.from_numpy(a["mu." + g].copy()),
                                torch.from_numpy(a["nu." + g].copy()))
                            for g in GROUPS},
                   counts={g: 0 for g in GROUPS})
    return model, opt


def _assert_same(model, opt, gs, moments=None):
    np.testing.assert_array_equal(model.alive.numpy(), np.asarray(gs.alive))
    for g in GROUPS:
        np.testing.assert_allclose(getattr(model, g).detach().numpy(),
                                   np.asarray(getattr(gs.params, g)),
                                   rtol=0, atol=1e-6, err_msg=g)
        if moments is not None:
            for t, j in zip(opt.moments[g], getattr(moments, g)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                           atol=1e-6, err_msg="moment " + g)
    np.testing.assert_allclose(model.absgrads.numpy(), np.asarray(gs.absgrads),
                               rtol=0, atol=1e-6)
    assert float(model.absgrad_count) == float(gs.absgrad_count)


def _configs(**kw):
    return ModelConfig(**kw), JModelConfig(**kw)


@pytest.mark.parametrize("method", ["linear", "lower"])
@pytest.mark.parametrize("q", [0.0, 0.02, 0.5, 0.75, 0.98, 1.0])
def test_masked_quantile_matches_jax(q, method):
    a = _arrays(1)
    for mask in (a["alive"], np.ones(CAP, bool), np.eye(1, CAP, 5)[0] > 0):
        t = density.masked_quantile(torch.from_numpy(a["absgrads"]),
                                    torch.from_numpy(mask), q, method)
        j = jdensity.masked_quantile(jnp.asarray(a["absgrads"]),
                                     jnp.asarray(mask), q, method)
        assert float(t) == pytest.approx(float(j), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("threshold_type,value", [
    ("absolute", 0.5), ("percentile_top", 0.2), ("top_fraction", 0.25)])
def test_duplicate_high_pos_gradients_matches_jax(threshold_type, value):
    a = _arrays(2)
    cfg, jcfg = _configs(dup_threshold_type=threshold_type,
                         dup_threshold_value=value, dup_factor=3,
                         init_dup_rand_noise_scale=0.05)
    key = jax.random.PRNGKey(7)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (2, CAP, 3))))
    gs, moments = jdensity.duplicate_high_pos_gradients(
        *_jax_state(a), jcfg, key)
    model, opt = _port_state(a)
    density.duplicate_high_pos_gradients(model, opt, cfg, noise=noise)
    _assert_same(model, opt, gs, moments)
    n0 = int(a["alive"].sum())
    assert n0 < int(model.alive.sum()) <= CAP


def test_duplicate_all_matches_jax_and_drops_clones_past_capacity():
    a = _arrays(3, alive_frac=0.45)
    cfg, jcfg = _configs(dup_factor=4, init_dup_rand_noise_scale=0.1)
    key = jax.random.PRNGKey(8)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (3, CAP, 3))))
    gs, moments = jdensity.duplicate_all(*_jax_state(a), jcfg, key)
    model, opt = _port_state(a)
    density.duplicate_all(model, opt, cfg, noise=noise)
    _assert_same(model, opt, gs, moments)
    assert bool(model.alive.all())          # 4x the alive set > capacity


def test_duplicate_draws_from_the_generator():
    a = _arrays(4)
    cfg, _ = _configs(dup_factor=2)
    models = []
    for _ in range(2):
        model, opt = _port_state(a)
        density.duplicate_all(model, opt, cfg,
                              generator=torch.Generator().manual_seed(3))
        models.append(model)
    torch.testing.assert_close(models[0].means, models[1].means)
    assert int(models[0].alive.sum()) > int(a["alive"].sum())


@pytest.mark.parametrize("kind,value", [("absolute", 0.2),
                                        ("percentile", 0.3)])
def test_cull_low_opacity_matches_jax(kind, value):
    a = _arrays(5)
    cfg, jcfg = _configs(cull_opacity_type=kind, cull_opacity_value=value,
                         reset_opacity_value=0.5)
    gs, _ = jdensity.cull_low_opacity(*_jax_state(a), jcfg)
    model, opt = _port_state(a)
    density.cull_low_opacity(model, cfg)
    _assert_same(model, opt, gs)
    assert int(model.alive.sum()) < int(a["alive"].sum())


def test_reset_opacities_matches_jax():
    a = _arrays(6)
    gs, _ = _jax_state(a)
    model, opt = _port_state(a)
    density.reset_opacities(model, -1.0)
    gs = gs._replace(params=jdensity.reset_opacities(gs.params, -1.0))
    _assert_same(model, opt, gs)


def test_cull_not_projecting_matches_jax():
    a = _arrays(7)
    r = np.random.default_rng(8)
    v, h, w = 4, 24, 32
    f = 30.0
    Ks = np.tile(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                          np.float32), (v, 1, 1))
    vms = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    vms[:, :3, 3] = r.uniform(-0.3, 0.3, (v, 3))
    vms[:, 2, 3] += 2.0
    edges = r.uniform(size=(v, h, w)) < 0.4
    cfg, jcfg = _configs(cull_gaussians_not_projecting_threshold=0.3,
                         reset_opacity_value=0.5)
    gs, _ = jdensity.cull_not_projecting(
        *_jax_state(a), jcfg, jnp.asarray(vms), jnp.asarray(Ks),
        jnp.asarray(edges))
    model, opt = _port_state(a)
    density.cull_not_projecting(model, cfg, torch.from_numpy(vms),
                                torch.from_numpy(Ks), torch.from_numpy(edges))
    _assert_same(model, opt, gs)
    assert 0 < int(model.alive.sum()) < int(a["alive"].sum())


def test_cull_wayward_is_a_no_op_unless_applied():
    a = _arrays(9)
    cfg, jcfg = _configs(cull_wayward_apply=False)
    gs, _ = jdensity.cull_wayward(*_jax_state(a), jcfg)
    model, opt = _port_state(a)
    density.cull_wayward(model, cfg)
    _assert_same(model, opt, gs)
    assert torch.equal(model.alive, torch.from_numpy(a["alive"]))
    # applied, it culls (and clamps every opacity, as every cull does)
    cfg, jcfg = _configs(cull_wayward_apply=True, reset_opacity_value=0.5)
    gs, _ = jdensity.cull_wayward(*_jax_state(a), jcfg)
    density.cull_wayward(model, cfg)
    _assert_same(model, opt, gs)
    assert int(model.alive.sum()) < int(a["alive"].sum())


# The kNN distances of the two packages differ by ~1e-4 relative (direct
# differences vs the XLA expansion, tests/test_torch_knn.py) and the PCA
# eigenvalues by LAPACK rounding; the masks must still be equal, which
# holds where no statistic sits within that noise of its threshold.
@pytest.mark.parametrize("method,threshold_type,value", [
    ("mean_distance", "percentile_top", 0.1),
    ("mean_distance", "absolute", 0.4),
    ("max_distance", "percentile_top", 0.2),
    ("max_distance", "absolute", 0.55),
    ("pca_ratio", "percentile_top", 0.3),
    ("pca_ratio", "absolute", 0.6),
])
def test_wayward_mask_and_applied_cull_match_jax(method, threshold_type,
                                                 value):
    """Every method and threshold type (``pca_ratio`` reads the value as
    its quantile under either type, as the JAX version does), on 64 slots
    of which ~38 live, k = 10 neighbours."""
    a = _arrays(10)
    kw = dict(cull_wayward_method=method, cull_wayward_num_neighbors=10,
              cull_wayward_threshold_type=threshold_type,
              cull_wayward_threshold_value=value, cull_wayward_apply=True,
              reset_opacity_value=0.5)
    cfg, jcfg = _configs(**kw)
    gs, moments = _jax_state(a)
    j_mask = np.asarray(jdensity.wayward_mask(gs, jcfg))
    model, opt = _port_state(a)
    t_mask = density.wayward_mask(model, cfg).numpy()
    np.testing.assert_array_equal(t_mask, j_mask)
    live_flagged = int((t_mask & a["alive"]).sum())
    assert 0 < live_flagged < int(a["alive"].sum())
    gs, _ = jdensity.cull_wayward(gs, moments, jcfg)
    density.cull_wayward(model, cfg)
    _assert_same(model, opt, gs)
    assert int(model.alive.sum()) == int(a["alive"].sum()) - live_flagged
