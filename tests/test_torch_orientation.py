"""The orientation losses of the port held to the JAX package's, and the
view steps that fire them.

- ``major_directions``, ``ratio_loss`` (tied scales included: the recipe
  starts every scale at one constant) and ``direction_loss`` (enforce_full
  and enforce_half): values and gradients against ``jax.grad`` on the same
  NumPy inputs. The same f32 arithmetic on both sides: values rtol 1e-6,
  gradients rtol 1e-5 with atol 1e-6 of the gradient's max-abs (sums over
  neighbours and rows in another order).
- ``update_nearest_neighbors``: the same neighbour sets as the JAX one,
  ties aside (tests/test_torch_knn.py's near-tie rule).
- The trainer: 5 views with both loss start epochs at -1, so both branches
  fire at the 5th and 10th render. The JAX view order is injected and the
  port's state is held to the JAX trainer's after each epoch (each ending
  in a fired step): parameters within rtol 1e-4, Adam moments within rtol
  5e-3, both with atol 1e-6 of each group's max-abs; Adam counts and step
  exact. The projection loss weight is 1e-6, so every projection gradient
  is far below Adam's eps 1e-8 and the compositor's rounding noise (rtol
  2e-3, atol 3e-4 in tests/test_torch_train.py) cannot flip the sign of a
  first Adam step; the orientation branches' gradients are well above eps
  and drive the parameters. The moments keep the projection gradients'
  relative noise (the opacities' hold nothing else), hence their rtol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import config_from_dict
from edgegaussians_tpu.data import parsers
from edgegaussians_tpu.data.synthetic import generate_scene
from edgegaussians_tpu.models import losses as jlosses
from edgegaussians_tpu.ops import transforms as jtransforms
from edgegaussians_tpu.train import trainer as jtrainer
from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.models import losses
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.ops import transforms
from edgegaussians_tpu_torch.train import trainer

torch.set_num_threads(2)


def _geometry(n=120, seed=0, tied=0):
    r = np.random.default_rng(seed)
    means = r.uniform(0, 1, (n, 3)).astype(np.float32)
    scales = np.exp(r.uniform(-6, -3, (n, 3))).astype(np.float32)
    scales[:tied] = 0.004                       # the recipe's constant init
    quats = r.normal(size=(n, 4)).astype(np.float32)
    alive = r.uniform(size=n) < 0.8
    return means, scales, quats, alive


def _assert_grad(t, j, what, scale=None):
    j = np.asarray(j)
    if scale is None:
        scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


def test_major_directions_match_jax():
    means, scales, quats, _ = _geometry(tied=10)
    scales[10:20, 1] = scales[10:20, 2]          # ties between two axes
    t = transforms.major_directions(torch.from_numpy(scales),
                                    torch.from_numpy(quats))
    j = jtransforms.major_directions(jnp.asarray(scales), jnp.asarray(quats))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tied", [0, 120, 40])
def test_ratio_loss_and_gradient_match_jax(tied):
    _, scales, _, alive = _geometry(tied=tied)
    log_s = np.log(scales)

    def jloss(ls):
        return jlosses.ratio_loss(jnp.exp(ls), jnp.asarray(alive))

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(log_s))
    ls = torch.from_numpy(log_s).requires_grad_()
    tv = losses.ratio_loss(torch.exp(ls), torch.from_numpy(alive))
    (tg,) = torch.autograd.grad(tv, [ls])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    # each live row's terms are O(1 / live count) before they cancel; on
    # tied rows the exact gradient is 0 and both sides leave rounding
    # residue of ~1e-7 of that (torch.max(dim=...) would leave O(1))
    _assert_grad(tg, jg, "d log scales", scale=1.0 / alive.sum())
    if tied == 120:
        assert float(tv.detach()) == 1.0


@pytest.mark.parametrize("method", ["enforce_full", "enforce_half"])
def test_direction_loss_neighbours_and_gradients_match_jax(method):
    means, scales, quats, alive = _geometry(seed=1, tied=30)
    k = 4
    nn_j = np.asarray(jlosses.update_nearest_neighbors(
        jnp.asarray(means), jnp.asarray(alive), k, method))
    nn_t = losses.update_nearest_neighbors(
        torch.from_numpy(means), torch.from_numpy(alive), k, method)
    assert nn_t.shape == nn_j.shape == (120, 2 * k if method ==
                                        "enforce_half" else k)
    np.testing.assert_array_equal(nn_t.numpy(), nn_j)

    def jloss(m, ls, q):
        return jlosses.direction_loss(m, jnp.exp(ls), q, jnp.asarray(nn_j),
                                      jnp.asarray(alive), k, method)

    args = (means, np.log(scales), quats)
    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    tm, tls, tq = (torch.from_numpy(a).requires_grad_() for a in args)
    tv = losses.direction_loss(tm, torch.exp(tls), tq, nn_t,
                               torch.from_numpy(alive), k, method)
    tg = torch.autograd.grad(tv, [tm, tls, tq], allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    for name, a, b in zip(("means", "log scales", "quats"), tg, jg):
        _assert_grad(a, b, name)
    assert float(np.abs(np.asarray(jg[0])).max()) > 0
    assert float(tg[1].abs().max()) == 0          # no gradient via argmax


W, H, VIEWS, SCAN = 64, 48, 5, "SYN05"


def _cfg(base_dir):
    group = {"type": "start_at", "start_lr": 2e-3, "start_at_epoch": 0}
    return config_from_dict({
        "model": {"init_random_init": True, "init_min_num_gaussians": 150,
                  "random_init_box_center": 0.5, "random_init_box_size": 0.6,
                  "init_scales_val": 0.02, "init_opacity_val": 0.3,
                  "if_duplicate_high_pos_grad": False,
                  "if_cull_low_opacity": False, "if_cull_wayward": False,
                  "if_cull_gaussians_not_projecting": False,
                  "max_num_gaussians": 192, "tile_gaussian_capacity": 64,
                  "tile_size": 16, "max_tiles_per_gaussian": 16,
                  "tile_pair_budget": 2048, "tile_pair_kernel": "seg"},
        "training": {
            "num_epochs": 2,
            "optim": {"means": {"type": "step", "start_lr": 5e-3,
                                "milestones": [1], "gamma": 0.5},
                      "scales": group, "quats": group,
                      "opacities": dict(group, start_lr=0.03)},
            "loss": {"orientation_losses": {
                         "start_dir_loss_at_epoch": -1,
                         "start_ratio_loss_at_epoch": -1,
                         "dir_loss_num_nn": 4,
                         "dir_loss_scale_factor": 0.1,
                         "ratio_loss_scale_factor": 0.05},
                     "projection_losses": {
                         "start_alternating_at_epoch": 99,
                         "lambda_start": 1e-6, "lambda_end": 1e-6}}},
        "data": {"parser_type": "emap", "dataset_name": "ABC",
                 "base_dir": base_dir, "edge_detection_method": "DexiNed",
                 "image_res_scaling_factor": 1, "scale_scene_unit": False},
        "output": {"output_dir": "unused", "exp_name": "t"},
    })


def _jax_flat(ts):
    return {jtrainer._ckpt_field_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]}


def test_fired_view_steps_match_the_jax_trainer(tmp_path):
    generate_scene(str(tmp_path), SCAN, seed=6, n_views=VIEWS, width=W,
                   height=H, n_lines=3, n_curves=1, focal=60.0)
    cfg = _cfg(str(tmp_path / "data") + "/")
    scene = parsers.load_scene(cfg.data, SCAN)
    from edgegaussians_tpu.data.seed_points import init_seed_points_random
    seeds = init_seed_points_random(150, 0.5, 0.6, np.random.default_rng(0))
    images = np.asarray(scene.images, np.float32)
    edges = images >= cfg.model.edge_detection_threshold
    jargs = [jnp.asarray(a) for a in (images, edges, scene.viewmats,
                                      scene.Ks)]
    targs = [torch.from_numpy(np.asarray(a)) for a in (images, edges,
                                                       scene.viewmats,
                                                       scene.Ks)]
    ts = jtrainer.init_train_state(seeds, cfg)
    state = trainer.init_train_state(seeds, cfg)
    epoch_fn = jtrainer.make_epoch_fn(cfg, W, H, "jax")
    proj = trainer.make_proj_grad_fn(cfg, W, H)
    for epoch in range(2):
        # the JAX epoch's view order (trainer.py:297-299), injected
        _, k_perm = jax.random.split(ts.key)
        order = np.asarray(jax.random.permutation(k_perm, VIEWS)).tolist()
        ts, jstats = epoch_fn(ts, jnp.int32(epoch), *jargs)
        stats = trainer.run_epoch(state, epoch, *targs, cfg, proj,
                                  view_order=order)
        assert stats.avg_loss == pytest.approx(float(jstats.avg_loss),
                                               rel=1e-5)
        ref = convert.state_from_arrays(_jax_flat(ts))
        assert state.step == ref.step == 5 * (epoch + 1)
        assert state.opt.counts == ref.opt.counts
        # projection steps plus two fired branches on the geometry groups
        assert state.opt.counts["means"] == 7 * (epoch + 1)
        assert state.opt.counts["opacities"] == 5 * (epoch + 1)
        for g in GROUPS:
            for what, a, b in (
                    ("param", getattr(state.model, g),
                     getattr(ref.model, g)),
                    ("mu", state.opt.moments[g][0], ref.opt.moments[g][0]),
                    ("nu", state.opt.moments[g][1], ref.opt.moments[g][1])):
                b = b.detach().numpy()
                np.testing.assert_allclose(
                    a.detach().numpy(), b,
                    rtol=1e-4 if what == "param" else 5e-3,
                    atol=1e-6 * max(float(np.abs(b).max()), 1e-30),
                    err_msg=f"epoch {epoch} {what} {g}")
