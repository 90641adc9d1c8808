"""An 8-epoch trajectory of the seg recipe through both trainers' epoch and
density functions, with the JAX draws injected: the step at which the
port's training could first part from the reference's.

The recipe (``configs/ABC_DexiNed.json``) is cut to a 5-view 64x48
synthetic scan and 150 Gaussians in a 320 capacity, with its events moved
into the run: the bg_edge_ratio strategy from epoch 2 (every 5th render),
the ratio loss from epoch 2 and the direction loss from epoch 3 (every
5th render), all four groups learning from epoch 0, a duplication at
epoch 3 under the recipe's 'absolute' threshold (0.5) and an opacity cull
at epoch 5 (threshold raised to 0.25 so that it fires). Each epoch the
JAX epoch's view order, every render's bg scores and the duplication
noise are drawn from the JAX keys as the JAX trainer draws them
(trainer.py:297-299, :217, :671) and handed to the port.

Tolerances: ``alive`` equal at every epoch; each epoch's mean loss rtol
1e-5 (f32 sums in another order); parameters atol half of their group's
learning rate, i.e. half of the largest move one Adam step makes (the
port's gradients match to ~1e-6 relative, which Adam's sign-like first
steps can turn into a fraction of a step on near-zero entries); Adam's
step counts equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from edgegaussians_tpu.config import config_from_dict
from edgegaussians_tpu.data import parsers
from edgegaussians_tpu.data.seed_points import init_seed_points_random
from edgegaussians_tpu.data.synthetic import generate_scene
from edgegaussians_tpu.train import trainer as jtrainer
from edgegaussians_tpu_torch import config as tconfig
from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.train import trainer

torch.set_num_threads(2)

W, H, VIEWS, SCAN, EPOCHS, CAPACITY = 64, 48, 5, "SYN07", 8, 320
DUP_EPOCH, CULL_EPOCH = 3, 5


def _recipe(base_dir):
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "ABC_DexiNed.json")
    with open(path) as f:
        d = json.load(f)
    d["model"].update(
        init_min_num_gaussians=150, max_num_gaussians=CAPACITY,
        init_scales_val=0.02, init_opacity_val=0.3,
        dup_high_pos_grads_at_epoch=[DUP_EPOCH],
        cull_opacity_at_epoch=[CULL_EPOCH], cull_opacity_value=0.25)
    assert d["model"]["dup_threshold_type"] == "absolute"
    t = d["training"]
    t["num_epochs"] = EPOCHS
    for g in ("scales", "opacities", "quats"):
        t["optim"][g]["start_at_epoch"] = 0
    t["loss"]["orientation_losses"].update(start_dir_loss_at_epoch=2,
                                           start_ratio_loss_at_epoch=1)
    t["loss"]["projection_losses"]["start_alternating_at_epoch"] = 1
    d["data"]["base_dir"] = base_dir
    return d


def _jax_state_in_port(ts):
    return convert.state_from_arrays(
        {jtrainer._ckpt_field_key(p): np.asarray(leaf)
         for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]})


def test_seg_recipe_trajectory_matches_the_jax_trainer(tmp_path):
    generate_scene(str(tmp_path), SCAN, seed=7, n_views=VIEWS, width=W,
                   height=H, n_lines=3, n_curves=1, focal=60.0)
    d = _recipe(str(tmp_path / "data") + "/")
    cfg, tcfg = config_from_dict(d), tconfig.config_from_dict(d)
    scene = parsers.load_scene(cfg.data, SCAN)
    seeds = init_seed_points_random(
        150, cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, np.random.default_rng(0))
    images = np.asarray(scene.images, np.float32)
    edges = images >= cfg.model.edge_detection_threshold
    jimg, jedge, jvm, jK = (jnp.asarray(a) for a in (
        images, edges, scene.viewmats, scene.Ks))
    timg, tedge, tvm, tK = (torch.from_numpy(np.asarray(a)) for a in (
        images, edges, scene.viewmats, scene.Ks))
    ts = jtrainer.init_train_state(seeds, cfg)
    state = trainer.init_train_state(seeds, tcfg)
    epoch_fn = jtrainer.make_epoch_fn(cfg, W, H, "jax")
    density_fn = jtrainer.make_density_fn(cfg)
    proj = trainer.make_proj_grad_fn(tcfg, W, H)
    lrs = {g: getattr(cfg.training.optim, g).start_lr for g in GROUPS}
    dkey = jax.random.PRNGKey(cfg.training.seed + 1)
    n_copies = cfg.model.dup_factor - 1
    alive = []
    for epoch in range(EPOCHS):
        # the JAX epoch's draws (trainer.py:297-299, :217)
        key, k_perm = jax.random.split(ts.key)
        order = np.asarray(jax.random.permutation(k_perm, VIEWS)).tolist()
        bg_scores = {}
        for i in range(VIEWS):
            _, k_bg, key = jax.random.split(key, 3)
            bg_scores[state.step + i] = torch.tensor(np.asarray(
                jax.random.uniform(k_bg, (H * W,))))
        ts, jstats = epoch_fn(ts, jnp.int32(epoch), jimg, jedge, jvm, jK)
        stats = trainer.run_epoch(state, epoch, timg, tedge, tvm, tK, tcfg,
                                  proj, view_order=order,
                                  bg_scores=bg_scores)
        np.testing.assert_allclose(stats.avg_loss, float(jstats.avg_loss),
                                   rtol=1e-5, err_msg=f"loss, epoch {epoch}")
        # the density draw (trainer.py:671) and its noise (density.py:276)
        dkey, sub = jax.random.split(dkey)
        noise = torch.tensor(np.asarray(jax.random.normal(
            sub, (n_copies, CAPACITY, 3))))
        ts, _ = jtrainer.run_density_control(ts, epoch, cfg, jvm, jK, jedge,
                                             sub, density_fn=density_fn)
        trainer.run_density_control(state, epoch, tcfg, tvm, tK, tedge,
                                    noise=noise)
        ref = _jax_state_in_port(ts)
        assert torch.equal(state.model.alive, ref.model.alive), epoch
        assert state.opt.counts == ref.opt.counts, epoch
        alive.append(int(state.model.alive.sum()))
        for g in GROUPS:
            np.testing.assert_allclose(
                getattr(state.model, g).detach().numpy(),
                getattr(ref.model, g).detach().numpy(), rtol=0,
                atol=0.5 * lrs[g], err_msg=f"{g}, epoch {epoch}")
    # the run crossed a duplication, a cull and the orientation fires
    assert alive[DUP_EPOCH] > alive[DUP_EPOCH - 1]
    assert alive[CULL_EPOCH] < alive[CULL_EPOCH - 1]
    renders = EPOCHS * VIEWS
    assert state.opt.counts["opacities"] == renders
    assert state.opt.counts["means"] > renders
