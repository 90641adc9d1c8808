"""The port's training step, trainer and CLI held to the JAX package.

- The per-view step: JAX ``make_proj_grad_fn(cfg, W, H, "jax")`` (seg
  compositor in interpret mode) against the port's, over 3 consecutive
  views covering the three loss strategies, from states carried across by
  ``convert.py``. Loss rtol 1e-5; gradients and absgrad atol 3e-4, rtol
  2e-3 (the seg compositor tolerances, tests/test_pallas_segpair.py).
  Adam is compared given IDENTICAL gradients (the JAX ones), because its
  first steps move each parameter by about lr*sign(g) and would amplify
  sign noise in near-zero gradient entries; its arithmetic is the same
  term for term, so rtol 1e-6.
- The trainer: injected view order, every shipped recipe accepted (staged
  capacity too; only the XLA oracle compositor is refused), schedules
  with the orientation losses and an applied wayward cull, the
  pair-overflow watermark's actions (the fallback
  switches to the dense two-level path), and a density event after a
  fallback held to the JAX package's density function on the same state
  (alive exact, parameters and moments within 1e-6).
- The CLI on CPU: outputs, the skip guard, and checkpoints that cross
  between the packages through ``convert.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import config_from_dict
from edgegaussians_tpu.data import parsers
from edgegaussians_tpu.data.synthetic import generate_scene
from edgegaussians_tpu.io.ply import read_gaussian_params_from_ply
from edgegaussians_tpu.train import optim as joptim
from edgegaussians_tpu.train import trainer as jtrainer
from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.cli import train as train_cli
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.train import optim, trainer

torch.set_num_threads(2)

W, H, VIEWS, SCAN = 64, 48, 3, "SYN01"
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3


def _cfg_dict(base_dir, out_dir, **model):
    m = {"init_random_init": True, "init_min_num_gaussians": 200,
         "random_init_box_center": 0.5, "random_init_box_size": 0.6,
         "init_scales_val": 0.02, "init_opacity_val": 0.3,
         "if_duplicate_high_pos_grad": False, "if_cull_low_opacity": False,
         "if_cull_wayward": False, "if_cull_gaussians_not_projecting": False,
         "max_num_gaussians": 256, "tile_gaussian_capacity": 64,
         "tile_size": 16, "max_tiles_per_gaussian": 16,
         "tile_pair_budget": 2048, "tile_pair_kernel": "seg"}
    m.update(model)
    group = {"type": "start_at", "start_lr": 1e-3, "start_at_epoch": 0}
    return {
        "model": m,
        "training": {
            "num_epochs": 2,
            "optim": {"means": {"type": "step", "start_lr": 5e-3,
                                "milestones": [1], "gamma": 0.5},
                      "scales": group, "quats": group,
                      "opacities": dict(group, start_lr=0.03)},
            "loss": {"orientation_losses": {"start_dir_loss_at_epoch": 99,
                                            "start_ratio_loss_at_epoch": 99},
                     "projection_losses": {"start_alternating_at_epoch": 0,
                                           "sampling_whole_num_epochs_ratio":
                                               2}}},
        "data": {"parser_type": "emap", "dataset_name": "ABC",
                 "base_dir": base_dir, "edge_detection_method": "DexiNed",
                 "image_res_scaling_factor": 1, "scale_scene_unit": False},
        "output": {"output_dir": out_dir, "export_ply": True,
                   "log_dir": out_dir, "exp_name": "t"},
    }


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("syn")
    generate_scene(str(root), SCAN, seed=3, n_views=VIEWS, width=W,
                   height=H, n_lines=3, n_curves=1, focal=60.0)
    return root


@pytest.fixture
def cfg_path(dataset, tmp_path):
    def make(**model):
        d = _cfg_dict(str(dataset / "data") + "/", str(tmp_path / "out") + "/",
                      **model)
        p = tmp_path / "cfg.json"
        p.write_text(json.dumps(d))
        return str(p), d
    return make


def _jax_flat(ts):
    """A JAX TrainState flattened under its checkpoint keys."""
    return {jtrainer._ckpt_field_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]}


def _scene_and_seeds(cfg):
    scene = parsers.load_scene(cfg.data, SCAN)
    rng = np.random.default_rng(cfg.training.seed)
    from edgegaussians_tpu.data.seed_points import init_seed_points_random
    seeds = init_seed_points_random(
        cfg.model.init_min_num_gaussians, cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, rng)
    return scene, seeds


def test_view_step_matches_jax(cfg_path):
    _, d = cfg_path()
    _check_view_steps(d, "jax", (0, 1, 2))   # whole, bg, weighted


# the other render paths' model settings and the JAX backend that runs
# the same compositor on the CPU: (a) the v4 pair kernel in interpret
# mode, (b) the v1 single-level frame, (c) the pair-prefix two-level frame
OTHER_PATHS = {
    "pair_v4": (dict(tile_pair_kernel=True), "jax"),
    "single_v1": (dict(rasterizer_backend="pallas_v1", tile_dense_capacity=0,
                       tile_pair_budget=0), "pallas_v1"),
    "pair_prefix": (dict(tile_pair_kernel=False, tile_dense_capacity=16),
                    "jax"),
}


@pytest.mark.parametrize("path", list(OTHER_PATHS))
def test_view_step_on_the_other_render_paths_matches_jax(cfg_path, path):
    """One view step of each render path this slice adds, with the same
    tolerances as the seg path's."""
    model, backend = OTHER_PATHS[path]
    _, d = cfg_path(**model)
    _check_view_steps(d, backend, (0,))


def _check_view_steps(d, backend, strategies):
    """View steps 0.. of ``strategies`` from the same state through the
    JAX ``make_proj_grad_fn(cfg, W, H, backend)`` and the port's, then
    Adam on the JAX gradients."""
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    images = np.asarray(scene.images, np.float32)
    edges = images >= cfg.model.edge_detection_threshold
    ts = jtrainer.init_train_state(seeds, cfg)
    jproj = jax.jit(jtrainer.make_proj_grad_fn(cfg, W, H, backend))
    tproj = trainer.make_proj_grad_fn(cfg, W, H)
    epoch = 1
    lrs_j = joptim.all_lrs(cfg.training.optim, jnp.int32(epoch))
    lrs_t = optim.all_lrs(cfg.training.optim, epoch)
    key = jax.random.PRNGKey(5)
    for v, strategy in zip(range(VIEWS), strategies):
        key, k_bg = jax.random.split(key)
        state = convert.state_from_arrays(_jax_flat(ts))
        # the port's state is the JAX state: init parity, then carry-over
        if v == 0:
            init = trainer.init_train_state(seeds, cfg)
            for g in GROUPS:
                torch.testing.assert_close(getattr(init.model, g),
                                           getattr(state.model, g),
                                           rtol=0, atol=0)
        lj, sj, gj, sinkj = jproj(
            ts.gaussians.params, ts.gaussians.alive,
            jnp.asarray(scene.viewmats[v]), jnp.asarray(scene.Ks[v]),
            jnp.asarray(images[v]), jnp.asarray(edges[v]),
            jnp.int32(strategy), jnp.float32(1.0), k_bg)
        assert 0 < edges[v].sum() < edges[v].size / 2
        scores = torch.tensor(np.asarray(jax.random.uniform(k_bg, (H * W,))))
        lt, st, gt, sinkt = tproj(
            state.model, torch.from_numpy(scene.viewmats[v]),
            torch.from_numpy(scene.Ks[v]), torch.from_numpy(images[v]),
            torch.from_numpy(edges[v]), strategy, 1.0, scores)
        if sj.num_pairs is not None:    # None on the single-level frame
            assert int(st.num_pairs) == int(sj.num_pairs) > 0
        assert int(st.max_tile) == int(sj.max_tile)
        assert int(st.n_overflow) == int(sj.n_overflow)
        assert int(st.num_truncated) == int(sj.num_truncated)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5,
                                   err_msg=f"loss, view {v}")
        for g in GROUPS:
            np.testing.assert_allclose(
                gt[g].numpy(), np.asarray(getattr(gj, g)), atol=GRAD_ATOL,
                rtol=GRAD_RTOL, err_msg=f"grad {g}, view {v}")
        np.testing.assert_allclose(sinkt.numpy(), np.asarray(sinkj),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)

        # Adam on identical gradients
        params_j, opt_j = joptim.apply_updates(ts.gaussians.params, gj,
                                               ts.opt, lrs_j)
        optim.apply_updates(state.model,
                            {g: torch.tensor(np.asarray(getattr(gj, g)))
                             for g in GROUPS}, state.opt, lrs_t)
        for g in GROUPS:
            mu_j, nu_j = getattr(opt_j.moments, g)
            for a, b in ((getattr(params_j, g), getattr(state.model, g)),
                         (mu_j, state.opt.moments[g][0]),
                         (nu_j, state.opt.moments[g][1])):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.detach().numpy(), a, rtol=1e-6,
                    atol=1e-6 * np.abs(a).max(), err_msg=f"adam {g}")
            assert state.opt.counts[g] == int(getattr(opt_j.counts, g))
        ts = ts._replace(gaussians=ts.gaussians._replace(params=params_j),
                         opt=opt_j)


def test_run_epoch_honours_injected_view_order(cfg_path):
    _, d = cfg_path()
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    images = torch.from_numpy(np.asarray(scene.images, np.float32))
    edges = images >= cfg.model.edge_detection_threshold
    vms, Ks = torch.from_numpy(scene.viewmats), torch.from_numpy(scene.Ks)
    state = trainer.init_train_state(seeds, cfg)
    twin = convert.state_from_arrays(convert.state_to_arrays(state))
    proj = trainer.make_proj_grad_fn(cfg, W, H)
    stats = trainer.run_epoch(state, 0, images, edges, vms, Ks, cfg, proj,
                              view_order=[2])
    loss, pstats, _, _ = proj(twin.model, vms[2], Ks[2], images[2], edges[2],
                              0, 1.0)
    assert stats.avg_loss == pytest.approx(float(loss), rel=1e-6)
    assert stats.max_pairs == int(pstats.num_pairs)
    assert state.step == 1 and state.opt.counts["means"] == 1
    assert float(state.model.absgrad_count) == 2.0
    assert not torch.equal(state.model.means, twin.model.means)


def test_train_cli_end_to_end_and_checkpoints(cfg_path, tmp_path):
    path, d = cfg_path()
    argv = ["--config_file", path, "--scene_name", SCAN, "--backend",
            "torch"]
    assert train_cli.main(argv) == 0
    out_dir = tmp_path / "out" / "t_DexiNed" / SCAN
    for name in ("gaussians_all.ply", "time.txt", "epoch1.npz"):
        assert (out_dir / name).exists(), name
    pos, _, _, opac = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))
    assert pos.shape == (200, 3) and np.isfinite(pos).all()
    assert np.isfinite(opac).all()

    # skip-if-trained guard: no retraining, outputs untouched
    stamp = os.path.getmtime(out_dir / "epoch1.npz")
    assert train_cli.main(argv) == 0
    assert os.path.getmtime(out_dir / "epoch1.npz") == stamp

    # the port's checkpoint loads in the JAX package, and back
    cfg = config_from_dict(d)
    _, seeds = _scene_and_seeds(cfg)
    ts = jtrainer.load_checkpoint(str(out_dir / "epoch1.npz"),
                                  jtrainer.init_train_state(seeds, cfg))
    assert int(ts.step) == 2 * VIEWS
    back = convert.state_from_arrays(_jax_flat(ts))
    with np.load(out_dir / "epoch1.npz") as data:
        for key, value in convert.state_to_arrays(back).items():
            if key != convert.GENERATOR_KEY:
                np.testing.assert_array_equal(value, data[key], err_msg=key)

    # a JAX checkpoint resumes the port's CLI
    jpath = jtrainer.save_checkpoint(ts, str(tmp_path / "jax_ckpt"), 1)
    state = trainer.load_checkpoint(jpath, trainer.init_train_state(seeds,
                                                                    cfg))
    assert state.step == 2 * VIEWS
    assert state.opt.counts == {g: 2 * VIEWS for g in GROUPS}
    assert train_cli.main(argv + ["--force_rerun", "--ckpt_path",
                                  jpath]) == 0


def test_train_cli_refuses_mesh_flags(cfg_path):
    """A mesh of several ranks outside torchrun exits with the command
    that launches it; --mesh_gauss does not combine with --mesh_tiles."""
    path, _ = cfg_path()
    argv = ["--config_file", path, "--scene_name", SCAN, "--backend",
            "torch"]
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2 "):
        train_cli.main(argv + ["--mesh_tiles", "2"])
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 4 "):
        train_cli.main(argv + ["--mesh_views", "2", "--mesh_gauss", "2"])
    with pytest.raises(SystemExit, match="cannot combine"):
        train_cli.main(argv + ["--mesh_tiles", "2", "--mesh_gauss", "2"])


def test_train_cli_without_backend_needs_a_gpu(cfg_path):
    """No --backend means 'auto', which means the card: where torch sees
    no GPU the CLI raises before it trains and writes nothing; --backend
    torch is how a run asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where torch sees no GPU")
    path, d = cfg_path()
    with pytest.raises(RuntimeError, match="--backend torch"):
        train_cli.main(["--config_file", path, "--scene_name", SCAN])
    assert not os.path.exists(os.path.join(d["output"]["output_dir"],
                                           "t_DexiNed", SCAN))


@pytest.mark.parametrize("flags,steps", [
    (["--mesh_tiles", "1"], 2 * VIEWS),
    (["--mesh_gauss", "1"], 2 * VIEWS),
    (["--mesh_views", "1"], 2),
])
def test_train_cli_runs_one_rank_meshes(cfg_path, flags, steps):
    """The mesh flags at one rank train in this process: a band of the
    whole image, a shard of all the Gaussians, or view batches (2 epochs
    of one batch of all 3 views); the single-device run's outputs."""
    path, d = cfg_path()
    assert train_cli.main(["--config_file", path, "--scene_name", SCAN,
                           "--backend", "torch", "--force_rerun"]
                          + flags) == 0
    out = os.path.join(d["output"]["output_dir"], "t_DexiNed", SCAN)
    with np.load(os.path.join(out, "epoch1.npz")) as ck:
        assert int(ck["f:.step"]) == steps
        assert np.isfinite(ck["f:.gaussians.params.means"]).all()
    assert os.path.exists(os.path.join(out, "gaussians_all.ply"))


@pytest.mark.parametrize("change,match", [
    (dict(model={"staged_capacity": True}), "staged"),
    (dict(training={"step_mode": "view_batch"}), "view_batch"),
])
def test_staged_capacity_runs_and_view_batches_need_a_views_axis(
        cfg_path, change, match):
    """Staged capacity runs: 2 epochs of 3 views start at the staged
    capacity (1024 rows for 200 seeds, under the 2048 maximum) and grow
    only past the threshold. View batches are refused on a mesh without a
    'views' axis."""
    _, d = cfg_path(**change.get("model", {}))
    d["training"].update(change.get("training", {}))
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    if "training" in change:
        from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
        with pytest.raises(ValueError, match=match):
            trainer.train(scene, seeds, cfg, backend="torch",
                          mesh=mesh_mod.axis_mesh("tiles", 1))
        return
    cfg.model.max_num_gaussians = 2048
    logs = []
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append)
    assert state.model.capacity == 1024 and state.step == 2 * VIEWS
    assert not [x for x in logs if "capacity" in x]
    assert int(state.model.alive.sum()) == seeds.shape[0]
    cfg.model.staged_capacity_grow_threshold = 0.15    # 200 > 0.15 * 1024
    logs = []
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append)
    assert state.model.capacity == 2048
    assert logs[0] == "epoch 0: capacity 1024 -> 2048 (alive 200)"
    assert state.opt.moments["means"][0].shape == (2048, 3)


WAYWARD = {"if_cull_wayward": True, "cull_wayward_apply": True,
           "cull_wayward_num_neighbors": 6,
           "cull_wayward_threshold_value": 0.1}


@pytest.mark.parametrize("change", [
    dict(model=dict(WAYWARD, cull_wayward_at_epoch=[1])),
    dict(model=dict(WAYWARD, cull_wayward_at_epoch=[0],
                    cull_wayward_method="pca_ratio")),
    dict(orient={"start_dir_loss_at_epoch": 0}),
    dict(orient={"start_ratio_loss_at_epoch": 0}),
], ids=["wayward", "wayward_pca", "direction", "ratio"])
def test_train_runs_orientation_and_wayward_schedules(cfg_path, change):
    """The schedules the port refused before it had a kNN: 2 epochs of 3
    views; a loss starting after epoch 0 fires at render 5 (in epoch 1) and
    adds one Adam step on the geometry groups only; an applied wayward
    cull drops live Gaussians."""
    _, d = cfg_path(**change.get("model", {}))
    d["training"]["loss"]["orientation_losses"].update(
        change.get("orient", {}))
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    logs = []
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append)
    assert len([x for x in logs if x.startswith("epoch ")]) == 2
    assert state.step == 2 * VIEWS
    fired = 1 if "orient" in change else 0
    assert state.opt.counts == {"means": 6 + fired, "scales": 6 + fired,
                                "quats": 6 + fired, "opacities": 6}
    for g in GROUPS:
        assert torch.isfinite(getattr(state.model, g)).all(), g
    n_alive = int(state.model.alive.sum())
    assert n_alive < seeds.shape[0] if "model" in change \
        else n_alive == seeds.shape[0]


def test_every_shipped_recipe_is_accepted():
    """Every shipped recipe is accepted as it stands: the ABC recipes at
    their full num_epochs (the ratio loss after epoch 100, the direction
    loss after 250, their kNN and the wayward cull are ported) and the
    DTU and Replica recipes with their staged capacity. The one schedule
    the trainer refuses, in the ``resolve_backend`` call it starts with,
    is the XLA oracle compositor."""
    from edgegaussians_tpu_torch import resolve_backend
    from edgegaussians_tpu_torch.config import load_config
    for name in ("ABC_DexiNed", "ABC_DexiNed_fast", "ABC_PidiNet", "DTU",
                 "Replica"):
        cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                       "configs", f"{name}.json"))
        assert cfg.training.num_epochs - 1 > \
            cfg.training.loss.orientation_losses.start_dir_loss_at_epoch
        assert cfg.model.staged_capacity == (name in ("DTU", "Replica"))
        assert resolve_backend("torch", cfg.model.rasterizer_backend) == \
            "torch"
        for oracle in ("jax", "reference"):
            with pytest.raises(ValueError, match="XLA oracle"):
                resolve_backend("torch", oracle)


def _count_renders(monkeypatch):
    """Count the seg and two-level compositor calls of the rasterizer."""
    from edgegaussians_tpu_torch.ops import rasterize as rz
    calls = {"seg": 0, "two_level": 0}
    for name, fn_name in (("seg", "SegpairRender"),
                          ("two_level", "TileRenderTwoLevel")):
        fn = getattr(rz, fn_name)

        class Counted(fn):
            @classmethod
            def apply(cls, *args, _name=name, **kw):
                calls[_name] += 1
                return super().apply(*args, **kw)

        monkeypatch.setattr(rz, fn_name, Counted)
    return calls


@pytest.mark.parametrize("action,err", [
    ("warn", None), ("error", RuntimeError), ("fallback", None)])
def test_pair_overflow_actions(cfg_path, monkeypatch, action, err):
    _, d = cfg_path(tile_pair_budget=16, tile_pair_overflow_action=action,
                    tile_dense_capacity=16)
    d["training"]["num_epochs"] = 2 if action == "fallback" else 1
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    logs = []
    calls = _count_renders(monkeypatch)
    if err is None:
        trainer.train(scene, seeds, cfg, backend="torch", log_fn=logs.append)
        warnings = [line for line in logs
                    if "WARNING" in line and "DROPPED" in line]
        assert len(warnings) == 1 and "tile_pair_budget=16" in warnings[0]
    else:
        with pytest.raises(err, match="tile_pair_budget=16"):
            trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append)
    assert logs and "px/s=" in logs[0] and "pairs=" in logs[0]
    if action == "fallback":
        # the overflowed epoch stays truncated; the next renders all go
        # through the dense two-level frame, and pairs are still reported
        assert "switching to the dense frame path" in warnings[0]
        assert calls == {"seg": VIEWS, "two_level": VIEWS}
        assert logs[-1].startswith("epoch 1: ") and "pairs=" in logs[-1]
        assert float(logs[-1].split("loss=")[1].split()[0]) > 0


def _count_all_renders(monkeypatch):
    """Count each compositor's calls, and which single-level compositor."""
    from edgegaussians_tpu_torch.ops import rasterize as rz
    calls = {}
    for fn_name in ("SegpairRender", "PairRender", "TileRenderTwoLevel",
                    "TileRender"):
        fn = getattr(rz, fn_name)

        class Counted(fn):
            @classmethod
            def apply(cls, *args, _name=fn_name):
                key = _name if _name != "TileRender" else \
                    f"TileRender/{args[-1]}"
                calls[key] = calls.get(key, 0) + 1
                return super().apply(*args)

        monkeypatch.setattr(rz, fn_name, Counted)
    return calls


@pytest.mark.parametrize("path", list(OTHER_PATHS))
def test_train_runs_the_other_render_paths(cfg_path, monkeypatch, path):
    """Configs with ``tile_pair_kernel: true``, ``rasterizer_backend:
    "pallas_v1"`` or the pair kernel off under a pair budget load and
    train in the port's trainer, every render on their compositor."""
    model, _ = OTHER_PATHS[path]
    _, d = cfg_path(**model)
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    calls = _count_all_renders(monkeypatch)
    logs = []
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append)
    renders = 2 * VIEWS
    expected = {"pair_v4": {"PairRender": renders},
                "single_v1": {"TileRender/pallas_v1": renders},
                "pair_prefix": {"TileRenderTwoLevel": renders}}[path]
    assert calls == expected
    assert state.step == renders
    losses = [float(x.split("loss=")[1].split()[0]) for x in logs
              if x.startswith("epoch ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ("pairs=" in logs[0]) == (path != "single_v1")


def test_train_refuses_the_xla_oracle_backend(cfg_path):
    path, d = cfg_path(rasterizer_backend="jax")
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    with pytest.raises(ValueError, match="XLA oracle"):
        trainer.train(scene, seeds, cfg, backend="torch")
    with pytest.raises(ValueError, match="XLA oracle"):
        train_cli.main(["--config_file", path, "--scene_name", SCAN])


def test_pair_overflow_fallback_from_the_v4_path(cfg_path, monkeypatch):
    """The 'fallback' action rebuilds a ``tile_pair_kernel: true`` run
    with ``tile_pair_budget=0`` as for the seg kernel (trainer.py:716-738):
    epoch 0 overflows on the v4 path, epoch 1 renders on the dense
    two-level frame."""
    _, d = cfg_path(tile_pair_budget=16, tile_pair_kernel=True,
                    tile_pair_overflow_action="fallback",
                    tile_dense_capacity=16)
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    calls = _count_all_renders(monkeypatch)
    logs = []
    trainer.train(scene, seeds, cfg, backend="torch", log_fn=logs.append)
    assert sum("switching to the dense frame path" in x for x in logs) == 1
    assert calls == {"PairRender": VIEWS, "TileRenderTwoLevel": VIEWS}


@pytest.mark.parametrize("mode", ["tiles", "gauss", "view_batch"])
def test_pair_overflow_fallback_rebuilds_the_mesh_step(cfg_path, monkeypatch,
                                                       mode):
    """Under a one-rank mesh (a band of the whole image, a shard of all
    Gaussians, or view batches) the 'fallback' action rebuilds the mesh's
    step with ``tile_pair_budget=0`` (trainer.py:716-738): epoch 0 on the
    seg path, epoch 1 on the dense two-level frame."""
    from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
    _, d = cfg_path(tile_pair_budget=16, tile_pair_overflow_action="fallback",
                    tile_dense_capacity=16)
    if mode == "view_batch":
        d["training"]["step_mode"] = "view_batch"
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    calls = _count_renders(monkeypatch)
    logs = []
    mesh = None if mode == "view_batch" else mesh_mod.axis_mesh(mode, 1)
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append, mesh=mesh, mesh_strategy=mode)
    assert sum("switching to the dense frame path" in x for x in logs) == 1
    assert calls == {"seg": VIEWS, "two_level": VIEWS}
    assert state.step == (2 if mode == "view_batch" else 2 * VIEWS)


def test_density_event_after_a_fallback_matches_jax(cfg_path, tmp_path):
    """3 epochs: epoch 0 overflows the pair budget and falls back to the
    dense two-level frame, epoch 1 ends with a duplication, epoch 2 trains
    on. The state right after the event is held to the JAX package's
    density function applied to the same pre-event state (from a twin run
    without the event) with the same noise."""
    event = dict(tile_pair_budget=16, tile_dense_capacity=16,
                 tile_overflow_tiles=4, if_duplicate_high_pos_grad=True,
                 dup_high_pos_grads_at_epoch=[1],
                 dup_threshold_type="top_fraction", dup_threshold_value=0.3,
                 dup_factor=3)
    _, d = cfg_path(**event)
    d["training"]["num_epochs"] = 3
    d["training"]["checkpoint_interval"] = 1
    cfg = config_from_dict(d)
    scene, seeds = _scene_and_seeds(cfg)
    key = jax.random.PRNGKey(11)
    cap = cfg.model.max_num_gaussians
    noise = np.asarray(jax.random.normal(key, (2, cap, 3)))
    logs = []
    state = trainer.train(scene, seeds, cfg, backend="torch",
                          log_fn=logs.append,
                          checkpoint_dir=str(tmp_path / "event"),
                          density_noise={1: torch.tensor(noise)})
    assert sum("switching to the dense frame path" in x for x in logs) == 1
    assert [x.split(":")[0] for x in logs if x.startswith("epoch")][-1] \
        == "epoch 2"
    assert int(state.model.alive.sum()) > seeds.shape[0]

    twin = config_from_dict(dict(d, training=dict(d["training"],
                                                  num_epochs=2)))
    twin.model.if_duplicate_high_pos_grad = False
    trainer.train(scene, seeds, twin, backend="torch", log_fn=lambda _: None,
                  checkpoint_dir=str(tmp_path / "twin"))
    pre = jtrainer.load_checkpoint(str(tmp_path / "twin" / "epoch1.npz"),
                                   jtrainer.init_train_state(seeds, cfg))
    images = np.asarray(scene.images, np.float32)
    gs, moments = jtrainer.make_density_fn(cfg)(
        pre.gaussians, pre.opt.moments,
        jnp.asarray(jtrainer.density_flags(1, cfg)),
        jnp.asarray(scene.viewmats), jnp.asarray(scene.Ks),
        jnp.asarray(images >= cfg.model.edge_detection_threshold), key)
    post = jtrainer.load_checkpoint(str(tmp_path / "event" / "epoch1.npz"),
                                    jtrainer.init_train_state(seeds, cfg))
    np.testing.assert_array_equal(np.asarray(post.gaussians.alive),
                                  np.asarray(gs.alive))
    assert int(np.sum(gs.alive)) > int(np.sum(pre.gaussians.alive))
    for g in GROUPS:
        np.testing.assert_allclose(
            np.asarray(getattr(post.gaussians.params, g)),
            np.asarray(getattr(gs.params, g)), rtol=0, atol=1e-6, err_msg=g)
        for a, b in zip(getattr(post.opt.moments, g), getattr(moments, g)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg="moment " + g)
    np.testing.assert_array_equal(np.asarray(post.gaussians.absgrads),
                                  np.asarray(gs.absgrads))
    assert float(post.gaussians.absgrad_count) == 1.0
