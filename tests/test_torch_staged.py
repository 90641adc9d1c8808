"""Staged capacity and TensorBoard logging of the port's trainer, held to
the JAX package's.

- ``grow_capacity`` on a seeded JAX state carried over by ``convert.py``
  (random moments, some rows dead) equals JAX ``grow_capacity`` exactly
  in every array; a capacity at or below the current one changes nothing.
- ``staged_start_capacity`` equals JAX ``_staged_start_capacity`` over a
  grid of seed counts, start factors and maximum capacities.
- An 8-epoch trajectory of a cut staged recipe through both packages'
  ``train``: ``configs/DTU.json``'s staged settings and seg path on a
  5-view 64x48 synthetic scan with 150 seeds (tests/test_torch_
  trajectory.py's scan and start), started at 1024 rows of a 4096
  maximum, the grow threshold cut to 0.25 so that 150 live Gaussians
  reach it on an epoch with a duplication, and the duplications moved to
  epochs 3 and 6: at epoch 3 the capacity doubles first, then the clones
  are written with noise of the grown shape. The JAX run's draws are
  injected into the port's (each epoch's view order and bg scores from
  the key its checkpoint holds, the duplication noise from its density
  key, trainer.py:297-299, :217, :671). Capacity, the growth log line and
  ``alive`` equal at every epoch, each epoch's loss (read from both
  TensorBoard logs) rtol 1e-5, parameters within half their group's
  learning rate (tests/test_torch_trajectory.py's tolerances).
- A JAX checkpoint written after the growth resumes in the port at its
  own capacity, through ``load_checkpoint`` and the CLI; a capacity above
  the config's maximum is refused.
- The TensorBoard event files of a 2-epoch cut run from both trainers:
  the same tags at the same steps, scalars within rtol 1e-5, read with
  tensorboardX's own protobufs.
- scripts/torch_scale_run.py's Replica-layout scan equals the one
  scripts/dtu_scale_run.py writes with the JAX package's modules.
"""

import glob
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import config_from_dict
from edgegaussians_tpu.data import parsers
from edgegaussians_tpu.data.seed_points import init_seed_points_random
from edgegaussians_tpu.data.synthetic import generate_scene
from edgegaussians_tpu.train import trainer as jtrainer
from edgegaussians_tpu_torch import config as tconfig
from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.cli import train as train_cli
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.train import trainer

torch.set_num_threads(2)

W, H, VIEWS, SCAN, EPOCHS = 64, 48, 5, "SYN07", 8
N_SEED, MAX_CAP, START_CAP = 150, 4096, 1024
DUP_EPOCHS = [3, 6]


def _jax_flat(ts):
    return {jtrainer._ckpt_field_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]}


def _recipe(base_dir, out_dir, epochs=EPOCHS):
    """configs/DTU.json cut to the test's size, on random seeds."""
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "DTU.json")
    with open(path) as f:
        d = json.load(f)
    assert d["model"]["staged_capacity"]
    d["model"].update(
        init_random_init=True, init_min_num_gaussians=N_SEED,
        random_init_box_center=0.5, random_init_box_size=1.1,
        max_num_gaussians=MAX_CAP, staged_capacity_grow_threshold=0.25,
        init_scales_val=0.02, init_opacity_val=0.3, tile_pair_budget=8192,
        dup_high_pos_grads_at_epoch=DUP_EPOCHS, cull_opacity_at_epoch=[])
    t = d["training"]
    t.update(num_epochs=epochs, checkpoint_interval=1)
    for g in ("scales", "opacities", "quats"):
        t["optim"][g]["start_at_epoch"] = 0
    t["loss"]["projection_losses"]["start_alternating_at_epoch"] = 1
    d["data"].update(base_dir=base_dir, edge_detection_method="DexiNed",
                     dataset_name="ABC")
    d["output"].update(output_dir=out_dir, log_dir=out_dir + "logs/")
    return d


def _events(log_dir):
    """{tag: {step: value or image bytes}} of the tensorboardX event
    files under ``log_dir`` (TFRecord framing: length, its CRC, the
    record, its CRC)."""
    from tensorboardX.proto import event_pb2
    out = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "events.*"),
                                 recursive=True)):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, {})[ev.step] = (
                    v.simple_value if v.WhichOneof("value") == "simple_value"
                    else v.image.encoded_image_string)
    return out


def _train_jax(d, scene, seeds, out_dir):
    """Train config ``d`` with the JAX trainer, checkpointed every epoch
    under ``out_dir``; returns (log lines, checkpoints by epoch)."""
    logs = []
    jtrainer.train(scene, seeds, config_from_dict(d), backend="jax",
                   log_fn=logs.append, checkpoint_dir=out_dir,
                   log_dir=d["output"]["log_dir"])
    ckpts = []
    for e in range(d["training"]["num_epochs"]):
        with np.load(os.path.join(out_dir, f"epoch{e}.npz")) as z:
            ckpts.append(dict(z))
    return logs, ckpts


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The cut staged recipe trained by the JAX trainer, checkpointed and
    logged every epoch."""
    root = tmp_path_factory.mktemp("staged")
    generate_scene(str(root), SCAN, seed=7, n_views=VIEWS, width=W,
                   height=H, n_lines=3, n_curves=1, focal=60.0)
    d = _recipe(str(root / "data") + "/", str(root / "jax") + "/")
    cfg = config_from_dict(d)
    scene = parsers.load_scene(cfg.data, SCAN)
    seeds = init_seed_points_random(
        N_SEED, cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, np.random.default_rng(0))
    logs, ckpts = _train_jax(d, scene, seeds, str(root / "jax" / "ckpt"))
    return dict(root=root, d=d, scene=scene, seeds=seeds, logs=logs,
                ckpts=ckpts)


def _jax_draws(d, ckpts):
    """The view orders, bg scores and duplication noise of a JAX run of
    config ``d`` with checkpoints ``ckpts``, drawn from its keys as its
    trainer draws them."""
    seed = config_from_dict(d).training.seed
    n_copies = d["model"]["dup_factor"] - 1
    orders, bg, noise = [], {}, {}
    key = jax.random.PRNGKey(seed)
    dkey = jax.random.PRNGKey(seed + 1)
    for e in range(len(ckpts)):
        k, k_perm = jax.random.split(key)
        orders.append(np.asarray(
            jax.random.permutation(k_perm, VIEWS)).tolist())
        for i in range(VIEWS):
            _, k_bg, k = jax.random.split(k, 3)
            bg[e * VIEWS + i] = torch.tensor(np.asarray(
                jax.random.uniform(k_bg, (H * W,))))
        dkey, sub = jax.random.split(dkey)
        cap = ckpts[e]["f:.gaussians.alive"].shape[0]
        noise[e] = torch.tensor(np.asarray(jax.random.normal(
            sub, (n_copies, cap, 3))))
        key = jnp.asarray(ckpts[e]["f:.key"])
    return orders, bg, noise


def _port_run(run, out_dir, **kw):
    d = dict(run["d"], output=dict(run["d"]["output"],
                                   output_dir=out_dir + "/",
                                   log_dir=out_dir + "/logs/"))
    tcfg = tconfig.config_from_dict(d)
    orders, bg, noise = _jax_draws(run["d"], run["ckpts"])
    logs = []
    state = trainer.train(run["scene"], run["seeds"], tcfg, backend="torch",
                          log_fn=logs.append,
                          checkpoint_dir=os.path.join(out_dir, "ckpt"),
                          log_dir=d["output"]["log_dir"], view_orders=orders,
                          bg_scores=bg, density_noise=noise, **kw)
    return state, logs, d


def test_grow_capacity_matches_jax():
    d = _recipe("unused/", "unused/")
    cfg = config_from_dict(d)
    rng = np.random.default_rng(5)
    seeds = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    ts = jtrainer.init_train_state(seeds, cfg, capacity=512)
    alive = np.asarray(ts.gaussians.alive).copy()
    alive[rng.choice(300, 40, replace=False)] = False
    moments = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        ts.opt.moments)
    ts = ts._replace(
        gaussians=ts.gaussians._replace(
            alive=jnp.asarray(alive),
            absgrads=jnp.asarray(rng.uniform(size=512).astype(np.float32))),
        opt=ts.opt._replace(moments=moments))
    state = convert.state_from_arrays(_jax_flat(ts))
    before = convert.state_to_arrays(state)
    trainer.grow_capacity(state, 512)
    trainer.grow_capacity(state, 256)
    for k, v in convert.state_to_arrays(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    trainer.grow_capacity(state, 2048)
    want = _jax_flat(jtrainer.grow_capacity(ts, 2048))
    got = convert.state_to_arrays(state)
    assert got["f:.gaussians.alive"].shape == (2048,)
    for k, v in want.items():
        assert v.dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["f:.gaussians.params.quats"][512:],
                                  np.tile([[1.0, 0, 0, 0]], (1536, 1)))


@pytest.mark.parametrize("max_cap", [1024, 4096, 131072])
def test_staged_start_capacity_matches_jax(max_cap):
    for factor in (0.1, 1.0, 1.5, 2.0, 3.7):
        d = _recipe("unused/", "unused/")
        d["model"]["staged_capacity_start_factor"] = factor
        cfg, tcfg = config_from_dict(d), tconfig.config_from_dict(d)
        for n_seed in (0, 1, 500, 512, 1024, 2498, 20000, 65537):
            assert trainer.staged_start_capacity(n_seed, tcfg, max_cap) == \
                jtrainer._staged_start_capacity(n_seed, cfg, max_cap), \
                (n_seed, factor)


def test_staged_trajectory_matches_the_jax_trainer(jax_run, tmp_path):
    state, logs, d = _port_run(jax_run, str(tmp_path / "port"))
    grown = [x for x in jax_run["logs"] if "capacity" in x]
    assert grown[0] == (f"epoch {DUP_EPOCHS[0]}: capacity {START_CAP} -> "
                        f"2048 (alive {N_SEED})")
    assert [x for x in logs if "capacity" in x] == grown
    j_loss = _events(jax_run["d"]["output"]["log_dir"])["Projection_loss"]
    t_loss = _events(d["output"]["log_dir"])["Projection_loss"]
    assert sorted(j_loss) == sorted(t_loss) == list(range(EPOCHS))
    lrs = {g: d["training"]["optim"][g]["start_lr"] for g in GROUPS}
    caps = []
    for e in range(EPOCHS):
        np.testing.assert_allclose(t_loss[e], j_loss[e], rtol=1e-5,
                                   err_msg=f"loss, epoch {e}")
        ref = jax_run["ckpts"][e]
        with np.load(tmp_path / "port" / "ckpt" / f"epoch{e}.npz") as z:
            got = dict(z)
        np.testing.assert_array_equal(got["f:.gaussians.alive"],
                                      ref["f:.gaussians.alive"],
                                      err_msg=f"alive, epoch {e}")
        for g in GROUPS:
            k = f"f:.opt.counts.{g}"
            assert int(got[k]) == int(ref[k]), (k, e)
            k = f"f:.gaussians.params.{g}"
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=0.5 * lrs[g],
                                       err_msg=f"{g}, epoch {e}")
        caps.append(got["f:.gaussians.alive"].shape[0])
    alive = [int(c["f:.gaussians.alive"].sum()) for c in jax_run["ckpts"]]
    e0 = DUP_EPOCHS[0]
    assert caps[:e0] == [START_CAP] * e0 and caps[e0] == 2048
    assert alive[e0] > alive[e0 - 1] == N_SEED
    assert state.model.capacity == caps[-1]


def test_a_jax_checkpoint_after_a_growth_resumes_at_its_capacity(jax_run,
                                                                tmp_path):
    e = DUP_EPOCHS[0]
    path = str(jax_run["root"] / "jax" / "ckpt" / f"epoch{e}.npz")
    cap = jax_run["ckpts"][e]["f:.gaussians.alive"].shape[0]
    assert START_CAP < cap < MAX_CAP
    d = dict(jax_run["d"], output=dict(jax_run["d"]["output"],
                                       output_dir=str(tmp_path) + "/out/",
                                       log_dir=str(tmp_path) + "/logs/"))
    tcfg = tconfig.config_from_dict(d)
    template = trainer.init_train_state(jax_run["seeds"], tcfg)
    assert template.model.capacity == MAX_CAP
    state = trainer.load_checkpoint(path, template)
    assert state.model.capacity == cap
    assert state.step == (e + 1) * VIEWS
    small = trainer.init_train_state(jax_run["seeds"], tcfg, capacity=1024)
    with pytest.raises(ValueError, match="above the run's maximum 1024"):
        trainer.load_checkpoint(path, small)
    # the CLI resumes it and trains on at that capacity
    d["training"]["num_epochs"] = 1
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(d))
    assert train_cli.main(["--config_file", str(cfg_path), "--scene_name",
                           SCAN, "--backend", "torch", "--force_rerun",
                           "--ckpt_path", path]) == 0
    out = tmp_path / "out" / "release_DexiNed" / SCAN / "epoch0.npz"
    with np.load(out) as z:
        assert z["f:.gaussians.alive"].shape == (cap,)
        assert int(z["f:.step"]) == (e + 2) * VIEWS


def test_tensorboard_logs_match_the_jax_trainer(jax_run, tmp_path):
    d = _recipe(str(jax_run["root"] / "data") + "/",
                str(tmp_path / "jax") + "/", epochs=2)
    d["model"]["staged_capacity"] = False
    _, ckpts = _train_jax(d, jax_run["scene"], jax_run["seeds"],
                          str(tmp_path / "jax" / "ckpt"))
    orders, bg, _ = _jax_draws(d, ckpts)
    tlog = str(tmp_path / "port_logs")
    trainer.train(jax_run["scene"], jax_run["seeds"],
                  tconfig.config_from_dict(d), backend="torch",
                  log_fn=lambda *_: None, log_dir=tlog, view_orders=orders,
                  bg_scores=bg)
    j, t = _events(d["output"]["log_dir"]), _events(tlog)
    assert set(j) == set(t) == {"Projection_loss", "num_gaussians",
                                "Output_Image"}
    for tag in j:
        assert sorted(j[tag]) == sorted(t[tag]), tag
    assert sorted(t["Output_Image"]) == [0]
    assert sorted(t["Projection_loss"]) == [0, 1]
    for e in (0, 1):
        np.testing.assert_allclose(t["Projection_loss"][e],
                                   j["Projection_loss"][e], rtol=1e-5)
    assert t["num_gaussians"] == j["num_gaussians"] == {0: N_SEED,
                                                          1: N_SEED}


def test_replica_scan_matches_dtu_scale_run(tmp_path):
    """scripts/torch_scale_run.py writes the Replica-layout scan that
    scripts/dtu_scale_run.py's generate() writes, with the port's copies
    of the generator and the PLY writer: the same cameras, edge maps,
    ground truth and SfM seeds."""
    import argparse
    import importlib.util
    import sys

    from edgegaussians_tpu.io import ply as jply

    def load(name):
        path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                            f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    saved = list(sys.path)
    try:
        ref, port = load("dtu_scale_run"), load("torch_scale_run")
    finally:
        sys.path[:] = saved
    sc = port.REPLICA_SCENE
    args = argparse.Namespace(views=sc["n_views"], width=sc["width"],
                              height=sc["height"], lines=sc["n_lines"],
                              curves=sc["n_curves"])
    ref.generate(args, str(tmp_path / "jax"), "s0", "Replica")
    port.make_replica_scan(str(tmp_path / "port"), "s0")
    for rel in ("data/s0/colmap/sparse/sparse.ply",
                "groundtruth/sampled_pts/s0_0.005.ply"):
        np.testing.assert_array_equal(
            jply.read_point_cloud(str(tmp_path / "port" / rel)),
            jply.read_point_cloud(str(tmp_path / "jax" / rel)), err_msg=rel)
    with open(tmp_path / "jax" / "data" / "s0" / "meta_data.json") as f:
        meta = json.load(f)
    with open(tmp_path / "port" / "data" / "s0" / "meta_data.json") as f:
        assert json.load(f) == meta
    assert (meta["width"], meta["height"], len(meta["frames"])) == \
        (1200, 680, 30)
    for i in (0, 17, 29):
        name = f"edge_PidiNet/{i}_colors.png"
        assert (tmp_path / "port" / "data" / "s0" / name).read_bytes() == \
            (tmp_path / "jax" / "data" / "s0" / name).read_bytes(), name
