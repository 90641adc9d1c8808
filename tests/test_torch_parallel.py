"""The port's sharded trainers on CPU Gloo ranks, held to the JAX package
and to the port's own single-process runs.

Ranks are spawned processes of scripts/torch_multiprocess_worker.py
(Gloo, CPU tensors), given the launcher's environment by hand; every spawn
has an ``init_process_group`` timeout and a subprocess timeout, and runs
many checks, since each costs ~8 s of process start. The JAX references
run in this process on the conftest's virtual CPU devices, as
tests/test_train_sharded.py, test_train_tp.py and
test_train_dp_trajectory.py run them, with the same inputs (the port's
state is the JAX state carried over by ``convert.py``; the bg_edge_ratio
scores are the JAX keys' draws, injected).

One 4-rank spawn (seg path, 64x80 = 5 tile rows, so 4 bands of 2 rows
pad past the image):

- tile-band proj-grad against ``make_sharded_proj_grad_fn`` on a
  4-device 'tiles' mesh and Gaussian-axis proj-grad against
  ``make_tp_proj_grad_fn`` on a 4-device 'gauss' mesh, three strategies:
  loss rtol 1e-5, the four gradient groups and the sink atol 3e-4 + rtol
  2e-3 (the seg-vs-dense tolerances, tests/test_pallas_segpair.py:65-66),
  absgrad (the norm of the sink) the same, watermarks (max_tile,
  n_overflow, num_truncated, num_pairs) equal;
- three view-batch steps (bg_edge_ratio, weighted, whole) on a flat 4x1,
  a 2x2 views x tiles and a 2x2 views x gauss mesh against
  ``make_dp_train_step``: losses rtol 1e-5, parameters, Adam moments and
  absgrads atol 1e-5 + rtol 1e-3 (three Adam steps of lr 1e-3 from
  gradients within the tolerances above);
- the tile-sharded 'whole' loss and gradients of one view
  (``make_tile_sharded_render``, one tile row per rank) against JAX's on a
  1x4 mesh, the same tolerances;
- every rank's results equal rank 0's bit for bit (one all-reduce);
- the shard-sum probe, all-reduced over the 4 ranks, against JAX's probe
  kernel (tests/test_vma.py:205, interpret mode, ``check_vma=False``) on
  the same array of uniform draws: rtol 1e-4 (JAX adds each shard's 16384
  rows one by one), and within 1e-5 of the float64 sum, 1x the array's
  sum, not 4x; the all-gather's backward gives each shard the sum of the
  ranks' cotangents, not 4 times its own.

One 2-rank spawn: 3 epochs of ``trainer.train`` on a ('tiles', 2) mesh
(a ratio fire and a duplication), 3 epochs of view batches on a
('views', 2) mesh and the same with staged capacity (a growth before the
duplication; bit for bit the one-process run's state), against the
port's single-process runs of the same config and seed: the ranks'
states equal bit for bit; epoch losses (the
log line's 5 decimals) within one printed digit; alive equal;
parameters, Adam moments and absgrads atol 1e-5 + rtol 1e-3 (moments
and absgrads scale with the gradients: a gradient counted twice would
double them).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import config_from_dict as jconfig_from_dict
from edgegaussians_tpu.parallel import mesh as jmesh_mod
from edgegaussians_tpu.parallel import train_dp as jtrain_dp
from edgegaussians_tpu.parallel import train_sharded as jtrain_sharded
from edgegaussians_tpu.parallel import train_tp as jtrain_tp
from edgegaussians_tpu.train import trainer as jtrainer
from edgegaussians_tpu_torch import convert
from edgegaussians_tpu_torch.config import config_from_dict
from edgegaussians_tpu_torch.data.parsers import SceneViews
from edgegaussians_tpu_torch.models.gaussians import GROUPS
from edgegaussians_tpu_torch.train import trainer

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "scripts", "torch_multiprocess_worker.py")
SPAWN_TIMEOUT = 300
W, H, VIEWS = 64, 80, 4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
STATE_ATOL, STATE_RTOL = 1e-5, 1e-3
DP_EPOCHS = (0, 1, 1)          # strategies bg_edge_ratio, weighted, whole
DP_MESHES = ("flat", "tiles", "gauss")


def _cfg_dict(**training):
    group = {"type": "start_at", "start_lr": 1e-3, "start_at_epoch": 0}
    t = {"num_epochs": 3, "seed": 0,
         "optim": {"means": dict(group), "scales": dict(group),
                   "quats": dict(group),
                   "opacities": dict(group, start_lr=0.01)},
         "loss": {"orientation_losses": {"start_dir_loss_at_epoch": 99,
                                         "start_ratio_loss_at_epoch": 0},
                  "projection_losses": {
                      "loss_before_alternating": "bg_edge_ratio",
                      "start_alternating_at_epoch": 0,
                      "less_freq_loss": "whole",
                      "more_freq_loss": "weighted",
                      "sampling_whole_num_epochs_ratio": 2,
                      "bg_edge_pixel_ratio_start": 1.5,
                      "bg_edge_pixel_ratio_end": 1.5}}}
    t.update(training)
    return {"model": {"max_num_gaussians": 128, "tile_gaussian_capacity": 64,
                      "max_tiles_per_gaussian": 16, "tile_pair_budget": 4096,
                      "tile_pair_kernel": "seg", "init_scales_val": 0.03,
                      "init_opacity_val": 0.5,
                      "if_duplicate_high_pos_grad": True,
                      "dup_threshold_type": "top_fraction",
                      "dup_threshold_value": 0.2,
                      "dup_high_pos_grads_at_epoch": [1],
                      "if_cull_low_opacity": False,
                      "if_cull_gaussians_not_projecting": False},
            "training": t}


def _scene(seed=0, n_seed=96):
    r = np.random.default_rng(seed)
    seeds = r.uniform(-0.5, 0.5, (n_seed, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = r.random((VIEWS, H, W)).astype(np.float32)
    f = 60.0
    Ks = np.tile(np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                          np.float32), (VIEWS, 1, 1))
    vms = np.tile(np.eye(4, dtype=np.float32)[None], (VIEWS, 1, 1))
    # views differ: a small shift of the camera per view
    vms[:, 0, 3] = np.linspace(-0.05, 0.05, VIEWS)
    return seeds, images, vms, Ks


def _jax_flat(ts):
    return {jtrainer._ckpt_field_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world, tasks, inputs, out):
    """Run the worker on ``world`` Gloo ranks; every rank's outputs."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    cmd = [sys.executable, _WORKER, "--tasks", tasks, "--out", str(out),
           "--device", "cpu"]
    if inputs:
        cmd += ["--inputs", str(inputs)]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


def _write_inputs(path, cfg_dict, ts, images, vms, Ks, **extra):
    np.savez(path, cfg_json=np.array(json.dumps(cfg_dict)), images=images,
             viewmats=vms, Ks=Ks, edge_threshold=np.float32(0.5),
             **_jax_flat(ts), **extra)


def _dp_bg_scores(ts, mesh_shape):
    """The JAX view-batch step's bg_edge_ratio draws of each batch view:
    the step key folded with the view row, split once per view of the
    row (train_dp.py:288-289, :161)."""
    _, k_step = jax.random.split(ts.key)
    n_rows = mesh_shape[0]
    per = VIEWS // n_rows
    out = []
    for v in range(n_rows):
        key = jax.random.fold_in(k_step, v)
        for _ in range(per):
            key, k_bg = jax.random.split(key)
            out.append(np.asarray(jax.random.uniform(k_bg, (H * W,))))
    return np.stack(out)


JAX_DP_MESHES = {
    "flat": (lambda: jmesh_mod.make_mesh(4, 1, devices=jax.devices()[:4]),
             (4, 1)),
    "tiles": (lambda: jmesh_mod.make_mesh(2, 2, devices=jax.devices()[:4]),
              (2, 2)),
    "gauss": (lambda: jmesh_mod.make_views_gauss_mesh(
        2, 2, devices=jax.devices()[:4]), (2, 2)),
}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank spawn's outputs and the JAX references."""
    tmp = tmp_path_factory.mktemp("four")
    d = _cfg_dict()
    jcfg = jconfig_from_dict(d)
    seeds, images, vms, Ks = _scene()
    ts = jtrainer.init_train_state(seeds, jcfg)
    key = jax.random.PRNGKey(7)
    proj_scores = np.asarray(jax.random.uniform(key, (H * W,)))[None]
    # the JAX states each DP step starts from, and its draws
    dp_scores = {}
    refs = {}
    ji = jnp.asarray(images)
    jem = ji >= 0.5
    jvm, jK = jnp.asarray(vms), jnp.asarray(Ks)
    for name, (make_mesh, shape) in JAX_DP_MESHES.items():
        mesh = make_mesh()
        step = jtrain_dp.make_dp_train_step(jcfg, W, H, "jax", mesh)
        s = ts
        scores = []
        for i, epoch in enumerate(DP_EPOCHS):
            scores.append(_dp_bg_scores(s, shape))
            with mesh:
                s, loss, _ = step(s, jnp.int32(epoch), ji, jem, jvm, jK)
            refs[f"dp_{name}_loss{i}"] = float(loss)
        refs[f"dp_{name}_state"] = _jax_flat(s)
        dp_scores[f"dp_bg_scores_{name}"] = np.stack(scores)
    th = 64
    fn = jtrain_dp.make_tile_sharded_render(
        jcfg, W, th, "jax", jmesh_mod.make_mesh(1, 4,
                                                devices=jax.devices()[:4]))
    refs["tile_render"] = fn(ts.gaussians.params, ts.gaussians.alive,
                             jvm[0], jK[0], ji[0, :th])
    for axis, make in (("tiles", jtrain_sharded.make_sharded_proj_grad_fn),
                       ("gauss", jtrain_tp.make_tp_proj_grad_fn)):
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), (axis,))
        fn = jax.jit(make(jcfg, W, H, "jax", mesh, axis))
        for s in range(3):
            refs[f"proj_{axis}_s{s}"] = fn(
                ts.gaussians.params, ts.gaussians.alive, jvm[0], jK[0],
                ji[0], jem[0], jnp.int32(s), jnp.float32(1.5), key)
    inputs = tmp / "inputs.npz"
    _write_inputs(inputs, d, ts, images, vms, Ks, bg_scores=proj_scores,
                  bg_ratio=np.float32(1.5),
                  dp_epochs=np.array(DP_EPOCHS), **dp_scores)
    ranks = spawn(4, "proj,dp,probe", inputs, tmp / "out")
    return ranks, refs


def _close(got, ref, what, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=what)


def test_ranks_agree_bit_for_bit(four_ranks):
    ranks, _ = four_ranks
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k in r:
            if k in ("probe_plain", "gather_value", "gather_grad"):
                continue
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("axis", ["tiles", "gauss"])
def test_sharded_proj_grad_matches_jax(four_ranks, axis):
    ranks, refs = four_ranks
    out = ranks[0]
    for s in range(3):
        key = f"proj_{axis}_s{s}"
        l_j, st_j, g_j, sink_j = refs[key]
        np.testing.assert_allclose(out[f"{key}_loss"], float(l_j),
                                   rtol=LOSS_RTOL, err_msg=key)
        for g in GROUPS:
            _close(out[f"{key}_{g}"], np.asarray(getattr(g_j, g)),
                   f"{key} {g}")
        _close(out[f"{key}_sink"], np.asarray(sink_j), f"{key} sink")
        _close(np.linalg.norm(out[f"{key}_sink"], axis=-1),
               np.linalg.norm(np.asarray(sink_j), axis=-1),
               f"{key} absgrad")
        assert np.abs(out[f"{key}_sink"]).max() > 0
        stats = [int(np.asarray(x)) for x in (st_j.max_tile, st_j.n_overflow,
                                              st_j.num_truncated,
                                              st_j.num_pairs)]
        np.testing.assert_array_equal(out[f"{key}_stats"], stats,
                                      err_msg=key)


@pytest.mark.parametrize("mesh", DP_MESHES)
def test_view_batch_steps_match_jax(four_ranks, mesh):
    ranks, refs = four_ranks
    out = ranks[0]
    for i in range(len(DP_EPOCHS)):
        np.testing.assert_allclose(out[f"dp_{mesh}_loss{i}"],
                                   refs[f"dp_{mesh}_loss{i}"],
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
    ref = refs[f"dp_{mesh}_state"]
    assert int(out[f"dp_{mesh}:f:.step"]) == len(DP_EPOCHS) == \
        int(ref["f:.step"])
    for k, v in ref.items():
        if k in ("f:.key",) or k.startswith("f:.opt.counts"):
            continue
        _close(out[f"dp_{mesh}:{k}"], v, f"{mesh} {k}", STATE_ATOL,
               STATE_RTOL)
    assert out[f"dp_{mesh}:f:.gaussians.absgrads"].max() > 0


def test_tp_refuses_a_capacity_the_axis_does_not_divide(four_ranks):
    ranks, _ = four_ranks
    for r in ranks:
        assert "not divisible by 'gauss' axis size 4" in \
            str(r["tp_indivisible_error"])


def test_tile_sharded_render_matches_jax(four_ranks):
    """The 'whole' loss of view 0's top 4 tile rows, one row per rank,
    on the single-level frame (v2 plain vs the JAX XLA oracle)."""
    ranks, refs = four_ranks
    out = ranks[0]
    l_j, g_j, sink_j = refs["tile_render"]
    np.testing.assert_allclose(out["tile_render_loss"], float(l_j),
                               rtol=LOSS_RTOL)
    for g in GROUPS:
        _close(out[f"tile_render_{g}"], np.asarray(getattr(g_j, g)),
               f"tile render {g}")
    _close(out["tile_render_sink"], np.asarray(sink_j), "tile render sink")
    assert np.abs(out["tile_render_sink"]).max() > 0


def _jax_probe(x):
    """The JAX package's shard-sum probe (tests/test_vma.py:205) on a
    4-device 'tiles' mesh, interpret mode, check_vma=False."""
    from jax.experimental import pallas as pl
    from jax.sharding import Mesh, PartitionSpec as P

    from edgegaussians_tpu.ops import vma

    def kernel(x_ref, o_ref):
        def body(i, acc):
            return acc + x_ref[i, :] * 2.0

        o_ref[0, :] = jax.lax.fori_loop(
            0, x_ref.shape[0], body, jnp.zeros((128,), jnp.float32))

    def pcall(x):
        return pl.pallas_call(
            kernel, in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            out_shape=vma.out_struct((1, 128), jnp.float32, x),
            interpret=True)(x)

    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    f = jax.shard_map(lambda x: jax.lax.psum(pcall(x), "tiles"), mesh=mesh,
                      in_specs=P("tiles"), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def test_shard_sum_probe_matches_jax_under_all_reduce(four_ranks):
    ranks, _ = four_ranks
    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    import torch_multiprocess_worker as worker
    x = worker.probe_array(4, "cpu").numpy()
    ref = _jax_probe(x)
    exact = (2.0 * x.astype(np.float64)).sum(0, keepdims=True)
    # JAX's probe adds each shard's 16384 rows one by one
    np.testing.assert_allclose(ref, exact, rtol=1e-4)
    for r in ranks:
        assert int(r["probe_launches"]) == 0     # CPU: the plain version
        # 1x the whole array's sum (a second reduction would be 4x)
        np.testing.assert_allclose(r["probe_sum"], exact, rtol=1e-5)
        np.testing.assert_allclose(r["probe_sum"], ref, rtol=1e-4)
        np.testing.assert_allclose(r["probe_plain"], exact, rtol=1e-5)


def test_all_gather_backward_counts_each_cotangent_once(four_ranks):
    ranks, _ = four_ranks
    world, rows = 4, 3
    w0 = 1.0 + np.arange(world * rows * 8, dtype=np.float32).reshape(
        world * rows, 8)
    total = sum(r + 1 for r in range(world)) * w0
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(
            out["gather_value"],
            np.concatenate([np.arange(rows * 8, dtype=np.float32)
                            .reshape(rows, 8) + 100.0 * q
                            for q in range(world)]))
        np.testing.assert_array_equal(out["gather_grad"],
                                      total[r * rows:(r + 1) * rows])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    d = _cfg_dict()
    seeds, images, vms, Ks = _scene(seed=1)
    jts = jtrainer.init_train_state(seeds, jconfig_from_dict(d))
    inputs = tmp / "inputs.npz"
    _write_inputs(inputs, d, jts, images, vms, Ks, seeds=seeds,
                  view_batch_size=np.int32(2))
    ranks = spawn(2, "train", inputs, tmp / "out")
    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    import torch_multiprocess_worker as worker
    cfg = config_from_dict(d)
    scene = SceneViews(images=images, Ks=Ks, viewmats=vms, height=H,
                       width=W, cameras=None)
    single = {}
    for name, step_mode in (("tiles", "per_view"), ("views", "view_batch"),
                            ("staged", "view_batch")):
        c = config_from_dict(d)
        c.training.step_mode = step_mode
        c.training.view_batch_size = 2
        if name == "staged":
            c = worker.staged_config(c)
        lines = []
        state = trainer.train(scene, seeds, c, backend="torch",
                              log_fn=lines.append)
        single[name] = (convert.state_to_arrays(state), lines)
    return ranks, single, cfg


def _epoch_losses(lines):
    return [float(l.split("loss=")[1].split()[0]) for l in lines
            if l.startswith("epoch ")]


@pytest.mark.parametrize("run", ["tiles", "views"])
def test_two_rank_training_matches_single_process(two_ranks, run):
    ranks, single, cfg = two_ranks
    ref, lines = single[run]
    out = ranks[0]
    for k in ref:
        np.testing.assert_array_equal(ranks[1][f"train_{run}:{k}"],
                                      out[f"train_{run}:{k}"], err_msg=k)
    got_log = str(out[f"train_{run}_log"]).splitlines()
    assert str(ranks[1][f"train_{run}_log"]) == "", "rank 1 logged"
    # the log prints 5 decimals: within one printed digit
    np.testing.assert_allclose(_epoch_losses(got_log), _epoch_losses(lines),
                               rtol=0, atol=1.01e-5)
    assert len(_epoch_losses(lines)) == cfg.training.num_epochs
    alive = ref["f:.gaussians.alive"]
    np.testing.assert_array_equal(out[f"train_{run}:f:.gaussians.alive"],
                                  alive)
    assert alive.sum() > 96, "the duplication did not fire"
    assert int(out[f"train_{run}:f:.step"]) == int(ref["f:.step"])
    for k, v in ref.items():
        if v.dtype.kind != "f" or k == "f:.key":
            continue
        _close(out[f"train_{run}:{k}"], v, f"{run} {k}", STATE_ATOL,
               STATE_RTOL)


def test_two_rank_staged_training_is_bit_equal_to_one_process(two_ranks):
    """Staged capacity on a ('views', 2) mesh, batches of 2 views (one a
    rank, so the all-reduce adds the two views' terms as one process
    does): the capacity grows from 1024 to 2048 before epoch 1's
    duplication on both ranks in lockstep, and the final state equals
    the one-process run's bit for bit."""
    ranks, single, _ = two_ranks
    ref, lines = single["staged"]
    assert [x for x in lines if "capacity" in x] == \
        ["epoch 1: capacity 1024 -> 2048 (alive 96)"]
    got_log = str(ranks[0]["train_staged_log"]).splitlines()
    assert [x for x in got_log if "capacity" in x] == \
        [x for x in lines if "capacity" in x]
    assert ref["f:.gaussians.alive"].shape == (2048,)
    assert ref["f:.gaussians.alive"].sum() > 96
    for k, v in ref.items():
        if k == convert.GENERATOR_KEY:
            continue
        for r in (0, 1):
            np.testing.assert_array_equal(ranks[r][f"train_staged:{k}"], v,
                                          err_msg=f"rank {r} {k}")


def test_initialize_and_mesh_without_a_launcher(monkeypatch):
    """No launcher: initialize is a no-op, a mesh of one rank has no
    group and a larger one raises. Under a launcher's environment, two
    NCCL ranks on one card raise (before any CUDA call), and NCCL refuses
    CPU ranks: nothing switches backend on its own."""
    from edgegaussians_tpu_torch.parallel import distributed
    from edgegaussians_tpu_torch.parallel import mesh as mesh_mod
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    one = mesh_mod.make_mesh(1, 1)
    assert one.group(["views"]) is None and one.coord("tiles") == 0
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_mod.axis_mesh("tiles", 2)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        distributed.initialize(device_type="cuda")
    with pytest.raises(ValueError, match="CUDA ranks only"):
        distributed.initialize("nccl", device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_worker_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The worker's --device is cuda unless the caller names the CPU: run
    with no --device in a process that sees no GPU, it exits non-zero
    before joining a group, with a message naming ``--device cpu``, and
    writes nothing (no fallback to the CPU)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    proc = subprocess.run([sys.executable, _WORKER, "--tasks", "cli",
                           "--out", str(tmp_path / "out")], env=env,
                          cwd=_REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "out").exists()
