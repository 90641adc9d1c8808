"""The port's tools beside the trainer, held to the JAX package, and the
direction loss's gather backward.

- The gather backward (``ops/rank_sum.gather_rows`` in
  ``models/losses.direction_loss``): on 8 threads the ``means`` gradient at
  16384 rows x 7 neighbours is bit-equal over 5 runs, and equals the loss's
  gradient with the neighbour rows held fixed plus ``rank_sum_ref`` of the
  neighbour rows' cotangent by the flattened indices (autograd's CPU
  backward of ``means[nn]`` adds with atomics across threads); within 1e-6
  of max-abs of that autograd gradient; loss and gradients against
  ``jax.grad`` of the JAX loss at tests/test_torch_orientation.py's
  tolerances (values rtol 1e-6, gradients rtol 1e-5 + 1e-6 of max-abs);
  the dead query rows' cotangent rows all zero, and the sum without the
  all-zero rows (what the card's backward adds) bit-equal to the sum of
  every row.
- The CLIs: ``make_synthetic`` writes the JAX CLI's files byte for byte;
  ``precompute_gt`` the JAX CLI's PLY on tests/test_cli.py's fabricated
  ground truth; ``visualize_points_with_major_dirs`` writes a PNG;
  ``sweep`` on the CPU trains each scene to ``cli.train``'s PLY bit for
  bit, writes the JAX sweep's summary keys, splits scenes by ``RANK`` /
  ``WORLD_SIZE``, and refuses ``--backend auto`` without a GPU.
- ``scripts/torch_gather_trace.py`` reads the gather backward's kernels
  from a fabricated Chrome trace on fired steps only.
- ``utils/profiling``: ``ThroughputMeter.report()`` equals the JAX meter's
  under one patched clock; ``trace`` writes a Chrome trace on the CPU;
  ``device_timer`` adds the block's seconds.
"""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import mini_dataset  # noqa: F401  (scenes' fixture)

from edgegaussians_tpu.models import losses as jlosses
from edgegaussians_tpu_torch.models import losses
from edgegaussians_tpu_torch.ops import rank_sum

GATHER_N, GATHER_M, GATHER_RUNS = 16384, 7, 5


def _direction_inputs(seed=3):
    r = np.random.default_rng(seed)
    means = r.uniform(0, 1, (GATHER_N, 3)).astype(np.float32)
    scales = np.exp(r.uniform(-6, -3, (GATHER_N, 3))).astype(np.float32)
    quats = r.normal(size=(GATHER_N, 4)).astype(np.float32)
    alive = r.uniform(size=GATHER_N) < 0.8
    # neighbours never the row itself (its sqrt derivative is infinite)
    nn = (np.arange(GATHER_N)[:, None]
          + r.integers(1, GATHER_N, (GATHER_N, GATHER_M))) % GATHER_N
    return means, scales, quats, alive, nn


def _means_grad(inputs, gather=None):
    """The direction loss's ``means`` gradient, with ``gather`` in place of
    ``gather_rows`` when given; also the cotangent of the gathered rows."""
    means, scales, quats, alive, nn = inputs
    rows = {}

    def spy(x, idx):
        y = (gather or rank_sum.gather_rows)(x, idx)
        if y.requires_grad:
            y.register_hook(lambda g: rows.setdefault("g", g))
        return y

    m = torch.from_numpy(means).requires_grad_()
    saved = losses.gather_rows
    losses.gather_rows = spy
    try:
        loss = losses.direction_loss(
            m, torch.from_numpy(scales), torch.from_numpy(quats),
            torch.from_numpy(nn), torch.from_numpy(alive), GATHER_M)
    finally:
        losses.gather_rows = saved
    (g,) = torch.autograd.grad(loss, [m])
    return loss.detach(), g, rows.get("g")


def test_direction_gather_backward_repeats_on_eight_threads():
    inputs = _direction_inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        runs = [_means_grad(inputs) for _ in range(GATHER_RUNS)]
        # the loss's gradient with the neighbour rows held fixed
        _, fixed, _ = _means_grad(inputs,
                                  gather=lambda x, idx: x[idx].detach())
    finally:
        torch.set_num_threads(threads)
    _, g0, cot = runs[0]
    for _, g, _ in runs[1:]:
        assert torch.equal(g.view(torch.int32), g0.view(torch.int32))
    nn = torch.from_numpy(inputs[4])
    summed = rank_sum.rank_sum_ref(cot.reshape(-1, 3), nn.reshape(-1),
                                   GATHER_N)
    assert torch.equal((fixed + summed).view(torch.int32),
                       g0.view(torch.int32))


def test_direction_gather_backward_matches_autograd_and_jax():
    inputs = _direction_inputs()
    means, scales, quats, alive, nn = inputs
    loss, g, _ = _means_grad(inputs)
    _, plain, _ = _means_grad(inputs, gather=lambda x, idx: x[idx])
    scale = float(plain.abs().max())
    assert float((g - plain).abs().max()) <= 1e-6 * scale

    def jloss(m):
        return jlosses.direction_loss(m, jnp.asarray(scales),
                                      jnp.asarray(quats), jnp.asarray(nn),
                                      jnp.asarray(alive), GATHER_M)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(means))
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jg).max()))


def test_gather_backward_drops_zero_rows_exactly():
    """What the card's gather backward rests on: the direction loss's dead
    query rows give all-zero cotangent rows, and dropping the all-zero rows
    (``nonzero_rows``) gives the sum of every row bit for bit, with +0 and
    -0 rows, a NaN row (kept) and an output reached only by zero rows."""
    inputs = _direction_inputs()
    _, _, cot = _means_grad(inputs)
    alive, nn = inputs[3], torch.from_numpy(inputs[4])
    rows = cot.reshape(-1, 3)
    dead = ~torch.from_numpy(alive).repeat_interleave(GATHER_M)
    assert bool(dead.any()) and not bool(rows[dead].any())
    r = np.random.default_rng(1)
    signed = torch.from_numpy(np.where(r.uniform(size=(4000, 3)) < 0.5,
                                       0.0, -0.0).astype(np.float32))
    signed[::3] = torch.from_numpy(r.normal(size=(1334, 3))
                                   .astype(np.float32))
    signed[7] = float("nan")
    idx = torch.from_numpy(r.integers(0, 300, 4000))
    idx[idx == 5] = 6
    idx[1] = 5                      # output 5: one zero row only
    signed[1] = -0.0
    for rows, idx, n in ((rows, nn.reshape(-1), GATHER_N),
                         (signed, idx, 300)):
        keep = rank_sum.nonzero_rows(rows)
        assert not bool(keep.all())
        whole = rank_sum.rank_sum_ref(rows, idx, n)
        kept = rank_sum.rank_sum_ref(rows, idx, n, keep)
        assert torch.equal(kept.view(torch.int32), whole.view(torch.int32))


def test_gather_trace_reads_the_fired_steps_gather_backward(tmp_path):
    """``scripts/torch_gather_trace.py`` sums, for each node name (the
    port's ``GatherRowsBackward``, ATen's ``IndexBackward0``), the device
    kernels launched inside the node when the host enters it after a kNN
    launch and before the next seg forward launch, and counts those calls;
    a node outside a fired step's orientation branch, or a launch on
    another thread, is not read."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_gather_trace", os.path.join(os.path.dirname(__file__), "..",
                                           "scripts", "torch_gather_trace.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    def launch(ts, corr, kernel, dur, tid=1):
        return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": ts, "dur": 1, "tid": tid,
                 "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": kernel, "ts": ts + 100,
                 "dur": dur, "tid": 7, "args": {"correlation": corr}}]

    def node(ts, name, dur=10):
        return {"ph": "X", "cat": "cpu_op", "tid": 1, "ts": ts, "dur": dur,
                "name": f"autograd::engine::evaluate_function: {name}"}

    events = (launch(0, 1, "run_fwd_kernel", 3)
              + [node(10, "GatherRowsBackward")] + launch(12, 2, "sort", 50)
              + launch(20, 3, "knn_kernel<4>", 9)
              + [node(30, "GatherRowsBackward")]
              + launch(31, 4, "sort", 20) + launch(33, 5, "rank_sum_kernel", 7)
              + launch(35, 6, "other thread", 5, tid=2)
              + launch(50, 7, "run_fwd_kernel", 3)
              + [node(60, "IndexBackward0")] + launch(62, 8, "index_bwd", 40)
              + launch(70, 9, "knn_kernel<4>", 9) + [node(80, "IndexBackward0")]
              + launch(82, 10, "indexing_backward_kernel", 11))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = script.gather_backward_ms(str(path))
    assert set(got) == {"GatherRowsBackward", "IndexBackward0"}
    ours, aten = got["GatherRowsBackward"], got["IndexBackward0"]
    assert (ours["calls"], aten["calls"]) == (1, 1)
    assert ours["by_kernel"] == {"sort": 0.02, "rank_sum_kernel": 0.007}
    assert aten["by_kernel"] == {"indexing_backward_kernel": 0.011}
    assert ours["ms"] == pytest.approx(0.027)
    assert aten["ms"] == pytest.approx(0.011)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_make_synthetic_cli_writes_the_jax_clis_files(tmp_path):
    from edgegaussians_tpu.cli import make_synthetic as jcli
    from edgegaussians_tpu_torch.cli import make_synthetic
    argv = ["--scan_names", "S1", "S2", "--seed", "5", "--n_views", "3",
            "--width", "64", "--height", "64", "--n_lines", "2",
            "--n_curves", "1"]
    assert make_synthetic.main(["--base_dir", str(tmp_path / "port")]
                               + argv) == 0
    assert jcli.main(["--base_dir", str(tmp_path / "jax")] + argv) == 0
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax") and len(files) > 10
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def _fabricated_gt(root, scan="12345678"):
    """tests/test_cli.py:182's fabricated ABC ground truth."""
    objs = root / "obj"
    objs.mkdir(parents=True)
    (objs / f"{scan}_abc.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
    (root / "chunk_0000_feats.json").write_text(json.dumps({scan: [
        {"type": "Line", "sharp": True, "vert_indices": [0, 1]},
        {"type": "Line", "sharp": True, "vert_indices": [1, 2]},
        {"type": "BSpline", "sharp": False, "vert_indices": [2, 3]},
    ]}))
    (root / "chunk_0000_stats.json").write_text(json.dumps(
        {scan: {"bbox": [0, 0, 0, 1, 1, 1, 1, 1, 1]}}))
    return scan


def test_precompute_gt_cli_writes_the_jax_clis_ply(tmp_path):
    from edgegaussians_tpu.cli import precompute_gt as jcli
    from edgegaussians_tpu_torch.cli import precompute_gt
    from edgegaussians_tpu_torch.io.ply import read_point_cloud
    for side, main in (("port", precompute_gt.main), ("jax", jcli.main)):
        scan = _fabricated_gt(tmp_path / side)
        assert main(["--gt_base_dir", str(tmp_path / side)]) == 0
    rel = os.path.join("sampled_pts", f"{scan}_0.005.ply")
    port = (tmp_path / "port" / rel).read_bytes()
    assert port == (tmp_path / "jax" / rel).read_bytes()
    assert 300 < len(read_point_cloud(str(tmp_path / "port" / rel))) < 500


def test_visualize_cli_writes_a_png(tmp_path):
    from edgegaussians_tpu_torch.cli import visualize_points_with_major_dirs
    from edgegaussians_tpu_torch.io.ply import \
        write_pts_with_major_dirs_as_ply
    r = np.random.default_rng(0)
    dirs = r.normal(size=(40, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ply = str(tmp_path / "dirs.ply")
    write_pts_with_major_dirs_as_ply(r.uniform(0, 1, (40, 3)), dirs, ply)
    png = tmp_path / "dirs.png"
    assert visualize_points_with_major_dirs.main(
        ["--dirs_ply", ply, "--save_path", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


SCENES = ("SCENE01", "SCENE02")


@pytest.fixture
def scenes(mini_dataset):  # noqa: F811
    """tests/test_cli.py's two-view 48x48 scene and a copy of it."""
    cfg_path, tmp = mini_dataset
    shutil.copytree(tmp / "data" / "SCENE01", tmp / "data" / "SCENE02")
    return cfg_path, tmp


def _sweep_config(scenes, out):
    """The scenes' config cut to 1 epoch, its outputs under ``out``: (its
    path, the run directory of its scenes)."""
    cfg_path, tmp = scenes
    cfg = json.loads(open(cfg_path).read())
    cfg["training"]["num_epochs"] = 1
    cfg["output"]["output_dir"] = str(tmp / out) + "/"
    path = tmp / f"{out}.json"
    path.write_text(json.dumps(cfg))
    return str(path), tmp / out / "t_DexiNed"


def test_sweep_cli_trains_each_scene_as_the_train_cli(scenes, monkeypatch):
    from edgegaussians_tpu.cli import sweep as jsweep
    from edgegaussians_tpu_torch.cli import sweep, train
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    cfg_path, out = _sweep_config(scenes, "sweep")
    assert sweep.main(["--config_file", cfg_path, "--scene_names", "all",
                       "--backend", "torch"]) == 0
    summary = json.loads((out / "sweep_p0.json").read_text())
    train_cfg, train_out = _sweep_config(scenes, "train")
    for scene in SCENES:
        assert train.main(["--config_file", train_cfg, "--scene_name",
                           scene, "--backend", "torch"]) == 0
        ply = "gaussians_all.ply"
        assert (out / scene / ply).read_bytes() == \
            (train_out / scene / ply).read_bytes(), scene
    # a second sweep skips the trained scenes
    assert sweep.main(["--config_file", cfg_path, "--scene_names",
                       ",".join(SCENES), "--backend", "torch"]) == 0
    assert json.loads((out / "sweep_p0.json").read_text()) == {}

    jax_cfg, jax_out = _sweep_config(scenes, "jax_sweep")
    assert jsweep.main(["--config_file", jax_cfg, "--scene_names", "all",
                        "--backend", "jax"]) == 0
    jsummary = json.loads((jax_out / "sweep_p0.json").read_text())
    assert set(summary) == set(jsummary) == set(SCENES)
    for scene in SCENES:
        assert set(summary[scene]) == set(jsummary[scene]) \
            == {"seconds", "gaussians"}
        assert summary[scene]["gaussians"] > 0


def test_sweep_cli_splits_scenes_by_rank(scenes, monkeypatch):
    from edgegaussians_tpu_torch.cli import sweep
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    cfg_path, out = _sweep_config(scenes, "rank1")
    assert sweep.main(["--config_file", cfg_path, "--scene_names",
                       ",".join(SCENES), "--backend", "torch"]) == 0
    assert set(json.loads((out / "sweep_p1.json").read_text())) == \
        {"SCENE02"}
    assert not (out / "SCENE01").exists() and not \
        (out / "sweep_p0.json").exists()
    assert (out / "SCENE02" / "gaussians_all.ply").exists()


def test_sweep_cli_auto_refuses_without_a_gpu(scenes):
    from edgegaussians_tpu_torch.cli import sweep
    if torch.cuda.is_available():
        pytest.skip("torch sees a GPU: 'auto' trains there")
    cfg_path, out = _sweep_config(scenes, "auto")
    with pytest.raises(RuntimeError, match="--backend torch"):
        sweep.main(["--config_file", cfg_path, "--scene_names", "SCENE01"])
    assert not out.exists()


def test_throughput_meter_reports_as_the_jax_meter(monkeypatch):
    from edgegaussians_tpu.utils import profiling as jprofiling
    from edgegaussians_tpu_torch.utils import profiling
    clock = iter([10.0, 10.0, 12.5, 12.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    meters = [m.ThroughputMeter(pixels_per_render=640_000,
                                tiles_per_render=2500)
              for m in (profiling, jprofiling)]
    for m in meters:
        m.reset()                 # t0 from the patched clock: 10.0
        m.tick(4)
        m.tick()
    port, jax_report = (m.report() for m in meters)   # at 12.5
    assert port == jax_report
    assert port["renders_per_s"] == 2.0 and port["elapsed_s"] == 2.5


def test_trace_and_device_timer_on_the_cpu(tmp_path):
    from edgegaussians_tpu_torch.utils import profiling
    result = {}
    with profiling.device_timer(result, "step", device="cpu"):
        with profiling.trace(str(tmp_path)):
            torch.randn(64, 64).matmul(torch.randn(64, 64)).sum()
    with profiling.device_timer(result, "step"):
        pass
    assert result["step"] > 0
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
