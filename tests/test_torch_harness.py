"""The port's harness scripts (``scripts/torch_*.py``) held to the JAX
functions that their JAX counterparts (``scripts/profile_stages.py``,
``profile_train_step.py``, ``epoch_ab.py``, ``tp_dtu_bench.py``,
``time_to_converge.py``, ``pair_budget_audit.py``, ``_common.py``) call,
on the same NumPy inputs.

Inputs: the bench fixture cut to its first 1500-2048 Gaussians, camera 0
rendered at 200x200 with its intrinsics scaled, and one scan written by
the port's ``cli.make_synthetic`` (3 views, 64x64) trained with the ABC
recipe at a capacity of 2048 (the CPU's plain kNN at the recipe's 16384
would take most of a minute a fire).

- profile_stages: the binning's ``pairs / counts1_sum / counts2_sum /
  trunc`` equal JAX ``tiles._sort_pairs`` and ``bin_gaussians_two_level``
  exactly, and the seg path's pair count JAX ``bin_pairs_frame_order``'s;
  the full step's loss within 1e-5 relative of JAX ``rasterize`` (the XLA
  path on the two-level frame, the seg compositor in interpret mode, as
  the existing parity tests run them), its gradients within 1e-4 of
  max-abs, but for ``means``, within 3e-4: at this cut the ``means``
  gradient of either package in f32 sits 1.5-1.9e-4 of max-abs from the
  port's float64 evaluation of the same step (both packages sum each
  Gaussian's pixel terms in another order), so no f32 pair can agree to
  1e-4 there.
- profile_train_step: the proj-grad's loss (1e-5 relative) and gradients
  (as above) against JAX ``trainer.make_proj_grad_fn``; the kNN indices
  exactly; the direction and ratio losses within 1e-5 relative; one Adam
  step on the port's gradients within 1e-6 relative of JAX ``optim``'s on
  the same gradients.
- Each script's output keys hold the JAX script's, read from that file's
  source (``res["..."]``, dict literals), so a renamed key fails; the
  stage labels of profile_stages hold the JAX script's ``label=``s.
- epoch_ab: the ``full`` variant fires the kNN and ``noorient`` does not.
- tp_dtu_bench: ``ref`` and ``tp --mesh 1`` (a one-rank Gloo world) give
  the same loss within 1e-5 at n = 2048 and 128x96.
- The audit's peak equals the log's largest ``pairs=``; a config whose
  path counts no pairs is refused.
- time_to_converge's eval finds the checkpoints written at interval 2 and
  writes finite rows (the checkpoints hold Gaussians laid along the scan's
  edges: at 4 epochs the recipe has not begun to train opacities, so its
  own Gaussians pass no extraction filter).
- Every new script refuses ``--device cuda`` (its default) without a GPU,
  and none imports ``jax`` or ``edgegaussians_tpu``.

The ``cuda``-marked cases (skipped here) run each script's functions on
the card at the same cut and check the launch counts that
``chip_smoke.py`` phase 11 checks. JAX is imported inside the CPU tests,
so the file imports on the card's machine, which has none.
"""

import ast
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import torch_common  # noqa: E402
import torch_epoch_ab as epoch_ab  # noqa: E402
import torch_pair_budget_audit as audit_mod  # noqa: E402
import torch_profile_stages as stages_mod  # noqa: E402
import torch_profile_train_step as step_mod  # noqa: E402
import torch_time_to_converge as ttc_mod  # noqa: E402
import torch_tp_dtu_bench as tp_mod  # noqa: E402

torch.set_num_threads(2)

NEW_SCRIPTS = ("torch_common", "torch_profile_stages",
               "torch_profile_train_step", "torch_epoch_ab",
               "torch_tp_dtu_bench", "torch_time_to_converge",
               "torch_pair_budget_audit")
CPU = torch.device("cpu")
CUT_N, SIZE = 2048, 200              # profile_stages' fixture cut
STEP_CAP, STEP_N = 2048, 1500        # profile_train_step's cut
SCAN, VIEWS, PX = "S1", 3, 64
SMALL_CAP, SMALL_SEEDS = 2048, 500
LOSS_RTOL, GRAD_TOL, MEANS_GRAD_TOL = 1e-5, 1e-4, 3e-4

def _close_grads(port, jax_grads, names):
    for name, a, b in zip(names, port, jax_grads):
        a, b = np.asarray(a), np.asarray(b)
        tol = MEANS_GRAD_TOL if name == "means" else GRAD_TOL
        assert np.isfinite(a).all(), name
        err = np.abs(a - b).max()
        assert err <= tol * np.abs(b).max(), (name, err, np.abs(b).max())


# --- inputs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A 3-view 64x64 scan from the port's make_synthetic and the recipe
    cut to a capacity of 2048 and 4 epochs: (data dir, ground-truth dir,
    config)."""
    from edgegaussians_tpu_torch.cli import make_synthetic
    base = tmp_path_factory.mktemp("harness_scan")
    assert make_synthetic.main(
        ["--base_dir", str(base), "--scan_names", SCAN, "--n_views",
         str(VIEWS), "--width", str(PX), "--height", str(PX)]) == 0
    with open(torch_common.RECIPE) as f:
        raw = json.load(f)
    raw["model"]["max_num_gaussians"] = SMALL_CAP
    raw["model"]["init_min_num_gaussians"] = SMALL_SEEDS
    raw["training"]["num_epochs"] = 4
    cfg = base / "small.json"
    cfg.write_text(json.dumps(raw))
    return str(base / "data"), str(base / "groundtruth"), str(cfg)


@pytest.fixture(scope="module")
def stage_run():
    """profile_stages on the CPU at the cut: the inputs, then each path's
    stages, counts and full step."""
    sc_np, r = stages_mod.scene(True, max_n=CUT_N, size=SIZE)
    sc = stages_mod.on_device(sc_np, CPU)
    s = stages_mod.FIXTURE_SETTINGS
    dense = stages_mod.dense_stages(sc, r, s["cap"], s["k1"], s["t2"],
                                    s["m"], CPU, reps=1)
    seg = stages_mod.seg_stages(sc, CPU, reps=1)
    return sc_np, dense, seg


def _jax_scene(sc_np):
    import jax.numpy as jnp
    return ([jnp.asarray(sc_np[k]) for k in ("means", "quats", "scales",
                                             "opac")],
            jnp.asarray(sc_np["viewmat"]), jnp.asarray(sc_np["K"]))


# --- profile_stages -------------------------------------------------------

def test_profile_stages_counts_equal_jax_binning(stage_run):
    from edgegaussians_tpu.ops import tiles as jtiles
    from edgegaussians_tpu.ops.projection import project_gaussians
    sc_np, (_, counts, _), (_, seg_counts, _) = stage_run
    (m, q, s, o), vm, K = _jax_scene(sc_np)
    W, H = sc_np["width"], sc_np["height"]
    st = stages_mod.FIXTURE_SETTINGS
    import jax

    @jax.jit
    def binning(m, q, s, o):
        proj = project_gaussians(m, q, s, o, vm, K, W, H)
        _, _, counts, _, ntr = jtiles._sort_pairs(proj, W, H, 16, st["m"])
        bins2 = jtiles.bin_gaussians_two_level(
            proj, W, H, 16, st["k1"], st["cap"] - st["k1"], st["t2"],
            max_tiles_per_gaussian=st["m"])
        pb = jtiles.bin_pairs_frame_order(proj, W, H, 16, st["cap"], 49152,
                                          max_tiles_per_gaussian=st["m"])
        return counts, ntr, bins2, pb

    jcounts, ntr, bins2, pb = binning(m, q, s, o)
    assert counts == {"pairs": int(jcounts.sum()),
                      "counts1_sum": int(bins2.counts1.sum()),
                      "counts2_sum": int(bins2.counts2.sum()),
                      "trunc": int(ntr)}
    assert counts["counts2_sum"] > 0 and counts["pairs"] > 0
    assert seg_counts["pairs"] == int(pb.num_pairs)
    assert seg_counts["kept"] == int(np.asarray(pb.counts_f).sum())


@pytest.mark.parametrize("path", ["dense", "seg"])
def test_profile_stages_full_step_matches_jax_rasterize(stage_run, path):
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.ops.rasterize import rasterize
    sc_np, dense, seg = stage_run
    full = (dense if path == "dense" else seg)[2]
    args, vm, K = _jax_scene(sc_np)
    st = stages_mod.FIXTURE_SETTINGS
    kw = (dict(capacity=st["cap"], dense_capacity=st["k1"],
               overflow_tiles=st["t2"], pair_budget=0)
          if path == "dense" else
          dict(capacity=st["cap"], pair_budget=49152, pair_kernel="seg"))

    def loss(m, q, s, o):
        out = rasterize(m, q, s, o, vm, K, sc_np["width"], sc_np["height"],
                        tile_size=16, max_tiles_per_gaussian=st["m"],
                        backend="jax", **kw)
        return jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1)))

    lj, gj = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(*args)
    np.testing.assert_allclose(float(full[0]), float(lj), rtol=LOSS_RTOL)
    _close_grads([g.numpy() for g in full[1:]], gj,
                 ("means", "quats", "scales", "opacities"))


def test_profile_stages_labels_are_the_jax_scripts(stage_run):
    _, (dense, _, _), (seg, _, _) = stage_run
    found = []
    for node in ast.walk(_source_tree("profile_stages")):
        if isinstance(node, ast.keyword) and node.arg == "label":
            if isinstance(node.value, ast.Constant):
                text = node.value.value
            else:          # an f-string: its text before the sizes
                text = node.value.values[0].value.split(" (")[0]
            found.append(((node.lineno, node.col_offset), text))
    labels = [text.replace("lax.sort", "torch.sort")
              for _, text in sorted(found)]
    assert list(dense) == labels
    assert all(k.startswith("seg: ") for k in seg)
    assert all(np.isfinite(v["ms"]) for v in {**dense, **seg}.values())


# --- profile_train_step ---------------------------------------------------

@pytest.fixture(scope="module")
def step_run():
    model, cfg, W, H, vm, K = step_mod.padded_model(STEP_CAP, STEP_N, SIZE)
    calls, values = step_mod.components(model, cfg, W, H, vm, K, CPU)
    calls["adam"]()
    return model, (W, H, vm, K), calls, values


def test_profile_train_step_components_match_jax(step_run):
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.config import load_config
    from edgegaussians_tpu.models import losses as jlosses
    from edgegaussians_tpu.models.gaussians import GaussianParams
    from edgegaussians_tpu.train import optim as joptim
    from edgegaussians_tpu.train import trainer as jtrainer
    from edgegaussians_tpu_torch.models.gaussians import GROUPS
    model, (W, H, vm, K), _, values = step_run
    cfg = load_config(torch_common.RECIPE)
    cfg.model.max_num_gaussians = STEP_CAP
    # the model before the Adam call stepped its copy
    p = GaussianParams(**{g: jnp.asarray(getattr(model, g).detach().numpy())
                          for g in GROUPS})
    alive = jnp.asarray(model.alive.numpy())
    gt = jnp.zeros((H, W), jnp.float32)
    loss, _, grads, _ = jax.jit(jtrainer.make_proj_grad_fn(
        cfg, W, H, "jax"))(p, alive, jnp.asarray(vm.numpy()),
                          jnp.asarray(K.numpy()), gt, gt > 0.5,
                          jnp.int32(0), jnp.float32(1.0),
                          jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(values["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    _close_grads([values["grads"][g].numpy() for g in GROUPS],
                 [getattr(grads, g) for g in GROUPS], GROUPS)

    ol = cfg.training.loss.orientation_losses
    num_nn, enforce = ol.dir_loss_num_nn, ol.dir_loss_enforce_method
    nn_idx = jlosses.update_nearest_neighbors(p.means, alive, num_nn,
                                              enforce, approx=False)
    np.testing.assert_array_equal(values["nn_idx"].numpy(),
                                  np.asarray(nn_idx))
    calls = step_run[2]
    dir_port, ratio_port = calls["dir_loss"]()[0], calls["ratio_loss"]()[0]
    dir_jax = jlosses.direction_loss(p.means, jnp.exp(p.scales), p.quats,
                                     nn_idx, alive, num_nn, enforce)
    ratio_jax = jlosses.ratio_loss(jnp.exp(p.scales), alive)
    np.testing.assert_allclose(float(dir_port), float(dir_jax),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ratio_port), float(ratio_jax),
                               rtol=LOSS_RTOL)

    # one Adam step on the port's gradients, in both packages
    lrs = joptim.all_lrs(cfg.training.optim, jnp.int32(100))
    same = GaussianParams(**{g: jnp.asarray(values["grads"][g].numpy())
                             for g in GROUPS})
    stepped, _ = joptim.apply_updates(p, same, joptim.init_opt_state(p),
                                      lrs)
    for g in GROUPS:
        np.testing.assert_allclose(
            getattr(values["adam_model"], g).detach().numpy(),
            np.asarray(getattr(stepped, g)), rtol=1e-6, atol=1e-7,
            err_msg=g)


# --- output keys ----------------------------------------------------------

def _source_tree(name: str):
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        return ast.parse(f.read())


def jax_output_keys(name: str) -> set:
    """The string keys a JAX script writes: of its dict literals and of
    ``res["..."] = ...`` assignments."""
    keys = set()
    for node in ast.walk(_source_tree(name)):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name)
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_jax_output_keys_are_read_from_the_sources():
    assert jax_output_keys("profile_train_step") >= {
        "proj_grad_ms", "expected_in_train_mpx_s", "platform", "capacity"}
    assert jax_output_keys("pair_budget_audit") == {
        "budget", "peak_pairs", "overflow_warnings", "wall_s", "chamfer",
        "f10"}
    assert jax_output_keys("_common") == {"chamfer", "f5", "f10", "f20"}


def test_profile_train_step_output_keys(step_run):
    model, (W, H, vm, K), _, _ = step_run
    from edgegaussians_tpu_torch.config import load_config
    cfg = load_config(torch_common.RECIPE)
    cfg.model.max_num_gaussians = STEP_CAP
    res = step_mod.profile(model, cfg, W, H, vm, K, CPU, reps=1)
    assert set(res) >= jax_output_keys("profile_train_step")
    for k in jax_output_keys("profile_train_step"):
        if k.endswith("_ms"):
            stem = k[:-3]
            assert {f"{stem}_device_ms",
                    f"{stem}_launches"} <= set(res) or stem in (
                "expected_step",), k
    assert "expected_launches_per_step" in res
    assert res["capacity"] == STEP_CAP and res["platform"] == "cpu"
    assert all(np.isfinite(res[k]) for k in
               jax_output_keys("profile_train_step") - {"platform"})


# --- epoch_ab -------------------------------------------------------------

def test_epoch_ab_full_fires_knn_and_noorient_does_not(scan, tmp_path,
                                                       monkeypatch):
    from edgegaussians_tpu_torch.ops import knn as knn_mod
    data, _, cfg = scan
    fired, runs = [0], []
    real_ref, real_run = knn_mod.knn_ref, epoch_ab.run_variant

    def counting_ref(*a, **k):
        fired[0] += 1
        return real_ref(*a, **k)

    def run(tag, *a, **k):
        before = fired[0]
        out = real_run(tag, *a, **k)
        runs.append((tag, fired[0] - before))
        return out

    monkeypatch.setattr(knn_mod, "knn_ref", counting_ref)
    monkeypatch.setattr(epoch_ab, "run_variant", run)
    res = epoch_ab.epoch_ab(2, 1, str(tmp_path), cfg, SCAN, CPU, data)
    assert [tag for tag, _ in runs] == ["full", "noorient"] == res["order"]
    fires = dict(runs)
    assert fires["full"] >= 1 and fires["noorient"] == 0
    assert set(res) >= jax_output_keys("epoch_ab")
    for tag in ("full", "noorient"):
        assert len(res[f"{tag}_losses"]) == 2
        assert all(np.isfinite(res[f"{tag}_losses"]))


def test_epoch_ab_reads_ms_a_view_from_the_epoch_lines():
    log = ("epoch 0: loss=0.1 px/s=10.0M t=1s\n"
           "epoch 1: loss=0.1 pairs=5/9 px/s=40.0M t=2s\n"
           "epoch 2: loss=0.1 px/s=0.0M t=3s\n")
    assert epoch_ab.steady_ms(log, 800, 800) == [16.0]


# --- tp_dtu_bench ---------------------------------------------------------

def test_tp_dtu_bench_ref_and_tp_mesh_1_agree():
    env = dict(os.environ)
    ref = tp_mod.bench("ref", 2048, 128, 96, 1, CPU)
    with tp_mod.one_rank_world(CPU):
        tp = tp_mod.bench("tp", 2048, 128, 96, 1, CPU, 1)
    assert dict(os.environ) == env
    assert not torch.distributed.is_initialized()
    assert (ref["mode"], tp["mode"]) == ("replicated", "tp@1")
    assert np.isfinite(ref["loss"]) and ref["loss"] > 0
    np.testing.assert_allclose(tp["loss"], ref["loss"], rtol=1e-5)
    keys = jax_output_keys("tp_dtu_bench")
    assert set(ref) >= keys and set(tp) >= keys


# --- the audit and time-to-converge ---------------------------------------

def _audit_args(scan, out, *extra):
    data, gt, cfg = scan
    return ["--config", cfg, "--data_dir", data, "--scene_name", SCAN,
            "--gt_base", gt, "--epochs", "2", "--seeds", "1",
            "--device", "cpu", "--out_root", out, *extra]


def test_pair_budget_audit_peak_is_the_logs_largest_pairs(scan, tmp_path,
                                                          capsys):
    assert audit_mod.main(_audit_args(scan, str(tmp_path))) == 0
    text = capsys.readouterr().out
    res = json.loads(text.strip().splitlines()[-1])
    logged = [int(p) for p in re.findall(r"pairs=(\d+)/", text)]
    assert len(logged) == 2 and res["peak_pairs"] == max(logged) > 0
    assert res["pairs"] == logged and res["overflow_warnings"] == 0
    assert set(res) >= jax_output_keys("pair_budget_audit")


def test_pair_budget_audit_refuses_a_path_without_pairs(scan, tmp_path):
    data, gt, cfg = scan
    raw = json.loads(open(cfg).read())
    raw["model"].update(tile_pair_kernel=False, tile_dense_capacity=0)
    path = tmp_path / "single.json"
    path.write_text(json.dumps(raw))
    args = _audit_args(scan, str(tmp_path / "out"))
    args[1] = str(path)
    with pytest.raises(SystemExit, match="no pairs"):
        audit_mod.main(args)


def _edge_state(ckpt: str, gt_ply: str) -> None:
    """Rewrite a checkpoint's Gaussians as elongated, opaque Gaussians
    laid along the scan's ground-truth edges."""
    from edgegaussians_tpu_torch.convert import KEYS
    from edgegaussians_tpu_torch.io.ply import read_point_cloud
    pts = read_point_cloud(gt_ply).astype(np.float32)
    with np.load(ckpt) as d:
        flat = dict(d)
    cap = flat[KEYS["alive"]].shape[0]
    n = min(len(pts), cap)
    d = np.roll(pts, -1, 0) - np.roll(pts, 1, 0)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    # the rotation taking x to d, wxyz
    quats = np.concatenate([1.0 + d[:, :1], np.zeros_like(d[:, :1]),
                            -d[:, 2:3], d[:, 1:2]], 1)
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = np.where(norm > 1e-6, quats / np.maximum(norm, 1e-6),
                     np.array([[0.0, 0.0, 0.0, 1.0]]))    # d = -x
    rows = {"means": pts, "quats": quats,
            "scales": np.log(np.tile([[0.01, 0.001, 0.001]], (n, 1))),
            "opacities": np.full((n, 1), 3.0)}
    for g, v in rows.items():
        flat[KEYS[f"params.{g}"]][:n] = v[:n]
    flat[KEYS["alive"]][:] = np.arange(cap) < n
    np.savez(ckpt, **flat)


def test_time_to_converge_eval_writes_a_row_per_checkpoint(scan, tmp_path,
                                                         capsys):
    data, gt, cfg = scan
    out = str(tmp_path / "ttc")
    common = ["--out_root", out, "--scene_name", SCAN, "--gt_base", gt]
    assert ttc_mod.main(["--stage", "train", "--config", cfg,
                         "--data_dir", data, "--interval", "2",
                         "--device", "cpu", *common]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trained["checkpoints"] == [1, 3]
    from edgegaussians_tpu_torch.config import load_config
    run_dir = torch_common.scene_run_dir(
        load_config(os.path.join(out, "ttc_config.json")), out, SCAN)
    for e in (1, 3):
        _edge_state(os.path.join(run_dir, f"epoch{e}.npz"),
                    os.path.join(gt, "sampled_pts", f"{SCAN}_0.005.ply"))
    assert ttc_mod.main(["--stage", "eval", "--seeds", "1", *common]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(out, "ttc_results.json")) as f:
        rows = json.load(f)
    assert rows == ev["rows"] and ev["no_edges"] == []
    assert [r["epoch"] for r in rows] == [1, 3]
    for r in rows:
        assert set(r) == jax_output_keys("time_to_converge")
        assert all(np.isfinite(r[k]) for k in r) and r["chamfer"] < 0.05
    # extract_and_eval's keys are _common.py's
    ep = os.path.join(out, "eval", "ep0003", SCAN)
    m = torch_common.extract_and_eval(
        os.path.join(ep, "gaussians_all.ply"),
        load_config(os.path.join(out, "ttc_config.json")), ep, scan=SCAN,
        gt_base=gt, extraction_seeds=1)
    assert set(m) == jax_output_keys("_common")
    assert len(m["chamfer"]) == 1 and np.isfinite(m["chamfer"][0])


# --- the timing helper ----------------------------------------------------

def _record(name, device, us=0.0):
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval
    return SimpleNamespace(
        name=name, time_range=Interval(10.0, 10.0 + us),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


@pytest.mark.parametrize("lost", [0, 1])
def test_window_counts_refuses_a_window_short_of_kernel_records(lost):
    """A window's device time is the sum of its kernel records' durations,
    copies and fills left out; a window with fewer kernel records than
    host launch records gives none, so that profiled reads it again."""
    events = [_record("cudaLaunchKernel", False),
              _record("cuLaunchKernel", False),
              _record("cudaMemsetAsync", False),
              _record("Memset (Device)", True, 5.0),
              _record("aten::add", False)]
    events += [_record("k1", True, 2.0), _record("k2", True, 3.0)][lost:]
    launches, dev_us = torch_common.window_counts(events)
    assert launches == 2
    assert dev_us == (5.0 if not lost else None)


# --- devices and imports --------------------------------------------------

@pytest.mark.parametrize("script,argv", [
    (stages_mod, []), (step_mod, []), (epoch_ab, []),
    (tp_mod, ["--mode", "ref"]), (ttc_mod, ["--stage", "train"]),
    (audit_mod, [])])
def test_scripts_refuse_the_card_without_a_gpu(script, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch sees a GPU: the scripts run there")
    if script is ttc_mod or script is audit_mod or script is epoch_ab:
        argv = argv + ["--out_root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="--device cpu|--backend torch"):
        script.main(argv)
    assert not os.listdir(tmp_path)


def test_new_scripts_import_nothing_of_jax():
    for name in NEW_SCRIPTS:
        for node in ast.walk(_source_tree(name)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "edgegaussians_tpu",
                                    "_common"), (name, mod)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU for the Hopper kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profile_stages_launches_on_the_card(card):
    sc_np, r = stages_mod.scene(True, max_n=CUT_N, size=SIZE)
    sc = stages_mod.on_device(sc_np, card)
    s = stages_mod.FIXTURE_SETTINGS
    dense, _, full = stages_mod.dense_stages(sc, r, s["cap"], s["k1"],
                                             s["t2"], s["m"], card, reps=2)
    seg, _, seg_full = stages_mod.seg_stages(sc, card, reps=2)
    got = {**dense, **seg}
    for name, want in stages_mod.STAGE_KERNELS.items():
        assert got[name]["kernels"] == want, name
    assert all(v["launches"] >= 1 and v["device_ms"] > 0
               for v in got.values())
    assert all(bool(torch.isfinite(g).all()) for g in full + seg_full)


@pytest.mark.cuda
def test_profile_train_step_launches_on_the_card(card):
    model, cfg, W, H, vm, K = step_mod.padded_model(STEP_CAP, STEP_N, SIZE,
                                                    card)
    res = step_mod.profile(model, cfg, W, H, vm, K, card, reps=2)
    assert res["kernels"]["knn"] == {"knn": 1}
    assert res["kernels"]["dir_loss"] == {"rank_sum_gather": 1}
    assert res["kernels"]["proj_grad"] == {"segpair_fwd": 1,
                                           "segpair_bwd": 1, "rank_sum": 1}
    assert res["expected_launches_per_step"] > res["proj_grad_launches"]


@pytest.mark.cuda
def test_epoch_ab_launches_on_the_card(card, scan, tmp_path):
    data, _, cfg = scan
    res = epoch_ab.epoch_ab(2, 1, str(tmp_path), cfg, SCAN, card, data)
    assert res["full_launches"]["knn"] >= 1
    assert res["noorient_launches"]["knn"] == 0
    for tag in ("full", "noorient"):
        assert res[f"{tag}_launches"]["segpair_fwd"] == 2 * VIEWS


@pytest.mark.cuda
def test_tp_dtu_bench_launches_on_the_card(card):
    ref = tp_mod.bench("ref", 2048, 128, 96, 2, card)
    with tp_mod.one_rank_world(card):
        tp = tp_mod.bench("tp", 2048, 128, 96, 2, card, 1)
    np.testing.assert_allclose(tp["loss"], ref["loss"], rtol=1e-5)
    want = {"raster_v2_fwd": 2, "raster_v2_bwd": 2, "rank_sum": 1}
    assert ref["kernels"] == want and tp["kernels"] == want
    assert ref["peak_device_mem_gib"] > 0


@pytest.mark.cuda
def test_audit_and_time_to_converge_launch_on_the_card(card, scan, tmp_path,
                                                      capsys):
    args = _audit_args(scan, str(tmp_path / "audit"))
    args[args.index("cpu")] = "cuda"
    assert audit_mod.main(args) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["launches"]["segpair_fwd"] == 2 * VIEWS
    assert res["peak_pairs"] == max(res["pairs"])
    data, gt, cfg = scan
    out = str(tmp_path / "ttc")
    assert ttc_mod.main(["--stage", "train", "--config", cfg, "--data_dir",
                         data, "--scene_name", SCAN, "--interval", "2",
                         "--out_root", out]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trained["launches"]["segpair_fwd"] > 0
