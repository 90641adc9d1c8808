"""The port's last nine harness scripts (``scripts/torch_*.py``) held to
their JAX counterparts (``scripts/dup_spread_ab.py``,
``dp_quality_run.py``, ``spread_synth.py``, ``dtu_spread.py``,
``scaling_efficiency.py``, ``pair_kernel_ab.py``, ``scatter_lab.py``,
``segpair_profile.py``, ``profile_sharded_trace.py``) and to the JAX
functions they call, on the same NumPy inputs, on the CPU.

- No new script imports ``jax`` or ``edgegaussians_tpu``; each refuses
  ``--device cuda`` (its default) without a GPU and writes nothing.
- Output keys: those of dp_quality_run, dtu_spread, pair_kernel_ab and
  scaling_efficiency, and spread_synth's columns, read from the JAX
  sources (``test_torch_harness.jax_output_keys``), are the ports'.
- Configs: the config each of dup_spread_ab, dp_quality_run, dtu_spread
  and pair_kernel_ab derives equals the one the JAX script builds from
  the same shipped JSON (the JAX script run with its training stubbed
  out), but for the output paths, which the port keeps under ``build/``.
- DTU generation: ``torch_dtu_spread.generate`` at 2 views, 160x120
  writes the files the JAX ``dtu_spread.generate`` writes, byte for byte.
- Scatter lab at N 2000, 256x256, K1 32, K2 64, t2 64, 16 tiles a
  Gaussian: the binning's ranks and counts equal JAX
  ``bin_gaussians_two_level``'s; every variant A-G within 1e-5 of max-abs
  of ``jnp.zeros(...).at[idx].add(rows, mode="drop")`` on the masked
  rows it keeps (E and F at caps above and below the cut's valid slots);
  G bit for bit ``rank_sum_ref``.
- Segpair profile: the step of each of ``0``, ``1`` and ``seg`` on the
  fixture cut to 2048 Gaussians at 200x200, camera 1: the loss within
  1e-5 relative and the gradients within test_torch_harness's tolerances
  (1e-4 of max-abs, ``means`` 3e-4) of JAX ``rasterize(...,
  backend="jax", pair_kernel=...)`` (the Pallas kernels in interpret
  mode).
- Sharded trace: the tile-band proj-grad of the one-rank world at the
  same cut against JAX ``make_sharded_proj_grad_fn`` on a one-device
  mesh, the same tolerances; its loss the unsharded one's.
- Scaling efficiency: the scene arrays the JAX draws; one spawn of 2 Gloo
  ranks runs each mode (1 warm and 1 timed epoch, each from the initial
  state) at 64x64, 2 views and 256 Gaussians: the ranks' states bit for
  bit equal, each mode's state within tests/test_torch_parallel.py's
  state tolerances (atol 1e-5 + rtol 1e-3) of the same mode in one
  process.
- The top-op reader on a hand-written Chrome trace: kernel and launch
  records per op by correlation id, a window short of kernel records
  refused and read again.
- Smoke runs on a 3-view 64x64 scan from ``cli.make_synthetic``:
  dup_spread_ab, dp_quality_run and pair_kernel_ab, 2 epochs on the CPU,
  each prints its JSON line with the JAX keys; spread_synth over the
  view-batch run (its Gaussians laid along the scan's edges) equals the
  port's ``evaluate_scan`` row.

JAX is imported inside the tests.
"""

import argparse
import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import torch_common  # noqa: E402
import torch_dp_quality_run as dpq  # noqa: E402
import torch_dtu_spread as dtu  # noqa: E402
import torch_dup_spread_ab as dup  # noqa: E402
import torch_epoch_ab as epoch_ab  # noqa: E402
import torch_pair_kernel_ab as pka  # noqa: E402
import torch_profile_sharded_trace as shard  # noqa: E402
import torch_scaling_efficiency as scaling  # noqa: E402
import torch_scatter_lab as lab  # noqa: E402
import torch_segpair_profile as segprof  # noqa: E402
import torch_spread_synth as spread  # noqa: E402
from test_torch_harness import (  # noqa: E402
    GRAD_TOL, LOSS_RTOL, _close_grads, _source_tree, jax_output_keys)

torch.set_num_threads(2)

NEW_SCRIPTS = ("torch_dup_spread_ab", "torch_dp_quality_run",
               "torch_spread_synth", "torch_dtu_spread",
               "torch_scaling_efficiency", "torch_pair_kernel_ab",
               "torch_scatter_lab", "torch_segpair_profile",
               "torch_profile_sharded_trace", "torch_common",
               "torch_epoch_ab")
CPU = torch.device("cpu")
SCAN, VIEWS, PX = "S1", 3, 64
CUT_N, SIZE = 2048, 200              # the fixture cut
LAB_CUT = dict(n=2000, width=256, height=256, k1=32, k2=64, t2=64, m=16)
SCALING_CUT = dict(width=64, height=64, views=2, gaussians=256)
# tests/test_torch_parallel.py's state tolerances
STATE_ATOL, STATE_RTOL = 1e-5, 1e-3


class Stop(Exception):
    """Raised by a stub to end a JAX script once its config exists."""


# --- inputs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A 3-view 64x64 scan from the port's make_synthetic and the recipe
    cut to a capacity of 2048: (data dir, ground-truth dir, config)."""
    from edgegaussians_tpu_torch.cli import make_synthetic
    base = tmp_path_factory.mktemp("scripts_scan")
    assert make_synthetic.main(
        ["--base_dir", str(base), "--scan_names", SCAN, "--n_views",
         str(VIEWS), "--width", str(PX), "--height", str(PX)]) == 0
    with open(torch_common.RECIPE) as f:
        raw = json.load(f)
    raw["model"]["max_num_gaussians"] = 2048
    raw["model"]["init_min_num_gaussians"] = 500
    cfg = base / "small.json"
    cfg.write_text(json.dumps(raw))
    return str(base / "data"), str(base / "groundtruth"), str(cfg)


def _jax_script(name: str):
    """A JAX script of scripts/ as a module (its main not run)."""
    import importlib
    return importlib.import_module(name)


def _scan_args(scan, out, *extra):
    data, gt, cfg = scan
    return ["--config", cfg, "--data_dir", data, "--scene_name", SCAN,
            "--gt_base", gt, "--device", "cpu", "--out_root", out, *extra]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- imports and devices --------------------------------------------------

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


@pytest.mark.parametrize("script,argv", [
    (dup, []), (dpq, []), (dtu, []), (scaling, []), (pka, []),
    (lab, []), (segprof, []), (shard, [])])
def test_scripts_refuse_the_card_without_a_gpu(script, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch sees a GPU: the scripts run there")
    out = str(tmp_path / "out")
    if script in (dup, dpq, dtu, pka):
        argv = argv + ["--out_root", out]
    elif script in (segprof, shard):
        argv = argv + ["--out", out]
    with pytest.raises(RuntimeError, match="--device cpu"):
        script.main(argv)
    assert not os.listdir(tmp_path)


# --- output keys ----------------------------------------------------------

def test_jax_output_keys_of_the_nine():
    assert jax_output_keys("dp_quality_run") == {
        "mode", "batch", "wall_s", "chamfer", "f10"}
    assert jax_output_keys("dtu_spread") == {
        "scan", "wall_s", "chamfer", "f5", "f10", "rows", "chamfer_mean",
        "chamfer_std", "f10_mean", "f10_std"}
    assert jax_output_keys("pair_kernel_ab") == {
        "t_dense_ms_per_view", "t_pair_kernel_ms_per_view",
        "t_seg_kernel_ms_per_view", "speedup_pair", "speedup_seg",
        "in_train_px_s_pair", "in_train_px_s_seg"}
    assert jax_output_keys("scaling_efficiency") >= {
        "platform", "backend", "width", "height", "views", "gaussians",
        "modes", "devices", "sec_per_epoch", "px_per_s", "tiles_per_s",
        "efficiency_vs_1dev"}


def _jax_list(name: str, var: str) -> list:
    """The string list a JAX script assigns to ``var``."""
    for node in ast.walk(_source_tree(name)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var
                and isinstance(node.value, ast.List)):
            return [e.value for e in node.value.elts]
    raise AssertionError(f"{name}.py assigns no list to {var}")


def test_spread_synth_columns_are_the_jax_scripts():
    assert spread.KEYS == _jax_list("spread_synth", "keys")


# --- configs --------------------------------------------------------------

def test_dup_spread_ab_arms_configs_equal_jax(tmp_path, monkeypatch):
    from edgegaussians_tpu.config import load_config as jax_load
    jdup = _jax_script("dup_spread_ab")
    seen = []

    def train_one(cfg, seed, out_dir):
        cfg.training.seed = seed        # as the JAX train_one sets it
        seen.append((seed, dataclasses.asdict(cfg)))
        return "ply", 1, 0.0, None

    monkeypatch.setattr(jdup, "train_one", train_one)
    monkeypatch.setattr(jdup, "extract_and_eval", lambda *a, **k: {
        "chamfer": [0.01], "f5": [0.9], "f10": [0.9], "f20": [0.9]})
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["dup_spread_ab.py", "--seeds", "2",
                                      "--fraction", "0.3", "--out_root",
                                      str(tmp_path)])
    assert jdup.main() == 0
    arms = dup.arms(0.3)
    assert list(arms) == ["absolute", "top_fraction"]
    want = []
    for arm, overrides in arms.items():
        for seed in range(2):
            cfg = dup.arm_config(torch_common.RECIPE, overrides)
            cfg.training.seed = seed
            want.append((seed, dataclasses.asdict(cfg)))
    assert seen == want
    shipped = jax_load(torch_common.RECIPE)
    shipped.training.seed = 0
    # 'absolute' is the config as shipped
    assert seen[0][1] == dataclasses.asdict(shipped)
    assert seen[2][1]["model"]["dup_threshold_type"] == "top_fraction"
    assert seen[2][1]["model"]["dup_threshold_value"] == 0.3


def test_dp_quality_run_config_equals_jax(tmp_path, monkeypatch):
    from edgegaussians_tpu.cli import train as jax_train
    jdp = _jax_script("dp_quality_run")

    def stop(argv):
        raise Stop

    monkeypatch.setattr(jax_train, "main", stop)
    monkeypatch.chdir(REPO)
    out = str(tmp_path / "dp")
    monkeypatch.setattr(sys, "argv", ["dp_quality_run.py", "--batch", "5",
                                      "--epochs", "7", "--out_root", out])
    with pytest.raises(Stop):
        jdp.main()
    with open(os.path.join(out, "dp_config.json")) as f:
        jax_raw = json.load(f)
    path = torch_common.derive_config(torch_common.RECIPE, out, "dp_config",
                                      None, dpq.dp_mutation(5, 7))
    with open(path) as f:
        assert json.load(f) == jax_raw
    assert jax_raw["training"]["step_mode"] == "view_batch"


def test_dtu_spread_config_equals_jax(tmp_path, monkeypatch):
    import edgegaussians_tpu.config as jax_config
    jdtu = _jax_script("dtu_spread")
    written = tmp_path / "jax_cfg.json"

    def redirect(path, *a, **k):
        if path == "/tmp/dtu_spread_cfg.json":
            path = str(written)
        return open(path, *a, **k)

    def stop(path):
        raise Stop

    monkeypatch.setattr(jdtu, "open", redirect, raising=False)
    monkeypatch.setattr(jax_config, "load_config", stop)
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["dtu_spread.py", "--scenes", "1",
                                      "--skip-generate", "--epochs", "7",
                                      "--pair_budget", "1234"])
    with pytest.raises(Stop):
        jdtu.main()
    jax_raw = json.loads(written.read_text())
    port = dtu.dtu_config(7, str(tmp_path / "base"), str(tmp_path / "out"),
                          str(tmp_path / "logs"), 1234)
    assert port["data"].pop("base_dir") == f"{tmp_path / 'base'}/data/"
    assert port["output"].pop("output_dir") == f"{tmp_path / 'out'}/"
    assert port["output"].pop("log_dir") == f"{tmp_path / 'logs'}/"
    assert jax_raw["data"].pop("base_dir") == "synthetic_data/DTU_spread/data/"
    assert jax_raw["output"].pop("output_dir") == "output_synth/DTU_spread/"
    assert jax_raw["output"].pop("log_dir") == "logs/DTU/"
    assert port == jax_raw
    assert jax_raw["model"]["tile_pair_budget"] == 1234


def test_pair_kernel_ab_variant_configs_equal_jax(tmp_path, monkeypatch):
    from edgegaussians_tpu.cli import train as jax_train
    jpka = _jax_script("pair_kernel_ab")
    monkeypatch.setattr(jax_train, "main", lambda argv: 0)
    monkeypatch.chdir(REPO)
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["pair_kernel_ab.py", "--epochs", "5",
                                      "--out_root", jout])
    jpka.main()
    assert list(pka.VARIANTS) == ["dense", "pairk", "segk"]
    kernels = {}
    for tag, variant in pka.VARIANTS.items():
        with open(os.path.join(jout, f"{tag}.json")) as f:
            jax_raw = json.load(f)
        path = epoch_ab.variant_config(tag, variant, 5,
                                       str(tmp_path / "port"),
                                       torch_common.RECIPE)
        with open(path) as f:
            port = json.load(f)
        assert jax_raw["output"].pop("output_dir") == \
            os.path.join(jout, tag, "ABC") + "/"
        assert port["output"].pop("output_dir") == os.path.join(
            str(tmp_path / "port"), f"{tag}0", "ABC") + "/"
        for raw in (jax_raw, port):
            assert raw["output"].pop("log_dir").endswith("/logs/")
        assert port == jax_raw, tag
        kernels[tag] = port["model"]["tile_pair_kernel"]
    assert kernels == {"dense": False, "pairk": True, "segk": "seg"}


# --- DTU generation -------------------------------------------------------

def test_dtu_spread_generate_writes_the_jax_bytes(tmp_path, monkeypatch):
    jdtu = _jax_script("dtu_spread")
    args = argparse.Namespace(views=2, width=160, height=120)
    monkeypatch.chdir(tmp_path)
    jdtu.generate("dtu_sp0", 20, args)
    dtu.generate("dtu_sp0", 20, args, str(tmp_path / "port"))
    jbase = tmp_path / "synthetic_data" / "DTU_spread"

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(jbase)
    assert names == files(tmp_path / "port")
    assert os.path.join("data", "dtu_sp0", "sparse_sfm_points.txt") in names
    assert len(names) > 4
    for name in names:
        assert (jbase / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


# --- scatter lab ----------------------------------------------------------

@pytest.fixture(scope="module")
def lab_scene():
    return lab.lab_scene(device=CPU, **LAB_CUT)


def test_scatter_lab_binning_equals_jax(lab_scene):
    import jax.numpy as jnp

    from edgegaussians_tpu.ops.projection import project_gaussians
    from edgegaussians_tpu.ops.tiles import bin_gaussians_two_level
    c = LAB_CUT
    r = np.random.default_rng(0)
    n, W, H = c["n"], c["width"], c["height"]
    means = jnp.asarray(r.uniform(-0.5, 0.5, (n, 3)), jnp.float32) \
        + jnp.array([0, 0, 2.0])
    quats = jnp.asarray(r.normal(size=(n, 4)), jnp.float32)
    scales = jnp.asarray(
        np.exp(r.uniform(np.log(0.003), np.log(0.03), (n, 3))), jnp.float32)
    opac = jnp.asarray(r.uniform(0.2, 0.95, n), jnp.float32)
    f = 1111.0
    Km = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    proj = project_gaussians(means, quats, scales, opac,
                             jnp.eye(4, dtype=jnp.float32), Km, W, H)
    bins = bin_gaussians_two_level(proj, W, H, 16, c["k1"], c["k2"],
                                   c["t2"], max_tiles_per_gaussian=c["m"])
    b = lab_scene["bins"]
    for k in ("ranks1", "ranks2", "counts1", "counts2"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(bins, k)), k)
    assert int(b.counts2.sum()) > 0
    T = b.ranks1.shape[0]
    np.testing.assert_array_equal(
        lab_scene["dg1"].numpy(),
        np.asarray(jnp.asarray(r.normal(size=(T, c["k1"], 8)), jnp.float32)))


def _first_valid(counts: np.ndarray, k: int, cap) -> np.ndarray:
    """[rows, k] mask of the slots inside each row's count and, given a
    cap, among the first ``cap`` of them in slot order."""
    valid = np.arange(k)[None, :] < counts[:, None]
    if cap is not None:
        valid &= np.cumsum(valid.ravel()).reshape(valid.shape) <= cap
    return valid


# compaction caps below the cut's valid slots (6321 and 242), so E and F
# drop rows
SMALL_CAPS = dict(p1cap=4000, p2cap=100)


@pytest.mark.parametrize("caps", [{}, SMALL_CAPS])
def test_scatter_lab_variants_match_the_jax_scatter(lab_scene, caps):
    import jax.numpy as jnp
    b, n = lab_scene["bins"], lab_scene["n"]
    c1, c2 = b.counts1.numpy(), b.counts2.numpy()
    v1 = _first_valid(c1, LAB_CUT["k1"], None)
    v2 = _first_valid(c2, LAB_CUT["k2"], None)
    assert (v1.sum(), v2.sum()) == (6321, 242)
    dg1, dg2 = lab_scene["dg1"].numpy(), lab_scene["dg2"].numpy()
    m1, m2 = (torch.from_numpy(dg1 * v1[..., None]),
              torch.from_numpy(dg2 * v2[..., None]))
    idx = np.concatenate([b.ranks1.numpy().ravel(), b.ranks2.numpy().ravel()])

    def jax_ref(k1, k2):
        rows = np.concatenate([
            np.concatenate([g, np.abs(g[..., 3:5])], -1).reshape(-1, 10)
            for g in (dg1 * k1[..., None], dg2 * k2[..., None])])
        return np.asarray(jnp.zeros((n, 10), jnp.float32).at[idx].add(
            rows, mode="drop"))

    table = lab.variants(lab_scene, **caps)
    assert list(table) == ["A", "B", "C", "D", "E", "F", "G", "G_plain"]
    with torch.no_grad():
        for name, (_, fn, (cap1, cap2)) in table.items():
            if name in ("E", "F"):
                assert cap2 == caps.get("p2cap", lab.P2CAP)
            ref = jax_ref(_first_valid(c1, LAB_CUT["k1"], cap1),
                          _first_valid(c2, LAB_CUT["k2"], cap2))
            got = fn(m1, m2).numpy()
            cols = 8 if name == "C" else 10
            assert got.shape == (n, 16 if name == "D" else cols), name
            if name == "D":
                assert not got[:, 10:].any()
            tol = 1e-5 * np.abs(ref).max()
            assert np.abs(got[:, :cols] - ref[:, :cols]).max() <= tol, name
        # G is the row sum of the valid slots' rows, bit for bit its plain
        # version's
        from edgegaussians_tpu_torch.ops.rank_sum import rank_sum_ref
        rows = torch.cat([torch.cat([g, g[..., 3:5].abs()], -1).reshape(-1, 10)
                          for g in (m1, m2)])
        valid = torch.from_numpy(np.concatenate([v1.ravel(), v2.ravel()]))
        plain = rank_sum_ref(rows, torch.from_numpy(idx), n, valid)
        g = table["G"][1](m1, m2)
        assert torch.equal(g.view(torch.int32), plain.view(torch.int32))


def test_scatter_lab_reports_every_variant(lab_scene):
    res = lab.scatter_lab(CPU, reps=1, sizes=LAB_CUT, **SMALL_CAPS)
    assert set(res["variants"]) == {"A", "B", "C", "D", "E", "F", "G",
                                    "G_plain"}
    dropped = {k: r["dropped_rows"] for k, r in res["variants"].items()}
    assert dropped == {"A": 0, "B": 0, "C": 0, "D": 0, "E": 242 - 100,
                       "F": 6321 - 4000 + 242 - 100, "G": 0, "G_plain": 0}
    for name, row in res["variants"].items():
        assert row["rel_err"] <= 1e-5 and row["repeat_bits"], name
        assert np.isfinite(row["ms"])
    assert (res["counts1_sum"], res["counts2_sum"]) == (6321, 242)


# --- segpair profile and the sharded trace --------------------------------

@pytest.fixture(scope="module")
def fixture_cut():
    return segprof.fixture(CPU, CUT_N, SIZE)


@pytest.mark.parametrize("variant", ["0", "1", "seg"])
def test_segpair_profile_step_matches_jax_rasterize(fixture_cut, variant):
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.ops.rasterize import rasterize
    fx, cam = fixture_cut, 1
    got = segprof.make_step(fx, variant)(cam)
    args = [jnp.asarray(p.numpy()) for p in fx["params"]]
    vm = jnp.asarray(fx["viewmats"][cam].numpy())
    K = jnp.asarray(fx["Ks"][cam].numpy())
    W, H = fx["width"], fx["height"]

    def loss(m, q, s, o):
        out = rasterize(m, q, s, o, vm, K, W, H, backend="jax",
                        pair_kernel=segprof.pair_kernel(variant),
                        **segprof.TILES)
        return jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1)
                                - jnp.zeros((H, W), jnp.float32)))

    lj, gj = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(*args)
    assert float(lj) > 0
    np.testing.assert_allclose(float(got[0]), float(lj), rtol=LOSS_RTOL)
    _close_grads([g.numpy() for g in got[1:]], gj,
                 ("means", "quats", "scales", "opacities"))


def test_segpair_profile_cycles_the_fixture_cameras(tmp_path, fixture_cut,
                                                    monkeypatch):
    monkeypatch.setattr(segprof, "WARM_STEPS", 2)
    seen = []
    real = segprof.make_step

    def make_step(fx, variant):
        step = real(fx, variant)

        def counted(cam):
            seen.append(cam)
            return step(cam)
        return counted

    monkeypatch.setattr(segprof, "make_step", make_step)
    res = segprof.profile_variant(fixture_cut, "seg", 7, str(tmp_path / "t"),
                                  CPU)
    n_cams = fixture_cut["viewmats"].shape[0]
    assert n_cams == 5
    assert seen == [v % 5 for v in range(segprof.WARM_STEPS)] + \
        [i % 5 for i in range(7)]
    assert os.path.exists(res["trace"]) and res["rows"] == []
    assert res["total_device_ms"] == 0 and res["ms_per_step"] > 0


def test_sharded_trace_proj_grad_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from edgegaussians_tpu.config import load_config
    from edgegaussians_tpu.models.gaussians import GaussianParams
    from edgegaussians_tpu.parallel import train_sharded
    s = shard.setup(CPU, CUT_N, SIZE)
    with shard.one_rank_world(CPU):
        res = shard.profile(s, 1, str(tmp_path / "trace"), CPU)
        loss, _, grads, sink = shard.call(shard.sharded_fn(s), s)
    assert res["loss"] == float(loss)
    np.testing.assert_allclose(res["unsharded_loss"], res["loss"],
                               rtol=1e-5)
    m = s["model"]
    params = GaussianParams(**{g: jnp.asarray(getattr(m, g).detach().numpy())
                               for g in ("means", "scales", "quats",
                                         "opacities")})
    mesh = Mesh(np.array(jax.devices()[:1]), ("tiles",))
    fn = jax.jit(train_sharded.make_sharded_proj_grad_fn(
        load_config(torch_common.RECIPE), s["width"], s["height"], "jax",
        mesh))
    jl, _, jg, jsink = fn(params, jnp.ones((m.capacity,), bool),
                          jnp.asarray(s["vm"].numpy()),
                          jnp.asarray(s["K"].numpy()),
                          jnp.asarray(s["gt"].numpy()),
                          jnp.asarray(s["edge_mask"].numpy()),
                          jnp.int32(0), jnp.float32(1.0),
                          jax.random.PRNGKey(0))
    assert float(jl) > 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    names = ("means", "scales", "quats", "opacities")
    _close_grads([grads[g].numpy() for g in names],
                 [getattr(jg, g) for g in names], names)
    sink_j = np.asarray(jsink)
    assert np.abs(sink.numpy() - sink_j).max() <= \
        GRAD_TOL * np.abs(sink_j).max()


# --- scaling efficiency ---------------------------------------------------

def test_scaling_scene_equals_the_jax_draws():
    import jax.numpy as jnp
    W, H, nv, n = 48, 32, 3, 100
    r = np.random.default_rng(0)
    seeds = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = jnp.asarray(r.random((nv, H, W)), jnp.float32)
    f = W * 0.9
    Ks = jnp.tile(jnp.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                            jnp.float32), (nv, 1, 1))
    vms = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (nv, 1, 1))
    sc = scaling.scene(W, H, nv, n)
    for k, v in (("seeds", seeds), ("images", images),
                 ("edge_masks", images > 0.5), ("Ks", Ks),
                 ("viewmats", vms)):
        np.testing.assert_array_equal(sc[k], np.asarray(v), k)
        assert sc[k].dtype == np.asarray(v).dtype, k
    cfg = scaling.scaling_config(n)
    assert (cfg.model.max_num_gaussians, cfg.model.tile_gaussian_capacity,
            cfg.model.tile_dense_capacity, cfg.training.num_epochs) == \
        (n, 256, 128, 100)


@pytest.mark.parametrize("ranks_on,placed", [
    ("cards", {1: "cards", 2: "cards", 4: "cards"}),
    ("shared", {1: "shared", 2: "shared", 4: "shared", 8: "shared"})])
def test_scaling_placement_on_four_cards(ranks_on, placed, monkeypatch,
                                         capsys):
    """On a host with 4 cards, ``cards`` drops size 8 as the JAX script
    drops sizes above its device count, ``shared`` places every size,
    and one run never mixes the two; a ``shared`` rank is pinned to card
    0 whatever card ``distributed.initialize`` gave it."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [scaling.placement(s, "cards", cuda) for s in (1, 2, 4, 8)] \
        == ["cards", "cards", "cards", ""]
    assert {scaling.placement(s, r, CPU) for s in (1, 8)
            for r in ("cards", "shared")} == {"cpu"}
    spawned = []

    def fake_spawn(size, where, argv, result_dir):
        spawned.append((size, where))
        rows = {m: {"devices": size, "sec_per_epoch": 1.0 / size,
                    "px_per_s": 100.0 * size, "tiles_per_s": 1.0 * size}
                for m in scaling.MODES}
        with open(os.path.join(result_dir, "rows.json"), "w") as f:
            json.dump(rows, f)
        return ""

    monkeypatch.setattr(scaling, "resolve_device", lambda name: cuda)
    monkeypatch.setattr(scaling, "card", lambda: "card")
    monkeypatch.setattr(scaling, "spawn", fake_spawn)
    assert scaling.main(["--mesh-sizes", "1,2,4,8", "--steps", "1",
                         "--ranks_on", ranks_on]) == 0
    res = _last_json(capsys)
    assert spawned == list(placed.items())
    assert res["ranks_on"] == {str(k): v for k, v in placed.items()}
    assert ("note" in res) == (ranks_on == "shared")
    for mode in scaling.MODES:
        rows = res["modes"][mode]
        assert [r["devices"] for r in rows] == list(placed)
        assert {r["ranks_on"] for r in rows} == {ranks_on}
        assert [r["efficiency_vs_1dev"] for r in rows] == [1.0] * len(rows)

    current = [3]
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.__setitem__(0, d))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    assert scaling.rank_device("cuda", "cards") == torch.device("cuda", 3)
    assert scaling.rank_device("cuda", "shared") == torch.device("cuda", 0)
    assert scaling.rank_device("cpu", "shared") == CPU


def test_scaling_two_gloo_ranks_agree_with_one_process(tmp_path):
    c = SCALING_CUT
    argv = ["--width", str(c["width"]), "--height", str(c["height"]),
            "--views", str(c["views"]), "--gaussians", str(c["gaussians"]),
            "--steps", "1", "--device", "cpu"]
    scaling.spawn(2, "cpu", argv, str(tmp_path))
    with open(tmp_path / "rows.json") as f:
        rows = json.load(f)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert set(rows) == set(scaling.MODES)
    for mode, row in rows.items():
        assert row["devices"] == 2 and row["sec_per_epoch"] > 0, mode
    assert set(ranks[0]) == set(ranks[1])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    sc = scaling.scene(**c)
    one, states = scaling.run_modes(scaling.MODES, 1, sc,
                                    scaling.scaling_config(c["gaussians"]),
                                    1, CPU)
    ref = scaling.state_arrays(states)
    assert set(ref) == set(ranks[0])
    for k, v in ref.items():
        assert np.isfinite(ranks[0][k]).all() if v.dtype != bool else True
        np.testing.assert_allclose(ranks[0][k], v, atol=STATE_ATOL,
                                   rtol=STATE_RTOL, err_msg=k)
    # one epoch moved the parameters from their initial values
    init = scaling.fresh_state(sc["seeds"],
                               scaling.scaling_config(c["gaussians"]), CPU)
    assert not np.array_equal(ref["sharded:param means"],
                              init.model.means.detach().numpy())
    assert all(one[m]["devices"] == 1 for m in scaling.MODES)


# --- the top-op reader ----------------------------------------------------

def _kernel(name, corr, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "dur": dur,
            "args": {"correlation": corr}}


def _launch(corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "dur": 3,
            "args": {"correlation": corr}}


def _trace(lost=0):
    events = [_launch(1), _launch(2), _launch(3, "cuLaunchKernel"),
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync",
               "dur": 1, "args": {"correlation": 4}},
              {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
               "dur": 2, "args": {"correlation": 4}},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9},
              {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1}]
    events += [_kernel("void run_fwd_kernel<(RunEnd)0>(...)", 1, 20.0),
               _kernel("elementwise", 2, 5.0),
               _kernel("void run_fwd_kernel<(RunEnd)0>(...)", 3, 22.0)][lost:]
    return {"traceEvents": events}


def test_trace_ops_counts_kernel_and_launch_records_per_op(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    ops = torch_common.trace_ops(str(path))
    assert ops == {
        "void run_fwd_kernel<(RunEnd)0>(...)": {"us": 42.0, "kernels": 2,
                                                "launches": 2},
        "elementwise": {"us": 5.0, "kernels": 1, "launches": 1}}
    table = torch_common.op_table(ops, 2)
    assert [r["op"] for r in table["rows"]] == list(ops)
    assert table["total_device_ms"] == pytest.approx(0.0235)
    assert table["rows"][0]["pct"] == pytest.approx(100 * 42 / 47)
    assert torch_common.op_count(table["rows"], "segpair_fwd") == 2
    assert torch_common.op_count(table["rows"], "segpair_bwd") == 0


def test_trace_ops_refuses_a_window_short_of_kernel_records(tmp_path,
                                                            monkeypatch):
    assert torch_common.trace_ops(_trace(lost=1)) is None
    windows = []

    def short(path):
        windows.append(path)
        return None

    monkeypatch.setattr(torch_common, "trace_ops", short)
    with pytest.raises(RuntimeError, match="fewer kernel records"):
        torch_common.traced_ops(lambda: None, 2, str(tmp_path), CPU)
    assert len(windows) == torch_common.PROFILED_WINDOWS
    reads = iter([None, {"k": {"us": 1.0, "kernels": 1, "launches": 1}}])
    monkeypatch.setattr(torch_common, "trace_ops", lambda p: next(reads))
    ops, wall, counts = torch_common.traced_ops(lambda: None, 2,
                                                str(tmp_path), CPU)
    assert ops == {"k": {"us": 1.0, "kernels": 1, "launches": 1}}
    assert wall >= 0 and not any(counts.values())


# --- smoke runs -----------------------------------------------------------

def _edge_ply(gt_ply: str, ply: str) -> None:
    """Elongated, opaque Gaussians laid along the scan's ground-truth
    edges, written as a trained PLY."""
    from edgegaussians_tpu_torch.io.ply import read_point_cloud
    from edgegaussians_tpu_torch.models.gaussians import (GaussianModel,
                                                          export_as_ply)
    pts = read_point_cloud(gt_ply).astype(np.float32)
    d = np.roll(pts, -1, 0) - np.roll(pts, 1, 0)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    quats = np.concatenate([1.0 + d[:, :1], np.zeros_like(d[:, :1]),
                            -d[:, 2:3], d[:, 1:2]], 1)
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = np.where(norm > 1e-6, quats / np.maximum(norm, 1e-6),
                     np.array([[0.0, 0.0, 0.0, 1.0]]))
    n = len(pts)
    model = GaussianModel(n)
    rows = {"means": pts, "quats": quats,
            "scales": np.log(np.tile([[0.01, 0.001, 0.001]], (n, 1))),
            "opacities": np.full((n, 1), 3.0)}
    with torch.no_grad():
        for g, v in rows.items():
            getattr(model, g).copy_(torch.from_numpy(v.astype(np.float32)))
        model.alive.fill_(True)
    export_as_ply(model, ply)


def test_smoke_runs_print_the_jax_keys(scan, tmp_path, capsys):
    data, gt, cfg = scan
    out = str(tmp_path)
    assert dup.main(_scan_args(scan, os.path.join(out, "dup"), "--seeds",
                               "1", "--epochs", "2")) == 0
    res = _last_json(capsys)
    assert list(res["results"]) == ["absolute", "top_fraction"]
    for arm, rows in res["results"].items():
        assert [set(r) for r in rows] == [
            {"seed", "gaussians", "wall_s", "chamfer", "f10"}]
        assert all(np.isfinite(res["runs"][f"{arm}/seed0"]["losses"]))
    with open(os.path.join(out, "dup", "dup_ab_results.json")) as f:
        assert json.load(f) == res["results"]

    assert dpq.main(_scan_args(scan, os.path.join(out, "dp"), "--epochs",
                               "2", "--seeds", "1")) == 0
    res = _last_json(capsys)
    assert set(res) >= jax_output_keys("dp_quality_run")
    assert res["mode"] == "view_batch" and res["batch"] == 10
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))

    args = _scan_args(scan, os.path.join(out, "pk"), "--epochs", "2")
    args.remove("--gt_base")
    args.remove(gt)
    assert pka.main(args) == 0
    res = _last_json(capsys)
    assert set(res) >= jax_output_keys("pair_kernel_ab")
    assert (res["width"], res["height"]) == (PX, PX)
    assert res["order"] == ["dense", "pairk", "segk"]
    for tag in pka.VARIANTS:
        assert len(res[f"{tag}_losses"]) == 2
        assert all(np.isfinite(res[f"{tag}_losses"]))

    # spread_synth over the view-batch run, its Gaussians on the edges
    from edgegaussians_tpu_torch.cli.evaluate import evaluate_scan
    from edgegaussians_tpu_torch.config import load_config
    dp_cfg = os.path.join(out, "dp", "dp_config.json")
    run_dir = torch_common.scene_run_dir(load_config(dp_cfg),
                                         os.path.join(out, "dp"), SCAN)
    _edge_ply(os.path.join(gt, "sampled_pts", f"{SCAN}_0.005.ply"),
              os.path.join(run_dir, "gaussians_all.ply"))
    # the run's own extraction left its (empty) sampled edges, which
    # evaluate_scan reads before the parametric edges that fit_edges writes
    os.remove(os.path.join(run_dir, "edge_sampled_points_0.005.ply"))
    assert spread.main(["--config_file", dp_cfg, "--gt_base_dir", gt,
                        "--output_base_dir", os.path.dirname(run_dir),
                        "--scan_names", SCAN]) == 0
    got = _last_json(capsys)
    import collections
    pr = collections.defaultdict(list)
    row = evaluate_scan(SCAN, gt, os.path.dirname(run_dir), pr,
                        use_parametric_edges=True)
    assert row is not None
    want = {**row, **{k: v[0] for k, v in pr.items()}}
    assert got == {SCAN: {k: float(v) for k, v in want.items()}}
    assert set(spread.KEYS) <= set(got[SCAN])
    assert got[SCAN]["chamfer_dist"] < 0.05
