"""Package-level checks of the PyTorch port: it never loads JAX or the
JAX package, its own copies of the JAX package's NumPy modules (config,
cameras, io, data, eval, extract) stay equal to the originals, its
backend resolution,
and the plain pieces of the slice (losses, Adam schedules, model init and
PLY round trip, the per-pixel oracle) held to the JAX package on the same
NumPy inputs.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegaussians_tpu.config import ModelConfig, OptimConfig
from edgegaussians_tpu.models import gaussians as jgaussians
from edgegaussians_tpu.models import losses as jlosses
from edgegaussians_tpu.ops.rasterize_ref import (
    rasterize_reference as jrasterize_reference)
from edgegaussians_tpu.train import optim as joptim
from edgegaussians_tpu_torch import resolve_backend
from edgegaussians_tpu_torch.models import gaussians, losses
from edgegaussians_tpu_torch.ops.rasterize_ref import rasterize_reference
from edgegaussians_tpu_torch.train import optim

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, import with neither
    JAX nor any module of the JAX package loaded: the machine with the
    GPU has no JAX, and the port keeps its own copies of what it needs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import edgegaussians_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'edgegaussians_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) >= 67, names\n"
        "bad = [m for m in sys.modules if m in ('jax', 'edgegaussians_tpu')\n"
        "       or m.startswith(('jax.', 'edgegaussians_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_resolve_backend():
    """'auto' means the card: it resolves to 'cuda' and raises where
    torch sees no GPU; the CPU runs only when named."""
    assert resolve_backend("torch") == "torch"
    assert resolve_backend("auto", "torch") == "torch"
    assert resolve_backend("torch", "auto") == "torch"
    with pytest.raises(ValueError):
        resolve_backend("pallas")
    if torch.cuda.is_available():
        assert resolve_backend("auto", "auto") == "cuda"
        assert resolve_backend("cuda") == "cuda"
    else:
        for backend, configured in (("auto", "auto"), ("cuda", "auto"),
                                    ("auto", "cuda"), ("cuda", "torch")):
            with pytest.raises(RuntimeError, match="--backend torch"):
                resolve_backend(backend, configured)


def test_configured_compositor_resolves_the_device_as_auto():
    from edgegaussians_tpu_torch import resolve_compositor
    for name in ("pallas", "pallas_v1"):
        if torch.cuda.is_available():
            assert resolve_backend("auto", name) == "cuda"
        else:
            with pytest.raises(RuntimeError, match="sees no GPU"):
                resolve_backend("auto", name)
        assert resolve_backend("torch", name) == "torch"
        assert resolve_compositor(name) == name
    for name in ("auto", "cuda", "torch"):
        assert resolve_compositor(name) == "pallas"
    for name in ("jax", "reference"):
        with pytest.raises(ValueError, match="XLA oracle"):
            resolve_compositor(name)
        with pytest.raises(ValueError, match="XLA oracle"):
            resolve_backend("auto", name)


def _images(seed=0, h=24, w=32):
    r = np.random.default_rng(seed)
    pred = r.uniform(0, 1, (h, w)).astype(np.float32)
    gt = (r.uniform(0, 1, (h, w)) > 0.8).astype(np.float32)
    return pred, gt, gt >= 0.5


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0, 40.0])
def test_projection_losses_match_jax(ratio):
    """Exact arithmetic on both sides: rtol 1e-6 (f32 summation order)."""
    pred, gt, edge = _images()
    scores = np.random.default_rng(1).uniform(size=pred.size).astype(
        np.float32)
    tp, tg, te = map(torch.from_numpy, (pred, gt, edge))
    jp, jg, je = map(jnp.asarray, (pred, gt, edge))
    wm = losses.compute_weight_mask(te)
    np.testing.assert_allclose(
        wm.numpy(), np.asarray(jlosses.compute_weight_mask(je)), rtol=1e-6)
    pairs = [
        (losses.projection_loss_whole(tp, tg),
         jlosses.projection_loss_whole(jp, jg)),
        (losses.projection_loss_whole(tp, tg, "l2"),
         jlosses.projection_loss_whole(jp, jg, "l2")),
        (losses.projection_loss_weighted(tp, tg, wm),
         jlosses.projection_loss_weighted(
             jp, jg, jlosses.compute_weight_mask(je))),
        (losses.masked_l1(tp, tg, te), jlosses.masked_l1(jp, jg, je)),
    ]
    # bg_edge_ratio with the JAX draws injected: the same pixels are drawn
    import jax
    key = jax.random.PRNGKey(3)
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (pred.size,))))
    pairs.append((
        losses.projection_loss_bg_edge_ratio(tp, tg, te, ratio, draws),
        jlosses.projection_loss_bg_edge_ratio(jp, jg, je,
                                              jnp.float32(ratio), key)))
    for t, j in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


def test_lr_schedules_and_annealing_match_jax():
    cfg = OptimConfig()
    cfg.means.milestones = [10, 20, 30]
    cfg.means.gamma = 0.75
    for epoch in (0, 9, 10, 25, 30, 31, 100):
        lj = joptim.all_lrs(cfg, jnp.int32(epoch))
        lt = optim.all_lrs(cfg, epoch)
        for g in lt:
            assert lt[g] == pytest.approx(float(lj[g]), rel=1e-6), (g, epoch)
        for mode in ("constant", "linear"):
            assert optim.annealed(1.0, 0.2, mode, epoch, 100) == \
                pytest.approx(float(joptim.annealed(
                    1.0, 0.2, mode, jnp.int32(epoch), 100)), rel=1e-6)


def test_partial_adam_step_matches_jax():
    """Adam on a subset of groups (the direction/ratio losses' partial
    step): same arithmetic term for term, rtol 1e-6."""
    r = np.random.default_rng(2)
    seeds = r.uniform(0, 1, (20, 3)).astype(np.float32)
    mcfg = ModelConfig(max_num_gaussians=32)
    js = jgaussians.init_state(seeds, mcfg)
    model = gaussians.init_state(seeds, mcfg)
    jopt = joptim.init_opt_state(js.params)
    topt = optim.init_opt_state(model)
    lrs = {"means": 0.01, "scales": 0.02, "quats": 0.0, "opacities": 0.05}
    params = js.params
    for step, groups in enumerate((optim.GROUPS, ("means", "scales"),
                                   optim.GROUPS)):
        grads = {g: r.normal(size=getattr(params, g).shape).astype(
            np.float32) for g in optim.GROUPS}
        params, jopt = joptim.apply_updates(
            params, jgaussians.GaussianParams(
                **{g: jnp.asarray(x) for g, x in grads.items()}),
            jopt, {g: jnp.float32(v) for g, v in lrs.items()}, groups)
        optim.apply_updates(model, {g: torch.from_numpy(x)
                                    for g, x in grads.items()},
                            topt, lrs, groups)
    for g in optim.GROUPS:
        np.testing.assert_allclose(getattr(model, g).detach().numpy(),
                                   np.asarray(getattr(params, g)),
                                   rtol=1e-6, atol=1e-7)
        assert topt.counts[g] == int(getattr(jopt.counts, g))


def test_model_init_and_ply_round_trip_match_jax(tmp_path):
    r = np.random.default_rng(5)
    seeds = r.uniform(0, 1, (40, 3)).astype(np.float32)
    mcfg = ModelConfig(max_num_gaussians=64, init_scales_val=0.01,
                       init_opacity_val=0.1)
    js = jgaussians.init_state(seeds, mcfg, seed=7)
    model = gaussians.init_state(seeds, mcfg, seed=7)
    for g in optim.GROUPS:
        np.testing.assert_array_equal(getattr(model, g).detach().numpy(),
                                      np.asarray(getattr(js.params, g)))
    np.testing.assert_array_equal(model.alive.numpy(), np.asarray(js.alive))
    n = gaussians.export_as_ply(model, str(tmp_path / "t.ply"))
    assert n == jgaussians.export_as_ply(js, str(tmp_path / "j.ply")) == 40
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    back = gaussians.load_from_ply(str(tmp_path / "t.ply"), mcfg,
                                   capacity=64)
    jback = jgaussians.load_from_ply(str(tmp_path / "j.ply"), mcfg,
                                     capacity=64)
    for g in optim.GROUPS:
        np.testing.assert_allclose(getattr(back, g).detach().numpy(),
                                   np.asarray(getattr(jback.params, g)),
                                   rtol=1e-6, atol=1e-6)


def test_per_pixel_oracle_matches_jax():
    """The oracle twins: same projection, same per-pixel alphas, log-space
    composite; atol 1e-5 on intensities in [0, 1]."""
    from test_pallas_segpair import _scene
    *args, w, h = _scene(n=120)
    img_j = jrasterize_reference(*args, w, h)
    img_t = rasterize_reference(*[torch.tensor(np.asarray(a)) for a in args],
                                w, h)
    assert float(img_t.max()) > 0.5
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5)


def test_config_copy_matches_jax():
    from edgegaussians_tpu import config as jconfig
    from edgegaussians_tpu_torch import config
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
    assert len(paths) >= 5
    for path in paths:
        assert dataclasses.asdict(config.load_config(path)) == \
            dataclasses.asdict(jconfig.load_config(path)), path


def _scene_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_synthetic_copy_writes_the_same_scene_and_parsers_read_it(tmp_path):
    """generate_scene of both packages from one seed writes the same
    files (decoded images, point clouds, camera JSON); the parsers, seed
    points and camera helpers of both read them to equal arrays."""
    import json

    from PIL import Image

    from edgegaussians_tpu import cameras as jcameras
    from edgegaussians_tpu.config import config_from_dict as jconfig_from_dict
    from edgegaussians_tpu.data import parsers as jparsers
    from edgegaussians_tpu.data import seed_points as jseeds
    from edgegaussians_tpu.data.synthetic import generate_scene as jgenerate
    from edgegaussians_tpu.io import ply as jply
    from edgegaussians_tpu_torch import cameras
    from edgegaussians_tpu_torch.config import config_from_dict
    from edgegaussians_tpu_torch.data import parsers, seed_points
    from edgegaussians_tpu_torch.data.synthetic import generate_scene
    from edgegaussians_tpu_torch.io import ply

    kw = dict(seed=4, n_views=3, width=40, height=32, n_lines=2, n_curves=1,
              focal=40.0)
    generate_scene(str(tmp_path / "port"), "S", **kw)
    jgenerate(str(tmp_path / "jax"), "S", **kw)
    files = _scene_files(tmp_path / "port")
    assert files == _scene_files(tmp_path / "jax") and len(files) > 5
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)), rel)
        elif rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.endswith(".ply"):
            np.testing.assert_array_equal(ply.read_point_cloud(str(a)),
                                          jply.read_point_cloud(str(b)), rel)
        else:
            assert a.read_bytes() == b.read_bytes(), rel

    raw = {"data": {"parser_type": "emap", "dataset_name": "ABC",
                    "base_dir": str(tmp_path / "port" / "data") + "/",
                    "edge_detection_method": "DexiNed"}}
    scene = parsers.load_scene(config_from_dict(raw).data, "S")
    jscene = jparsers.load_scene(jconfig_from_dict(raw).data, "S")
    for name in ("images", "viewmats", "Ks"):
        np.testing.assert_array_equal(getattr(scene, name),
                                      getattr(jscene, name), name)
    assert (scene.width, scene.height) == (jscene.width, jscene.height)
    assert cameras.max_pairwise_center_distance(scene.cameras) == \
        jcameras.max_pairwise_center_distance(jscene.cameras)
    assert parsers.get_paths_from_data_config(
        config_from_dict(raw).data, "S") == \
        jparsers.get_paths_from_data_config(jconfig_from_dict(raw).data, "S")
    seed_path = str(tmp_path / "port" / "groundtruth" / "sampled_pts" /
                    "S_0.005.ply")
    np.testing.assert_array_equal(
        seed_points.init_seed_points_from_file(
            seed_path, 500, np.random.default_rng(1)),
        jseeds.init_seed_points_from_file(
            seed_path, 500, np.random.default_rng(1)))
    np.testing.assert_array_equal(
        seed_points.init_seed_points_random(
            50, 0.5, 1.1, np.random.default_rng(2)),
        jseeds.init_seed_points_random(50, 0.5, 1.1,
                                       np.random.default_rng(2)))


def _colmap_db_calls(m):
    """A COLMAP database written through ``m`` and read back: cameras,
    images, keypoints, matches in both orders, pair ids, blobs."""
    import tempfile
    r = np.random.default_rng(13)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "database.db")
        with m.ColmapDatabase(path) as db:
            cam = db.add_camera(1, 64, 48, [50.0, 50.0, 32.0, 24.0])
            ims = [db.add_image(f"{i}.png", cam) for i in range(3)]
            for i in ims:
                db.add_keypoints(i, r.uniform(0, 64, (10, 2)))
                db.add_descriptors(i, r.integers(0, 255, (10, 128)))
            db.add_matches(ims[2], ims[0], r.integers(0, 10, (6, 2)))
            db.add_two_view_geometry(ims[0], ims[1],
                                     r.integers(0, 10, (4, 2)))
        db = m.ColmapDatabase(path)
        try:
            out = (db.cameras(), db.images(),
                   [db.keypoints(i) for i in ims + [99]],
                   db.matches(ims[0], ims[2]), db.matches(ims[2], ims[0]),
                   db.matches(ims[0], ims[1]))
            geometry = db.conn.execute(
                "SELECT * FROM two_view_geometries").fetchall()
        finally:
            db.close()
    return out + (list(geometry[0]),
                  m.image_ids_to_pair_id(7, 3), m.pair_id_to_image_ids(
                      m.image_ids_to_pair_id(3, 7)),
                  m.blob_to_array(m.array_to_blob(np.arange(6.0)),
                                  np.float64, (2, 3)),
                  m.blob_to_array(None, np.float32, (0, 2)))


def _cluster_ply_bytes(m):
    """The bytes of ``m.export_clusters_as_ply`` of seeded clusters."""
    import tempfile
    points = np.random.default_rng(14).uniform(0, 1, (30, 3))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clusters.ply")
        m.export_clusters_as_ply(points, [{0, 3, 5}, set(range(10, 30))],
                                 path)
        with open(path, "rb") as f:
            return f.read()


def _copy_cases():
    """Per copied NumPy module: calls of its public functions on NumPy
    inputs made from a seed, as (name, fn(module) -> result)."""
    r = np.random.default_rng(12)
    cloud = r.uniform(0, 1, (300, 3))
    other = r.uniform(0, 1, (200, 3))
    dirs = r.normal(size=(300, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ctrl = r.uniform(0, 1, (4, 3))
    line = np.linspace(0, 1, 40)[:, None] * r.normal(size=(1, 3)) \
        + r.normal(scale=0.002, size=(40, 3))
    scales, quats = r.uniform(0.1, 1, (50, 3)), r.normal(size=(50, 4))
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    R, t = np.eye(3), np.array([[-0.5], [-0.5], [2.0]])
    return {
        "eval.neighbors": lambda m: (m.k_nearest_neighbors(other, cloud, 3),
                                     m.k_nearest_neighbors(other, cloud, 1),
                                     m.knn_self(cloud, 5)),
        "eval.metrics": lambda m: (
            m.chamfer_distance(other, cloud),
            m.compute_precision_recall_IOU(other, cloud, m.empty_metrics()),
            m.f_score(0.5, 0.25), m.downsample_point_cloud_average(cloud, 8)),
        "eval.gt": lambda m: (
            m.bezier_curve_length(ctrl, 20),
            m.sample_parametric_edges({"curves_ctl_pts": [ctrl.tolist()],
                                       "lines_end_pts": [[0, 0, 0, .3, .2,
                                                          .1]]}, 0.01)),
        "extract.filtering": lambda m: (
            m.filter_stat_outliers(cloud, 10, 2.0),
            m.filter_by_opacity(cloud[:, 0], 0.5),
            m.project2D_single(K, R, t, cloud),
            m.filter_by_projection(cloud, [cloud[:48, :2].repeat(32, 1)
                                           [:, :64]],
                                   [{"K": K, "R": R, "t": t, "h": 48,
                                     "w": 64}], 0.2)),
        "extract.clustering": lambda m: m.cluster_points_using_directions_greedy(
            cloud, dirs, 0.3, 2, rng=np.random.default_rng(4))[0],
        "extract.fitting": lambda m: (
            m.bezier_curve(np.linspace(0, 1, 7), ctrl), m.line_fitting(line),
            m.ransac_line(line, 0.005, 50, np.random.default_rng(2)),
            m.bezier_fit(line),
            m.fit_edges([set(range(40))], line,
                        np.tile([[1.0, 0, 0]], (40, 1)),
                        rng=np.random.default_rng(3))[1]),
        "extract.pipeline": lambda m: m.major_directions_np(scales, quats),
        "io.colmap_db": _colmap_db_calls,
        "vis.vis_utils": _cluster_ply_bytes,
    }


def _assert_same_tree(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not all(
            isinstance(x, (int, float, np.number)) for x in a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, (set, str, bytes)):
        assert a == b, where
    elif a is None:
        assert b is None, where
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=1e-12, atol=0, err_msg=where)


@pytest.mark.parametrize("module", list(_copy_cases()))
def test_numpy_eval_and_extract_copies_match_jax(module):
    """The port's copies of the JAX package's NumPy-only modules (eval,
    extract, the COLMAP database, the visualization helpers) give what the
    originals give, call for call (the KD-tree behind eval.neighbors
    differs, C++ vs scipy; both are exact)."""
    import importlib
    port = importlib.import_module(f"edgegaussians_tpu_torch.{module}")
    orig = importlib.import_module(f"edgegaussians_tpu.{module}")
    public = sorted(n for n, v in vars(orig).items()
                    if callable(v) and not n.startswith("_")
                    and getattr(v, "__module__", "") == orig.__name__)
    assert public and all(hasattr(port, n) for n in public), public
    call = _copy_cases()[module]
    _assert_same_tree(call(port), call(orig), module)
