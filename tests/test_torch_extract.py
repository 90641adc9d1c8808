"""The port's downstream stages held to the JAX package's on one scan: edge
extraction (filter -> cluster -> fit -> sample), the metrics, and the
``fit_edges`` / ``evaluate`` CLIs with the same flags and output layout.

The scan is a small synthetic one (``generate_scene``), and the trained
Gaussians are made from its own wireframe: points jittered along each line
and curve with the major axis along the tangent, plus low-opacity and
outlying rows for the filters to drop. Both packages run the same NumPy
code on it (the port's modules are copies) with the same seed; the only
difference is the KD-tree behind the neighbour queries (the JAX package's
C++ one where built, scipy's cKDTree in the port), which is exact on both
sides. So clusters, fitted edges, sampled points and metrics must be
equal, floats within rtol 1e-12.
"""

import json
import os
import pickle

import numpy as np
import pytest

from edgegaussians_tpu.cli import evaluate as jevaluate
from edgegaussians_tpu.cli import fit_edges as jfit_edges
from edgegaussians_tpu.config import load_config as jload_config
from edgegaussians_tpu.data import parsers as jparsers
from edgegaussians_tpu.data.synthetic import generate_scene
from edgegaussians_tpu.eval import metrics as jmetrics
from edgegaussians_tpu.extract.pipeline import extract_edges as jextract
from edgegaussians_tpu_torch.cli import evaluate, fit_edges
from edgegaussians_tpu_torch.config import load_config
from edgegaussians_tpu_torch.data import parsers
from edgegaussians_tpu_torch.eval import metrics
from edgegaussians_tpu_torch.extract.pipeline import extract_edges
from edgegaussians_tpu_torch.io import ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN = "SYNX"


def _gaussians_on(wireframe, rng):
    """Gaussians along the wireframe's edges, major axis (x, the largest
    scale) along the tangent, plus 40 outliers and 60 faint rows."""
    pts, dirs = [], []
    for a, b in np.asarray(wireframe["lines"]):
        t = rng.uniform(0, 1, 90)
        pts.append(a + t[:, None] * (b - a))
        dirs.append(np.tile(b - a, (90, 1)))
    for c in np.asarray(wireframe["curves"]):
        t = rng.uniform(0, 1, 120)[:, None]
        u = 1 - t
        pts.append(u ** 3 * c[0] + 3 * u * u * t * c[1] + 3 * u * t * t * c[2]
                   + t ** 3 * c[3])
        dirs.append(3 * u * u * (c[1] - c[0]) + 6 * u * t * (c[2] - c[1])
                    + 3 * t * t * (c[3] - c[2]))
    pts = np.concatenate(pts)
    pts = pts + rng.normal(scale=0.001, size=pts.shape)
    dirs = np.concatenate(dirs)
    n = len(pts)
    pts = np.concatenate([pts, rng.uniform(0.1, 0.9, (100, 3))])
    dirs = np.concatenate([dirs, rng.normal(size=(100, 3))])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[dirs[:, 0] < 0] *= -1
    # the rotation taking x to d: wxyz = normalize(1 + d_x, 0, -d_z, d_y)
    quats = np.stack([1 + dirs[:, 0], np.zeros(len(dirs)), -dirs[:, 2],
                      dirs[:, 1]], 1)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.tile([0.01, 0.002, 0.003], (len(pts), 1)) \
        * rng.uniform(0.8, 1.2, (len(pts), 1))
    opac = rng.uniform(0.3, 0.9, (len(pts), 1))
    opac[n + 40:] = 0.1                          # faint rows
    return (pts.astype(np.float32), scales.astype(np.float32),
            quats.astype(np.float32), opac.astype(np.float32))


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """(config path, output dir of the trained scan, GT base dir)."""
    root = tmp_path_factory.mktemp("extract")
    generate_scene(str(root), SCAN, seed=8, n_views=4, width=96, height=96,
                   n_lines=3, n_curves=2, focal=110.0)
    with open(root / "data" / SCAN / "wireframe.json") as f:
        wireframe = json.load(f)
    with open(os.path.join(REPO, "configs", "ABC_DexiNed.json")) as f:
        cfg = json.load(f)
    cfg["data"]["base_dir"] = str(root / "data") + "/"
    cfg["output"]["output_dir"] = str(root / "out") + "/"
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = root / "out" / "release_DexiNed" / SCAN
    os.makedirs(out_dir)
    ply.write_gaussian_params_as_ply(
        *_gaussians_on(wireframe, np.random.default_rng(0)),
        str(out_dir / "gaussians_all.ply"))
    return cfg_path, out_dir, root / "groundtruth"


def test_extract_edges_matches_jax(scan, tmp_path):
    cfg_path, out_dir, _ = scan
    ply_path = str(out_dir / "gaussians_all.ply")
    results = []
    for tag, extract, load, load_scene in (
            ("port", extract_edges, load_config, parsers.load_scene),
            ("jax", jextract, jload_config, jparsers.load_scene)):
        cfg = load(cfg_path)
        results.append(extract(
            ply_path, cfg, scene=load_scene(cfg.data, SCAN),
            output_dir=str(tmp_path / tag), save_filtered=True,
            save_sampled_points=True, seed=3))
    t, j = results
    for name in ("positions", "scales", "quats", "opacities", "major_dirs",
                 "sampled_points"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert t.clusters == j.clusters
    assert t.parametric == j.parametric
    # the filters dropped the faint rows and kept most edge rows; edges
    # were found
    assert 500 < len(t.positions) < 690
    assert len(t.clusters) >= 3
    assert t.parametric["lines_end_pts"] and len(t.sampled_points) > 100
    for name in ("parametric_edges.json", "gaussians_filtered.ply",
                 "pts_with_major_dirs.ply",
                 "edge_sampled_points_0.005.ply"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_metrics_match_jax(scan):
    _, out_dir, gt_dir = scan
    gt = ply.read_point_cloud(str(gt_dir / "sampled_pts" /
                                  f"{SCAN}_0.005.ply"))
    pred = ply.read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))[0]
    assert metrics.chamfer_distance(pred, gt) == \
        pytest.approx(jmetrics.chamfer_distance(pred, gt), rel=1e-12)
    pr_t, pr_j = metrics.empty_metrics(), jmetrics.empty_metrics()
    metrics.compute_precision_recall_IOU(pred, gt, pr_t)
    jmetrics.compute_precision_recall_IOU(pred, gt, pr_j)
    assert pr_t == pr_j and pr_t["fscore_0.01"][0] > 0.3
    np.testing.assert_allclose(
        metrics.downsample_point_cloud_average(pred, 16),
        jmetrics.downsample_point_cloud_average(pred, 16), rtol=1e-12)


def test_cli_fit_edges_and_evaluate_match_jax(scan, tmp_path, capsys):
    """Both packages' CLIs, same flags, on the same trained scan: the same
    ``parametric_edges.json`` and the same metric pickles."""
    cfg_path, out_dir, gt_dir = scan
    outputs = {}
    for tag, fit, ev in (("port", fit_edges, evaluate),
                         ("jax", jfit_edges, jevaluate)):
        assert fit.main(["--config_file", cfg_path, "--scene_name", SCAN,
                         "--seed", "5"]) == 0
        metrics_dir = tmp_path / tag
        assert ev.main(["--scan_names", SCAN, "--gt_base_dir", str(gt_dir),
                        "--output_base_dir", str(out_dir.parent),
                        "--use_parametric_edges", "--write_metrics",
                        "--write_metrics_dir", str(metrics_dir)]) == 0
        edges = (out_dir / "parametric_edges.json").read_bytes()
        os.remove(out_dir / "parametric_edges.json")
        pickles = {}
        for name in ("pr.pkl", "acc_comp_chamfer.pkl"):
            with open(metrics_dir / "release" / "DexiNed" / name, "rb") as f:
                pickles[name] = pickle.load(f)
        outputs[tag] = (edges, pickles, capsys.readouterr().out)
    assert outputs["port"][0] == outputs["jax"][0]
    assert outputs["port"][1] == outputs["jax"][1]
    assert outputs["port"][2] == outputs["jax"][2]
    per_scan = outputs["port"][1]["acc_comp_chamfer.pkl"][SCAN]
    assert per_scan["edgegaussians"]["chamfer_dist"] < 0.05
