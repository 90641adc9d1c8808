"""BENCHMARK.json against the benchmark's contract, discovery by name,
the work and bound arithmetic on hand-worked cases, the result line's
keys, the trace reader, and the whole-name check for JAX modules."""

import json
import math
import os
import re
import sys
import types

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(map(line_ok, b["command"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_ok(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    metric_names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
    assert len(json.dumps(b)) <= 64 * 1024


def test_discovery_by_name():
    from port_bench.harness import cell as cell_mod
    b = bench()
    for w in b["workloads"]:
        c = cell_mod.load(w["name"])
        assert c.config == w["config"] and c.recipe["model"]
        assert c.limits and all(v > 0 for v in c.limits.values())
        for m in c.end_to_end + c.per_layer:
            assert callable(cell_mod.reader(m["name"]))
        assert {m["name"] for m in c.end_to_end} == \
            {m["name"] for m in b["end_to_end"]
             if w["name"] in m.get("workloads", [w["name"]])}
        # setup_s, another end-to-end metric, and a per-layer metric that
        # moves one the cell reports
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        assert all(m["moves"] in e2e for m in c.per_layer)
    assert {m["name"] for m in cell_mod.load("dtu.early").end_to_end} == \
        {"view_step_device_ms.early", "setup_s"}
    # a quantity split by cells shares its quantity's reader
    ctx = {"trace": None, "device_steps": 60,
           "device_window": types.SimpleNamespace(busy_s=0.15)}
    for part in ("early", "orient"):
        assert cell_mod.reader("view_step_device_ms." + part)(ctx) == \
            pytest.approx(2.5)
    with pytest.raises(FileNotFoundError):
        cell_mod.reader("no_such_metric.early")
    orient = cell_mod.load("dtu.orient")
    assert "knn_roofline" in {m["name"] for m in orient.per_layer}
    assert "knn_roofline" not in {m["name"] for m in
                                  cell_mod.load("dtu.early").per_layer}
    with pytest.raises(KeyError):
        cell_mod.load("no.such_cell")


def test_fixed_epochs():
    from port_bench.harness import cell as cell_mod, program
    got = {w: program.fixed_epoch(cell_mod.load(w).recipe,
                                  cell_mod.load(w).traffic)
           for w in ("dtu.early", "dtu.orient")}
    assert got == {"dtu.early": 20, "dtu.orient": 450}


def test_bounds_hand_worked():
    from port_bench.harness import peaks
    assert peaks.bound_s(3.35e12, 0, (0, 0)) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12 / 16, (16, 1)) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12 / 29, (29, 2)) == pytest.approx(
        2 * 16 / 29)           # the special-function units bound it
    # one view: 100 pairs, 2000 evaluations, 4 tiles
    common = 100 * 32 + 5 * 4 + 8 * 256 * 4 + 4 * 256 * 4
    assert peaks.seg_bound_s(100, 2000, 4) == pytest.approx(
        max(common / 3.35e12, 2000 * 16 / 67e12, 2000 / (67e12 / 16))
        + max((common + 3200) / 3.35e12, 2000 * 29 / 67e12,
              2000 * 2 / (67e12 / 16)))
    assert peaks.rank_sum_bytes(10, 7, 64) == 64 + 10 * 48 + 7 * 40
    assert peaks.gather_bytes(3, 5, 8) == 8 * 5 * 12 + 3 * 5 * 8 + 8 * 12
    assert peaks.knn_bytes(8, 6) == 8 * 12 + 8 + 8 * 6 * 12


def test_work_hand_worked():
    from port_bench.harness import work
    # 3 views, 6 view steps = 2 epochs, 2 fires over 4 live rows
    ctx = {"view_steps": 6, "evals": [10, 20, 30], "pairs": [1, 2, 3],
           "fires": 2, "live": 4, "tiles": 4, "capacity": 8, "num_nn": 5,
           "budget": 64}
    assert work.epochs(ctx) == 2
    assert work.flops(ctx) == 2 * 60 * 45 + 2 * 16 * 9
    from port_bench.harness import peaks
    assert work.knn_bound_s(ctx) == pytest.approx(
        2 * max(peaks.knn_bytes(8, 6) / 3.35e12, 16 * 9 / 67e12))
    assert work.seg_bound_s(ctx) == pytest.approx(
        2 * sum(peaks.seg_bound_s(p, e, 4) for p, e in
                zip([1, 2, 3], [10, 20, 30])))


class Ev:
    """A kineto event's methods the trace reader calls."""

    def __init__(self, kind, name, start, end, corr=0, tid=1):
        self.k, self.n, self.s, self.e, self.c, self.t = \
            kind, name, start, end, corr, tid

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.k in ("kernel", "gpu_memset") \
            else DeviceType.CPU

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def correlation_id(self):
        return self.c

    def start_thread_id(self):
        return self.t


def test_trace_reader():
    from port_bench.harness import trace
    ev = [Ev("cpu_op", "aten::mul", 0, 100),
          Ev("cuda_runtime", "cudaLaunchKernel", 10, 20, corr=1),
          Ev("cpu_op", "aten::add", 200, 300),
          Ev("cuda_runtime", "cudaLaunchKernel", 210, 220, corr=2),
          Ev("kernel", "void k1<float>", 50, 150, corr=1),
          Ev("gpu_memset", "Memset", 140, 160),
          Ev("kernel", "void rank_sum_sum_kernel", 400, 450, corr=2)]
    w = trace.read(ev, 1e-6)
    assert w.launches == 2 and w.busy_s == pytest.approx(160e-9)
    assert w.kernel_n == {"void k1<float>": 1, "void rank_sum_sum_kernel": 1}
    assert w.gaps == [("aten::add", pytest.approx(240e-9))]
    assert trace.kernel_seconds(w, ("rank_sum_sum_kernel",)) == \
        (pytest.approx(50e-9), 1)
    # a window short of kernel records is read again
    assert trace.read(ev[:4] + ev[5:6], 1e-6) is None


def test_packed_dtu_scan_is_the_tracked_one():
    """``scenes/dtu_s0.npz`` holds the tracked dtu_s0 scan as the
    program's EMAP parser reads it: the edge maps' bytes, the cameras and
    the SfM seed points."""
    import numpy as np
    from PIL import Image
    from edgegaussians_tpu_torch.data.parsers import EMAPParser
    from port_bench.harness import scenes
    scan = os.path.join(ROOT, "synthetic_data", "DTU_synth", "data",
                        "dtu_s0")
    with open(os.path.join(ROOT, "port_bench", "configs", "dtu.json")) as f:
        spec = json.load(f)["scene"]
    packed = scenes.load_scene(spec, ROOT, None)
    views = EMAPParser(os.path.join(scan, "meta_data.json")).load_views(
        os.path.join(scan, "edge_PidiNet"))
    with open(os.path.join(scan, "meta_data.json")) as f:
        frames = json.load(f)["frames"]
    with np.load(os.path.join(ROOT, spec["file"])) as z:
        for i, fr in enumerate(frames):
            im = Image.open(os.path.join(scan, "edge_PidiNet",
                                         fr["rgb_path"])).convert("L")
            assert np.array_equal(z["images"][i], np.asarray(im))
    np.testing.assert_allclose(packed.viewmats, views.viewmats, atol=1e-6)
    np.testing.assert_array_equal(packed.Ks, views.Ks)
    np.testing.assert_allclose(packed.images, views.images, atol=1e-7)
    np.testing.assert_array_equal(
        packed.points,
        np.loadtxt(os.path.join(scan, "sparse_sfm_points.txt")).reshape(-1,
                                                                        3))


@pytest.mark.parametrize("where", ["loss", "group"])
def test_a_late_nan_is_not_correct(where):
    """A NaN in a later step's loss or a later group's gap reads NaN and
    fails, wherever it falls in the order compared."""
    import torch
    from port_bench.harness import compare
    g = {k: torch.ones(8) * (i + 1) for i, k in enumerate(compare.GROUPS)}
    state = {**g, **{"m_" + k: v * 0.1 for k, v in g.items()},
             "absgrads": torch.ones(8), "alive": torch.ones(8, dtype=bool)}
    ref = {"losses": [0.5, 0.4, 0.3], "after_1": state, "after_k": state,
           "knn": None}
    side = {"losses": list(ref["losses"]), "after_1": dict(state),
            "after_k": dict(state), "knn": None}
    assert compare.readings(side, ref, g, False)["loss"] == 0.0
    if where == "loss":
        side["losses"][2] = float("nan")
    else:
        side["after_k"]["opacities"] = g["opacities"].clone()
        side["after_k"]["opacities"][3] = float("nan")
    got = compare.readings(side, ref, g, False)
    assert math.isnan(got["loss" if where == "loss" else "change"])
    limits = {k: 1.0 for k in got}
    assert not compare.verdict(got, limits)
    assert math.isnan(compare.worst([0.1, float("nan"), 0.2]))
    assert compare.worst([0.1, 0.3, 0.2]) == 0.3


def test_forbidden_modules_by_whole_name(monkeypatch):
    import run
    for name in ("edgegaussians_tpu_torch", "edgegaussians_tpu_torch.ops",
                 "jax_like", "port_bench"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    for name in ("edgegaussians_tpu.ops", "jaxlib", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["edgegaussians_tpu", "flax", "jax",
                                       "jaxlib"]


def test_result_line_keys():
    import run
    from port_bench.harness import cell as cell_mod, trace
    cell = cell_mod.load("dtu.orient")
    ctx = {"setup_s": 9.0, "window_s": 2.0, "view_steps": 60,
           "pixels_per_step": 1600 * 1200, "epochs": 2,
           "pairs": [1000.0] * 30, "evals": [50000.0] * 30, "tiles": 7500,
           "capacity": 131072, "live": 22482, "fires": 12, "num_nn": 5,
           "budget": 196608, "trace": None}
    nums = {k: 0.0 for k in cell.limits}
    out = {"ctx": ctx, "readings": {"program": nums}, "peak": 123,
           "noise": {"losses": [0.1, 0.1], "epoch_s": [1.0, 1.0]}}
    line = run.result_line(cell, out, False, "card")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 60
    win = trace.Window(
        window_s=2.0, busy_s=0.2, launches=66000,
        kernel_s={"run_fwd_kernel<1>": 0.01, "segpair_bwd_kernel": 0.02,
                  "rank_sum_sum_kernel": 0.001, "knn_kernel<6>": 0.09},
        kernel_n={"run_fwd_kernel<1>": 60, "segpair_bwd_kernel": 60,
                  "rank_sum_sum_kernel": 72, "knn_kernel<6>": 12},
        gaps=[("aten::mul", 1.0)])
    # the device window of a --trace 0 run: 80 traced view steps
    ctx.update(device_window=win._replace(busy_s=0.4), device_steps=80)
    line = run.result_line(cell, out, False, "card")
    assert set(line["metrics"]) == {"train_px_per_s", "train_mfu",
                                    "view_step_device_ms.orient",
                                    "setup_s"}
    assert line["metrics"]["train_px_per_s"]["value"] == pytest.approx(
        60 * 1600 * 1200 / 2.0 / 1e6)
    assert line["metrics"]["view_step_device_ms.orient"]["value"] == \
        pytest.approx(5.0)
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    early = run.result_line(cell_mod.load("dtu.early"), out, False, "card")
    assert set(early["metrics"]) == {"view_step_device_ms.early",
                                     "setup_s"}
    ctx["trace"] = win
    line = run.result_line(cell, out, True, "card")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["metrics"]["launches_per_view_step.orient"]["value"] == \
        1100
    assert line["metrics"]["device_idle_share"]["value"] == \
        pytest.approx(90.0)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert line["device"]["busy_s"] == 0.2
    nums["loss"] = 2 * cell.limits["loss"]
    assert run.result_line(cell, out, True, "card")["correct"] is False
