"""A cell of ``BENCHMARK.json``, found by name.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, which this module finds by the name ``BENCHMARK.json``
gives it, so that a cell or a metric is added by adding files:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` names): the
  recipe as it is run (``recipe``), its scene (``scene``), and what was
  assumed (``assumed``);
- ``traffic/<traffic>.json``: the phase of the recipe a window holds;
- ``metrics/<metric>.py``: a reader, ``read(ctx) -> value or None``
  (a metric split by cells, ``<quantity>.<part>``, may share its
  quantity's reader, ``metrics/<quantity>.py``);
- ``limits/<workload>.json``: the limit of each number the correctness
  check compares, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: str
    traffic_name: str
    chips: int
    recipe: Dict
    scene: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json`` with its
    files."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfile = _json(os.path.join(ROOT, conf["file"]))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(
        name=name, config=w["config"], traffic_name=w["traffic"],
        chips=w["chips"], recipe=cfile["recipe"], scene=cfile["scene"],
        traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                   w["traffic"] + ".json")),
        limits=_json(os.path.join(BENCH_DIR, "limits",
                                  name + ".json"))["limits"],
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``; for a quantity
    split by the cells that report it (``<quantity>.<part>``, as
    ``step_mfu.early``), of ``metrics/<quantity>.py`` where the part has
    no file of its own."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(BENCH_DIR, "metrics",
                            metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
