"""Device time of the direction loss's gather backward in torch.profiler
Chrome traces of the port's training (``cli.train --profile_dir``, or
``chip_smoke.py --profile_dir``, whose phase 5 writes
``<dir>/orient/trace.json``).

    python3 scripts/torch_gather_trace.py TRACE.json [TRACE.json ...]

For each trace it prints one JSON line: for each autograd node of
``GATHER_BACKWARD_NODES`` entered on fired steps, the device ms of the
kernels launched inside it, the number of such calls and the ms by
kernel name. ``GatherRowsBackward`` is the gather's own backward
(``ops/rank_sum.gather_rows``). ``IndexBackward0`` is ATen's backward of
an advanced index: in a tree before ``gather_rows``, the gather
``means[nn_indices]``'s, and in every tree that of
``ops/transforms.major_directions``' ``cols[arange, amax]``, so a parent
tree's gather is its ``IndexBackward0`` less this tree's. A call counts
when the host enters the node after a kNN launch and before the next seg
forward launch, i.e. in a fired step's orientation branch; its kernels
are matched to their launches by correlation id. Needs no GPU.
"""

from __future__ import annotations

import argparse
import json

GATHER_BACKWARD_NODES = ("IndexBackward0", "GatherRowsBackward")


def gather_backward_ms(trace_path: str) -> dict:
    """{node name: {"ms", "calls", "by_kernel"}} of the nodes of
    GATHER_BACKWARD_NODES on fired steps in one trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel"}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e["name"]),
                      key=lambda e: e["ts"])

    def launched(e):
        k = kernels.get(e["args"].get("correlation"))
        return k["name"] if k else ""

    markers = [(e["ts"], "knn" in launched(e)) for e in launches
               if "knn_kernel" in launched(e)
               or "run_fwd_kernel" in launched(e)]
    prefix = "autograd::engine::evaluate_function: "
    out = {}
    for node in events:
        name = node["name"][len(prefix):]
        if node.get("cat") != "cpu_op" or not node["name"].startswith(
                prefix) or name not in GATHER_BACKWARD_NODES:
            continue
        before = [is_knn for ts, is_knn in markers if ts < node["ts"]]
        if not before or not before[-1]:
            continue
        got = out.setdefault(name, {"ms": 0.0, "calls": 0, "by_kernel": {}})
        got["calls"] += 1
        for e in launches:
            if e["tid"] == node["tid"] and \
                    node["ts"] <= e["ts"] <= node["ts"] + node["dur"]:
                k = kernels.get(e["args"].get("correlation"))
                if k:
                    got["by_kernel"][k["name"]] = (
                        got["by_kernel"].get(k["name"], 0.0) + k["dur"] / 1e3)
                    got["ms"] += k["dur"] / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("traces", nargs="+")
    args = ap.parse_args(argv)
    for path in args.traces:
        print(json.dumps({"trace": path, **gather_backward_ms(path)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
