"""Shared plumbing of the port's harness scripts (``scripts/torch_*.py``).

The counterpart of ``scripts/_common.py``: the default scan and its
ground truth, the per-scene run directory of ``cli.train``, and
extraction + evaluation of a trained PLY, on the port's ``extract/`` and
``eval/`` (NumPy, the CPU). Beside them, what every harness needs on the
card:

- :func:`resolve_device`: ``cuda`` by default, refused without a GPU;
- :func:`measure`: one timing of a call, as CUDA events (``ms``), as the
  device's own time (``device_ms``: the calls queued behind a sleeping
  kernel by :func:`queued_ms`, so the host's launch cost does not pace
  them; a call of more launches than a stream holds pending, or one that
  waits for the device inside, is read from torch.profiler's kernel
  records instead, ``device_ms_by`` says which) and as launches
  (``launches``: the host's kernel launch records per call in a
  torch.profiler window, which the profiler does not lose in bursts as it
  loses device records; ``kernels``: the port's own kernel counters per
  call);
- :func:`profiled`: that window, which is read again where it returns
  fewer kernel records than host launch records;
- :func:`kernel_counts` and :func:`reset_kernel_counts`: the port's
  kernel counters, which ``chip_smoke.py`` reads too;
- :func:`trace_ops` and :func:`traced_ops`: the per-op table of a
  torch.profiler Chrome trace (each kernel's device time, its kernel
  records and the host launch records that started them), the port's
  counterpart of ``scripts/xplane_top_ops.py``; a window short of kernel
  records is read again, as :func:`profiled` reads one;
- :func:`train_cli`: the port's training CLI with its output captured;
- :func:`torchrun`: ``torch.distributed.run`` of a script on N ranks, as
  ``chip_smoke.py`` and the multi-rank scripts start them.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SCAN = "00004926"
GT_BASE = "data/ABC-NEF_Edge/groundtruth"
RECIPE = os.path.join(REPO_ROOT, "configs", "ABC_DexiNed.json")
FIXTURE = os.path.join(REPO_ROOT, "bench_fixture", "abc_00004926.npz")
# default output roots: under the checkout's git-ignored build/
OUT_ROOT = os.path.join(REPO_ROOT, "build", "harness")

BLOCKS = 3                      # timing blocks; the median is reported
PROFILED_CALLS = 3              # calls in the launch-counting window
# windows read before a short one raises: CUPTI drops device records in
# bursts, up to every record of two windows running on the H100 machine
PROFILED_WINDOWS = 8
QUEUED_BLOCKS = 5               # blocks of queued calls; the median
QUEUE_SLEEP_CYCLES = 40_000_000  # the least sleep calls are queued behind
# launches queued behind the sleeping kernel at most: a stream holds about
# a thousand pending launches, past which the host blocks until the
# device drains them
QUEUED_LAUNCHES = 512
RANKS_TIMEOUT = 300             # seconds a torchrun of ranks may take
# the counter of each kernel wrapper -> the CUDA kernel's symbol in a
# trace (the seg and v4 pair forwards launch one template, run_fwd_kernel)
KERNEL_SYMBOLS = {
    "segpair_fwd": "run_fwd_kernel", "segpair_bwd": "segpair_bwd_kernel",
    "pair_fwd": "run_fwd_kernel", "pair_bwd": "pair_bwd_kernel",
    "raster_v2_fwd": "raster_v2_fwd_kernel",
    "raster_v2_bwd": "raster_v2_bwd_kernel",
    "raster_v1_fwd": "raster_v1_fwd_kernel",
    "raster_v1_bwd": "raster_v1_bwd_kernel",
    "knn": "knn_kernel", "rank_sum": "rank_sum_kernel",
    "rank_sum_gather": "rank_sum_kernel", "shard_sum": "shard_sum2x_kernel"}
# the loss each epoch of the trainer's log reports
EPOCH_LOSS = re.compile(r"^epoch \d+: loss=(\S+)", re.M)


def scene_run_dir(cfg, out_root: str, scan: str = SCAN) -> str:
    """The per-scene output directory cli/train.py writes to."""
    exp = f"{cfg.output.exp_name}_{cfg.data.edge_detection_method}"
    return os.path.join(out_root, "ABC", exp, scan)


def extract_and_eval(ply: str, cfg, out_dir: str, scan: str = SCAN,
                     gt_base: str = GT_BASE, extraction_seeds: int = 3,
                     scene=None):
    """Run extraction + eval ``extraction_seeds`` times on one trained PLY.

    Returns a dict of per-seed metric lists: chamfer, f5, f10, f20.
    ``out_dir`` must be the directory holding/receiving the scan's outputs
    (i.e. .../<scan>); evaluate_scan is pointed at its parent.
    """
    from edgegaussians_tpu_torch.cli.evaluate import evaluate_scan
    from edgegaussians_tpu_torch.data import parsers
    from edgegaussians_tpu_torch.eval import metrics as metrics_mod
    from edgegaussians_tpu_torch.extract.pipeline import extract_edges

    if scene is None and cfg.filtering.filter_by_projection:
        scene = parsers.load_scene(cfg.data, scan)

    os.makedirs(out_dir, exist_ok=True)
    out = {"chamfer": [], "f5": [], "f10": [], "f20": []}
    for es in range(extraction_seeds):
        extract_edges(ply, cfg, scene=scene, output_dir=out_dir,
                      save_sampled_points=True, sample_resolution=0.005,
                      seed=es)
        pr = metrics_mod.empty_metrics()
        res = evaluate_scan(scan, gt_base, os.path.dirname(out_dir), pr,
                            use_parametric_edges=True,
                            sample_resolution=0.005)
        if res is None:
            continue
        out["chamfer"].append(res["chamfer_dist"])
        for name, t in (("f5", "0.005"), ("f10", "0.01"), ("f20", "0.02")):
            out[name].append(metrics_mod.f_score(
                np.mean(pr[f"precision_{t}"]), np.mean(pr[f"recall_{t}"])))
    return out


def epoch_losses(log: str) -> list:
    """The epoch losses of a training log, in order."""
    return [float(v) for v in EPOCH_LOSS.findall(log)]


def mean_rounded(values, digits: Optional[int] = None):
    """The mean of ``values`` (rounded to ``digits`` when given), or None
    where there are none (an extraction that found no edges)."""
    if not values:
        return None
    mean = float(np.mean(values))
    return mean if digits is None else round(mean, digits)


def resolve_device(name: str = "cuda") -> torch.device:
    """``cuda`` (the default of every harness) or ``cpu``; ``cuda`` raises
    where torch sees no GPU."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but torch sees no "
                           "GPU; pass --device cpu (or --backend torch) to "
                           "run on the CPU")
    return torch.device(name)


def backend_of(device: torch.device) -> str:
    """The training CLI's ``--backend`` for ``device``."""
    return "cuda" if device.type == "cuda" else "torch"


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    CPU's name where there is no card."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def kernel_modules():
    """The port's kernel modules, each with its ``launch_counts``."""
    from edgegaussians_tpu_torch.ops import (
        knn, pair, rank_sum, raster_v1, raster_v2, segpair, shard_sum)
    return (segpair, raster_v2, knn, pair, raster_v1, rank_sum, shard_sum)


def kernel_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches since the counts were last reset."""
    return {k: v for mod in kernel_modules()
            for k, v in mod.launch_counts.items()}


def reset_kernel_counts() -> None:
    for mod in kernel_modules():
        mod.reset_launch_counts()


def _median_ms(fn: Callable, reps: int, blocks: int, cuda: bool):
    """(median ms per call over ``blocks`` blocks of ``reps`` calls, the
    most host ms a block took to enqueue its calls, the last call's
    output)."""
    times, host = [], []
    for _ in range(blocks):
        if cuda:
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / reps)
        else:
            times.append(host[-1] / reps)
    return float(np.median(times)), max(host), out


@functools.lru_cache(maxsize=None)
def _cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, read
    once."""
    cycles = 20_000_000
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(stop)


def queued_ms(fn: Callable, reps: int,
              host_ms: Optional[float] = None) -> float:
    """Device ms per call of ``fn``: after a warm call, ``reps`` calls
    queued behind a kernel that sleeps QUEUE_SLEEP_CYCLES, or twice the
    ``host_ms`` the host is expected to take to enqueue them where that is
    longer, so that they run back to back whatever the host's launch cost
    (median of QUEUED_BLOCKS blocks). Raises where the host took longer to
    queue them than the sleep lasted: a call that waits for the device
    inside cannot be queued."""
    fn()
    torch.cuda.synchronize()
    cycles = QUEUE_SLEEP_CYCLES
    if host_ms is not None:
        cycles = max(cycles, int(_cycles_per_ms() * (2.0 * host_ms + 5.0)))
    times = []
    for _ in range(QUEUED_BLOCKS):
        slept, start, stop = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueued = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        if enqueued >= slept.elapsed_time(start):
            raise RuntimeError(f"queued_ms: queuing took {enqueued:.3f} ms, "
                               "longer than the sleep")
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def is_kernel_record(e) -> bool:
    """A device record of a kernel (not of a copy or a fill)."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))


def is_launch_record(e) -> bool:
    """A host record of a kernel launch."""
    from torch.autograd import DeviceType
    return e.device_type != DeviceType.CUDA and "LaunchKernel" in e.name


def window_counts(events):
    """(host kernel launch records, device us of the kernel records or
    None where the window returned fewer kernel records than launches) of
    one profiler window's events."""
    launches = sum(map(is_launch_record, events))
    records = [e for e in events if is_kernel_record(e)]
    if len(records) < launches:
        return launches, None
    return launches, sum(e.time_range.elapsed_us() for e in records)


def profiled(fn: Callable, calls: int = PROFILED_CALLS,
             device_records: bool = True):
    """(host kernel launch records per call, device ms per call as the sum
    of the kernels' durations, the port's kernel launches per call by
    name) over one torch.profiler window of ``calls`` calls. The profiler
    loses device records now and then: a window that returns fewer kernel
    records than host launch records is read again, up to
    PROFILED_WINDOWS times, and then raises rather than report a short
    sum. With ``device_records`` False (a process whose earlier profiler
    windows make it lose them all) one window is read for its host
    records alone, and the device ms is None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILED_WINDOWS):
        reset_kernel_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = {k: v / calls for k, v in kernel_counts().items() if v}
        launches, dev_us = window_counts(prof.events())
        if not device_records:
            return launches / calls, None, kernels
        if dev_us is not None:
            return launches / calls, dev_us / calls / 1e3, kernels
    raise RuntimeError(f"profiled: fewer kernel records than the {launches} "
                       f"host launch records in each of {PROFILED_WINDOWS} "
                       "windows")


def trace_ops(trace) -> Optional[Dict[str, dict]]:
    """The ops of a torch.profiler Chrome trace (a path, or its loaded
    JSON): each device kernel's name -> ``us`` (the sum of its kernel
    records' durations), ``kernels`` (its kernel records) and
    ``launches`` (the host launch records whose correlation id is one of
    its kernel records'). None where the trace holds fewer kernel records
    than host launch records: the profiler lost some, and the window must
    be read again. Copies and fills are not kernels."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels, launches = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            kernels.append(e)
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "LaunchKernel" in e.get("name", "")):
            launches.append(e)
    if len(kernels) < len(launches):
        return None
    ops, by_corr = {}, {}
    for e in kernels:
        row = ops.setdefault(e["name"], {"us": 0.0, "kernels": 0,
                                         "launches": 0})
        row["us"] += float(e.get("dur", 0.0))
        row["kernels"] += 1
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] = e["name"]
    for e in launches:
        name = by_corr.get(e.get("args", {}).get("correlation"))
        if name is not None:
            ops[name]["launches"] += 1
    return ops


def op_table(ops: Dict[str, dict], steps: int) -> dict:
    """The op table of :func:`trace_ops`'s ``ops`` over ``steps`` steps:
    ``rows`` by device time, most first (``ms_per_step``, ``pct`` of the
    total, ``count`` of kernel records, ``launches``, ``op``) and
    ``total_device_ms`` a step."""
    total = sum(r["us"] for r in ops.values())
    rows = [{"ms_per_step": r["us"] / 1e3 / steps,
             "pct": 100.0 * r["us"] / max(total, 1e-12),
             "count": r["kernels"], "launches": r["launches"], "op": name}
            for name, r in sorted(ops.items(), key=lambda kv: -kv[1]["us"])]
    return {"rows": rows, "total_device_ms": total / 1e3 / steps}


def print_ops(rows: Sequence[dict]) -> None:
    """An op table's rows as the JAX scripts print theirs."""
    print(f"{'ms/step':>9} {'%':>5} {'count':>7} {'launch':>7}  op")
    for r in rows:
        print(f"{r['ms_per_step']:9.3f} {r['pct']:5.1f} {r['count']:7d} "
              f"{r['launches']:7d}  {r['op'][:90]}")


def op_count(rows: Sequence[dict], kernel: str) -> int:
    """Kernel records of the port kernel counted as ``kernel`` (a key of
    :data:`KERNEL_SYMBOLS`) in an op table's rows."""
    return sum(r["count"] for r in rows
               if KERNEL_SYMBOLS[kernel] in r["op"])


def traced_ops(fn: Callable, steps: int, out_dir: str,
               device: torch.device):
    """``steps`` calls of ``fn`` in one torch.profiler window, its Chrome
    trace written to ``<out_dir>/trace.json`` and read by
    :func:`trace_ops`: (the ops, wall seconds a step of the window, the
    port's kernel launches over it). A window short of kernel records is
    read again, up to PROFILED_WINDOWS times, then raises."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    for _ in range(PROFILED_WINDOWS):
        reset_kernel_counts()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            if cuda:
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        counts = kernel_counts()
        prof.export_chrome_trace(path)
        ops = trace_ops(path)
        if ops is not None:
            return ops, wall, counts
    raise RuntimeError(f"traced_ops: {path} held fewer kernel records than "
                       f"host launch records in each of {PROFILED_WINDOWS} "
                       "windows")


def measure(fn: Callable, device: torch.device, reps: int = 10):
    """One timing of ``fn``: (the timing, the last call's output). The
    timing holds ``ms`` (CUDA events after a warm call, median of BLOCKS
    blocks of ``reps`` calls; on the CPU, where the plain versions are
    checked and not timed, the host clock over one block),
    ``launches`` (host launch records per call), ``kernels`` (the port's
    kernel launches per call), ``profiler_device_ms`` (the profiler's
    sum of the call's kernel durations, which leaves out the gaps between
    kernels) and ``device_ms``: calls queued behind a sleeping kernel, as
    many as keep QUEUED_LAUNCHES launches pending, which counts the gaps;
    where one call launches more, or waits for the device inside, the
    profiler's sum, and ``device_ms_by`` says which. On the CPU only
    ``ms`` is a number."""
    cuda = device.type == "cuda"
    if cuda:
        fn()
        torch.cuda.synchronize()
    ms, host_ms, out = _median_ms(fn, reps, BLOCKS if cuda else 1, cuda)
    if not cuda:
        return {"ms": ms, "device_ms": None, "launches": None,
                "kernels": {}}, out
    launches, prof_ms, kernels = profiled(fn)
    queued = min(reps, int(QUEUED_LAUNCHES // max(launches, 1)))
    dev = None
    if queued:
        try:
            dev = queued_ms(fn, queued, host_ms * queued / reps)
        except RuntimeError:        # the call waits for the device inside
            pass
    return {"ms": ms, "device_ms": prof_ms if dev is None else dev,
            "device_ms_by": "profiler" if dev is None else "queued",
            "profiler_device_ms": prof_ms, "launches": launches,
            "kernels": kernels}, out


class Tee(io.TextIOBase):
    """Writes to every stream given."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def train_cli(cfg_path: str, scan: str, device: torch.device,
              echo: bool = True):
    """Train through the port's ``cli.train`` with every kernel count set
    to 0 just before: (its captured output, the kernel launches read just
    after, wall seconds)."""
    from edgegaussians_tpu_torch.cli import train as train_cli_mod
    buf = io.StringIO()
    reset_kernel_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf) if echo else buf):
        rc = train_cli_mod.main(["--config_file", cfg_path, "--scene_name",
                                 scan, "--force_rerun", "--backend",
                                 backend_of(device)])
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"cli.train returned {rc}")
    return buf.getvalue(), kernel_counts(), wall


def torchrun(nproc: int, tag: str, args, timeout: int = RANKS_TIMEOUT) -> str:
    """``torch.distributed.run --standalone`` of ``args`` (a script and
    its arguments, or ``-m`` and a module) on ``nproc`` ranks from the
    checkout's root; returns its output, raises unless it exits 0 within
    ``timeout`` seconds. Every process it starts is stopped on return."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: torch.distributed.run exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    return text


def derive_config(base_config: str, out_root: str, name: str,
                  data_dir: Optional[str] = None, mutate=None) -> str:
    """The config ``base_config`` with its outputs under ``out_root`` (as
    the JAX scripts place them), its scans read from ``data_dir`` when
    given, and ``mutate(raw)`` applied; written to
    ``<out_root>/<name>.json``, whose path is returned."""
    with open(base_config) as f:
        raw = json.load(f)
    if data_dir:
        raw["data"]["base_dir"] = os.path.join(data_dir, "")
    raw["output"]["output_dir"] = os.path.join(out_root, "ABC") + "/"
    raw["output"]["log_dir"] = os.path.join(out_root, "logs") + "/"
    if mutate is not None:
        mutate(raw)
    os.makedirs(out_root, exist_ok=True)
    path = os.path.join(out_root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path


def add_scan_args(ap, gt_base: bool = True) -> None:
    """The flags of the training harnesses that name the scan: the
    config, where its scans live, the scan and, for those that score it,
    its ground truth; and the device."""
    ap.add_argument("--config", default=RECIPE)
    ap.add_argument("--data_dir", default=None,
                    help="the scans' directory (default: the config's "
                         "data.base_dir)")
    ap.add_argument("--scene_name", default=SCAN)
    if gt_base:
        ap.add_argument("--gt_base", default=GT_BASE)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (an error without one); cpu: the "
                         "plain versions")
