#!/usr/bin/env python3
"""Benchmark of ``edgegaussians_tpu_torch``: training throughput of one
cell of ``BENCHMARK.json`` on one H100.

    python3 port_bench/run.py --workload dtu.early --seed 7 --seconds 30 \\
        --trace 0

from the root of a checkout. A run builds the cell's recipe step and
state (set-up, ``setup_s``), trains one whole epoch at the traffic's fixed
recipe epoch (the correctness check watches its first view steps) and a
second one, then measures: ``--trace 0`` trains epoch after epoch at that
epoch for ``--seconds`` and stops at the first epoch end past them (the
host window), then traces ``TRACE_EPOCHS`` more epochs with torch.profiler
for the device's busy time of a view step (the end-to-end metrics);
``--trace 1`` traces ``TRACE_EPOCHS`` epochs (the per-layer metrics). Then, with the program's state
freed, the plain reference follows the watched steps from the same
initial state and the run is ``correct`` where every compared number is
within its limit (``limits/<workload>.json``).

The last line of standard output is the result as one JSON object; the
noise record (card, clocks, host, each epoch's seconds) comes before it.
The last lines of standard error are the compared numbers beside their
limits. Exits 2 without a result where torch sees too few CUDA devices,
and 3 where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every cache a run writes lives at a fixed path inside the checkout
CACHE = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "edgegaussians_tpu")
WARM_EPOCHS = 2      # the first holds the watched steps
TRACE_EPOCHS = 2
TOP = 10


def configure() -> None:
    """Python's bytecode and any kernel cache under ``CACHE``; the
    program's own nvcc builds go to its fixed ``build/torch_kernels``
    inside the checkout."""
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            control: bool = False, window: bool = True) -> dict:
    """One run of ``cell`` on ``device`` (the card, or the CPU in the
    benchmark's tests): every number of the result, the compared readings
    and the noise record. With ``control`` the readings hold the
    control's too; without ``window`` only the readings are taken."""
    import torch

    from port_bench.harness import check, noise, program, reference
    from port_bench.harness import trace as trace_mod

    cuda = device.type == "cuda"
    marks = {"imported": time.perf_counter() - T_START}
    run = program.build(cell, seed, device, ROOT, CACHE)
    sync(device)
    marks["built"] = time.perf_counter() - T_START
    V, H, W = run.images.shape
    ol = cell.recipe["training"]["loss"]["orientation_losses"]
    fires = (run.epoch > ol["start_dir_loss_at_epoch"]
             or run.epoch > ol["start_ratio_loss_at_epoch"])
    k = program.steps_to_check(run, fires)
    step0 = run.state.step
    spy = program.Spy(run, k)
    try:
        program.epoch(run, spy.proj_grad)
    finally:
        spy.close()
    marks["epoch_1"] = time.perf_counter() - T_START
    for _ in range(WARM_EPOCHS - 1):
        program.epoch(run)
    sync(device)
    setup_s = time.perf_counter() - T_START

    def params():
        return {g: getattr(run.state.model, g).detach().clone()
                for g in reference.GROUPS}

    start = params()
    first_step = [run.state.step]     # of the last (traced) window
    before = noise.record() if cuda else {}
    epoch_s, cpu_s, losses = [], [], []

    def loop(epochs=None) -> float:
        sync(device)
        first_step[0] = run.state.step
        t0 = time.perf_counter()
        while True:
            te, ce = time.perf_counter(), time.process_time()
            losses.append(program.epoch(run).avg_loss)
            epoch_s.append(time.perf_counter() - te)
            cpu_s.append(time.process_time() - ce)
            if (len(epoch_s) >= epochs if epochs
                    else time.perf_counter() - t0 >= seconds):
                return time.perf_counter() - t0

    def traced_epochs() -> float:
        """``TRACE_EPOCHS`` epochs, their host seconds: the device window
        of a ``--trace 0`` run, outside the host window's statistics."""
        sync(device)
        device_first[0] = run.state.step
        t0 = time.perf_counter()
        for _ in range(TRACE_EPOCHS):
            program.epoch(run)
        return time.perf_counter() - t0

    win = dwin = None
    device_first = [run.state.step]
    if not window:
        window_s = 0.0
    elif trace:
        win = trace_mod.traced(lambda: (epoch_s.clear(), cpu_s.clear(),
                                        losses.clear(),
                                        loop(TRACE_EPOCHS))[-1])
        window_s = win.window_s
    else:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        window_s = loop()
        ru2 = resource.getrusage(resource.RUSAGE_SELF)
        marks["switches"] = [ru2.ru_nvcsw - ru.ru_nvcsw,
                             ru2.ru_nivcsw - ru.ru_nivcsw]
    closed = time.perf_counter()
    after = noise.record() if cuda else {}
    end = params()
    steps = run.state.step - first_step[0]
    fired = sum(1 for s in range(first_step[0] + 1, run.state.step + 1)
                if fires and s % 5 == 0)
    if window and not trace and cuda:
        # the device's busy seconds of the same step, by the trace, once
        # the host window has closed
        dwin = trace_mod.traced(traced_epochs)
    device_steps = run.state.step - device_first[0] if dwin else 0
    traced_s = time.perf_counter() - closed
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    alive = run.state.model.alive.clone()
    side = {"losses": [float(x) for x in spy.losses],
            "after_1": spy.after_1, "after_k": spy.after_k, "knn": spy.knn}
    initial, alive0, capacity = run.initial, run.alive0, run.capacity
    images, edges, viewmats, Ks = run.images, run.edges, run.viewmats, run.Ks
    del run, spy
    if cuda:
        torch.cuda.empty_cache()

    # the work the window's steps needed, by the benchmark's own plain
    # projection and tiles, at the window's start and its end
    rs = reference.epoch_context(cell.recipe, 0)["render"]
    pairs, evals = [], []
    for v in range(V if window else 0):
        counts = [reference.count_work(p, alive, viewmats[v], Ks[v], W, H,
                                       rs) for p in (start, end)]
        pairs.append(sum(c[0] for c in counts) / 2)
        evals.append(sum(c[1] for c in counts) / 2)

    counted = time.perf_counter()
    drawn = check.inputs(cell.recipe, seed,
                         program.fixed_epoch(cell.recipe, cell.traffic),
                         step0, k, images)
    readings = check.run_check(side, initial, alive0, capacity, step0,
                               (images, edges, viewmats, Ks), drawn, fires,
                               control=control)
    live = int(alive.sum())
    # seconds of the work that follows the window: the counts, the check
    after_window = {"device_window_s": traced_s,
                    "count_s": counted - closed - traced_s,
                    "check_s": time.perf_counter() - counted}
    ctx = {
        "setup_s": setup_s, "window_s": window_s, "view_steps": steps,
        "pixels_per_step": W * H, "epochs": len(epoch_s),
        "pairs": pairs, "evals": evals,
        "tiles": -(-W // rs["tile_size"]) * -(-H // rs["tile_size"]),
        "capacity": capacity, "live": live, "fires": fired,
        "num_nn": ol["dir_loss_num_nn"], "budget": rs["pair_budget"],
        "trace": win, "device_window": dwin, "device_steps": device_steps,
    }
    return {"ctx": ctx, "readings": readings, "peak": peak,
            "noise": {"before": before, "after": after,
                      "epoch_s": epoch_s, "cpu_s": cpu_s, "losses": losses,
                      "after_window": after_window, "setup": marks}}


def result_line(cell, out: dict, trace: bool, device_name: str) -> dict:
    from port_bench.harness import cell as cell_mod
    from port_bench.harness import compare
    ctx = out["ctx"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell_mod.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = out["readings"]["program"]
    correct = compare.verdict(numbers, cell.limits)
    bad = sum(1 for x in out["noise"]["losses"] if not math.isfinite(x))
    line = {"correct": correct, "attempted": ctx["view_steps"],
            "failed": bad * ctx["view_steps"] // max(ctx["epochs"], 1),
            "metrics": metrics,
            "device": {"platform": "gpu", "kind": device_name, "count": 1,
                       "memory_peak_bytes": out["peak"]}}
    win = ctx["trace"]
    if trace:
        line["device"]["busy_s"] = win.busy_s
        line["device"]["window_s"] = win.window_s
        ops = sorted(win.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        line["breakdown"] = {"device_ops": [[n[:64], s] for n, s in ops],
                             "idle_gaps": [[n[:64], s] for n, s in win.gaps]}
    line["checks"] = {k: {"value": numbers.get(k), "limit": cell.limits[k]}
                      for k in cell.limits}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    configure()
    import torch

    from port_bench.harness import cell as cell_mod
    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(device))
    for when in ("setup", "before", "after", "after_window"):
        print(f"noise {when}: {json.dumps(out['noise'][when])}")
    for key in ("epoch_s", "cpu_s"):
        print(f"{key}: " + " ".join(f"{s:.4f}" for s in out["noise"][key]))
    ctx = out["ctx"]
    dwin = ctx["device_window"]
    # the host window's rate in every cell, also where no end-to-end
    # metric reports it
    print("work: " + json.dumps({k: ctx[k] for k in
                                 ("view_steps", "epochs", "window_s",
                                  "live", "capacity", "fires")}
                                | {"pairs": sum(ctx["pairs"]),
                                   "evals": sum(ctx["evals"]),
                                   "host_px_per_s": cell_mod.reader(
                                       "train_px_per_s")(ctx),
                                   "device_steps": ctx["device_steps"],
                                   "device_busy_s": dwin and dwin.busy_s,
                                   "device_window_s":
                                       dwin and dwin.window_s}))
    print(f"correct {str(line['correct']).lower()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
