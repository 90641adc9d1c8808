"""What a torch.profiler window of the measured loop shows.

The re-read rule is the program's harnesses' (``scripts/torch_common.py``
``window_counts`` / ``profiled``, copied here so that the yardstick stays
with the benchmark): CUPTI drops device records now and then, so a window
that holds fewer kernel records than host kernel-launch records is read
again, up to ``WINDOWS`` times, and then raises rather than report a short
sum. The events are read from the profiler's kineto results in memory; no
trace file is written.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

WINDOWS = 8
TOP = 10


class Window(NamedTuple):
    window_s: float                  # host seconds of the traced loop
    busy_s: float                    # union of device activity intervals
    launches: int                    # host kernel-launch records
    kernel_s: Dict[str, float]       # device seconds by kernel name
    kernel_n: Dict[str, int]         # kernel records by name
    gaps: List[Tuple[str, float]]    # idle seconds by the host op whose
                                     # launch ended the gap, most first


def _cuda(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type() == DeviceType.CUDA


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _is_launch(e) -> bool:
    return not _cuda(e) and "LaunchKernel" in e.name()


def _is_kernel(e) -> bool:
    return not e.name().startswith(("Memcpy", "Memset"))


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call's record (cudaLaunchKernel,
    cuLaunchKernel, ...), not an op's."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _host_op_of(launches, ops) -> Dict[int, str]:
    """Correlation id -> the innermost host op (same thread) whose span
    holds the launch record."""
    by_thread = defaultdict(list)
    for e in ops:
        by_thread[e.start_thread_id()].append((e.start_ns(), 0, e))
    for e in launches:
        by_thread[e.start_thread_id()].append((e.start_ns(), 1, e))
    names = {}
    for items in by_thread.values():
        items.sort(key=lambda t: (t[0], t[1]))
        stack = []                   # the ops open at this point, nested
        for start, is_launch, e in items:
            while stack and _end(stack[-1]) < start:
                stack.pop()
            if is_launch:
                names[e.correlation_id()] = (stack[-1].name() if stack
                                             else "(no host op)")
            else:
                stack.append(e)
    return names


def read(events, window_s: float) -> Window:
    """A :class:`Window` of one profiler window's kineto events, or None
    where it holds fewer kernel records than launch records."""
    launches, kernels, device, ops = [], [], [], []
    for e in events:
        if _cuda(e):
            device.append(e)
            if _is_kernel(e):
                kernels.append(e)
        elif _is_launch(e):
            launches.append(e)
        elif not _is_runtime(e.name()):
            ops.append(e)
    if len(kernels) < len(launches) or not kernels:
        return None
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    for e in kernels:
        kernel_s[e.name()] += e.duration_ns() * 1e-9
        kernel_n[e.name()] += 1
    device.sort(key=lambda e: e.start_ns())
    busy, gaps = 0, defaultdict(float)
    op_of = _host_op_of(launches, ops)
    cur_s, cur_e = device[0].start_ns(), _end(device[0])
    for e in device[1:]:
        if e.start_ns() > cur_e:
            busy += cur_e - cur_s
            gaps[op_of.get(e.correlation_id(), "(no host op)")] += \
                (e.start_ns() - cur_e) * 1e-9
            cur_s = e.start_ns()
        cur_e = max(cur_e, _end(e))
    busy += cur_e - cur_s
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return Window(window_s=window_s, busy_s=busy * 1e-9,
                  launches=len(launches), kernel_s=dict(kernel_s),
                  kernel_n=dict(kernel_n), gaps=top)


def traced(loop: Callable[[], float]) -> Window:
    """Run ``loop`` (which returns its host seconds) under torch.profiler
    until a window holds all its kernel records."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window_s = loop()
        events = prof.profiler.kineto_results.events()
        win = read(events, window_s)
        if win is not None:
            return win
    kinds = defaultdict(int)
    for e in events:
        kinds[("device " if _cuda(e) else "host ") + e.name()[:24]] += 1
    raise RuntimeError(f"fewer kernel records than host launch records in "
                       f"each of {WINDOWS} profiler windows (the last: "
                       f"{dict(kinds)})")


def kernel_seconds(win: Window, symbols) -> Tuple[float, int]:
    """(device seconds, records) of the kernels whose names hold any of
    ``symbols``."""
    s = sum(v for k, v in win.kernel_s.items()
            if any(sym in k for sym in symbols))
    n = sum(v for k, v in win.kernel_n.items()
            if any(sym in k for sym in symbols))
    return s, n
