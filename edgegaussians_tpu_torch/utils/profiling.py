"""Profiling and throughput instrumentation.

Counterpart of ``edgegaussians_tpu/utils/profiling.py`` in PyTorch: a timer
that waits for the card, per-step throughput counters (px/s, renders/s,
tiles/s) and a torch.profiler trace context that writes a Chrome trace.

- :func:`device_timer` waits with ``torch.cuda.synchronize`` where the JAX
  version drained the dispatch queue: CUDA launches return before the card
  finishes, so a host clock without the wait times the enqueue;
- :func:`trace` records the host and, wherever torch sees a GPU, the
  card's activity, and writes ``trace.json`` into ``log_dir``
  (chrome://tracing, Perfetto); the trainer's ``profile_dir`` window uses
  the same :func:`start_profiler` and :func:`export_trace`;
- :class:`ThroughputMeter` has the JAX meter's fields and ``report()``
  keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def _sync(device) -> None:
    """Wait for ``device``'s queued work: a CUDA device's, or with ``None``
    the current card's where this process has initialised CUDA; nothing
    for the CPU."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(result: Dict[str, float], key: str,
                 device: Optional[torch.device] = None):
    """Adds the seconds of the block to ``result[key]``, the device's work
    included: after the block it waits for ``device`` (see :func:`_sync`)."""
    t0 = time.perf_counter()
    yield
    _sync(device)
    result[key] = result.get(key, 0.0) + (time.perf_counter() - t0)


def start_profiler(device: Optional[torch.device] = None):
    """A started torch.profiler over the host and, for a CUDA ``device``
    (``None``: wherever torch sees a GPU), the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def export_trace(prof, log_dir: str) -> str:
    """Writes a stopped profiler's Chrome trace to ``<log_dir>/trace.json``
    and returns its path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (:func:`start_profiler`: the card's
    activity too wherever torch sees a GPU); writes
    ``<log_dir>/trace.json``."""
    prof = start_profiler()
    try:
        yield prof
    finally:
        prof.stop()
    export_trace(prof, log_dir)


@dataclass
class ThroughputMeter:
    """Accumulates renders and pixels; reports px/s and renders/s."""
    pixels_per_render: int
    tiles_per_render: int = 0
    renders: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def tick(self, n_renders: int = 1):
        self.renders += n_renders

    def report(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "renders_per_s": self.renders / dt,
            "px_per_s": self.renders * self.pixels_per_render / dt,
            "tiles_per_s": self.renders * self.tiles_per_render / dt,
            "elapsed_s": dt,
        }

    def reset(self):
        self.renders = 0
        self._t0 = time.perf_counter()
