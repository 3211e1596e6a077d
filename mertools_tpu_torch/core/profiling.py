"""Tracing / throughput observability (port of ``mertools_tpu/core/profiling.py``).

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in Perfetto or chrome://tracing)
  into a directory (set ``MERTPU_TRACE_DIR`` to enable it globally).
  CUDA activity is recorded when the host has a card.
- :class:`Throughput` — per-stage clips/sec + audio-sec/sec counters,
  printed by the extraction CLIs.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed block when a trace dir is configured."""
    logdir = logdir or os.environ.get("MERTPU_TRACE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[trace] wrote {path}")


class Throughput:
    """Streaming rate counter: items/sec (+ optional payload units/sec)."""

    def __init__(self, name: str = "stage", unit: str = "clips"):
        self.name = name
        self.unit = unit
        self.t0 = time.perf_counter()
        self.items = 0
        self.payload = 0.0
        self._last_print = self.t0

    def add(self, n_items: int, payload: float = 0.0):
        self.items += n_items
        self.payload += payload

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def rate(self) -> float:
        return self.items / max(self.elapsed, 1e-9)

    def report(self, every: float = 0.0) -> str | None:
        now = time.perf_counter()
        if every and now - self._last_print < every:
            return None
        self._last_print = now
        msg = f"[{self.name}] {self.items} {self.unit}, {self.rate():.2f} {self.unit}/sec"
        if self.payload:
            msg += f", {self.payload / max(self.elapsed, 1e-9):.1f} units/sec"
        return msg
