"""Profiling/observability helpers (port of ``aprilslam_tpu/utils/profiling.py``).

* :class:`StageTimer` — per-stage wall-clock accounting with device sync;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace;
* :class:`FpsCounter` — rolling frames/sec.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None):
        """Time the body; with ``sync`` set, wait for the CUDA device to
        finish the stage's work first (PyTorch returns before the card does)."""
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {t / max(c, 1) * 1e3:8.2f} ms/call  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` trace around a region (host, and the CUDA device
    when there is one), written as ``trace.json`` under ``logdir`` (default:
    ``aprilslam_trace`` in the temporary directory); open it in Perfetto or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "aprilslam_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class FpsCounter:
    def __init__(self, window: int = 30):
        self.window = window
        self._n = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0

    def tick(self, frames: int = 1) -> float | None:
        self._n += frames
        if self._n >= self.window:
            now = time.perf_counter()
            self.fps = self._n / (now - self._t0)
            self._n = 0
            self._t0 = now
            return self.fps
        return None
