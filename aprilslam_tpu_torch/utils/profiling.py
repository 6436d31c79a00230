"""Observability of the port: named spans inside the step, their recorder,
and the Chrome-trace exporter (``aprilslam_tpu/utils/profiling.py``'s
``StageTimer`` and ``trace``).

* :func:`span` marks a stage of the step (``slam.*``, the detector's
  ``stage_*``). Inside a ``torch.profiler`` session it opens a
  ``record_function`` range, a ``user_annotation`` event on the profiler's
  own clock beside the kernels and copies it launched; while a
  :class:`SpanRecorder` is active it records the span. Otherwise it costs
  two checks and dispatches nothing.
* :class:`SpanRecorder` keeps every span in memory (name, parent, request
  id, host start and end) and sums them per name; with ``syncs=True`` it
  also counts the host synchronisations made inside each span.
* :func:`trace` writes a Chrome trace of a region.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
import warnings

import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_active: SpanRecorder | None = None


def span(name: str):
    """Context manager marking a stage called ``name`` (see the module)."""
    rec = _active
    if rec is not None and rec.thread != threading.get_ident():
        rec = None
    prof = _profiler_enabled()
    if rec is None and not prof:
        return _NULL
    return _Span(name, rec, prof)


class _Span:
    __slots__ = ("name", "rec", "range", "index")

    def __init__(self, name: str, rec: SpanRecorder | None, prof: bool):
        self.name = name
        self.rec = rec
        self.range = record_function(name) if prof else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.rec is not None:
            self.index = self.rec._open(self.name)

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._close(self.index)
        if self.range is not None:
            self.range.__exit__(*exc)


class SpanRecorder:
    """Records the spans opened on this thread while it is active; one
    recorder at a time. Each record is ``[name, parent index or None,
    request id, start ns, end ns, syncs]``; the request id is the index of
    the outermost span, so the spans of one ``SlamSystem.process`` call
    share it. Times are ``time.perf_counter_ns``.

    With ``syncs=True`` torch's sync debug mode warns at each host
    synchronisation, and each warning counts against the innermost open
    span (``None`` outside every span). The warnings machinery costs host
    time, so the host times of such a recorder are not to be read."""

    def __init__(self, syncs: bool = False):
        self.syncs = syncs
        self.records: list[list] = []
        self.syncs_outside = 0
        self._stack: list[int] = []
        self.thread: int | None = None

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a SpanRecorder is already active")
        self.thread = threading.get_ident()
        if self.syncs:
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=".*synchroniz")
            self._show = warnings.showwarning
            warnings.showwarning = self._warned
            self._mode = None
            if torch.cuda.is_available():
                self._mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None
        if self.syncs:
            if self._mode is not None:
                torch.cuda.set_sync_debug_mode(self._mode)
            self._warnings.__exit__(*exc)

    def _open(self, name: str) -> int:
        i = len(self.records)
        parent = self._stack[-1] if self._stack else None
        request = i if parent is None else self.records[parent][2]
        self.records.append([name, parent, request, time.perf_counter_ns(), 0, 0])
        self._stack.append(i)
        return i

    def _close(self, i: int) -> None:
        self.records[i][4] = time.perf_counter_ns()
        self._stack.pop()

    def _warned(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            self._show(message, category, filename, lineno, file, line)
        elif self._stack:
            self.records[self._stack[-1]][5] += 1
        else:
            self.syncs_outside += 1

    def summary(self) -> dict:
        """Per span name: ``calls``, ``host_s`` (inclusive), ``self_s``
        (inclusive less its child spans), ``syncs`` (made while it was the
        innermost open span) and ``parent`` (the name of its first call's
        parent span, or ``None``). With ``syncs=True`` the key ``None``
        holds the syncs made outside every span."""
        child_ns = [0] * len(self.records)
        for name, parent, _req, t0, t1, _n in self.records:
            if parent is not None:
                child_ns[parent] += t1 - t0
        out: dict = {}
        for i, (name, parent, _req, t0, t1, n) in enumerate(self.records):
            s = out.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0, "syncs": 0,
                                      "parent": None if parent is None else self.records[parent][0]})
            s["calls"] += 1
            s["host_s"] += (t1 - t0) * 1e-9
            s["self_s"] += (t1 - t0 - child_ns[i]) * 1e-9
            s["syncs"] += n
        if self.syncs:
            out[None] = {"calls": 0, "host_s": 0.0, "self_s": 0.0, "syncs": self.syncs_outside, "parent": None}
        return out


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` trace around a region (host, and the CUDA device
    when there is one), written as ``trace.json`` under ``logdir`` (default:
    ``aprilslam_trace`` in the temporary directory); open it in Perfetto or
    chrome://tracing. The step's spans appear in it as ranges."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "aprilslam_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
