"""Spans and counters at the stage boundaries of the encode and decode
paths, on the ``torch.profiler`` clock.

A span is on only while a torch profiler records (``mz --traceprof``, or
any ``torch.profiler.profile`` around the call).  Off, ``span`` tests the
profiler's flag and returns a shared do-nothing context: no torch op, no
clock, no allocation.  On, it enters ``record_function("minlz." + name)``,
so it lands in the same Kineto timeline as the CUDA kernels, and keeps in
memory, by name: the count, host seconds, host self seconds (less its
children's) and the parent's name as first seen.  The outermost span, and
a span opened with ``batch=True``, draws the next number of a process-wide
sequence; every span under it passes that number as ``record_function``'s
``args``, so that all spans of one batch or request share it.  A span
given a CUDA ``device`` also records two timing events on the current
stream, at entry and at exit; ``snapshot`` resolves them, waiting for
the last of each span's events.  Their difference is the stream's time
in the stage, any idle moment between its launches included.  Each span
also keeps up to ``SAMPLES`` host durations, for a median.

``count(name, n)`` adds to a counter, only while on.  ``snapshot()`` and
``reset()`` read and clear both; nothing is written to disk here.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "minlz."
# Per span name, at most this many host durations are kept for the median.
SAMPLES = 1 << 16


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()
_local = threading.local()
_seq = itertools.count(1)
_spans: dict = {}
_counters: dict = {}


class _Stat:
    __slots__ = ("count", "host_ns", "self_ns", "parent", "samples",
                 "device_s", "events")

    def __init__(self, parent):
        self.count = self.host_ns = self.self_ns = 0
        self.parent = parent
        self.samples = []
        self.device_s = None
        self.events = []


class _Span:
    __slots__ = ("name", "device", "batch", "seq", "parent", "child_ns",
                 "t0", "rf", "ev0")

    def __init__(self, name, device, batch):
        self.name, self.device, self.batch = name, device, batch

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.seq = (next(_seq) if self.parent is None or self.batch
                    else self.parent.seq)
        self.child_ns = 0
        self.rf = torch.profiler.record_function(PREFIX + self.name,
                                                 str(self.seq))
        self.rf.__enter__()
        self.ev0 = None
        if (self.device is not None
                and torch.device(self.device).type == "cuda"):
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        pair = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
            pair = (self.ev0, ev1)
        self.rf.__exit__(*exc)
        dt = time.perf_counter_ns() - self.t0
        if self.parent is not None:
            self.parent.child_ns += dt
        with _lock:
            st = _spans.get(self.name)
            if st is None:
                st = _spans[self.name] = _Stat(
                    self.parent.name if self.parent is not None else None)
            st.count += 1
            st.host_ns += dt
            st.self_ns += dt - self.child_ns
            if len(st.samples) < SAMPLES:
                st.samples.append(dt)
            if pair is not None:
                st.events.append(pair)
        return False


def span(name: str, device=None, batch: bool = False):
    """A context manager: the stage ``name`` (recorded as ``minlz.<name>``)
    while a torch profiler records, else nothing.  ``device``: a CUDA
    device whose current stream times the stage with two events.
    ``batch``: draw a new sequence number even under an enclosing span."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, batch)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a torch profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _median(vals):
    vals = sorted(vals)
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else (vals[mid - 1] + vals[mid]) / 2


def snapshot() -> dict:
    """``{"spans": {name: {count, host_s, self_s, host_median_s, device_s,
    parent}}, "counters": {name: n}}``.  ``host_median_s`` is the median
    of the first ``SAMPLES`` calls; ``device_s`` is None for a span that
    recorded no events.  It waits for the last event of each span that
    recorded events."""
    with _lock:
        spans = {}
        for name, st in _spans.items():
            if st.events:
                st.events[-1][1].synchronize()
                st.device_s = (st.device_s or 0.0) + sum(
                    a.elapsed_time(b) for a, b in st.events) / 1e3
                st.events = []
            spans[name] = {
                "count": st.count, "host_s": st.host_ns / 1e9,
                "self_s": st.self_ns / 1e9,
                "host_median_s": _median(st.samples) / 1e9,
                "device_s": st.device_s, "parent": st.parent}
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
