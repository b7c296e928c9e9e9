"""What a ``torch.profiler`` trace of the measured window says of the
device: busy time, the window's length, device time by operation, and the
idle gaps by what the host was doing.  The busy and idle arithmetic is
``minlz_tpu_torch.bench._share``'s, copied here so that the yardstick
stays fixed.

Host spans are the benchmark's own ``record_function`` ranges, all named
``mzbench.<what>``; ``mzbench.window`` spans the measured window.
"""

from __future__ import annotations

import contextlib
import re

import torch

PREFIX = "mzbench."
WINDOW = PREFIX + "window"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own (a no-op unless profiled)."""
    with torch.profiler.record_function(PREFIX + name):
        yield


def profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof):
    """(name, on_device, start us, end us) of every traced event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        on_device = (e.device_type() == DeviceType.CUDA and not annotation
                     and not name.startswith(PREFIX))
        if e.device_type() == DeviceType.CUDA and not on_device:
            continue  # the device's mirror of a host annotation
        out.append((name, on_device, start, end))
    return out


def _merge(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def clean(name: str) -> str:
    """A name as the result line carries it: at most 64 characters of
    letters, digits and ``_.:/-``."""
    return re.sub(r"[^A-Za-z0-9_.:/-]+", "_", name)[:64]


def reduce(prof, top: int = 10) -> dict:
    """``busy_s`` and ``window_s`` (the ``mzbench.window`` span), the
    device operations by summed seconds (``device_ops``, all of them in
    ``by_name``) and the idle gaps by host activity (``idle_gaps``), each
    list longest first and at most ``top`` long."""
    events = _events(prof)
    windows = [(a, b) for n, dev, a, b in events if n == WINDOW and not dev]
    if not windows:
        raise RuntimeError("the trace holds no mzbench.window span")
    lo, hi = windows[0]
    device = [(n, max(a, lo), min(b, hi)) for n, dev, a, b in events
              if dev and b > lo and a < hi]
    if not device:
        raise RuntimeError("the trace holds no device activity in the window")
    by_name = {}
    for n, a, b in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    merged = _merge([(a, b) for _, a, b in device])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((a, b, n) for n, dev, a, b in events
                  if not dev and n != WINDOW)
    idle = {}
    active, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        outer = next((h[2] for h in active if h[2].startswith(PREFIX)),
                     "host")
        inner = active[-1][2] if active else None
        label = outer if inner in (None, outer) else f"{outer}/{inner}"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6

    def longest(d):
        return [[clean(k), v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "by_name": by_name, "device_ops": longest(by_name),
            "idle_gaps": longest(idle)}
