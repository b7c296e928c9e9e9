"""The program's own spans and counters, as the per-layer readers take
them: ``minlz_tpu_torch.trace.snapshot()`` after a traced window.  A span
is on only while the window's ``torch.profiler`` records, so the snapshot
holds the window and nothing of set-up.  Every function returns None where
there is nothing to read: an untraced run, a cell of the other kind, a
checkout whose program has no tracer, or a span that was never entered."""

from __future__ import annotations


def snapshot():
    """The program's snapshot, or None where it has no tracer."""
    try:
        from minlz_tpu_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def _snap(rec, trace, kind):
    if trace is None or rec["kind"] != kind:
        return None
    return snapshot()


def device_ms(rec, trace, name):
    """Span ``name``'s card time a call, in ms, over the window: the time
    between its two CUDA events on the stream, at the stage's entry and
    exit, summed, over its count."""
    snap = _snap(rec, trace, "encode")
    st = snap and snap["spans"].get(name)
    if not st or st["device_s"] is None:
        return None
    return 1e3 * st["device_s"] / st["count"]


def self_ms(rec, trace, names, per):
    """The host self time (less the children's) of spans ``names`` summed,
    in ms, over the count of span ``per``."""
    snap = _snap(rec, trace, "encode")
    got = snap and [snap["spans"].get(n) for n in names + [per]]
    if not got or not all(got):
        return None
    return 1e3 * sum(st["self_s"] for st in got[:-1]) / got[-1]["count"]


def share_pct(rec, trace, part, whole):
    """100 * counter ``part`` / counter ``whole``."""
    snap = _snap(rec, trace, "encode")
    counters = snap["counters"] if snap else {}
    if not counters.get(whole) or part not in counters:
        return None
    return 100.0 * counters[part] / counters[whole]


def median_host_ms(rec, trace, name):
    """The median host time of one call of span ``name``, in ms."""
    snap = _snap(rec, trace, "decode")
    st = snap and snap["spans"].get(name)
    return 1e3 * st["host_median_s"] if st else None
