"""The readers of the program's own spans and counters, on hand-built
snapshots: each reads its number, and none where its spans or counters
are absent, the run is untraced, the cell is of the other kind, or the
program has no tracer."""

import sys

import pytest

from mzbench import harness

ENCODE = {"kind": "encode"}
DECODE = {"kind": "decode"}
TRACE = {"busy_s": 8.0, "window_s": 10.0}


def span(count, host_s=0.0, self_s=0.0, device_s=None, median=0.0):
    return {"count": count, "host_s": host_s, "self_s": self_s,
            "host_median_s": median, "device_s": device_s, "parent": None}


SNAP = {
    "spans": {
        "writer.encode_buffer": span(60, 3.0, 0.30),
        "writer.flush_batch": span(60, 2.7, 0.06),
        "codec.pack_batch": span(60, 0.6, 0.60),
        "emit.match": span(60, 0.9, 0.9, device_s=3.0),
        "emit.greedy": span(60, 0.1, 0.1, device_s=0.24),
        "emit.verify": span(60, 0.2, 0.2, device_s=0.6),
        "emit.segments": span(60, 0.5, 0.5, device_s=3.6),
        "codec.copy_back": span(60, 0.4, 0.4, device_s=0.42),
        "codec.frame_segments": span(60, 0.3, 0.30),
        "writer.frame": span(60, 0.5, 0.54),
        "decode.planned": span(7000, 3.0, 0.5, median=0.0004),
    },
    "counters": {"codec.copy_back_bytes": 1000, "codec.kept_bytes": 300,
                 "writer.blocks_stored_raw": 0},
}

EXPECTED = {  # reader -> (record, value in SNAP)
    "match_ms.compress": (ENCODE, 50.0),
    "greedy_ms.compress": (ENCODE, 4.0),
    "verify_ms.compress": (ENCODE, 10.0),
    "emit_ms.compress": (ENCODE, 60.0),
    "copyback_ms.compress": (ENCODE, 7.0),
    "host_ms.compress": (ENCODE, 1e3 * (0.30 + 0.60 + 0.30 + 0.54) / 60),
    "copyback_kept.compress": (ENCODE, 30.0),
    "host_ms.decode": (DECODE, 0.4),
}
NEEDS = {  # reader -> what it reads, by name
    "match_ms.compress": ["emit.match"],
    "greedy_ms.compress": ["emit.greedy"],
    "verify_ms.compress": ["emit.verify"],
    "emit_ms.compress": ["emit.segments"],
    "copyback_ms.compress": ["codec.copy_back"],
    "host_ms.compress": ["writer.encode_buffer", "codec.pack_batch",
                         "codec.frame_segments", "writer.frame",
                         "writer.flush_batch"],
    "copyback_kept.compress": ["codec.kept_bytes", "codec.copy_back_bytes"],
    "host_ms.decode": ["decode.planned"],
}


@pytest.fixture
def snapshot(monkeypatch):
    """Point the program's snapshot at a dict the test sets."""
    from minlz_tpu_torch import trace

    box = {"snap": SNAP}
    monkeypatch.setattr(trace, "snapshot", lambda: box["snap"])
    return box


def read(name, rec, tr=TRACE):
    return harness.load_metric(name).read(rec, tr)


def without(names):
    return {"spans": {k: v for k, v in SNAP["spans"].items()
                      if k not in names},
            "counters": {k: v for k, v in SNAP["counters"].items()
                         if k not in names}}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_spans(name, snapshot):
    rec, value = EXPECTED[name]
    assert read(name, rec) == pytest.approx(value)
    other = DECODE if rec is ENCODE else ENCODE
    assert read(name, other) is None
    assert read(name, rec, None) is None
    for missing in NEEDS[name]:
        snapshot["snap"] = without([missing])
        assert read(name, rec) is None, missing
    snapshot["snap"] = {"spans": {}, "counters": {}}
    assert read(name, rec) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_a_tracer_reads_nothing(name, monkeypatch):
    """A checkout whose program has no ``minlz_tpu_torch.trace``."""
    import minlz_tpu_torch

    monkeypatch.setitem(sys.modules, "minlz_tpu_torch.trace", None)
    monkeypatch.delattr(minlz_tpu_torch, "trace", raising=False)
    rec, _ = EXPECTED[name]
    assert read(name, rec) is None


def test_device_times_without_events_read_nothing(snapshot):
    snap = without([])
    snap["spans"]["emit.match"] = span(60, 0.9, 0.9, device_s=None)
    snapshot["snap"] = snap
    assert read("match_ms.compress", ENCODE) is None


def test_every_new_reader_is_in_the_benchmark():
    bench = harness.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, (rec, _) in EXPECTED.items():
        cells = per_layer[name]["workloads"]
        assert cells and all(c.endswith(".compress-emit") == (rec is ENCODE)
                             for c in cells)
