"""minlz_tpu_torch.trace on the CPU: spans and counters cost one flag test
and record nothing with no profiler; under torch.profiler they record each
stage of the device_emit Writer, the serializer Writer, the Reader and
decode_planned, with their counts, parents, self times and one sequence
number a batch, inside their parents on the profiler's clock."""

import io
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minlz_tpu_torch import trace
from minlz_tpu_torch.ops import exec_chain
from minlz_tpu_torch.ops.device_codec import DeviceCodec
from minlz_tpu_torch.ops.emit import OUT_PAD
from minlz_tpu_torch.stream import Reader, Writer

BLOCK = 16 << 10

EMIT = {  # span -> parent, one of each a device_emit batch
    "writer.flush_batch": "writer.encode_buffer",
    "codec.pack_batch": "writer.flush_batch",
    "codec.copy_in": "writer.flush_batch",
    "emit.match": "writer.flush_batch",
    "emit.greedy": "writer.flush_batch",
    "emit.verify": "writer.flush_batch",
    "emit.segments": "writer.flush_batch",
    "codec.copy_back": "writer.flush_batch",
    "codec.frame_segments": "writer.flush_batch",
    "writer.frame": "writer.flush_batch",
}
SERIALIZER = {
    "writer.flush_batch": "writer.encode_buffer",
    "codec.encode_batch": "writer.flush_batch",
    "encode.match": "codec.encode_batch",
    "encode.serialize": "codec.encode_batch",
    "writer.frame": "writer.flush_batch",
}
READER = {
    "codec.prepare": "reader.batch",
    "decode.plan": "reader.batch",
    "decode.planned": "reader.batch",
    "decode.parse": "decode.planned",
    "decode.compact": "decode.planned",
    "decode.range_firsts": "decode.planned",
    "decode.execute": "decode.planned",
    "decode.trim": "reader.batch",
    "reader.check": "reader.batch",
}
PLANNED = ("decode.planned", "decode.parse", "decode.compact",
           "decode.range_firsts", "decode.execute")


@pytest.fixture(scope="module")
def blocks():
    """A batch of two blocks: text that compresses to a few tokens a
    segment (the plain parse walks one byte row at a time) and random
    bytes, which the Writer stores raw."""
    text = (b"minlz trace span on the card; " * BLOCK)[:BLOCK]
    noise = np.random.default_rng(8).integers(0, 256, BLOCK, np.uint8)
    return [text, noise.tobytes()]


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def enters(monkeypatch):
    """Every (name, args) that enters a record_function."""
    seen = []
    real = torch.ops.profiler._record_function_enter_new

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        spy)
    return seen


def write(blocks, device_emit=True):
    buf = io.BytesIO()
    w = Writer(buf, device="cpu", level=2, block_size=BLOCK,
               device_emit=device_emit)
    w._dev_batch_size = len(blocks)
    w.encode_buffer(b"".join(blocks))
    w.close()
    return buf.getvalue()


def planned_call(stream):
    """decode_planned on the plan of the stream's first hinted block."""
    from minlz_tpu_torch.oracle.decode import parse_header

    pos, body, hints = 0, None, None
    while pos < len(stream):
        ctype, n = stream[pos], int.from_bytes(stream[pos + 1:pos + 4],
                                               "little")
        chunk = stream[pos + 4:pos + 4 + n]
        if ctype == 0x88:
            hints = chunk
        elif hints is not None:
            body = chunk[4:]
            break
        pos += 4 + n
    _, want, at = parse_header(b"\x00" + body)
    seg, rng, segs = DeviceCodec("cpu")._prepare(body[at - 1:], hints, want)
    plan = exec_chain.plan_batch([segs], seg, rng)
    return exec_chain.decode_planned(plan, "cpu")


def check_tree(snap, table):
    for name, parent in table.items():
        st = snap["spans"][name]
        assert st["parent"] == parent, name
        assert st["self_s"] <= st["host_s"], name
        assert st["device_s"] is None  # no CUDA events on the CPU


def test_no_profiler_records_nothing(blocks, enters):
    stream = write(blocks)
    out = Reader(io.BytesIO(stream), device="cpu").readall()
    assert out == b"".join(blocks)
    planned_call(stream)
    trace.count("writer.blocks_stored_raw", 1)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.snapshot() == {"spans": {}, "counters": {}}
    assert enters == []


def test_off_span_is_one_shared_context():
    assert trace.span("a") is trace.span("b", torch.device("cpu"), True)
    with trace.span("a") as s:
        assert s is None


def test_device_emit_writer_stages(blocks, enters):
    with profile(activities=[ProfilerActivity.CPU]):
        stream = write(blocks)
    snap = trace.snapshot()
    check_tree(snap, EMIT)
    assert snap["spans"]["writer.encode_buffer"]["parent"] is None
    for name in EMIT:
        assert snap["spans"][name]["count"] == 1, name
    outer = snap["spans"]["writer.flush_batch"]
    assert outer["self_s"] < outer["host_s"]
    assert snap["counters"]["writer.blocks_stored_raw"] == 1
    # One sequence number for the batch, another for the submission.
    seqs = {}
    for name, args in enters:
        assert name.startswith(trace.PREFIX)
        seqs.setdefault(args, set()).add(name[len(trace.PREFIX):])
    assert sorted(map(sorted, seqs.values())) == [
        sorted(EMIT), ["writer.encode_buffer"]]
    assert Reader(io.BytesIO(stream), device=None).readall() == \
        b"".join(blocks)


def test_serializer_writer_stages(blocks):
    with profile(activities=[ProfilerActivity.CPU]):
        write(blocks, device_emit=False)
    snap = trace.snapshot()
    check_tree(snap, SERIALIZER)
    assert all(snap["spans"][n]["count"] == 1 for n in SERIALIZER)
    assert "codec.copy_back_bytes" not in snap["counters"]


def test_reader_and_decode_planned_stages(blocks, enters):
    stream = write(blocks)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = Reader(io.BytesIO(stream), device="cpu").readall()
    assert out == b"".join(blocks)
    snap = trace.snapshot()
    check_tree(snap, READER)
    assert snap["spans"]["reader.batch"]["parent"] is None
    for name in READER:
        assert snap["spans"][name]["count"] == 1, name
    assert len({args for _, args in enters}) == 1
    # On the profiler's clock each span lies inside its parent.
    spans = [(e.name()[len(trace.PREFIX):], e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    assert {n for n, _, _ in spans} == set(READER) | {"reader.batch"}
    for name, a, b in spans:
        parent = snap["spans"][name]["parent"]
        if parent is not None:
            assert any(p == parent and pa <= a and b <= pb
                       for p, pa, pb in spans), name

    trace.reset()
    enters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            planned_call(stream)
    snap = trace.snapshot()
    assert set(snap["spans"]) == set(PLANNED)
    assert snap["spans"]["decode.planned"]["parent"] is None
    assert all(snap["spans"][n]["count"] == 2 for n in PLANNED)
    st = snap["spans"]["decode.planned"]
    assert 0 < st["host_median_s"] <= st["host_s"]
    # One number a call, drawn by the outermost span.
    assert len({args for _, args in enters}) == 2


def test_byte_counters_against_the_batch_shape(blocks):
    codec = DeviceCodec("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        res = codec.encode_batch_emit(blocks)
    seg, arr, _ = codec._emit_batch(blocks)
    B, nseg = arr.shape[0], arr.shape[1] // seg
    counters = trace.snapshot()["counters"]
    assert counters["codec.copy_back_bytes"] == \
        B * nseg * (seg + OUT_PAD) + B * nseg * 4  # segments and lengths
    from minlz_tpu_torch.minlz import put_uvarint

    kept = sum(len(r[0]) - 1 - len(put_uvarint(len(b)))
               for r, b in zip(res, blocks) if r is not None)
    assert res[1] is None and kept > 0
    assert counters["codec.kept_bytes"] == kept
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_threads_lose_no_span_or_count():
    """Threads entering spans and adding to a counter at once, switching
    often: every span and every count is kept, and each thread's spans
    nest under its own outer span."""
    threads, rounds = 16, 200

    def work():
        for _ in range(rounds):
            with trace.span("outer"):
                with trace.span("inner"):
                    trace.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    snap = trace.snapshot()
    assert snap["counters"]["n"] == threads * rounds
    assert snap["spans"]["outer"]["count"] == threads * rounds
    assert snap["spans"]["inner"]["count"] == threads * rounds
    assert snap["spans"]["outer"]["parent"] is None
    assert snap["spans"]["inner"]["parent"] == "outer"
    assert snap["spans"]["outer"]["self_s"] <= snap["spans"]["outer"]["host_s"]


def test_emit_rows_counted_as_plain_on_the_cpu(blocks):
    """A device_emit batch on the CPU: every segment row goes through
    emit_segments_plain (emit.plain_rows), none through the kernel, which
    is never launched."""
    from minlz_tpu_torch import _build

    codec = DeviceCodec("cpu")
    before = _build.launch_counts()["emit"]
    with profile(activities=[ProfilerActivity.CPU]):
        codec.encode_batch_emit(blocks)
    seg, arr, _ = codec._emit_batch(blocks)
    counters = trace.snapshot()["counters"]
    assert counters["emit.plain_rows"] == arr.shape[0] * arr.shape[1] // seg
    assert "emit.kernel_rows" not in counters
    assert _build.launch_counts()["emit"] == before
