"""The whole-block decode road of the port (minlz_tpu_torch.ops.exec_block and
its routing in DeviceCodec) against the JAX package's v1 road
(minlz_tpu.ops.pallas_decode.decode_block_tpu, Pallas in interpret mode), the
host record walk of minlz_tpu_torch.ops.decode_kernel, and the stream layers
of both packages without the range clamp.  On the CPU every stage of the port
runs its plain torch version.  Tolerance 0: bytes and integers."""

import io

import numpy as np
import pytest
import torch

from minlz_tpu.ops import decode_kernel as jdk
from minlz_tpu.ops import device_codec as jdc
from minlz_tpu.ops import exec_chain as jec
from minlz_tpu.ops import pallas_decode as jpd
from minlz_tpu.stream import Reader as JaxReader
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch.minlz import CHUNK_TYPE_PARSE_HINT
from minlz_tpu_torch.ops import decode_kernel as tdk
from minlz_tpu_torch.ops import device_codec as tdc
from minlz_tpu_torch.ops import exec_block as teb
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops.parse import parse_segments
from minlz_tpu_torch.stream import Reader, Writer

from test_torch_common import encode_segs

SEG = 4096
RANGE = tdc.RANGE
COMP = (np.arange(4 * 512, dtype=np.uint32) % 251).astype(np.uint8)


def _case(kind: str, twain: bytes) -> bytes:
    rng = np.random.default_rng(sum(kind.encode()))
    n = int(rng.integers(20 << 10, 96 << 10))
    if kind == "text":
        s = int(rng.integers(0, len(twain) - 1000))
        return (twain[s : s + 1000] * 100)[:n]
    if kind == "runs":
        return b"".join(
            bytes([int(rng.integers(0, 5))]) * int(rng.integers(1, 300))
            for _ in range(n // 50))[:n]
    if kind == "low_entropy":
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    if kind == "periodic":
        return (bytes(range(7)) * (n // 7 + 1))[:n]
    if kind == "sorted_ints":
        a = rng.integers(0, 1 << 16, n // 4 + 1).astype(np.uint32)
        a.sort()
        return a.tobytes()[:n]
    assert kind == "mixed"
    unit = twain[:500] + rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    return (unit * (n // 1000 + 1))[:n]


@pytest.mark.parametrize("kind", ["text", "runs", "low_entropy", "periodic",
                                  "sorted_ints", "mixed"])
def test_whole_block_matches_jax(kind, twain):
    """Blocks of 20-96 KiB encoded without a range clamp: the port's bytes
    equal the JAX v1 road's and the input."""
    data = _case(kind, twain)
    segs = encode_segs(data, SEG, 0)
    want = jpd.decode_block_tpu(segs, len(data), SEG)
    got = teb.decode_block_whole(segs, len(data), SEG, "cpu")
    assert got == want == data
    assert tdk.decode_segments(segs, len(data), SEG) == data


def test_far_copy_reaches_an_earlier_range(twain):
    """A tail that repeats the head across a random middle: without the
    clamp a copy's source lies in an earlier 128 KiB range, which only the
    whole-block road can follow."""
    rng = np.random.default_rng(17)
    head = twain[: 12 << 10]
    data = head + rng.integers(0, 256, 150 << 10, dtype=np.uint8).tobytes() \
        + head
    assert len(data) > RANGE + len(head)
    segs = encode_segs(data, SEG, 0)

    plan = tec.plan_batch([segs], SEG, 0)
    t = plan.tensors("cpu")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, _, total = tec.compact_records(recs, counts, t["lane_start"],
                                         t["lane_len"], t["lane_lo"],
                                         t["lane_hi"])
    pos, llen, clen, csrc, _ = crec[:, :int(total)].to(torch.int64)
    d = pos + llen
    far = (clen > 0) & ((d - csrc) // RANGE < d // RANGE)
    assert int(far.sum()) >= 1

    want = jpd.decode_block_tpu(segs, len(data), SEG)
    got = teb.decode_block_whole(segs, len(data), SEG, "cpu")
    assert got == want == data
    assert tdk.decode_segments(segs, len(data), SEG) == data
    # With the clamp the same input has no such copy and takes the ranges.
    clamped = encode_segs(data, SEG, RANGE)
    assert tec.decode_block_chained(clamped, len(data), SEG, RANGE,
                                    "cpu") == data


# ---- crafted records, with positions, through execute_blocks ---------------

def run_records(records, span=4 * 512):
    """Execute one block of records (llen, clen, csrc, lsrc), placed back
    to back from output position 0, against COMP."""
    pos, rows = 0, []
    for llen, clen, csrc, lsrc in records:
        rows.append((pos, llen, clen, csrc, lsrc))
        pos += llen + clen
    out = teb.execute_blocks(
        torch.tensor(rows, dtype=torch.int32).T.contiguous(),
        torch.tensor([0, len(rows)], dtype=torch.int64),
        torch.tensor([0], dtype=torch.int64),
        torch.tensor([span], dtype=torch.int32), torch.from_numpy(COMP),
        span)
    return out.numpy().tobytes()


def sequential(records, span=4 * 512):
    out = bytearray()
    for llen, clen, csrc, lsrc in records:
        out += bytes(COMP[lsrc : lsrc + llen])
        for _ in range(clen):
            out.append(out[-csrc])
    return bytes(out) + bytes(span - len(out))


@pytest.mark.parametrize("align", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("llen", [1, 3, 26, 511, 513])
def test_literal_alignment_sweep(align, llen):
    recs = [(llen, 0, 1, align)]
    assert run_records(recs) == sequential(recs)


@pytest.mark.parametrize(
    "offset,clen",
    [(1, 5), (1, 100), (2, 37), (3, 64), (7, 29), (64, 200), (300, 513)],
)
def test_copy_offsets(offset, clen):
    recs = [(max(64, offset), clen, offset, 0)]
    assert run_records(recs) == sequential(recs)


def test_copy_zero_literal_record():
    recs = [(16, 0, 1, 0), (0, 8, 4, 0)]
    assert run_records(recs) == sequential(recs)


def test_row_crossing_literal_then_copy():
    recs = [(500, 0, 1, 0), (30, 40, 10, 500)]
    assert run_records(recs) == sequential(recs)


def test_blocks_of_unequal_size_in_one_batch():
    """Two blocks of one batch, of different spans: each decodes from its
    own records into its own output slice, and a copy source before the
    block's first byte reads 0 instead of the block before."""
    spans = [1140, 512]
    per_block = [[(40, 100, 3, 0), (0, 1000, 140, 0)],
                 [(7, 0, 1, 100), (5, 300, 12, 900)]]
    rows, first = [], [0]
    for recs in per_block:
        pos = 0
        for llen, clen, csrc, lsrc in recs:
            rows.append((pos, llen, clen, csrc, lsrc))
            pos += llen + clen
        first.append(len(rows))
    rows.append((312, 0, 8, 400, 0))  # reaches before the second block
    first[-1] += 1
    out = teb.execute_blocks(
        torch.tensor(rows, dtype=torch.int32).T.contiguous(),
        torch.tensor(first, dtype=torch.int64),
        torch.tensor([0, spans[0]], dtype=torch.int64),
        torch.tensor(spans, dtype=torch.int32), torch.from_numpy(COMP),
        sum(spans)).numpy().tobytes()
    want = b"".join(sequential(r, s) for r, s in zip(per_block, spans))
    assert out == want  # the hostile copy wrote zeros over zeros


# ---- planning --------------------------------------------------------------

def test_plan_whole_blocks_of_unequal_size():
    """rng == 0: one range per block, as many lanes as segments, spans and
    lane bounds block-local; range_firsts follows range_lane."""
    blocks = [[b"ab", b"cde", b"f"], [b"gh"], [], [b"i"] * 5]
    plan = tec.plan_batch(blocks, SEG, 0)
    assert plan.range_lane.tolist() == [0, 3, 4, 4, 9]
    assert plan.range_span.tolist() == [3 * SEG, SEG, 0, 5 * SEG]
    assert plan.range_out.tolist() == [0, 3 * SEG, 4 * SEG, 4 * SEG]
    assert plan.lane_lo.tolist() == [0, SEG, 2 * SEG, 0, 0, SEG, 2 * SEG,
                                     3 * SEG, 4 * SEG]
    assert (plan.lane_hi - plan.lane_lo == SEG).all()
    assert plan.max_span == 5 * SEG and plan.rng == 0
    assert bytes(plan.comp) == b"abcdefgh" + b"i" * 5
    lane_out = torch.arange(9, dtype=torch.int64) * 10
    for total in (95, torch.tensor([95])):
        first = tec.range_firsts(lane_out, total,
                                 torch.from_numpy(plan.range_lane))
        assert first.tolist() == [0, 30, 40, 40, 95]
    # Ranged plans keep their lanes padded to whole ranges.
    ranged = tec.plan_batch(blocks, SEG, 2 * SEG)
    assert ranged.range_lane.tolist() == [0, 2, 4, 6, 8, 10, 12]
    assert ranged.max_span == 2 * SEG


# ---- routing in DeviceCodec -------------------------------------------------

@pytest.fixture(scope="module")
def unclamped(twain):
    """One block encoded without the clamp: (data, body, hints)."""
    from minlz_tpu_torch.oracle import decode as odec
    from minlz_tpu_torch.ops.encode_kernel import encode_block_device

    data = (twain * 2)[5 : 5 + (40 << 10)]
    block, hints = encode_block_device(data, SEG, 0, 2, "cpu")
    _, want, pos = odec.parse_header(block)
    assert want == len(data)
    return data, block[pos:], hints


def _spy(monkeypatch):
    calls = {"whole": 0, "chained": 0}

    def whole(*args, **kwargs):
        calls["whole"] += len(args[0])
        return real_whole(*args, **kwargs)

    def chained(*args, **kwargs):
        calls["chained"] += len(args[0])
        return real_chained(*args, **kwargs)

    real_whole, real_chained = (teb.decode_blocks_whole,
                                tec.decode_blocks_chained)
    monkeypatch.setattr(teb, "decode_blocks_whole", whole)
    monkeypatch.setattr(tec, "decode_blocks_chained", chained)
    return calls


@pytest.mark.parametrize("rng", [0, 3 * SEG + 1, 2 * RANGE])
def test_hints_without_usable_clamp_take_the_whole_block_road(
        rng, unclamped, monkeypatch):
    data, body, hints = unclamped
    calls = _spy(monkeypatch)
    dc = tdc.DeviceCodec("cpu")
    assert dc.decode(body, tdc.marshal_hints(SEG, hints, rng),
                     len(data)) == data
    assert calls == {"whole": 1, "chained": 0}
    assert dc.blocks_decoded == 1


def test_hint_version_1_decodes_the_same(unclamped):
    data, body, hints = unclamped
    v2 = tdc.marshal_hints(SEG, hints, 0)
    v1 = bytearray(v2)
    v1[4] = 1
    n = len(tdc.put_uvarint(SEG)) + len(tdc.put_uvarint(len(hints)))
    del v1[5 + n]  # the range field, here the 1-byte uvarint 0
    assert tdc.parse_hints(bytes(v1)) == tdc.parse_hints(v2)
    assert jdc.parse_hints(bytes(v1)) == tdc.parse_hints(v2)
    assert tdc.DeviceCodec("cpu").decode(body, bytes(v1), len(data)) == data


def test_mixed_batch_returns_blocks_in_order(unclamped, twain, monkeypatch):
    from minlz_tpu_torch.oracle import decode as odec

    data, body, hints = unclamped
    dc = tdc.DeviceCodec("cpu")
    items, want = [], []
    for i in range(2):
        other = (twain * 2)[i * 9000 :][: 30 << 10]
        block, payload = dc.encode(other, 2)
        _, n, pos = odec.parse_header(block)
        items += [(block[pos:], payload, n),
                  (body, tdc.marshal_hints(SEG, hints, 0), len(data))]
        want += [other, data]
    calls = _spy(monkeypatch)
    assert dc.decode_batch(items) == want
    assert calls == {"whole": 2, "chained": 2}
    assert dc.blocks_decoded == 4


def test_block_over_the_format_limit_is_left_to_the_host():
    from minlz_tpu_torch.minlz import CorruptError

    n = tdc.MAX_BLOCK + 1
    hints = tdc.marshal_hints(1 << 20, [(0, 0)] * 9, 0)
    with pytest.raises(CorruptError, match="exceeds"):
        tdc.DeviceCodec("cpu").decode(b"", hints, n)


def test_seg8192_whole_block(twain):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + (
        twain * 2)[: 3 * 8192 - 100]
    segs = encode_segs(data, 8192, 0)
    assert teb.decode_block_whole(segs, len(data), 8192, "cpu") == data
    assert tdk.decode_segments(segs, len(data), 8192) == data


# ---- the host referee against the JAX package's ----------------------------

def test_decode_kernel_matches_jax_on_independent_segments(twain):
    """Segments that decode on their own (each a block of one segment),
    through the JAX scan parse + host walk and through the port's."""
    chunks = [twain[i * 5000 : i * 5000 + SEG] for i in range(3)]
    chunks.append(bytes(range(64)) * 64)
    segs = [encode_segs(c, SEG, 0)[0] for c in chunks]
    want = jdk.decode_segments_jnp(segs, [SEG] * len(segs))
    got = tdk.decode_segments(segs, SEG * len(segs), SEG)
    assert got == b"".join(want) == b"".join(chunks)
    comp, start, lens = tdk.pack_lanes(segs)
    mat, jlens = jdk.pack_segments(segs)
    assert lens.tolist() == jlens.tolist()
    for i, s in enumerate(segs):
        assert bytes(comp[start[i] : start[i] + lens[i]]) == s
        assert bytes(mat[: lens[i], i].astype(np.uint8)) == s


def test_host_walk_rejects_a_copy_before_the_block():
    recs = np.zeros((7, 3), np.int32)
    recs[:, 0] = (2, 0, 4, 9, 0, 2, 0)  # copy offset 9 at position 2
    with pytest.raises(ValueError, match="copy offset"):
        tdk.execute_records_host(recs, [1], np.zeros(8, np.uint8), [0],
                                 SEG)


# ---- streams without the range clamp ---------------------------------------

BLOCK = 128 << 10
N_BLOCKS = 3


@pytest.fixture(scope="module")
def streams():
    """The same bytes through both packages' device Writers with the range
    clamp switched off (hints carry range 0)."""
    from minlz_tpu_torch.corpus import make_corpus

    data = make_corpus(1 << 20)[-N_BLOCKS * BLOCK :]
    jbuf, buf = io.BytesIO(), io.BytesIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jec, "RANGE", 0)
        mp.setattr(tdc, "RANGE", 0)
        with JaxWriter(jbuf, device=True, block_size=BLOCK,
                       concurrency=1) as jw:
            jw.write(data)
        w = Writer(buf, device="cpu", block_size=BLOCK, concurrency=1)
        before = w.codec.blocks_encoded  # the process's codec on the CPU
        with w:
            w.write(data)
    assert w.codec.blocks_encoded - before == N_BLOCKS
    return data, jbuf.getvalue(), buf.getvalue()


def _hint_payloads(stream: bytes):
    pos, found = 0, []
    while pos < len(stream):
        n = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        if stream[pos] == CHUNK_TYPE_PARSE_HINT:
            found.append((pos + 4, n))
        pos += 4 + n
    return found


def test_unclamped_writer_bytes_match_jax_writer(streams):
    data, jax_bytes, port_bytes = streams
    assert len(port_bytes) < len(data)
    assert port_bytes == jax_bytes
    payloads = _hint_payloads(port_bytes)
    assert len(payloads) == N_BLOCKS
    for at, n in payloads:
        assert tdc.parse_hints(port_bytes[at : at + n])[2] == 0


def test_port_reader_reads_unclamped_streams(streams, monkeypatch):
    data, jax_bytes, port_bytes = streams
    calls = _spy(monkeypatch)
    for stream in (port_bytes, jax_bytes):
        r = Reader(io.BytesIO(stream), device="cpu")
        before = r.codec.blocks_decoded
        assert r.readall() == data
        assert r.codec.blocks_decoded - before == N_BLOCKS
    assert calls == {"whole": 2 * N_BLOCKS, "chained": 0}
    r = Reader(io.BytesIO(port_bytes), device="cpu")
    before = r.codec.blocks_decoded
    assert r.read(1000) == data[:1000]
    assert r.codec.blocks_decoded - before == 1


def _count_jax_v1(monkeypatch):
    calls = []
    real = jpd.decode_block_tpu

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jpd, "decode_block_tpu", counted)
    return calls


def test_jax_reader_reads_the_ports_unclamped_stream(streams, monkeypatch):
    data, _, port_bytes = streams
    calls = _count_jax_v1(monkeypatch)
    assert JaxReader(io.BytesIO(port_bytes), device=True).readall() == data
    assert len(calls) == N_BLOCKS  # its v1 road, not its host decoder


def test_version_1_hint_chunks_decode_on_the_device(streams, monkeypatch):
    """The stream an earlier writer wrote: every hint payload rewritten to
    version 0x01 (no range field; the chunk shrinks by one byte)."""
    data, _, port_bytes = streams
    out, prev = bytearray(), 0
    for at, n in _hint_payloads(port_bytes):
        payload = bytearray(port_bytes[at : at + n])
        seg, offs, rng = tdc.parse_hints(bytes(payload))
        assert rng == 0
        payload[4] = 1
        skip = len(tdc.put_uvarint(seg)) + len(tdc.put_uvarint(len(offs)))
        del payload[5 + skip]
        assert tdc.parse_hints(bytes(payload)) == (seg, offs, 0)
        out += port_bytes[prev : at - 3]
        out += len(payload).to_bytes(3, "little") + payload
        prev = at + n
    out += port_bytes[prev:]
    r = Reader(io.BytesIO(bytes(out)), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == data
    assert r.codec.blocks_decoded - before == N_BLOCKS
    calls = _count_jax_v1(monkeypatch)
    assert JaxReader(io.BytesIO(bytes(out)), device=True).readall() == data
    assert len(calls) == N_BLOCKS
