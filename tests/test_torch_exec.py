"""Decode executor of the port (minlz_tpu_torch.ops.exec_chain): record-level
cases of tests/test_exec_chain.py recast as (llen, clen, csrc, lsrc) records,
whole-block decodes against the spec oracle and the JAX executor, and the
mutated hints/body fuzz of tests/test_fuzz.py on the port's DeviceCodec.
On the CPU every stage runs its plain torch version."""

import numpy as np
import pytest
import torch

from minlz_tpu_torch.minlz import CorruptError
from minlz_tpu.oracle import decode as odec
from minlz_tpu.oracle import encode as oenc
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops.device_codec import (
    RANGE, DeviceCodec, marshal_hints, parse_hints, split_body)
from minlz_tpu_torch.ops.encode_kernel import encode_block_device
from minlz_tpu_torch.ops.parse import parse_segments

# A known byte ramp stands in for the compressed buffer.
COMP = (np.arange(4 * 512, dtype=np.uint32) % 251).astype(np.uint8)


def run_records(records, span=4 * 512):
    """Execute one range of records (llen, clen, csrc, lsrc), placed back to
    back from output position 0, against COMP.  Returns the range bytes."""
    pos, rows = 0, []
    for llen, clen, csrc, lsrc in records:
        rows.append((pos, llen, clen, csrc, lsrc))
        pos += llen + clen
    crec = torch.tensor(rows, dtype=torch.int32).T.contiguous()
    first = torch.tensor([0, len(rows)], dtype=torch.int64)
    out = tec.execute_ranges(
        crec, first, torch.tensor([0], dtype=torch.int64),
        torch.tensor([span], dtype=torch.int32), torch.from_numpy(COMP),
        span)
    return out.numpy()


def sequential(records, span=4 * 512):
    """Byte-serial reference: literals from COMP, then each copy byte from
    the output `csrc` bytes back."""
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
    assert run_records(recs).tobytes() == sequential(recs)


@pytest.mark.parametrize(
    "offset,clen",
    [(1, 5), (1, 100), (2, 37), (3, 64), (7, 29), (64, 200), (300, 513)],
)
def test_copy_offsets(offset, clen):
    """Copies, including RLE overlap (offset < length)."""
    recs = [(max(64, offset), clen, offset, 0)]
    assert run_records(recs).tobytes() == sequential(recs)


def test_copy_zero_literal_record():
    recs = [(16, 0, 1, 0), (0, 8, 4, 0)]
    assert run_records(recs).tobytes() == sequential(recs)


def test_row_crossing_literal_then_copy():
    recs = [(500, 0, 1, 0), (30, 40, 10, 500)]
    assert run_records(recs).tobytes() == sequential(recs)


def test_multiple_ranges():
    """Three ranges of one batch, the last one short: each range is
    decoded on its own, from its own records, into its own output span."""
    spans = [1024, 1024, 512]
    per_range = [
        [(40, 100, 3, 0), (0, 30, 41, 0)],
        [(7, 0, 1, 100), (5, 300, 12, 900)],
        [(512, 0, 1, 1000)],
    ]
    rows, first = [], [0]
    for recs in per_range:
        pos = 0
        for llen, clen, csrc, lsrc in recs:
            rows.append((pos, llen, clen, csrc, lsrc))
            pos += llen + clen
        first.append(len(rows))
    offs = np.cumsum([0] + spans[:-1])
    out = tec.execute_ranges(
        torch.tensor(rows, dtype=torch.int32).T.contiguous(),
        torch.tensor(first, dtype=torch.int64),
        torch.from_numpy(offs.astype(np.int64)),
        torch.tensor(spans, dtype=torch.int32),
        torch.from_numpy(COMP), sum(spans)).numpy().tobytes()
    want = b"".join(sequential(r, s) for r, s in zip(per_range, spans))
    assert out == want


def test_copy_before_range_start_reads_zero():
    """A hostile copy source before the range start reads 0, and lengths
    are clipped to the range span: no out-of-bounds access."""
    crec = torch.tensor([[0, 4, 10, 9, 0], [14, 0, 99999, 1, 0]],
                        dtype=torch.int32).T.contiguous()
    out = tec.execute_ranges(
        crec, torch.tensor([0, 2], dtype=torch.int64),
        torch.tensor([0], dtype=torch.int64),
        torch.tensor([32], dtype=torch.int32), torch.from_numpy(COMP), 32)
    # Copy byte q reads q - 9: bytes 4..8 read before the range (0), bytes
    # 9..12 repeat bytes 0..3, byte 13 repeats byte 4; then an RLE run of
    # byte 13 fills the clipped rest of the span.
    want = bytes(COMP[:4]) + bytes(6) + bytes(COMP[1:4]) + bytes(1 + 18)
    assert out.numpy().tobytes() == want


def _encode_segs(data, seg, rng=RANGE):
    block, hints = encode_block_device(data, seg, rng, 2, "cpu")
    assert odec.decode_block(block) == data
    _, _, pos = odec.parse_header(block)
    return split_body(block[pos:], [h[0] for h in hints])


def test_batched_multi_block_decode(twain):
    """Blocks of mixed sizes and content in one dispatch, against the
    oracle's view of the same bytes."""
    rng = np.random.default_rng(3)
    blocks = [
        (twain * 40)[: 160 << 10],
        rng.integers(0, 16, 96 << 10, dtype=np.uint8).tobytes(),
        (twain * 40)[13:][: 64 << 10],
        bytes(48 << 10),
    ]
    segs = [_encode_segs(b, 4096) for b in blocks]
    got = tec.decode_blocks_chained(segs, [len(b) for b in blocks], 4096,
                                    RANGE, "cpu")
    assert got == blocks


def test_seg8192_whole_literal_record(twain):
    seg = 8192
    ramp = (np.arange(seg, dtype=np.uint32) * 2654435761 >> 13).astype(
        np.uint8).tobytes()
    s0, s1 = bytearray(), bytearray()
    oenc.emit_literals(s0, ramp)
    oenc.emit_literals(s1, twain[:seg])
    data = ramp + twain[:seg]
    got = tec.decode_block_chained([bytes(s0), bytes(s1)], len(data), seg,
                                   RANGE, "cpu")
    assert got == data


def test_seg8192_device_roundtrip(twain):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + (
        twain * 2)[: 3 * 8192]
    segs = _encode_segs(data, 8192)
    assert tec.decode_block_chained(segs, len(data), 8192, RANGE,
                                    "cpu") == data


def test_two_blocks_match_jax_executor(twain):
    """The port's bytes equal the JAX executor's (Pallas in interpret mode)
    on the same two-block batch."""
    from minlz_tpu.ops import exec_chain as jec

    blocks = [(twain * 3)[: 32 << 10], bytes(range(256)) * 40]
    segs = [_encode_segs(b, 4096) for b in blocks]
    totals = [len(b) for b in blocks]
    want = jec.decode_blocks_chained(segs, totals, 4096, jec.RANGE)
    got = tec.decode_blocks_chained(segs, totals, 4096, RANGE, "cpu")
    assert got == want == blocks


def _check_clamps(plan, crec, first):
    """Compaction's guarantees: every record lies inside its range span
    (a whole block on the whole-block road), and a range's records move
    forward without overlapping.  The records are the columns before the
    last range's end, the total."""
    pos, llen, clen, csrc, lit = crec[:, :int(first[-1])].to(torch.int64)
    assert bool((csrc >= 1).all())
    assert bool(((lit >= 0) & (lit <= len(plan.comp))).all())
    for r, span in enumerate(plan.range_span):
        a, b = int(first[r]), int(first[r + 1])
        p, n = pos[a:b], (llen + clen)[a:b]
        assert bool(((p >= 0) & (p + n <= int(span))).all())
        live = n > 0
        ends = (p + n)[live]
        assert bool((p[live][1:] >= ends[:-1]).all())


def test_fuzz_mutated_hints_and_body():
    """Mutated hint payloads and block bodies through the port's decoder:
    CorruptError or bytes, never anything else; the compaction clamps hold
    on every mutated batch, on the range road and on the whole-block road
    (well-formed hints without a usable range clamp)."""
    from test_fuzz import _gen_input, _mutate

    rng = np.random.default_rng(0xBEEF)
    base = _gen_input(rng, 12_000)
    dc = DeviceCodec("cpu")
    block, hints = dc.encode(base, 2)
    _, want, pos = odec.parse_header(block)
    body = block[pos:]
    assert dc.decode(body, hints, want) == base

    decoded = whole = 0
    for _ in range(24):
        badh, badb = _mutate(rng, hints), _mutate(rng, body)
        try:
            seg, offs, hrng = parse_hints(badh)
        except CorruptError:
            continue
        try:
            got = dc.decode(badb, badh, want)
        except CorruptError:
            continue
        assert isinstance(got, bytes) and len(got) == want
        decoded += 1
        segs = split_body(badb, offs)
        if not DeviceCodec._chained_ok(seg, hrng, want):
            hrng = 0
            whole += 1
        plan = tec.plan_batch([segs], seg, hrng)
        t = plan.tensors("cpu")
        recs, counts = parse_segments(t["comp"], t["lane_start"],
                                      t["lane_len"])
        crec, lane_out, total = tec.compact_records(
            recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
            t["lane_hi"])
        _check_clamps(plan, crec,
                      tec.range_firsts(lane_out, total, t["range_lane"]))
    assert decoded >= 3

    # The same mutated bodies under well-formed hints without a clamp.
    v1 = marshal_hints(parse_hints(hints)[0],
                       [(o, 0) for o in parse_hints(hints)[1]], 0)
    assert dc.decode(body, v1, want) == base
    for _ in range(6):
        badb = _mutate(rng, body)
        got = dc.decode(badb, v1, want)
        assert isinstance(got, bytes) and len(got) == want
        seg, offs, _ = parse_hints(v1)
        plan = tec.plan_batch([split_body(badb, offs)], seg, 0)
        t = plan.tensors("cpu")
        recs, counts = parse_segments(t["comp"], t["lane_start"],
                                      t["lane_len"])
        crec, lane_out, total = tec.compact_records(
            recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
            t["lane_hi"])
        _check_clamps(plan, crec,
                      tec.range_firsts(lane_out, total, t["range_lane"]))
