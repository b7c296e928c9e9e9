"""The append-only decode road of the port (compact_records_dense and
execute_scheduled in minlz_tpu_torch.ops.exec_chain) against the JAX
package's r4 road (compact_ops_dense and execute_scheduled in
minlz_tpu.ops.exec_chain, Pallas in interpret mode, in its packed and its
planar arena layout) and against the port's own positioned road.  On the CPU
the port runs its plain torch versions.  Tolerance 0: bytes and integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minlz_tpu.ops import exec_chain as jec
from minlz_tpu.ops.pallas_decode import parse_segments_pallas
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops import resolve_model as trm
from minlz_tpu_torch.ops.parse import parse_segments
from minlz_tpu_torch.testing import RECORD_KINDS, record_batch

from test_exec_chain import COMP, ROW, run_ops
from test_torch_common import dense_ops_to_records, encode_segs

SEG = 4096
RANGE = tec.RANGE
SPAN = 4 * ROW


def run_records(records, span=SPAN):
    """Execute one range of records (llen, clen, csrc, lsrc) through the
    port's append-only executor, against the JAX tests' byte ramp."""
    drec = torch.tensor(records, dtype=torch.int32).T.contiguous()
    out = tec.execute_scheduled(
        drec, torch.tensor([0, len(records)], dtype=torch.int64),
        torch.tensor([0], dtype=torch.int64),
        torch.tensor([span], dtype=torch.int32), torch.from_numpy(COMP),
        span, span)
    return out.numpy()


def both_packages(records):
    """(the port's bytes, the JAX executor's bytes) of one record list.  The
    JAX arena addresses literals from its guard row on."""
    jax_out = run_ops([(ll, cl, cs, ROW + ls) for ll, cl, cs, ls in records])
    return run_records(records).tobytes(), bytes(jax_out[:SPAN])


def sequential(records, span=SPAN):
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
    port, jax_bytes = both_packages(recs)
    assert port == jax_bytes == sequential(recs)


@pytest.mark.parametrize(
    "offset,clen",
    [(1, 5), (1, 100), (2, 37), (3, 64), (7, 29), (64, 200), (300, 513)],
)
def test_copy_offsets(offset, clen):
    recs = [(max(64, offset), clen, offset, 0)]
    port, jax_bytes = both_packages(recs)
    assert port == jax_bytes == sequential(recs)


def test_copy_zero_literal_record():
    recs = [(16, 0, 1, 0), (0, 8, 4, 0)]
    port, jax_bytes = both_packages(recs)
    assert port == jax_bytes == sequential(recs)


def test_row_crossing_literal_then_copy():
    recs = [(500, 0, 1, 0), (30, 40, 10, 500)]
    port, jax_bytes = both_packages(recs)
    assert port == jax_bytes == sequential(recs)


def test_cursor_stops_at_the_span():
    """Hostile lengths: each record lands at the cursor, clipped to the
    range span; the cursor never passes it, negative lengths count as 0,
    and the next range starts from its own 0."""
    drec = torch.tensor(
        [(4, 10, 2, 0), (-7, 0, 1, 0), (3, 2 ** 31 - 1, 1, 100),
         (5, 5, 1, 0),            # past the span: nothing lands
         (6, 0, 1, 200)],         # the second range
        dtype=torch.int32).T.contiguous()
    out = tec.execute_scheduled(
        drec, torch.tensor([0, 4, 5], dtype=torch.int64),
        torch.tensor([0, 32], dtype=torch.int64),
        torch.tensor([32, 16], dtype=torch.int32), torch.from_numpy(COMP),
        48, 32).numpy().tobytes()
    first = bytearray(COMP[:4])
    for _ in range(10):
        first.append(first[-2])
    first += bytes(COMP[100:103])
    first += bytes([first[-1]]) * (32 - len(first))
    assert out == bytes(first) + bytes(COMP[200:206]) + bytes(10)


def test_multiple_ranges_match_the_positioned_executor():
    spans = [1024, 1024, 512]
    per_range = [
        [(40, 100, 3, 0), (0, 30, 41, 0)],
        [(7, 0, 1, 100), (5, 300, 12, 900)],
        [(512, 0, 1, 1000)],
    ]
    rows, prows, first = [], [], [0]
    for recs in per_range:
        pos = 0
        for llen, clen, csrc, lsrc in recs:
            rows.append((llen, clen, csrc, lsrc))
            prows.append((pos, llen, clen, csrc, lsrc))
            pos += llen + clen
        first.append(len(rows))
    common = (torch.tensor(first, dtype=torch.int64),
              torch.from_numpy(np.cumsum([0] + spans[:-1]).astype(np.int64)),
              torch.tensor(spans, dtype=torch.int32), torch.from_numpy(COMP),
              sum(spans), 1024)
    sched = tec.execute_scheduled(
        torch.tensor(rows, dtype=torch.int32).T.contiguous(), *common)
    fast = tec.execute_ranges(
        torch.tensor(prows, dtype=torch.int32).T.contiguous(), *common)
    want = b"".join(sequential(r, s) for r, s in zip(per_range, spans))
    assert sched.numpy().tobytes() == fast.numpy().tobytes() == want


# ---- real batches -----------------------------------------------------------

@pytest.fixture(scope="module")
def batch(twain):
    blocks = [(twain * 3)[: 32 << 10], bytes(range(256)) * 40]
    segs = [encode_segs(b, SEG, RANGE) for b in blocks]
    return blocks, segs, [len(b) for b in blocks]


def test_scheduled_road_matches_jax_planar_and_packed(batch, monkeypatch):
    """The port's append-only road against the JAX r4 executor in its planar
    and in its packed arena, and against the port's positioned road."""
    blocks, segs, totals = batch
    sched = tec.decode_blocks_chained(segs, totals, SEG, RANGE, "cpu",
                                      executor="scheduled")
    fast = tec.decode_blocks_chained(segs, totals, SEG, RANGE, "cpu",
                                     executor="fast")
    planar = jec.decode_blocks_chained(segs, totals, SEG, jec.RANGE,
                                       planar=True)
    monkeypatch.setattr(jec, "_V2_DEFAULT", False)
    packed = jec.decode_blocks_chained(segs, totals, SEG, jec.RANGE,
                                       planar=False)
    assert sched == planar == packed == fast == blocks


def test_small_ranges_and_seg8192(twain):
    """Ranges of two segments (many short ranges, the last one partial) and
    8192-byte segments through both of the port's executors."""
    data = (twain * 2)[100 : 100 + (52 << 10) + 77]
    for seg, rng in ((SEG, 2 * SEG), (8192, RANGE), (8192, 8192)):
        segs = encode_segs(data, seg, rng)
        for executor in tec.EXECUTORS:
            assert tec.decode_block_chained(
                segs, len(data), seg, rng, "cpu", executor) == data


def test_unknown_executor_and_oversized_range_raise(batch):
    _, segs, totals = batch
    with pytest.raises(ValueError, match="executor"):
        tec.decode_blocks_chained(segs, totals, SEG, RANGE, "cpu",
                                  executor="planar")
    with pytest.raises(ValueError, match="stage at most"):
        tec.decode_blocks_chained(segs, totals, SEG, 2 * RANGE, "cpu")


def _jax_dense(segs):
    """The JAX parse and compact_ops_dense on a batch, one chain: (ops
    [1, cap, 3], record count, pc, guard)."""
    (comp_lanes, lens, _, _), st, _, _ = jec.plan_batch(segs, SEG, jec.RANGE)
    n_rows, pc = st["n_rows"], st["pc"]
    lanes = comp_lanes.shape[0]
    ct = comp_lanes[:, :n_rows].T.astype(np.int32).reshape(
        n_rows // 4, 4, lanes // 128, 128)
    words = ct[:, 0] | (ct[:, 1] << 8) | (ct[:, 2] << 16) | (ct[:, 3] << 24)
    emits = parse_segments_pallas(jnp.asarray(words), jnp.asarray(lens),
                                  n_rows)
    L = st["R"] * st["spr"]
    lane_counts = np.asarray(
        jnp.sum(emits[0] > 0, axis=0, dtype=jnp.int32)).reshape(-1)[:L]
    total = int(lane_counts.sum())
    cap = -(-total // jec.OP_T) * jec.OP_T
    lane_off = (np.cumsum(lane_counts) - lane_counts).astype(np.int32)
    ops = jec.compact_ops_dense(
        *emits[:6], jnp.asarray(lane_off), jnp.asarray(lane_counts),
        nchain=1, cap_chain=cap, pc=pc, guard=jec.ROW_B)
    return np.asarray(ops), total, pc, jec.ROW_B


def test_dense_compaction_matches_jax_field_by_field(batch):
    """llen, clen, csrc and the literal byte of every record, after undoing
    the TPU arena offset (lane * pc + guard); then both executors on the
    JAX package's records."""
    blocks, segs, totals = batch
    ops, total, pc, guard = _jax_dense(segs)
    plan = tec.plan_batch(segs, SEG, RANGE)
    t = plan.tensors("cpu")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    drec, lane_out, n = tec.compact_records_dense(
        recs, counts, t["lane_start"], t["lane_len"])
    assert drec.shape == (4, recs.shape[1]) and int(n) == total > 1000
    want = dense_ops_to_records(ops, [total], pc, guard, plan.lane_start)
    for row, name in enumerate(("llen", "clen", "csrc", "lit")):
        np.testing.assert_array_equal(drec[row, :total].numpy(), want[row],
                                      name)

    # The positioned compaction holds the same records, with a position.
    crec, lane_out2, n2 = tec.compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    assert torch.equal(lane_out, lane_out2) and torch.equal(n, n2)
    assert torch.equal(crec[1:, :total], drec[:, :total])

    first = tec.range_firsts(lane_out, n, t["range_lane"])
    out = tec.execute_scheduled(
        torch.from_numpy(want), first, t["range_out"], t["range_span"],
        t["comp"], plan.total_out, plan.max_span)
    assert tec.trim_blocks(plan, out, totals) == blocks


def test_dense_compaction_clamps_hostile_fields():
    """Negative lengths count as 0, csrc is at least 1, and the literal
    index stays within the lane's compressed bytes."""
    lane_start = torch.tensor([0, 10], dtype=torch.int32)
    lane_len = torch.tensor([10, 6], dtype=torch.int32)
    counts = torch.tensor([2, 1], dtype=torch.int32)
    recs = torch.zeros((7, 18), dtype=torch.int32)
    #            kind dst  clen csrc  lsrc llen lacc
    recs[:, 0] = torch.tensor([1, 0, -5, 0, -3, 7, 0])
    recs[:, 1] = torch.tensor([2, 9, 40, -9, 99, -1, 0])
    recs[:, 11] = torch.tensor([2, 0, 3, 2 ** 31 - 1, 4, 2 ** 31 - 1, 0])
    drec, lane_out, total = tec.compact_records_dense(recs, counts,
                                                      lane_start, lane_len)
    assert lane_out.tolist() == [0, 2] and total.tolist() == [3]
    assert drec[:, :3].tolist() == [[7, 0, 2 ** 31 - 1], [0, 40, 3],
                                    [1, 1, 2 ** 31 - 1], [0, 10, 14]]


# ---- the kernel's composition: a cursor scan, then K3's tiled resolution ----

def sequential_ranges(drec, first, out_off, span, comp, total_out, max_span):
    """The append-only executor walked record by record in Python ints, the
    clamps of its docstring: bytes outside every range are 0."""
    out = bytearray(total_out)
    n = drec.shape[1]
    for r in range(len(span)):
        # A range that goes backwards takes back no earlier record.
        lo = max(min(max(int(f), 0), n) for f in first[:r + 1])
        hi = max(min(max(int(first[r + 1]), 0), n), lo)
        S = min(max(int(span[r]), 0), max_span)
        buf = bytearray(S)
        cur = 0
        for k in range(lo, hi):
            llen, clen, csrc, lit = (int(v) for v in drec[:, k])
            ll = min(max(llen, 0), S - cur)
            for i in range(ll):
                g = min(max(lit + i, 0), len(comp) - 1)
                buf[cur + i] = int(comp[g]) if len(comp) else 0
            cur += ll
            cl = min(max(clen, 0), S - cur)
            csrc = max(csrc, 1)
            for i in range(cl):
                s = cur - csrc + (i % csrc if csrc < cl else i)
                buf[cur + i] = buf[s] if s >= 0 else 0
            cur += cl
        o = int(out_off[r])
        out[o:o + S] = buf
    return bytes(out)


def composed(drec, first, out_off, span, comp, total_out, max_span, sub):
    """What the card runs: scheduled_positions, then K3's sub-tiled
    resolution (ops/resolve_model.py) on the positioned records."""
    pos = tec.scheduled_positions(drec, first, span, max_span)
    crec = torch.cat([pos[None], drec])
    bounds = tec.scheduled_bounds(first, drec.shape[1])
    out, _ = trm.execute_ranges_tiled(crec, bounds, out_off, span, comp,
                                      total_out, max_span, sub)
    return out


@pytest.mark.parametrize("sub", [256, 4096, trm.SUB])
@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_scan_then_resolve_matches_plain(kind, sub):
    """Synthetic densities: the records of ``record_batch`` without their
    position row.  Spans of 0, odd sizes and the full 128 KiB."""
    spans = [RANGE, 0, 37, 5000, RANGE - 1]
    crec, first, out_off, span, comp, total = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in record_batch(kind, spans, seed=2, n_comp=1 << 16))
    drec = crec[1:].contiguous()
    args = (drec, first, out_off, span, comp, total, RANGE)
    want = tec.execute_scheduled_plain(*args)
    assert torch.equal(composed(*args, sub), want)
    assert torch.equal(tec.execute_scheduled(*args), want)
    # Back to back from 0: the scan gives the records their positions.
    assert torch.equal(want, tec.execute_ranges_plain(crec, *args[1:]))


HOSTILE_DREC = (
    # llen, clen, csrc, lit
    (4, 10, 2, 0),
    (-7, 0, 1, 0),             # negative literal length
    (3, -9, 0, 100),           # negative copy length, csrc 0 -> 1
    (2, 5, -40, 3),            # negative csrc
    (0, 12, 1 << 30, 0),       # a source far before the range: zeros
    (6, 3, 1, -20),            # literal index before comp
    (5, 7, 3, 1 << 30),        # literal index past comp
    (2 ** 31 - 1, 5, 1, 0),    # sums past the span: the cursor stops
    (5, 2 ** 31 - 1, 1, 0),
    (9, 9, 9, 9),
)


@pytest.mark.parametrize("sub", [64, 1024])
def test_scan_then_resolve_on_hostile_records(sub):
    """Hostile fields, ranges that are empty, inverted or past the record
    list: the composition, the plain version and a record-by-record walk
    agree, and the scan's positions never pass the span."""
    drec = torch.tensor(HOSTILE_DREC * 3, dtype=torch.int32).T.contiguous()
    n = drec.shape[1]
    first = torch.tensor([0, 7, 7, 4, 18, n, n + 5], dtype=torch.int64)
    span = torch.tensor([300, 64, 50, 2000, 700, 10], dtype=torch.int32)
    out_off = torch.cumsum(span.to(torch.int64), 0) - span.to(torch.int64)
    total = int(span.sum())
    comp = torch.from_numpy(COMP[:500].copy())
    for c in (comp, comp[:0]):
        args = (drec, first, out_off, span, c, total, 2000)
        want = tec.execute_scheduled_plain(*args)
        assert torch.equal(composed(*args, sub), want)
        assert want.numpy().tobytes() == sequential_ranges(
            drec.numpy(), first.numpy(), out_off.numpy(), span.numpy(),
            c.numpy(), total, 2000)
    pos = tec.scheduled_positions(drec, first, span, 2000)
    assert pos[:7].tolist() == [0, 14, 14, 17, 24, 36, 45]
    # Range 3 ([4, 18) as given) takes records 7 to 17 only, and its first
    # record's literals fill its span: the cursor stops there.
    assert tec.scheduled_bounds(first, n).tolist() == [0, 7, 7, 7, 18, n, n]
    assert pos[7:18].tolist() == [0] + [2000] * 10
    assert pos[18] == 0 and int(pos[18:].max()) == 700


def test_scheduled_positions_are_the_cursor():
    """Exclusive sums of the clamped lengths per range, in int64 (two
    lengths near 2^31 do not wrap), stopped at the span."""
    drec = torch.tensor([(5, 3, 1, 0), (-2, 4, 1, 0), (2 ** 31 - 1,
                         2 ** 31 - 1, 1, 0), (1, 1, 1, 0), (7, 0, 1, 0),
                         (2, 2, 1, 0)], dtype=torch.int32).T.contiguous()
    first = torch.tensor([0, 4, 6], dtype=torch.int64)
    span = torch.tensor([100, 5], dtype=torch.int32)
    pos = tec.scheduled_positions(drec, first, span, 100)
    assert pos.tolist() == [0, 8, 12, 100, 0, 5]
