"""The compaction of the port (minlz_tpu_torch.ops.exec_chain:
lane_offsets, compact_records at range and at whole-block lane spans,
compact_records_dense, range_firsts) under its launch contract: the output
at the parse's slot capacity, the lane offsets and the record total as
tensors, the records in the first total columns.  The plain versions are
held to a record-by-record numpy model of the clamps written here, on the
corpus mix and on mutated hints and bodies; decode_planned on each road to
the JAX package's decode; the executors to reading nothing past the total;
the plan's hoisted range check to its ValueError.  On the CPU every stage
runs its plain torch version.  Tolerance 0: integers and bytes."""

import numpy as np
import pytest
import torch

from minlz_tpu.ops import exec_chain as jec
from minlz_tpu.ops import pallas_decode as jpd
from minlz_tpu_torch.corpus import make_corpus
from minlz_tpu_torch.minlz import CorruptError
from minlz_tpu_torch.ops import exec_block as teb
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops import resolve_model as trm
from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.ops.device_codec import RANGE, DeviceCodec
from minlz_tpu_torch.ops.parse import parse_segments

from test_torch_common import encode_segs

SEG = 4096
I32 = np.iinfo(np.int32)


def model_compact(recs, counts, lane_start, lane_len, lane_lo=None,
                  lane_hi=None):
    """The compaction's clamps, record by record in Python ints: for each
    lane in order, each of its counts[l] records from slot lane_start[l] +
    l.  Positioned (lane spans given): a record is kept only if it starts
    at or after the end of every earlier record of its lane (from 0); a
    kept record lands at lane_lo + dst, at most lane_hi, a dropped one at
    lane_hi; the literal then the copy length are cut to the span left.
    Rows (pos, llen, clen, csrc, lit), or without spans (llen, clen, csrc,
    lit) with no keep test.  Returns (rows [5 or 4, total], lane_out)."""
    recs = np.asarray(recs, np.int64)
    rows, lane_out = [], []
    for lane, cnt in enumerate(np.asarray(counts).tolist()):
        lane_out.append(len(rows))
        start, clen_lane = int(lane_start[lane]), int(lane_len[lane])
        prior = 0
        for k in range(cnt):
            _, dst, clen, csrc, lsrc, llen, _ = recs[:, start + lane + k]
            llen, clen = max(int(llen), 0), max(int(clen), 0)
            lit = start + min(max(int(lsrc), 0), clen_lane)
            if lane_lo is None:
                rows.append((llen, clen, max(int(csrc), 1), lit))
                continue
            lo, hi = int(lane_lo[lane]), int(lane_hi[lane])
            keep = dst >= prior
            prior = max(prior, int(dst) + llen + clen)
            p = min(lo + int(dst), hi) if keep else hi
            ll = min(llen, hi - p)
            rows.append((p, ll, min(clen, hi - p - ll), max(int(csrc), 1),
                         lit))
    width = 4 if lane_lo is None else 5
    return (np.array(rows, np.int64).reshape(-1, width).T,
            np.array(lane_out, np.int64))


def _parsed(plan):
    t = plan.tensors("cpu")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    return t, recs, counts


def check_against_model(plan):
    """Both plain compactions of a plan against the model: capacity, lane
    offsets, total, the first total columns and zeros past them.  Returns
    the number of records."""
    t, recs, counts = _parsed(plan)
    lanes = (t["lane_start"], t["lane_len"], t["lane_lo"], t["lane_hi"])
    for got, spans in ((tec.compact_records(recs, counts, *lanes), lanes[2:]),
                       (tec.compact_records_dense(recs, counts, *lanes[:2]),
                        ())):
        out, lane_out, total = got
        want, want_off = model_compact(recs, counts, *lanes[:2], *spans)
        n = want.shape[1]
        assert out.shape == (want.shape[0], recs.shape[1])
        assert out.dtype == torch.int32 and lane_out.dtype == torch.int64
        assert total.shape == (1,) and int(total) == n
        np.testing.assert_array_equal(lane_out.numpy(), want_off)
        np.testing.assert_array_equal(out[:, :n].numpy(), want)
        assert not bool(out[:, n:].any())
        first = tec.range_firsts(lane_out, total, t["range_lane"])
        assert int(first[-1]) == n
    return n


@pytest.fixture(scope="module")
def corpus_segs():
    """Two blocks of the corpus mix, with and without the range clamp."""
    data = make_corpus(64 << 10)
    blocks = [data[: 24 << 10], data[24 << 10:]]
    return blocks, {rng: [encode_segs(b, SEG, rng) for b in blocks]
                    for rng in (RANGE, 0)}


@pytest.mark.parametrize("rng", [RANGE, 0])
def test_compaction_matches_the_model_on_the_corpus(corpus_segs, rng):
    """At range spans and at whole-block spans (plan_batch(rng=0)), and
    the dense compaction."""
    _, segs = corpus_segs
    assert check_against_model(tec.plan_batch(segs[rng], SEG, rng)) > 1000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compaction_matches_the_model_on_mutated_input(seed):
    """Mutated hint payloads and block bodies (tests/test_fuzz.py's input
    and mutator) give hostile records; every well-formed payload is
    compacted at its road's spans, the body under the original hints also
    at whole-block spans."""
    from test_fuzz import _gen_input, _mutate

    g = np.random.default_rng(0xC0DE + seed)
    dc = DeviceCodec("cpu")
    block, hints = dc.encode(_gen_input(g, 9000), 2)
    _, want, pos = odec.parse_header(block)
    body = block[pos:]
    checked = 0
    for _ in range(4):
        badh, badb = _mutate(g, hints), _mutate(g, body)
        for h in (badh, hints):
            try:
                seg, hrng, segs = dc._prepare(badb, h, want)
            except CorruptError:
                continue
            check_against_model(tec.plan_batch([segs], seg, hrng))
            checked += 1
            if h is hints:
                check_against_model(tec.plan_batch([segs], seg, 0))
    assert checked >= 4


def test_lane_offsets_are_tensors():
    counts = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    lane_out, total = tec.lane_offsets(counts)
    assert lane_out.tolist() == [0, 3, 3, 8] and total.tolist() == [9]
    assert lane_out.dtype == total.dtype == torch.int64
    empty, zero = tec.lane_offsets(torch.zeros(0, dtype=torch.int32))
    assert empty.numel() == 0 and zero.tolist() == [0]


def test_range_firsts_take_a_tensor_total():
    lane_out = torch.tensor([0, 4, 4, 10, 12], dtype=torch.int64)
    range_lane = torch.tensor([0, 2, 3, 5], dtype=torch.int64)
    for total in (torch.tensor([17]), 17):
        first = tec.range_firsts(lane_out, total, range_lane)
        assert first.tolist() == [0, 4, 10, 17]


@pytest.fixture(scope="module")
def jax_decoded(corpus_segs):
    """The JAX package's decode of the two blocks, as its own tests run it
    on the CPU (Pallas in interpret mode): the range road and the v1
    whole-block road."""
    blocks, segs = corpus_segs
    totals = [len(b) for b in blocks]
    ranged = jec.decode_blocks_chained(segs[RANGE], totals, SEG, jec.RANGE)
    whole = [jpd.decode_block_tpu(s, n, SEG) for s, n in zip(segs[0],
                                                            totals)]
    assert ranged == whole == blocks
    return ranged, whole


@pytest.mark.parametrize("road", ["fast", "scheduled", "whole"])
def test_decode_planned_matches_jax(corpus_segs, jax_decoded, road):
    blocks, segs = corpus_segs
    totals = [len(b) for b in blocks]
    if road == "whole":
        plan = tec.plan_batch(segs[0], SEG, 0)
        out = teb.decode_planned_whole(plan, "cpu")
        want = jax_decoded[1]
    else:
        plan = tec.plan_batch(segs[RANGE], SEG, RANGE)
        out = tec.decode_planned(plan, "cpu", road, plan.tensors("cpu"))
        want = jax_decoded[0]
    assert out.dtype == torch.uint8 and out.numel() == plan.total_out
    assert tec.trim_blocks(plan, out, totals) == want


@pytest.mark.parametrize("rng", [RANGE, 0])
def test_executors_read_nothing_past_the_total(corpus_segs, rng):
    """Columns past the total hold anything: filled with hostile words,
    the plain executors (K3's, the append-only one's, the whole-block
    one's) and the tiled model of the kernels' resolution give the same
    bytes."""
    _, segs = corpus_segs
    plan = tec.plan_batch(segs[rng], SEG, rng)
    t, recs, counts = _parsed(plan)
    crec, lane_out, total = tec.compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    n = int(total)
    assert n < crec.shape[1]
    junk = crec.clone()
    junk[:, n:] = torch.tensor([0, I32.max, I32.max, 1, -1],
                               dtype=torch.int32)[:, None]
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    common = (first, t["range_out"], t["range_span"], t["comp"],
              plan.total_out)
    if not rng:
        want = teb.execute_blocks(crec, *common)
        assert torch.equal(teb.execute_blocks(junk, *common), want)
        assert torch.equal(trm.execute_blocks_tiled(junk, *common)[0], want)
        return
    want = tec.execute_ranges(crec, *common, plan.max_span)
    assert torch.equal(tec.execute_ranges(junk, *common, plan.max_span),
                       want)
    assert torch.equal(
        trm.execute_ranges_tiled(junk, *common, plan.max_span)[0], want)
    assert torch.equal(
        tec.execute_scheduled(junk[1:], *common, plan.max_span), want)


def test_the_plan_checks_its_ranges():
    """The check range_args made on the card is made on the plan's numpy
    arrays when the plan is made: a range outside the output raises
    ValueError there, and check_spans raises on such tensors."""
    plan = tec.plan_batch([[b"ab", b"cd"], [b"ef"]], SEG, SEG)
    fields = dict(plan.__dict__)
    for key, bad in (("range_out", plan.range_out - 1),
                     ("range_span", plan.range_span + 1)):
        with pytest.raises(ValueError, match="outside the output"):
            tec.BatchPlan(**{**fields, key: bad})
        args = {"range_out": plan.range_out, "range_span": plan.range_span,
                key: bad}
        with pytest.raises(ValueError, match="outside the output"):
            tec.check_spans(torch.from_numpy(args["range_out"]),
                            torch.from_numpy(args["range_span"]),
                            plan.total_out)
    tec.BatchPlan(**fields)
    tec.check_spans(torch.from_numpy(plan.range_out),
                    torch.from_numpy(plan.range_span), plan.total_out)
