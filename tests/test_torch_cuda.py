"""Card-only checks: each CUDA kernel of the port against its plain torch
version, bit for bit, on a small decode batch (encoded with the range clamp
for the range road, without it for the whole-block road).  Skipped without a GPU;
chip_smoke.py runs the same comparison at the main path's shapes."""

import numpy as np
import pytest
import torch

from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.ops import exec_block as teb
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops.device_codec import RANGE, split_body
from minlz_tpu_torch.ops.encode_kernel import encode_blocks_device
from minlz_tpu_torch.ops import resolve_model as trm
from minlz_tpu_torch.ops.parse import parse_segments, parse_segments_plain
from minlz_tpu_torch.testing import (HOSTILE_RECORDS, HOSTILE_SPAN,
                                     RECORD_KINDS, record_batch)

pytestmark = pytest.mark.cuda


def _stages(twain, rng_bytes):
    """The small three-block batch, encoded on the card with the given
    range clamp (0: none), planned with it, parsed and compacted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(11)
    blocks = [(twain * 20)[: 200 << 10], bytes(40 << 10),
              rng.integers(0, 8, 70 << 10, dtype=np.uint8).tobytes()]
    segs = []
    for b, (blk, hints) in zip(
            blocks, encode_blocks_device(blocks, 4096, rng_bytes, 2, "cuda")):
        _, _, pos = odec.parse_header(blk)
        segs.append(split_body(blk[pos:], [h[0] for h in hints]))
    plan = tec.plan_batch(segs, 4096, rng_bytes)
    t = plan.tensors("cuda")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = tec.compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    return blocks, segs, plan, t, recs, counts, crec, lane_out, total


@pytest.fixture(scope="module")
def stages(twain):
    return _stages(twain, RANGE)


@pytest.fixture(scope="module")
def whole_stages(twain):
    return _stages(twain, 0)


def _same_records(kernel, plain):
    """A compaction's (out, lane_out, total) against its plain version's:
    the same capacity, lane offsets and total, and the same first total
    columns (those past it are unspecified)."""
    out, lane_out, total = kernel
    out_p, lane_out_p, total_p = plain
    n = int(total)
    assert out.shape == out_p.shape
    assert torch.equal(lane_out, lane_out_p) and torch.equal(total, total_p)
    assert torch.equal(out[:, :n], out_p[:, :n])


def test_parse_kernel_matches_plain(stages):
    _, _, _, t, recs, counts, _, _, _ = stages
    recs_p, counts_p = parse_segments_plain(t["comp"], t["lane_start"],
                                            t["lane_len"])
    assert torch.equal(counts, counts_p)
    assert torch.equal(recs, recs_p)


def test_compact_kernel_matches_plain(stages):
    _, _, _, t, recs, counts, crec, lane_out, total = stages
    _same_records((crec, lane_out, total), tec.compact_records_plain(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"]))


def test_exec_kernel_matches_plain(stages):
    blocks, segs, plan, t, _, _, crec, lane_out, total = stages
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    args = (crec, first, t["range_out"], t["range_span"], t["comp"],
            plan.total_out, plan.max_span)
    out = tec.execute_ranges(*args)
    assert torch.equal(out, tec.execute_ranges_plain(*args))
    got = tec.decode_blocks_chained(segs, [len(b) for b in blocks], 4096,
                                    RANGE, "cuda")
    torch.cuda.synchronize()
    assert got == blocks


def test_whole_block_compaction_matches_plain(whole_stages):
    """The compaction kernel at whole-block lane spans (the v1 compaction)."""
    _, _, plan, t, recs, counts, crec, lane_out, total = whole_stages
    assert plan.rng == 0 and len(plan.range_span) == 3
    _same_records((crec, lane_out, total), tec.compact_records_plain(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"]))


def test_block_executor_matches_plain(whole_stages):
    blocks, segs, plan, t, _, _, crec, lane_out, total = whole_stages
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    args = (crec, first, t["range_out"], t["range_span"], t["comp"],
            plan.total_out)
    out = teb.execute_blocks(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, teb.execute_blocks_plain(*args))
    got = teb.decode_blocks_whole(segs, [len(b) for b in blocks], 4096,
                                  "cuda")
    torch.cuda.synchronize()
    assert got == blocks


def test_dense_compaction_matches_plain(stages):
    _, _, _, t, recs, counts, crec, lane_out, total = stages
    args = (recs, counts, t["lane_start"], t["lane_len"])
    dense = tec.compact_records_dense(*args)
    _same_records(dense, tec.compact_records_dense_plain(*args))
    n = int(total)
    assert torch.equal(dense[2], total)
    # A valid stream: the same records.
    assert torch.equal(dense[0][:, :n], crec[1:, :n])


def test_scheduled_executor_matches_plain(stages):
    blocks, segs, plan, t, recs, counts, crec, lane_out, total = stages
    drec, _, _ = tec.compact_records_dense(recs, counts, t["lane_start"],
                                           t["lane_len"])
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    common = (first, t["range_out"], t["range_span"], t["comp"],
              plan.total_out, plan.max_span)
    out = tec.execute_scheduled(drec, *common)
    torch.cuda.synchronize()
    assert torch.equal(out, tec.execute_scheduled_plain(drec, *common))
    assert torch.equal(out, tec.execute_ranges(crec, *common))
    got = tec.decode_blocks_chained(segs, [len(b) for b in blocks], 4096,
                                    RANGE, "cuda", executor="scheduled")
    torch.cuda.synchronize()
    assert got == blocks


@pytest.mark.parametrize("lanes", [0, 1, 4095, 4096, 4097, 10000])
def test_lane_offset_scan_matches_plain(lanes):
    """The one-block scan loops over chunks of 4096 counts: offsets and
    total equal the plain cumsum's at chunk edges and past them, with
    counts up to 2^31 - 1 (the int64 sums do not wrap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = np.random.default_rng(lanes)
    counts = g.integers(0, 5000, lanes).astype(np.int32)
    counts[::97] = np.iinfo(np.int32).max
    counts = torch.from_numpy(counts)
    lane_out, total = tec.lane_offsets(counts.cuda())
    torch.cuda.synchronize()
    want_out, want_total = tec.lane_offsets_plain(counts)
    assert torch.equal(lane_out.cpu(), want_out)
    assert torch.equal(total.cpu(), want_total)


def _compactions_vs_plain(plan):
    """Both compaction kernels against their plain versions on a plan:
    the positioned one at the plan's lane spans, the dense one."""
    t = plan.tensors("cuda")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    lanes = (t["lane_start"], t["lane_len"], t["lane_lo"], t["lane_hi"])
    _same_records(tec.compact_records(recs, counts, *lanes),
                  tec.compact_records_plain(recs, counts, *lanes))
    _same_records(tec.compact_records_dense(recs, counts, *lanes[:2]),
                  tec.compact_records_dense_plain(recs, counts, *lanes[:2]))


@pytest.mark.parametrize("rng_bytes", [RANGE, 0])
def test_compaction_kernels_on_mutated_input(stages, rng_bytes):
    """Mutated segment bytes (bit flips, truncations, splices, huge
    varints) give hostile records: kernel == plain version at range spans
    and at whole-block spans, and on the dense road."""
    from minlz_tpu_torch.testing import mutate

    _, segs, _, _, _, _, _, _, _ = stages
    g = np.random.default_rng(41)
    for _ in range(6):
        bad = [[mutate(g, s) if g.random() < 0.3 else s for s in blk]
               for blk in segs]
        _compactions_vs_plain(tec.plan_batch(bad, 4096, rng_bytes))


def test_unwritten_columns_reach_no_executor(stages, whole_stages):
    """The compaction leaves columns past the total unwritten: with those
    columns filled with hostile words, K3, the append-only executor and
    the whole-block executor give the same bytes, as they read only
    [range_first[r], range_first[r + 1])."""
    for st, whole in ((stages, False), (whole_stages, True)):
        _, _, plan, t, recs, counts, crec, lane_out, total = st
        n = int(total)
        assert n < crec.shape[1]
        junk = crec.clone()
        junk[:, n:] = torch.tensor([0, 2 ** 31 - 1, 2 ** 31 - 1, 1, -1],
                                   dtype=torch.int32, device="cuda")[:, None]
        first = tec.range_firsts(lane_out, total, t["range_lane"])
        common = (first, t["range_out"], t["range_span"], t["comp"],
                  plan.total_out)
        if whole:
            assert torch.equal(teb.execute_blocks(junk, *common),
                               teb.execute_blocks(crec, *common))
            continue
        assert torch.equal(tec.execute_ranges(junk, *common, plan.max_span),
                           tec.execute_ranges(crec, *common, plan.max_span))
        assert torch.equal(
            tec.execute_scheduled(junk[1:].contiguous(), *common,
                                  plan.max_span),
            tec.execute_scheduled(crec[1:].contiguous(), *common,
                                  plan.max_span))


def test_decode_roads_do_not_synchronise(stages, whole_stages):
    """From plan tensors already on the card to the decoded tensor, the
    three roads make no synchronising call (torch's sync debug mode
    raises on one)."""
    blocks, _, plan, t, _, _, _, _, _ = stages
    _, _, plan_w, tw, _, _, _, _, _ = whole_stages
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tec.decode_planned(plan, "cuda", "fast", t),
                tec.decode_planned(plan, "cuda", "scheduled", t),
                teb.decode_planned_whole(plan_w, "cuda", tw)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [len(b) for b in blocks]
    for p, out in zip((plan, plan, plan_w), outs):
        assert tec.trim_blocks(p, out, want) == blocks


def test_hostile_records_kernels_match_plain():
    """Random int32 records, as no compaction would leave them: the
    append-only kernel and the dense compaction clamp as their plain
    versions do, with no fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = np.random.default_rng(5)
    n, R, span = 5000, 7, 8192
    info = np.iinfo(np.int32)
    drec = g.integers(info.min, info.max, (4, n), dtype=np.int64)
    tame = g.random((4, n)) < 0.9
    drec = np.where(tame, g.integers(-2, 60, (4, n)), drec).astype(np.int32)
    comp = torch.from_numpy(g.integers(0, 256, 3000, dtype=np.uint8))
    cuts = np.sort(g.integers(0, n, R - 1))
    first = torch.tensor([0, *cuts, n], dtype=torch.int64)
    r_out = torch.arange(R, dtype=torch.int64) * span
    r_span = torch.full((R,), span, dtype=torch.int32)
    r_span[-1] = 100
    # The ranges tile the output: bytes outside every range are not written.
    args = (first, r_out, r_span, comp, (R - 1) * span + 100, span)
    out = tec.execute_scheduled(torch.from_numpy(drec).cuda(),
                                *(a.cuda() if torch.is_tensor(a) else a
                                  for a in args))
    torch.cuda.synchronize()
    want = tec.execute_scheduled_plain(torch.from_numpy(drec), *args)
    assert torch.equal(out.cpu(), want)

    lanes = 40
    lane_len = torch.from_numpy(g.integers(0, 200, lanes).astype(np.int32))
    lane_start = (torch.cumsum(lane_len, 0) - lane_len).to(torch.int32)
    slots = int(lane_len.sum()) + lanes
    recs = np.where(g.random((7, slots)) < 0.8,
                    g.integers(-3, 300, (7, slots)),
                    g.integers(info.min, info.max, (7, slots),
                               dtype=np.int64)).astype(np.int32)
    counts = torch.from_numpy(
        g.integers(0, lane_len.numpy() + 2).astype(np.int32))
    cargs = (torch.from_numpy(recs), counts, lane_start, lane_len)
    dense = tec.compact_records_dense(*(a.cuda() for a in cargs))
    torch.cuda.synchronize()
    _same_records([x.cpu() for x in dense],
                  tec.compact_records_dense_plain(*cargs))
    # The positioned compaction on the same records, with random lane spans:
    # starts and ends past int32, negative lengths, the keep test's carry
    # across chunks of 32.
    lo = torch.from_numpy(g.integers(0, 5000, lanes).astype(np.int32))
    hi = lo + torch.from_numpy(g.integers(0, 5000, lanes).astype(np.int32))
    pargs = cargs + (lo, hi)
    positioned = tec.compact_records(*(a.cuda() for a in pargs))
    torch.cuda.synchronize()
    _same_records([x.cpu() for x in positioned],
                  tec.compact_records_plain(*pargs))


# ---- the parallel resolution on records made for it ------------------------

def _batch_on_card(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return tuple(torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                 else a for a in batch)


@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_range_kernel_on_synthetic_records(kind):
    """Deep chains, 4 KiB literal and RLE records, 2-4 byte records; spans
    of 0, below a sub-tile, no multiple of 16 or of the sub-tile."""
    spans = [RANGE, 0, 37, (32 << 10) + 13, RANGE - 1, 100_000]
    args = _batch_on_card(record_batch(kind, spans, seed=3))
    out = tec.execute_ranges(*args, RANGE)
    torch.cuda.synchronize()
    assert torch.equal(out, tec.execute_ranges_plain(*args, RANGE))


@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_block_kernel_on_synthetic_records(kind):
    """The same kinds at block spans that are no multiple of the tile;
    ``far`` copies across every tile boundary.  The kernel's tile phase and
    the tiled torch model leave the same number of residual bytes."""
    spans = [(1 << 20) + 1000, 0, 37, 3 * trm.TILE - 5, 200_000]
    args = _batch_on_card(record_batch(kind, spans, seed=4))
    out = teb.execute_blocks(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, teb.execute_blocks_plain(*args))
    model, info = trm.execute_blocks_tiled(*args)
    assert torch.equal(out, model)
    x_args = tec.range_args("execute_blocks", args[0], 5, *args[1:5],
                            args[5])
    out2 = torch.empty_like(out)
    scratch = teb.blocks_scratch(x_args, out2)
    teb.launch_blocks(x_args, out2, scratch, teb.TILES)
    torch.cuda.synchronize()
    assert int((scratch[: args[5]] >= 0).sum()) == info["residual"]
    if kind == "far":
        assert info["residual"] > 0 and info["hops"] >= 7
    teb.launch_blocks(x_args, out2, scratch, teb.FIXUP)
    torch.cuda.synchronize()
    assert torch.equal(out2, out)


def test_positioned_kernels_on_hostile_records():
    """Fields outside every bound, inside the executors' contract: both
    kernels clamp as the plain version does, with no fault; also with an
    empty comp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = np.random.default_rng(9)
    crec = torch.tensor(HOSTILE_RECORDS * 2, dtype=torch.int32).T.contiguous()
    n = len(HOSTILE_RECORDS)
    for comp in (g.integers(0, 256, 2048, dtype=np.uint8),
                 np.zeros(0, np.uint8)):
        args = (crec.cuda(), torch.tensor([0, n, 2 * n]).cuda(),
                torch.tensor([0, HOSTILE_SPAN]).cuda(),
                torch.tensor([HOSTILE_SPAN, HOSTILE_SPAN - 3],
                             dtype=torch.int32).cuda(),
                torch.from_numpy(comp).cuda(), 2 * HOSTILE_SPAN - 3)
        want = tec.execute_ranges_plain(*args, HOSTILE_SPAN)
        got = tec.execute_ranges(*args, HOSTILE_SPAN)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        got = teb.execute_blocks(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_greedy_kernel_matches_plain():
    """Real proposals and hostile int32, all four outputs, tolerance 0."""
    from minlz_tpu_torch.ops import greedy as tg

    from test_torch_common import random_proposals, real_proposals

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    with open(__file__, "rb") as f:
        text = f.read() * 40
    for off, length in (real_proposals(text[: 128 << 10]),
                        random_proposals(4, 300, 1000, hostile=True),
                        random_proposals(5, 33, 4096, hostile=False)):
        seg = off.shape[1]
        toff = torch.from_numpy(off).cuda()
        tlen = torch.from_numpy(length).cuda()
        kern = tg.greedy_parse(toff, tlen, seg)
        torch.cuda.synchronize()
        plain = tg.greedy_parse_plain(torch.from_numpy(off),
                                      torch.from_numpy(length), seg)
        for k, p in zip(kern, plain):
            assert torch.equal(k.cpu(), p)
        assert int(kern[0].sum()) > 0


# ---- kernel 8 across its windows --------------------------------------------

GREEDY_SEGS = [1000, 1003, 4096, 16384]


def _greedy_lanes(seg):
    """The edge cases of test_torch_common.greedy_edge_cases and random
    lanes, stacked: an odd lane count (one thread block a lane)."""
    from test_torch_common import greedy_edge_cases, random_proposals

    parts = list(greedy_edge_cases(seg).values())
    parts.append(random_proposals(seg, 5, seg, hostile=False))
    parts.append(random_proposals(seg + 1, 4, seg, hostile=True))
    off, length = (np.concatenate(a) for a in zip(*parts))
    if off.shape[0] % 2 == 0:
        off, length = off[1:], length[1:]
    return np.ascontiguousarray(off), np.ascontiguousarray(length)


def _greedy_plain(off, length):
    from minlz_tpu_torch.ops import greedy as tg

    return torch.stack(tg.greedy_parse_plain(
        torch.from_numpy(off), torch.from_numpy(length), off.shape[1]))


@pytest.mark.parametrize("seg", GREEDY_SEGS)
def test_greedy_kernel_on_edge_cases(seg):
    """No candidate, every length 4, a first offset of -1, lengths of
    2^31 - 1 and -2^31, tokens ending on and crossing window boundaries,
    random and hostile lanes; seg 1003 takes the scalar loads of rows that
    are not 16-byte aligned.  All four outputs equal the plain version's
    and the windowed model's."""
    from minlz_tpu_torch.ops import greedy as tg
    from minlz_tpu_torch.ops import greedy_model as gm

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    off, length = _greedy_lanes(seg)
    kern = tg.greedy_parse(torch.from_numpy(off).cuda(),
                           torch.from_numpy(length).cuda(), seg)
    torch.cuda.synchronize()
    want = _greedy_plain(off, length)
    assert torch.equal(torch.stack(kern).cpu(), want)
    model, _ = gm.greedy_parse_model(torch.from_numpy(off),
                                     torch.from_numpy(length), seg)
    assert torch.equal(torch.stack(model), want)


def test_greedy_launch_writes_every_element():
    """launch_greedy into an output filled with 0x7f7f7f7f: every element
    comes out right, so the wrapper needs no zero fill."""
    from minlz_tpu_torch.ops import greedy as tg

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    for seg in (4096, 1003):
        off, length = _greedy_lanes(seg)
        out = torch.full((4, off.shape[0], seg), 0x7F7F7F7F,
                         dtype=torch.int32, device="cuda")
        tg.launch_greedy(torch.from_numpy(off).cuda(),
                         torch.from_numpy(length).cuda(), seg, out)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), _greedy_plain(off, length))


def test_greedy_kernel_on_unaligned_rows():
    """Contiguous inputs that start 4 bytes past a 16-byte boundary."""
    from minlz_tpu_torch.ops import greedy as tg

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    off, length = _greedy_lanes(4096)
    lanes, seg = off.shape

    def shifted(a):
        flat = torch.from_numpy(np.concatenate([[7], a.ravel()])
                                .astype(np.int32)).cuda()
        return flat[1:].view(lanes, seg)

    toff, tlen = shifted(off), shifted(length)
    assert toff.is_contiguous() and toff.data_ptr() % 16 != 0
    kern = tg.greedy_parse(toff, tlen, seg)
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(kern).cpu(), _greedy_plain(off, length))


def test_greedy_wrapper_rejects_on_the_card():
    """The checks of greedy._check hold for CUDA tensors too."""
    from minlz_tpu_torch.ops import greedy as tg

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    off = torch.zeros((4, 64), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        tg.greedy_parse(off.to(torch.int64), off, 64)
    with pytest.raises(ValueError, match=r"\[B, 32\]"):
        tg.greedy_parse(off, off, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tg.greedy_parse(off.t().contiguous().t(), off, 64)
    with pytest.raises(ValueError, match="int32"):
        tg.greedy_parse(off[0], off[0], 64)
    with pytest.raises(ValueError, match="off is on"):
        tg.greedy_parse(off, off.cpu(), 64)


# ---- the emit kernel ------------------------------------------------------

EMIT_REAL = ["corpus-" + c for c in ("json", "lowent", "partial_tail", "runs",
                                     "text")]
EMIT_REAL += ["seg-8192", "seg-16384", "partial_empty", "ctx1"]
EMIT_SYNTH = [f"{c}-{seg}" for c in ("lit_runs", "rep_across_tiles", "fused",
                                     "copy1_long", "copy3_far", "random_mix")
              for seg in (4096, 8192, 16384)]


def emit_inputs(case, twain, dev):
    """(data, surv, off, vlen, n, seg) of an emit_segments call on ``dev``.
    Real cases run the encoder's stages before emission on ``dev``
    (match find, greedy parse, verify): the corpora of
    tests/test_torch_emit.py at 4 KiB segments, 256 KiB of text at 8 and
    16 KiB, blocks of unequal length (a partial last segment, empty
    trailing ones), and a first segment of context (``ctx = 1``: column
    slices, as encode_block_emit passes them).  Synthetic cases are
    test_torch_common.emit_edge_case."""
    from minlz_tpu_torch.ops import emit
    from minlz_tpu_torch.ops import encode_kernel as tek
    from minlz_tpu_torch.ops import greedy as tg
    from test_torch_common import emit_corpus, emit_edge_case, pad_block

    name, _, arg = case.partition("-")
    if case not in EMIT_REAL:
        data, surv, off, vlen, n = emit_edge_case(name, int(arg))
        t = [torch.from_numpy(a).to(dev) for a in (data, surv, off, vlen, n)]
        return (*t, int(arg))
    seg, ctx = 4096, 0
    if name == "corpus":
        blocks = [emit_corpus(twain, arg)]
    elif name == "seg":
        seg = int(arg)
        blocks = [(twain * 6)[: 256 << 10]]
    elif name == "partial_empty":
        blocks = [(twain * 6)[: 64 << 10], twain[:20000], twain[7000:12000]]
    else:
        ctx = 1
        blocks = [(twain * 6)[: 64 << 10], twain[:30000]]
    N = max(pad_block(b, seg)[0].shape[1] for b in blocks)
    arr = np.zeros((len(blocks), N), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    data = torch.from_numpy(arr).to(dev)
    n = torch.tensor([len(b) for b in blocks], dtype=torch.int32, device=dev)
    dist, length = tek.find_matches_dyn(data, n, seg, 0, 2)
    take, tok_off, _, _ = tg.greedy_parse(
        dist.to(torch.int32).reshape(-1, seg),
        length.to(torch.int32).reshape(-1, seg), seg)
    take, tok_off = take.reshape(data.shape), tok_off.reshape(data.shape)
    surv, vlen = emit.verify_extend(data, take, tok_off, n, seg)
    C = ctx * seg
    return data[:, C:], surv[:, C:], tok_off[:, C:], vlen[:, C:], n - C, seg


@pytest.mark.parametrize("case", EMIT_REAL + EMIT_SYNTH)
def test_emit_kernel_matches_plain(twain, case):
    """emit_segments on CUDA (one launch of the emit kernel, no call that
    synchronises with the host) against emit_segments_plain on the same
    CUDA inputs, bit for bit: out, zeros after each length included, and
    out_lens; the bare launch into outputs filled with 0x7f gives the same
    (every element is written)."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import emit

    _need_gpu()
    data, surv, off, vlen, n, seg = emit_inputs(case, twain, "cuda")
    if case == "ctx1":
        assert not data.is_contiguous()
    before = _build.launch_counts()["emit"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, lens = emit.emit_segments(data, surv, off, vlen, n, seg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.launch_counts()["emit"] == before + 1
    want_out, want_lens = emit.emit_segments_plain(data, surv, off, vlen, n,
                                                   seg)
    assert out.dtype == torch.uint8 and lens.dtype == torch.int32
    assert torch.equal(lens, want_lens)
    assert torch.equal(out, want_out)
    assert int(surv.sum()) > 0 and int(lens.max()) <= seg + emit.OUT_PAD

    raw = torch.full_like(out, 0x7F)
    raw_lens = torch.full_like(lens, 0x7F7F7F7F)
    emit.launch_emit(data.contiguous(),
                     *(t.contiguous() for t in (surv, off, vlen, n)), seg,
                     raw, raw_lens)
    torch.cuda.synchronize()
    assert torch.equal(raw, want_out) and torch.equal(raw_lens, want_lens)


def test_emit_counters_on_the_card(twain):
    """encode_block_emit on CUDA: one emit launch a call, and under a
    profiler every segment row counted as the kernel's, none as the plain
    version's."""
    from torch.profiler import ProfilerActivity, profile

    from minlz_tpu_torch import _build, trace
    from minlz_tpu_torch.ops import emit

    _need_gpu()
    flat = np.zeros((3, 32768), np.uint8)
    flat[0] = np.frombuffer((twain * 3)[:32768], np.uint8)
    flat[1, :9000] = np.frombuffer(twain[:9000], np.uint8)
    data = torch.from_numpy(flat).cuda()
    before = _build.launch_counts()["emit"]
    for k in range(2):
        emit.encode_block_emit(data, [32768, 9000, 1], 4096)
        assert _build.launch_counts()["emit"] == before + k + 1
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        emit.encode_block_emit(data, [32768, 9000, 1], 4096)
    counters = trace.snapshot()["counters"]
    trace.reset()
    assert counters["emit.kernel_rows"] == 3 * 8
    assert counters.get("emit.plain_rows", 0) == 0


def test_emit_kernel_attrs():
    """The card takes a block of the kernel at every segment size the codec
    uses, several to an SM."""
    from minlz_tpu_torch.ops import emit

    _need_gpu()
    for seg in (4096, 8192, 16384):
        a = emit.kernel_attrs(seg)
        assert a["threads"] == 256 and a["blocks_per_sm"] >= 2, a
        assert a["shared_bytes"] >= 2 * seg + emit.OUT_PAD, a


# ---- the probe kernels ----------------------------------------------------

def _cuda(*arrays):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


def _same(kernel_out, plain_out):
    torch.cuda.synchronize()
    assert torch.equal(kernel_out.cpu(), plain_out.cpu())


@pytest.mark.parametrize("space,rows", [("shared", 256), ("global", 1024)])
def test_probe_scalar_kernel_matches_plain(space, rows):
    from minlz_tpu_torch.ops import probe

    for n_chains in (1, 5, 32):
        steps, buf = _cuda(*probe.scalar_inputs(300, n_chains, rows,
                                                fill=True))
        _same(probe.probe_scalar(steps, buf, n_chains, space),
              probe.probe_scalar_plain(steps, buf, n_chains))


@pytest.mark.parametrize("space,rows", [("shared", 256), ("global", 1024)])
def test_probe_chain_body_kernel_matches_plain(space, rows):
    from minlz_tpu_torch.ops import probe

    for n_chains in (1, 5, 32):
        meta, buf = _cuda(*probe.chain_body_inputs(70, n_chains, rows,
                                                   fill=True))
        for mode in ("minimal", "realign"):
            _same(probe.probe_chain_body(meta, buf, n_chains, mode, space),
                  probe.probe_chain_body_plain(meta, buf, n_chains, mode))


@pytest.mark.parametrize("n_chains", [16, 32])
def test_probe_chain_body_kernel_at_4096_rows_in_shared_memory(n_chains):
    """The JAX script's 4096 rows in the shared space: a block a chain,
    each staging its region of 256 or 128 rows."""
    from minlz_tpu_torch.ops import probe

    meta, buf = _cuda(*probe.chain_body_inputs(300, n_chains, 4096,
                                               fill=True))
    for mode in ("minimal", "realign"):
        _same(probe.probe_chain_body(meta, buf, n_chains, mode, "shared"),
              probe.probe_chain_body_plain(meta, buf, n_chains, mode))


@pytest.mark.parametrize("space", ["shared", "global"])
@pytest.mark.parametrize("n_chains,rows", [(4, 64), (5, 83), (16, 4096)])
def test_probe_chain_body_kernel_off_its_region(space, n_chains, rows):
    """Chains that own disjoint rows but stray into the next chain's region
    (and past the last region): those rows are walked in device memory and
    stay exact."""
    from minlz_tpu_torch.ops import probe

    from test_torch_probe import strayed

    meta, buf = probe.chain_body_inputs(300, n_chains, rows, fill=True)
    meta, buf = _cuda(strayed(meta, rows, n_chains), buf)
    for mode in ("minimal", "realign"):
        _same(probe.probe_chain_body(meta, buf, n_chains, mode, space),
              probe.probe_chain_body_plain(meta, buf, n_chains, mode))


@pytest.mark.parametrize("space", ["shared", "global"])
def test_probe_chain_body_kernel_clamps_wild_rows(space):
    """Row numbers below 0 in chain 0 and past the buffer in the last chain
    (each clamps into its own chain's rows), offsets of any sign."""
    from minlz_tpu_torch.ops import probe

    n_chains, rows, n_ops = 4, 96, 200
    meta, buf = probe.chain_body_inputs(n_ops, n_chains, rows, fill=True)
    steps = meta.reshape(n_chains, n_ops, 3)
    g = np.random.default_rng(5)
    steps[0, ::7, :2] = g.integers(-(1 << 31), 0, (len(steps[0, ::7]), 2))
    steps[-1, ::5, :2] = g.integers(rows, 1 << 31, (len(steps[-1, ::5]), 2))
    steps[:, ::3, 2] = g.integers(-(1 << 31), 1 << 31, (n_chains,
                                                        len(steps[0, ::3])))
    meta, buf = _cuda(steps.reshape(-1).copy(), buf)
    for mode in ("minimal", "realign"):
        _same(probe.probe_chain_body(meta, buf, n_chains, mode, space),
              probe.probe_chain_body_plain(meta, buf, n_chains, mode))


def test_probe_chain_body_wrapper_rejects_on_the_card():
    from minlz_tpu_torch.ops import probe

    meta, buf = _cuda(*probe.chain_body_inputs(8, 8, 4096, fill=True))
    with pytest.raises(ValueError, match="region of 512 rows"):
        probe.probe_chain_body(meta, buf, 8, space="shared")
    counts, ops, arena = _cuda(*probe.ablate_inputs(1, 20, 455, fill=True))
    with pytest.raises(ValueError, match="region of 455 rows"):
        probe.ablate_exec(counts, ops, arena, chain_rows=455)


def test_probe_gather_kernel_matches_plain():
    from minlz_tpu_torch.ops import probe

    for vregs in (1, 4, 9):
        tbl, idx = _cuda(*probe.gather_inputs(37, vregs, wrap=True))
        idx[3, 5], idx[9, 0] = -4, 1 << 30        # clamped, no fault
        _same(probe.probe_gather(tbl, idx),
              probe.probe_gather_plain(tbl, idx))


@pytest.mark.parametrize("n_chains", [1, 2, 4, 8, 16])
def test_probe_scalar_kernel_at_4096_rows_in_shared_memory(n_chains):
    """The JAX script's 4096 rows in the shared space: a block a chain at
    16 chains, a cluster of 2, 4, 8 or 16 blocks a chain below, the whole
    buffer compared."""
    from minlz_tpu_torch.ops import probe

    steps, buf = _cuda(*probe.scalar_inputs(300, n_chains, 4096, fill=True))
    _same(probe.probe_scalar(steps, buf, n_chains, "shared"),
          probe.probe_scalar_plain(steps, buf, n_chains))
    assert probe.LAUNCHED["probe_scalar"] == probe.scalar_plan(
        4096, n_chains, "shared")


@pytest.mark.parametrize("space", ["shared", "global"])
@pytest.mark.parametrize("n_chains,rows", [(2, 4096), (16, 4096), (5, 83)])
def test_probe_scalar_kernel_off_its_region(space, n_chains, rows):
    """Chains that own disjoint rows but stray into the next chain's region
    (and past the last region): those rows are walked in device memory and
    stay exact, in a cluster too."""
    from minlz_tpu_torch.ops import probe

    from test_torch_probe import strayed

    steps, buf = probe.scalar_inputs(300, n_chains, rows, fill=True)
    steps, buf = _cuda(strayed(steps, rows, n_chains, per_step=2), buf)
    _same(probe.probe_scalar(steps, buf, n_chains, space),
          probe.probe_scalar_plain(steps, buf, n_chains))


@pytest.mark.parametrize("space", ["shared", "global"])
@pytest.mark.parametrize("n_chains,rows", [(4, 96), (2, 4096)])
def test_probe_scalar_kernel_clamps_wild_rows(space, n_chains, rows):
    """Row numbers below 0 in chain 0 and past the buffer in the last chain
    (each clamps into its own chain's rows)."""
    from minlz_tpu_torch.ops import probe

    n_ops = 200
    steps, buf = probe.scalar_inputs(n_ops, n_chains, rows, fill=True)
    steps = steps.reshape(n_chains, n_ops, 2)
    g = np.random.default_rng(6)
    steps[0, ::7] = g.integers(-(1 << 31), 0, (len(steps[0, ::7]), 2))
    steps[-1, ::5] = g.integers(rows, 1 << 31, (len(steps[-1, ::5]), 2))
    steps, buf = _cuda(steps.reshape(-1).copy(), buf)
    _same(probe.probe_scalar(steps, buf, n_chains, space),
          probe.probe_scalar_plain(steps, buf, n_chains))


@pytest.mark.parametrize("space", ["shared", "global"])
def test_probe_scalar_kernel_alias_heavy(space):
    """Regions of 3 rows, and every other step reads the row the step
    before stored."""
    from minlz_tpu_torch.ops import probe

    from test_torch_probe import alias_heavy

    for n_chains in (1, 7, 32):
        steps, buf = probe.scalar_inputs(300, n_chains, 3 * n_chains,
                                         fill=True)
        steps, buf = _cuda(alias_heavy(steps, n_chains, 3 * n_chains), buf)
        _same(probe.probe_scalar(steps, buf, n_chains, space),
              probe.probe_scalar_plain(steps, buf, n_chains))


def test_probe_scalar_wrapper_rejects_on_the_card():
    """A region that needs more than 16 blocks of shared memory is refused,
    not walked in device memory."""
    from minlz_tpu_torch.ops import probe

    steps, buf = _cuda(*probe.scalar_inputs(8, 1, 16 * 453 + 1, fill=True))
    with pytest.raises(ValueError, match="more than 16"):
        probe.probe_scalar(steps, buf, 1, space="shared")


@pytest.mark.parametrize("n_iters", [1, 37, 257])
@pytest.mark.parametrize("tbl_rows", [1, 8, 33, 72])
def test_probe_gather_kernel_ragged(tbl_rows, n_iters):
    """Tables of 1 to 72 rows (72: the script's 9 vregs), iteration counts
    that leave blocks with one, two or no iterations, indices clamped from
    below 0 and past the table."""
    from minlz_tpu_torch.ops import probe

    g = np.random.default_rng(tbl_rows + n_iters)
    tbl = probe._fill((tbl_rows, 128), tbl_rows)
    idx = g.integers(-9, tbl.size + 9, (8 * n_iters, 128), dtype=np.int32)
    tbl, idx = _cuda(tbl, idx)
    for _ in range(2):          # the second launch finds its tickets reset
        _same(probe.probe_gather(tbl, idx),
              probe.probe_gather_plain(tbl, idx))


def test_probe_gather_kernel_spreads_over_the_card():
    """The script's largest configuration launches more than one block,
    and the plan it launched is gather_plan's."""
    from minlz_tpu_torch.ops import probe

    tbl, idx = _cuda(*probe.gather_inputs(256, 9, wrap=True))
    _same(probe.probe_gather(tbl, idx), probe.probe_gather_plain(tbl, idx))
    plan = probe.LAUNCHED["probe_gather"]
    assert plan == probe.gather_plan(256, tbl.numel()) and plan.grid > 1


def test_probe_taa_kernel_matches_plain():
    from minlz_tpu_torch.ops import probe

    a, idx = _cuda(*probe.taa_inputs(37, wrap=True))
    idx[2, 7], idx[8, 127] = -1, 500
    _same(probe.probe_taa(a, idx), probe.probe_taa_plain(a, idx))


def _taa_wild(n_iters):
    """taa_inputs(n_iters, wrap=True) (full-range words, so the sums wrap)
    with every seventh position a full-range int32, clamped to 0 or 127."""
    from minlz_tpu_torch.ops import probe

    a, idx = probe.taa_inputs(n_iters, wrap=True)
    flat = idx.reshape(-1)
    flat[::7] = probe._fill(flat[::7].shape, 40 + n_iters)
    return _cuda(a, idx)


@pytest.mark.parametrize("n_iters", [0, 1, 37, 2048])
def test_probe_taa_kernel_at_every_split(n_iters):
    """No iteration (zeros), one (a block does it all), a ragged count and
    the script's 2048 (16 a block over 128 blocks), twice each: the second
    launch finds its tickets reset."""
    from minlz_tpu_torch.ops import probe

    a, idx = _taa_wild(n_iters)
    want = probe.probe_taa_plain(a, idx)
    for _ in range(2):
        _same(probe.probe_taa(a, idx), want)
    assert probe.LAUNCHED["probe_taa"] == probe.gather_plan(n_iters, 0)
    if n_iters == 2048:
        assert probe.LAUNCHED["probe_taa"][:2] == (128, 8)


def test_gathers_share_their_tickets_on_a_stream():
    """probe_gather and probe_taa in turn on one stream, four times each,
    on the one set of tickets: every launch leaves them at zero."""
    from minlz_tpu_torch.ops import probe

    tbl, g_idx = _cuda(*probe.gather_inputs(257, 9, wrap=True))
    a, t_idx = _taa_wild(2048)
    g_want = probe.probe_gather_plain(tbl, g_idx)
    t_want = probe.probe_taa_plain(a, t_idx)
    got = []
    for _ in range(4):
        got.append((probe.probe_gather(tbl, g_idx), g_want))
        got.append((probe.probe_taa(a, t_idx), t_want))
    for out, want in got:
        _same(out, want)
    tickets = probe.gather_tickets(a.device, probe._build.stream_of(a))
    assert not tickets.any()


@pytest.mark.parametrize("variant", ["full", "onewin", "norealign", "nomask",
                                     "minimal"])
def test_ablate_kernel_matches_plain(variant):
    from minlz_tpu_torch.ops import probe

    for nchain, n, chain_rows in ((1, 200, 8), (7, 700, 24), (32, 90, 4)):
        counts, ops, arena = probe.ablate_inputs(nchain, n, chain_rows,
                                                 fill=True)
        g = np.random.default_rng(nchain)
        pick = g.random((nchain, n)) < 0.1       # overlapping, longer copies
        ops[..., 0] = np.where(
            pick, g.integers(0, 40, (nchain, n))
            | (g.integers(10, 70, (nchain, n)) << 14), ops[..., 0])
        ops[..., 1] = np.where(pick, g.integers(1, 9, (nchain, n)),
                               ops[..., 1])
        counts[-1] = n // 2
        args = _cuda(counts, ops, arena)
        _same(probe.ablate_exec(*args, variant, chain_rows=chain_rows),
              probe.ablate_exec_plain(*args, variant,
                                      chain_rows=chain_rows))


@pytest.mark.parametrize("variant", ["full", "onewin", "norealign", "nomask",
                                     "minimal"])
def test_ablate_kernel_at_16_chains(variant):
    """The script's second chain count, regions of 128 rows (64 KiB) and of
    454 rows (the most a block's shared memory holds)."""
    from minlz_tpu_torch.ops import probe

    for nchain, n, chain_rows in ((16, 1500, 128), (2, 600, 454)):
        args = _cuda(*probe.ablate_inputs(nchain, n, chain_rows, fill=True))
        _same(probe.ablate_exec(*args, variant, chain_rows=chain_rows),
              probe.ablate_exec_plain(*args, variant,
                                      chain_rows=chain_rows))


# ---- K1 on lanes made to cross its windows ----------------------------------

def _copy_tokens(rng, n):
    """n random bytes with no literal-run tag: copy tokens back to back,
    so the chain runs the whole lane."""
    b = rng.integers(0, 256, n, dtype=np.uint8)
    b |= (b & 3 == 0) * rng.integers(1, 4, n, dtype=np.uint8)
    return b.tobytes()


def _parse_lanes(name):
    from test_torch_common import encode_segs

    rng = np.random.default_rng(17)
    tail, shift = b"", 0
    if name == "random":
        segs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (1, 7, 300, 2049, 4096)]
    elif name == "long":
        segs = [_copy_tokens(rng, n) for n in (2047, 2048, 2049, 6000)]
    elif name == "seg16k":
        with open(__file__, "rb") as f:
            text = f.read() * 8
        segs = encode_segs(text[: 48 << 10], 16 << 10, 0)
    else:
        # Lanes of 0 and 1 bytes among long ones, comp not 16-byte aligned
        # and longer than the lanes: bytes past the last lane are not its.
        segs = [_copy_tokens(rng, n) for n in (0, 1, 0, 3000, 1, 2063)]
        # A literal run ends the first window, the next window's copy takes
        # it, and a header cut short ends the lane: no flush is left.
        segs.append(b"\x05\x00" * 1020 + b"\xe8\x46" + bytes(100)
                    + b"\x05\x00\x02")
        tail, shift = b"\x02\xff\xff" * 9, 3
    lens = np.array([len(s) for s in segs], np.int32)
    start = (np.cumsum(lens) - lens).astype(np.int32)
    comp = np.frombuffer(bytes(shift) + b"".join(segs) + tail + b"\x00",
                         np.uint8).copy()
    return (torch.from_numpy(comp)[shift:], torch.from_numpy(start),
            torch.from_numpy(lens))


@pytest.mark.parametrize("name", ["random", "long", "seg16k", "tiling"])
def test_parse_kernel_on_window_crossing_lanes(name):
    """Random bytes, copy-token lanes across several windows, 16 KiB
    segments, and a hostile tiling (empty and 1-byte lanes, unaligned comp
    with bytes past the lanes): the kernel equals its plain version and the
    token-level model in every slot, zero tails included."""
    from minlz_tpu_torch.ops import parse_model as pm

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _parse_lanes(name)
    recs, counts = parse_segments(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    recs_p, counts_p = parse_segments_plain(*args)
    assert torch.equal(counts.cpu(), counts_p)
    assert torch.equal(recs.cpu(), recs_p)
    recs_m, counts_m, _ = pm.parse_segments_model(*args)
    assert torch.equal(recs_m, recs_p) and torch.equal(counts_m, counts_p)


# ---- kernel 7: the cursor scan in front of K3 --------------------------------

@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_sched_kernel_on_synthetic_records(kind):
    """The synthetic densities without their position row: the append-only
    kernel equals its plain version and K3 on the positioned records."""
    spans = [RANGE, 0, 37, (32 << 10) + 13, RANGE - 1, 100_000]
    crec, *rest = _batch_on_card(record_batch(kind, spans, seed=3))
    drec = crec[1:].contiguous()
    out = tec.execute_scheduled(drec, *rest, RANGE)
    torch.cuda.synchronize()
    assert torch.equal(out, tec.execute_scheduled_plain(drec, *rest, RANGE))
    assert torch.equal(out, tec.execute_ranges(crec, *rest, RANGE))


def test_sched_kernel_on_backward_ranges():
    """range_first that goes backwards, past the records and empty ranges:
    each record is taken by one range at most, as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = np.random.default_rng(8)
    n = 3000
    drec = np.where(g.random((4, n)) < 0.95, g.integers(-2, 40, (4, n)),
                    g.integers(-(1 << 31), (1 << 31) - 1, (4, n),
                               dtype=np.int64)).astype(np.int32)
    first = torch.tensor([0, 900, 900, 400, 2000, 1500, n, n + 7],
                         dtype=torch.int64)
    span = torch.tensor([4096, 100, 2000, 8192, 64, 3000, 17],
                        dtype=torch.int32)
    out_off = torch.cumsum(span.to(torch.int64), 0) - span.to(torch.int64)
    comp = torch.from_numpy(g.integers(0, 256, 5000, dtype=np.uint8))
    args = (first, out_off, span, comp, int(span.sum()), 8192)
    out = tec.execute_scheduled(torch.from_numpy(drec).cuda(),
                                *(a.cuda() if torch.is_tensor(a) else a
                                  for a in args))
    torch.cuda.synchronize()
    want = tec.execute_scheduled_plain(torch.from_numpy(drec), *args)
    assert torch.equal(out.cpu(), want)


# --- search tables built on the card, and the mesh over NCCL -----------------


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.parametrize("match_len", range(1, 9))
def test_build_tables_device_on_card_matches_numpy(twain, match_len):
    """The torch table builder on the card against the NumPy builder (no
    reduction, no population limit) at bits 8, 16 and 23."""
    _need_gpu()
    from minlz_tpu_torch.search import SearchTableConfig
    from minlz_tpu_torch.search.build import build_table, build_tables_device

    rng = np.random.default_rng(match_len)
    rows = [(twain * 5)[: 64 << 10],
            rng.integers(0, 256, 64 << 10, dtype=np.uint8).tobytes()]
    blocks = np.stack([np.frombuffer(r, np.uint8) for r in rows])
    for bits in (8, 16, 23):
        got = build_tables_device(blocks, match_len, bits, "cuda")
        assert got.device.type == "cuda"
        cpu = build_tables_device(blocks, match_len, bits, "cpu")
        assert torch.equal(got.cpu(), cpu)
        for i, row in enumerate(rows):
            cfg = SearchTableConfig(match_len=match_len, table_bits=bits)
            cfg.max_population = 1.0
            cfg.max_reduced_population = 0.0
            table, red = build_table(row, cfg, b"", len(row))
            assert red == 0 and got[i].cpu().numpy().tobytes() == table


def _mesh_inputs(twain):
    n, nb = 32768, 4
    rng = np.random.default_rng(3)
    blocks = np.zeros((nb, n), np.uint8)
    for b in range(nb):
        d = bytearray((twain[b * 977:] + twain * 3)[:n])
        for _ in range(16):
            d[int(rng.integers(0, n))] = int(rng.integers(32, 127))
        blocks[b] = np.frombuffer(bytes(d), np.uint8)
    return blocks, np.full(nb, n, np.int32)


def test_one_rank_nccl_encode_matches_cpu(twain):
    _need_gpu()
    from functools import partial

    from minlz_tpu_torch.ops import emit
    from minlz_tpu_torch.parallel import ranks, sharded_encode_blocks

    blocks, valid = _mesh_inputs(twain)
    res = ranks.run([(partial(sharded_encode_blocks, seg=4096),
                      [(blocks, valid)])], 1, backend="nccl",
                    devices="cuda", timeout=300)[0][0]
    out, lens = emit.encode_block_emit(torch.from_numpy(blocks), valid, 4096)
    np.testing.assert_array_equal(res[0], out.numpy())
    np.testing.assert_array_equal(res[1], lens.numpy())
    sizes = lens.sum(dim=1).numpy()
    np.testing.assert_array_equal(res[3], np.cumsum(sizes) - sizes)


def test_mesh_writer_on_card(twain):
    """Writer(mesh=) on one NCCL rank writes the bytes of the port's
    Writer(device_emit=True) on the card, and reads back bit-exact."""
    _need_gpu()
    import io

    from minlz_tpu_torch.parallel import ranks
    from minlz_tpu_torch.stream import Reader, Writer

    payload = (twain * 19)[: 256 << 10]  # four 64 KiB blocks
    opts = dict(block_size=64 << 10, add_index=False, concurrency=1)
    stream, _ = ranks.run([(ranks.write_stream, [(payload, opts)])], 1,
                          backend="nccl", devices="cuda", timeout=300)[0][0]
    buf = io.BytesIO()
    with Writer(buf, device="cuda", device_emit=True, **opts) as w:
        w.write(payload)
    assert stream == buf.getvalue()
    r = Reader(io.BytesIO(stream), device="cuda")
    before = r.codec.blocks_decoded
    assert r.readall() == payload and r.codec.blocks_decoded - before == 4
    assert r.hint_fallbacks == 0


def test_cli_device_round_trip_on_card(tmp_path, monkeypatch):
    """`mz c -device` then `mz d -device` on the card round-trip 8 MiB, and
    every block goes through DeviceCodec.decode_batch on the card."""
    _need_gpu()
    from minlz_tpu_torch.cli import main
    from minlz_tpu_torch.corpus import make_corpus
    from minlz_tpu_torch.ops.device_codec import DeviceCodec

    seen = []
    real = DeviceCodec.decode_batch

    def spy(self, items):
        seen.append((self.device.type, len(items)))
        return real(self, items)

    monkeypatch.setattr(DeviceCodec, "decode_batch", spy)
    data = make_corpus(8 << 20)
    src, mz, out = tmp_path / "in", tmp_path / "in.mz", tmp_path / "out"
    src.write_bytes(data)
    assert main(["c", "-device", "-o", str(mz), str(src)],
                device="cuda") == 0
    assert main(["d", "-device", "-o", str(out), str(mz)],
                device="cuda") == 0
    assert out.read_bytes() == data
    assert seen == [("cuda", 8)]


def test_cli_card_is_the_default_route(tmp_path, monkeypatch):
    """Without -device, `mz c` and `mz d` run on the card all the same, and
    `mz d -offset` decodes the blocks it touches there one at a time
    (DeviceCodec.decode is a batch of one)."""
    _need_gpu()
    from minlz_tpu_torch.cli import main
    from minlz_tpu_torch.corpus import make_corpus
    from minlz_tpu_torch.ops.device_codec import DeviceCodec

    seen = []
    real = DeviceCodec.decode_batch

    def spy(self, items):
        seen.append((self.device.type, len(items)))
        return real(self, items)

    monkeypatch.setattr(DeviceCodec, "decode_batch", spy)
    data = make_corpus(8 << 20)
    src, mz, out = tmp_path / "in", tmp_path / "in.mz", tmp_path / "out"
    src.write_bytes(data)
    assert main(["c", "-o", str(mz), str(src)]) == 0
    assert main(["d", "-o", str(out), str(mz)]) == 0
    assert out.read_bytes() == data
    assert seen == [("cuda", 8)]
    seen.clear()
    start = (3 << 20) + 12345
    assert main(["d", "-offset", str(start), "-limit", str(2 << 20), "-o",
                 str(out), str(mz)]) == 0
    assert out.read_bytes() == data[start:start + (2 << 20)]
    assert seen == [("cuda", 1)] * 3


# ---- the JAX package's names: scan parse, reference decoder, greedy --------

def _scan_segments(segs):
    """The batch's first 24 segments and mutated copies of 8 of them."""
    from minlz_tpu_torch.testing import mutate

    lanes = [s for blk in segs for s in blk][:24]
    rng = np.random.default_rng(17)
    for s in lanes[:8]:
        lanes.append(mutate(rng, mutate(rng, s)))
    return lanes


def test_parse_segments_scan_on_card_matches_plain(stages):
    """The parse kernel's records laid out at their rows, all seven [P, B]
    arrays, against the row-by-row scan; the kernel launches once."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import decode_kernel as tdk

    mat, lens = tdk.pack_segments(_scan_segments(stages[1]))
    before = _build.launch_counts()["parse"]
    got = tdk.parse_segments_scan(torch.from_numpy(mat).cuda(),
                                  torch.from_numpy(lens).cuda())
    torch.cuda.synchronize()
    assert _build.launch_counts()["parse"] == before + 1
    want = tdk.parse_segments_scan_plain(torch.from_numpy(mat),
                                         torch.from_numpy(lens))
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert int((want[0] > 0).sum()) > 1000


def test_decode_segments_jnp_on_card(twain):
    """Segments that decode on their own: the card's scan parse and the
    CPU's give the same bytes, the input's."""
    from minlz_tpu_torch.ops import decode_kernel as tdk
    from test_torch_common import encode_segs

    _need_gpu()
    data = (twain * 3)[: 64 << 10]
    pieces = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    segs = [encode_segs(p, 4096, 0)[0] for p in pieces]
    sizes = [len(p) for p in pieces]
    got = tdk.decode_segments_jnp(segs, sizes, "cuda")
    assert got == pieces
    assert got == tdk.decode_segments_jnp(segs, sizes, "cpu")


def test_greedy_parse_jax_name_on_card():
    """encode_kernel.greedy_parse on CUDA tensors launches the greedy
    kernel and equals its plain version."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import encode_kernel as tek
    from minlz_tpu_torch.ops import greedy as tg
    from test_torch_common import random_proposals

    _need_gpu()
    off, length = random_proposals(31, 64, 4096, hostile=True)
    before = _build.launch_counts()["greedy"]
    got = tek.greedy_parse(torch.from_numpy(off).cuda(),
                           torch.from_numpy(length).cuda(), 4096)
    torch.cuda.synchronize()
    assert _build.launch_counts()["greedy"] == before + 1
    want = tg.greedy_parse_plain(torch.from_numpy(off),
                                 torch.from_numpy(length), 4096)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_spans_time_the_emit_stages_on_the_card(twain):
    """Under torch.profiler the device_emit Writer's six card-side stages
    (copy in, match, greedy, verify, emit, copy back) carry CUDA event
    times, one batch each, inside the batch's host time; the spans' mirrors
    on the device's timeline are user annotations, no device operation."""
    import io

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from minlz_tpu_torch import trace
    from minlz_tpu_torch.stream import Reader, Writer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    data = (twain * 48)[: 16 << 20]
    buf = io.BytesIO()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = Writer(buf, device="cuda", level=2, device_emit=True)
        w.encode_buffer(data)
        w.close()
    snap = trace.snapshot()
    trace.reset()
    stages = ["codec.copy_in", "emit.match", "emit.greedy", "emit.verify",
              "emit.segments", "codec.copy_back"]
    for name in stages:
        st = snap["spans"][name]
        assert st["count"] == 1 and st["device_s"] > 0, name
    card = sum(snap["spans"][n]["device_s"] for n in stages)
    assert card <= snap["spans"]["writer.flush_batch"]["host_s"]
    mirrors = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name().startswith(trace.PREFIX)]
    assert all(e.is_user_annotation() for e in mirrors)
    assert Reader(io.BytesIO(buf.getvalue()), device=None).readall() == data
