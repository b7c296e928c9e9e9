"""The tiled resolution of the port's positioned executors, as a plain torch
model (minlz_tpu_torch.ops.resolve_model): sub-tiles in output order for the
range road; tiles, residuals and the fix-up for the whole-block road, at tile
sizes small enough that short inputs cross many tiles.  Held equal to the
plain versions (execute_ranges_plain, execute_blocks_plain), to a byte-serial
walk, to the host referee (ops/decode_kernel.execute_records_host) where the
records are valid, and on real blocks to the JAX package's decoded bytes.
Tolerance: exact (bytes)."""

import numpy as np
import pytest
import torch

from minlz_tpu.ops import exec_chain as jec
from minlz_tpu.ops import pallas_decode as jpd
from minlz_tpu_torch.ops import decode_kernel as tdk
from minlz_tpu_torch.ops import exec_block as teb
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops import resolve_model as trm
from minlz_tpu_torch.ops.device_codec import RANGE
from minlz_tpu_torch.ops.parse import parse_segments
from minlz_tpu_torch.testing import HOSTILE_RECORDS, HOSTILE_SPAN

from test_torch_common import encode_segs

COMP = (np.arange(4 * 512, dtype=np.uint32) % 251).astype(np.uint8)
SPAN = 4 * 512
# (tile, sub-tile) of the model; None: one tile per range, as on the range
# road.  The kernels' own sizes come last.
GEOMETRIES = [(None, 64), (None, 100), (256, 64), (96, 32), (512, 512),
              (trm.TILE, trm.SUB)]


def back_to_back(records):
    """(llen, clen, csrc, lsrc) records -> positioned rows."""
    pos, rows = 0, []
    for llen, clen, csrc, lsrc in records:
        rows.append((pos, llen, clen, csrc, lsrc))
        pos += llen + clen
    return rows


def walk(rows, span, comp=COMP):
    """Byte-serial reference with the executors' clamps: rows in order, a
    copy source before the span's first byte reads 0."""
    out = bytearray(span)
    for pos, llen, clen, csrc, lit in rows:
        p = min(max(pos, 0), span)
        llen = min(max(llen, 0), span - p)
        clen = min(max(clen, 0), span - p - llen)
        csrc = max(csrc, 1)
        for i in range(llen):
            g = min(max(lit + i, 0), len(comp) - 1)
            out[p + i] = comp[g] if len(comp) else 0
        d = p + llen
        for i in range(clen):
            s = d + i - csrc
            out[d + i] = out[s] if s >= 0 else 0
    return bytes(out)


def tensors(per_span_rows, spans, offsets=None):
    rows = [r for part in per_span_rows for r in part]
    first = np.cumsum([0] + [len(part) for part in per_span_rows])
    if offsets is None:
        offsets = np.cumsum([0] + list(spans[:-1]))
    crec = torch.tensor(rows, dtype=torch.int32).reshape(-1, 5).T.contiguous()
    return (crec, torch.tensor(first, dtype=torch.int64),
            torch.tensor(offsets, dtype=torch.int64),
            torch.tensor(spans, dtype=torch.int32), torch.from_numpy(COMP),
            int(sum(spans)))


def run_model(args, tile, sub):
    max_span = int(args[3].max()) if args[3].numel() else 0
    if tile is None:
        out, info = trm.execute_ranges_tiled(*args, max_span, sub)
        assert info["residual"] == 0 and info["hops"] == 0
    else:
        out, info = trm.execute_blocks_tiled(*args, tile, sub)
    return out.numpy().tobytes(), info


def referee(rows, span):
    """The host record walk on the same records as one lane of one block."""
    recs = np.zeros((7, len(rows)), np.int32)
    for k, (pos, llen, clen, csrc, lit) in enumerate(rows):
        recs[:, k] = (0, pos, clen, csrc, lit, llen, 0)
    return tdk.execute_records_host(recs, [len(rows)], COMP, [0], span)


# name: records (llen, clen, csrc, lsrc), back to back, all valid for the
# host referee
RECORD_CASES = {
    "literal_1": [(1, 0, 1, 0)],
    "literal_513_align_3": [(513, 0, 1, 3)],
    "literal_511_align_7": [(511, 0, 1, 7)],
    "copy_1_5": [(64, 5, 1, 0)],
    "copy_1_100": [(64, 100, 1, 0)],
    "copy_2_37": [(64, 37, 2, 0)],
    "copy_3_64": [(64, 64, 3, 0)],
    "copy_7_29": [(64, 29, 7, 0)],
    "copy_64_200": [(64, 200, 64, 0)],
    "copy_300_513": [(300, 513, 300, 0)],
    "zero_literal_record": [(16, 0, 1, 0), (0, 8, 4, 0)],
    "row_crossing": [(500, 0, 1, 0), (30, 40, 10, 500)],
    # Every byte reads the one before it, a record each: depth = length.
    "deep_chain_csrc_1": [(1, 0, 1, 9)] + [(0, 1, 1, 0)] * 700,
    "deep_chain_period_3": [(3, 0, 1, 20)] + [(0, 1, 3, 0)] * 900,
    "deep_chain_of_short_copies": [(2, 0, 1, 5)] + [(0, 2, 2, 0)] * 500,
    # A 100-byte literal and a 300-byte RLE copy over sub-tile and tile
    # boundaries at 64, 96, 128, 256, ...
    "literal_straddles": [(30, 0, 1, 0), (100, 0, 1, 40), (70, 10, 5, 3)],
    "rle_across_boundaries": [(61, 300, 3, 0), (2, 700, 1, 7)],
    "copy_straddles_from_far": [(250, 0, 1, 0), (0, 20, 250, 0),
                                (10, 500, 270, 300)],
    # Each 64-byte piece copies the piece before it: on the whole-block road
    # a chain of residuals through every tile.
    "far_chain_through_every_tile": [(64, 0, 1, 11)] + [(0, 64, 64, 0)] * 31,
    "far_copies_mixed": [(200, 0, 1, 0), (5, 300, 190, 300), (0, 400, 505, 0),
                         (7, 600, 3, 900), (0, 500, 1500, 0)],
    "four_kib_records": [(1024, 0, 1, 0), (0, 1024, 1, 0)],
}


@pytest.mark.parametrize("tile,sub", GEOMETRIES)
@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_record_cases(name, tile, sub):
    rows = back_to_back(RECORD_CASES[name])
    args = tensors([rows], [SPAN])
    want = walk(rows, SPAN)
    assert referee(rows, SPAN) == want
    assert tec.execute_ranges_plain(*args, SPAN).numpy().tobytes() == want
    assert teb.execute_blocks_plain(*args).numpy().tobytes() == want
    got, _ = run_model(args, tile, sub)
    assert got == want


def test_rounds_follow_depth_not_record_count():
    """A chain of depth n takes about log2(n) doubling rounds, and at most
    log2(sub) + 1 in a sub-tile; many records without chains take one."""
    deep = tensors([back_to_back(RECORD_CASES["deep_chain_csrc_1"])], [SPAN])
    _, info = run_model(deep, None, 1024)
    assert 9 <= info["rounds"] <= 11          # depth 700
    _, info = run_model(deep, None, 64)
    assert info["rounds"] <= 7
    flat = tensors([back_to_back([(1, 0, 1, k % 200) for k in range(700)])],
                   [SPAN])
    assert run_model(flat, None, 1024)[1]["rounds"] == 0
    shallow = tensors([back_to_back([(64, 0, 1, 0)] + [(0, 1, 64, 0)] * 700)],
                      [SPAN])
    assert run_model(shallow, None, 1024)[1]["rounds"] <= 5   # depth 11


def test_residuals_and_hops_of_a_far_chain():
    rows = back_to_back(RECORD_CASES["far_chain_through_every_tile"])
    args = tensors([rows], [SPAN])
    got, info = run_model(args, 64, 32)
    assert got == walk(rows, SPAN)
    # Every byte but the first tile's literals is a residual, and the last
    # tile's bytes walk through every tile before them.
    assert info["residual"] == SPAN - 64
    assert info["hops"] == SPAN // 64 - 1
    got, info = run_model(args, 512, 64)
    assert got == walk(rows, SPAN)
    assert info["residual"] == SPAN - 512 and info["hops"] == 3


@pytest.mark.parametrize("tile,sub", GEOMETRIES)
def test_hostile_clamped_records(tile, sub):
    """Records as only a direct caller can supply them, inside the
    executors' contract (records with bytes move forward without
    overlapping): clamped alike by the walk, the plain version and the
    model."""
    span, rows = HOSTILE_SPAN, list(HOSTILE_RECORDS)
    args = tensors([rows], [span])
    want = walk(rows, span)
    assert tec.execute_ranges_plain(*args, span).numpy().tobytes() == want
    got, _ = run_model(args, tile, sub)
    assert got == want


@pytest.mark.parametrize("tile,sub", GEOMETRIES)
def test_batch_of_unequal_spans(tile, sub):
    """Several ranges or blocks of one batch: spans of 0, below a sub-tile,
    no multiple of 16 or of the tile; sources before a span's first byte
    read 0, not the span before."""
    spans = [1140, 0, 37, 513, 64]
    per_span = [
        back_to_back([(40, 100, 3, 0), (0, 1000, 140, 0)]),
        [],
        back_to_back([(7, 0, 1, 100), (5, 25, 2, 900)]),
        back_to_back([(3, 200, 3, 0), (0, 290, 203, 0)])
        + [(505, 0, 8, 600, 0)],
        back_to_back([(1, 63, 1, 77)]),
    ]
    args = tensors(per_span, spans)
    want = b"".join(walk(r, s) for r, s in zip(per_span, spans))
    assert tec.execute_ranges_plain(*args, max(spans)).numpy().tobytes() \
        == want
    got, _ = run_model(args, tile, sub)
    assert got == want


def test_empty_inputs():
    crec = torch.zeros((5, 0), dtype=torch.int32)
    i64 = torch.int64
    none = (crec, torch.zeros(1, dtype=i64), torch.zeros(0, dtype=i64),
            torch.zeros(0, dtype=torch.int32), torch.from_numpy(COMP), 0)
    assert trm.execute_blocks_tiled(*none)[0].numel() == 0
    no_comp = (torch.tensor([[0, 5, 3, 2, 0]], dtype=torch.int32).T,
               torch.tensor([0, 1]), torch.tensor([0]),
               torch.tensor([16], dtype=torch.int32),
               torch.zeros(0, dtype=torch.uint8), 16)
    out, _ = trm.execute_ranges_tiled(*no_comp, 16, 4)
    assert out.numpy().tobytes() == bytes(16)
    with pytest.raises(ValueError):
        trm.execute_tiled(*no_comp, 16, 0, 4)


def _compacted(segs, seg, rng):
    plan = tec.plan_batch([segs], seg, rng)
    t = plan.tensors("cpu")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = tec.compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    return plan, (crec, first, t["range_out"], t["range_span"], t["comp"],
                  plan.total_out)


@pytest.mark.parametrize("tile,sub", [(4096, 1024), (2048, 2048),
                                      (3000, 700)])
def test_real_block_whole_road_matches_jax(twain, tile, sub):
    """One real block without the range clamp: the model's bytes equal the
    JAX v1 road's (Pallas in interpret mode), the host referee's and the
    input, and some bytes are residuals."""
    rng = np.random.default_rng(23)
    head = twain[: 6 << 10]
    data = head + rng.integers(0, 256, 9 << 10, dtype=np.uint8).tobytes() \
        + twain[2000 : 2000 + (5 << 10)] + head
    segs = encode_segs(data, 4096, 0)
    want = jpd.decode_block_tpu(segs, len(data), 4096)
    plan, args = _compacted(segs, 4096, 0)
    out, info = trm.execute_blocks_tiled(*args, tile, sub)
    got = out.numpy()[: len(data)].tobytes()
    assert got == want == data
    assert tdk.decode_segments(segs, len(data), 4096) == data
    assert torch.equal(out, teb.execute_blocks_plain(*args))
    assert info["residual"] > 0 and info["hops"] >= 1


@pytest.mark.parametrize("sub", [512, 4096, trm.SUB])
def test_real_block_range_road_matches_jax(twain, sub):
    data = (twain * 2)[777 : 777 + (40 << 10)]
    segs = encode_segs(data, 4096, RANGE)
    want = jec.decode_blocks_chained([segs], [len(data)], 4096, jec.RANGE)[0]
    plan, args = _compacted(segs, 4096, RANGE)
    out, info = trm.execute_ranges_tiled(*args, plan.max_span, sub)
    assert out.numpy()[: len(data)].tobytes() == want == data
    assert torch.equal(out, tec.execute_ranges_plain(*args, plan.max_span))
    assert info["residual"] == 0
