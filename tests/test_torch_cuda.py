"""Card-only checks: each CUDA kernel of the port against its plain torch
version, bit for bit, on a small decode batch.  Skipped without a GPU;
chip_smoke.py runs the same comparison at the main path's shapes."""

import numpy as np
import pytest
import torch

from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops.device_codec import RANGE, split_body
from minlz_tpu_torch.ops.encode_kernel import encode_blocks_device
from minlz_tpu_torch.ops.parse import parse_segments, parse_segments_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def stages(twain):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(11)
    blocks = [(twain * 20)[: 200 << 10], bytes(40 << 10),
              rng.integers(0, 8, 70 << 10, dtype=np.uint8).tobytes()]
    segs = []
    for b, (blk, hints) in zip(
            blocks, encode_blocks_device(blocks, 4096, RANGE, 2, "cuda")):
        _, _, pos = odec.parse_header(blk)
        segs.append(split_body(blk[pos:], [h[0] for h in hints]))
    plan = tec.plan_batch(segs, 4096, RANGE)
    t = plan.tensors("cuda")
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out = tec.compact_records(recs, counts, t["lane_start"],
                                         t["lane_len"], t["lane_lo"],
                                         t["lane_hi"])
    return blocks, segs, plan, t, recs, counts, crec, lane_out


def test_parse_kernel_matches_plain(stages):
    _, _, _, t, recs, counts, _, _ = stages
    recs_p, counts_p = parse_segments_plain(t["comp"], t["lane_start"],
                                            t["lane_len"])
    assert torch.equal(counts, counts_p)
    assert torch.equal(recs, recs_p)


def test_compact_kernel_matches_plain(stages):
    _, _, _, t, recs, counts, crec, lane_out = stages
    crec_p, lane_out_p = tec.compact_records_plain(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    assert torch.equal(lane_out, lane_out_p)
    assert torch.equal(crec, crec_p)


def test_exec_kernel_matches_plain(stages):
    blocks, segs, plan, t, _, _, crec, lane_out = stages
    first = tec.range_firsts(lane_out, crec.shape[1], plan.spr)
    args = (crec, first, t["range_out"], t["range_span"], t["comp"],
            plan.total_out, plan.rng)
    out = tec.execute_ranges(*args)
    assert torch.equal(out, tec.execute_ranges_plain(*args))
    got = tec.decode_blocks_chained(segs, [len(b) for b in blocks], 4096,
                                    RANGE, "cuda")
    torch.cuda.synchronize()
    assert got == blocks


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
