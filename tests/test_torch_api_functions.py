"""The port's functions under the JAX package's last unmatched names,
against the JAX functions on the same inputs: parse_segments_scan and
decode_segments_jnp (ops/decode_kernel.py), find_matches and greedy_parse
(ops/encode_kernel.py), compact_ops_fast, compact_ops_dense and
execute_fast (ops/exec_chain.py), get_device_codec (ops/device_codec.py).
Inputs are the corpus mix (make_corpus) encoded by the port, mutated copies
of it, and seeded proposals.  On the CPU the wrappers run their plain
versions; scan_layout, the card's road of parse_segments_scan, is run here
on the plain parse's records.  Tolerance 0: integers and bytes."""

import io

import numpy as np
import pytest
import torch

from minlz_tpu.ops import decode_kernel as jdk
from minlz_tpu.ops import encode_kernel as jek
from minlz_tpu.ops import exec_chain as jec
from minlz_tpu.ops.pallas_decode import parse_segments_pallas
from minlz_tpu_torch import ops as tops
from minlz_tpu_torch.corpus import make_corpus
from minlz_tpu_torch.ops import decode_kernel as tdk
from minlz_tpu_torch.ops import device_codec as tdc
from minlz_tpu_torch.ops import encode_kernel as tek
from minlz_tpu_torch.ops import exec_chain as tec
from minlz_tpu_torch.ops import greedy as tg
from minlz_tpu_torch.ops.parse import parse_segments, parse_segments_plain
from minlz_tpu_torch.stream import Reader, Writer
from minlz_tpu_torch.testing import mutate

from test_torch_common import (both, dense_ops_to_records, encode_segs,
                               pad_block, random_proposals, real_proposals)

SEG = 4096
FIELDS = ("kind", "dst", "clen", "csrc", "lsrc", "llen", "lacc")


def _corpus_data():
    return make_corpus(64 << 10)[8 << 10 : 32 << 10]


def _corpus_segs():
    """Six 4 KiB pieces of the corpus mix, each encoded as a block of its
    own, so that each segment decodes on its own."""
    data = _corpus_data()
    return [encode_segs(data[i:i + SEG], SEG, 0)[0]
            for i in range(0, len(data), SEG)]


def _mutated_segs():
    rng = np.random.default_rng(11)
    out = []
    for s in _corpus_segs():
        for _ in range(2):
            s = mutate(rng, s)
        out.append(s)
    return out


SEGS = {"corpus": _corpus_segs, "mutated": _mutated_segs}


@pytest.fixture(scope="module", params=sorted(SEGS))
def scan_case(request):
    """(name, segs, mat, lens, the JAX scan's seven arrays)."""
    segs = SEGS[request.param]()
    mat, lens = jdk.pack_segments(segs)
    want = [np.asarray(x) for x in jdk.parse_segments_scan(mat, lens)]
    return request.param, segs, mat, lens, want


def _assert_fields(got, want):
    assert len(got) == len(want) == 7
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_pack_matrix_is_the_jax_packing(scan_case):
    _, segs, mat, lens, _ = scan_case
    got_mat, got_lens = tdk.pack_segments(segs)
    np.testing.assert_array_equal(got_mat, mat)
    np.testing.assert_array_equal(got_lens, lens)


def test_parse_segments_scan_matches_jax(scan_case):
    """The CPU road (the plain scan): every row of every field, the held
    state between records included."""
    _, _, mat, lens, want = scan_case
    got = tdk.parse_segments_scan(torch.from_numpy(mat),
                                  torch.from_numpy(lens))
    _assert_fields(got, want)
    assert int((got[0] > 0).sum()) > 100


def test_scan_layout_of_the_parse_records_matches_jax(scan_case):
    """The card's road on the CPU: the parse kernel's records (its plain
    version here) laid out at their rows."""
    _, _, mat, lens, want = scan_case
    comp, lane_start, lane_len = tdk._matrix_lanes(
        torch.from_numpy(mat), torch.from_numpy(lens))
    recs, counts = parse_segments_plain(comp, lane_start, lane_len)
    got = tdk.scan_layout(recs, counts, comp, lane_start, lane_len,
                          mat.shape[0])
    _assert_fields(got, want)


def test_scan_layout_refuses_records_of_other_lanes(scan_case):
    _, _, mat, lens, _ = scan_case
    comp, lane_start, lane_len = tdk._matrix_lanes(
        torch.from_numpy(mat), torch.from_numpy(lens))
    recs, counts = parse_segments_plain(comp, lane_start, lane_len)
    counts = counts.clone()
    counts[0] += 1
    with pytest.raises(ValueError, match="tokens"):
        tdk.scan_layout(recs, counts, comp, lane_start, lane_len,
                        mat.shape[0])


def test_parse_segments_scan_checks_its_input():
    mat = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="flush row"):
        tdk.parse_segments_scan(mat, torch.tensor([3, 8], dtype=torch.int32))
    with pytest.raises(ValueError, match="bytes"):
        tdk.parse_segments_scan(mat - 1, torch.tensor([1, 1],
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tdk.parse_segments_scan(mat.to(torch.int64),
                                torch.tensor([1, 1], dtype=torch.int32))


def _decode(fn, segs):
    try:
        return fn(segs, [SEG] * len(segs))
    except ValueError as exc:
        return type(exc)


def test_decode_segments_jnp_matches_jax(scan_case):
    name, segs, _, _, _ = scan_case
    want = _decode(jdk.decode_segments_jnp, segs)
    got = _decode(lambda s, n: tops.decode_segments_jnp(s, n, "cpu"), segs)
    assert got == want
    if name == "corpus":
        assert b"".join(got) == _corpus_data()
        return
    # One mutated segment spoils the batch: each one on its own too.
    for s in segs:
        one = _decode(jdk.decode_segments_jnp, [s])
        assert _decode(lambda x, n: tdk.decode_segments_jnp(x, n, "cpu"),
                       [s]) == one


def test_ops_exports_the_reference_decoder():
    assert tops.__all__ == ["decode_segments_jnp"]
    assert tops.decode_segments_jnp is tdk.decode_segments_jnp


# ---- encode_kernel ----------------------------------------------------------

GREEDY = {
    "real": lambda t: real_proposals((t * 2)[: 48 << 10], rng=tdc.RANGE),
    "tame": lambda t: random_proposals(21, 4, 512, hostile=False),
    "hostile": lambda t: random_proposals(22, 5, 256, hostile=True),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_parse_matches_jax(twain, case):
    off, length = GREEDY[case](twain)
    seg = off.shape[1]
    (joff, jlen), (toff, tlen) = both(off, length)
    want = jek.greedy_parse(joff, jlen, seg)
    got = tek.greedy_parse(toff, tlen, seg)
    assert len(got) == 4
    for name, g, w in zip(("take", "tok_off", "tok_len", "is_rep"), got,
                          want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[0].sum()) > 0


def test_greedy_names_are_the_greedy_modules():
    assert tek.greedy_parse is tg.greedy_parse
    assert tek.greedy_parse_compact is tg.greedy_parse_compact


@pytest.mark.parametrize("level", [1, 2])
def test_find_matches_is_find_matches_dyn_and_jax(level):
    data = make_corpus(64 << 10)[: 20 << 10]
    flat, n = pad_block(data)
    got = tek.find_matches(torch.from_numpy(flat), n, SEG, tdc.RANGE, level)
    dyn = tek.find_matches_dyn(torch.from_numpy(flat), [n], SEG, tdc.RANGE,
                               level)
    want = jek.find_matches(flat, n, SEG, tdc.RANGE, level)
    for g, d, w in zip(got, dyn, want):
        assert g.dtype == torch.int32 and g.shape == flat.shape
        assert torch.equal(g, d.to(torch.int32))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] > 0).sum()) > 1000


# ---- exec_chain: a batch of 8 blocks ----------------------------------------

BLOCK = 12 << 10


@pytest.fixture(scope="module")
def chained():
    """8 blocks of the corpus mix, the JAX parse, compact_ops_fast,
    compact_ops_dense and execute_fast on them (one chain, lanes in order)
    and the port's plan."""
    data = make_corpus(8 * BLOCK)
    blocks = [data[i * BLOCK:(i + 1) * BLOCK] for i in range(8)]
    segs = [encode_segs(b, SEG, tdc.RANGE) for b in blocks]
    (comp_lanes, lens, bases, lastrow), st, out0, _ = jec.plan_batch(
        segs, SEG, jec.RANGE)
    n_rows, pc, spr = st["n_rows"], st["pc"], st["spr"]
    lanes = comp_lanes.shape[0]
    ct = comp_lanes[:, :n_rows].T.astype(np.int32).reshape(
        n_rows // 4, 4, lanes // 128, 128)
    words = ct[:, 0] | (ct[:, 1] << 8) | (ct[:, 2] << 16) | (ct[:, 3] << 24)
    emits = parse_segments_pallas(words, lens, n_rows)
    L = st["R"] * spr
    lane_counts = np.asarray(
        (np.asarray(emits[0]) > 0).sum(axis=0, dtype=np.int32)).reshape(
            -1)[:L]
    total = int(lane_counts.sum())
    cap = -(-total // jec.OP_T) * jec.OP_T
    lane_off = (np.cumsum(lane_counts) - lane_counts).astype(np.int32)
    comp_rows = lanes * pc // jec.ROW_B
    n_arena = 1 + comp_rows + st["out_rows"] + 2
    out_base = (np.repeat(bases, spr)
                + (np.arange(L) % spr) * SEG).astype(np.int32)
    ops = np.asarray(jec.compact_ops_fast(
        *emits, lane_off, lane_counts, out_base, np.repeat(lastrow, spr),
        nchain=1, cap_chain=cap, pc=pc, n_arena_rows=n_arena))
    dense = np.asarray(jec.compact_ops_dense(
        *emits[:6], lane_off, lane_counts, nchain=1, cap_chain=cap, pc=pc,
        guard=jec.ROW_B))
    flat = comp_lanes.reshape(-1, 128, 4).astype(np.int32)
    arena_comp = np.concatenate([
        np.zeros((1, 128), np.int32),
        flat[:, :, 0] | (flat[:, :, 1] << 8) | (flat[:, :, 2] << 16)
        | (flat[:, :, 3] << 24)])
    tw = jec.tile_words(1)
    tiles = ops.reshape(cap // jec.OP_T, jec.OP_T * 3)
    ops_flat = np.pad(tiles, ((0, 0), (0, tw - tiles.shape[1]))).reshape(-1)
    arena = np.asarray(jec.execute_fast(
        ops_flat, np.array([total], np.int32), arena_comp, nchain=1,
        cap_chain=cap, n_arena_rows=n_arena))
    out_np = arena[out0:out0 + st["out_rows"]].view(np.uint32)
    jax_bytes = out_np.view(np.uint8).reshape(-1).tobytes()
    lane_of = np.repeat(np.arange(L), lane_counts)
    plan = tec.plan_batch(segs, SEG, tec.RANGE)
    return dict(blocks=blocks, segs=segs, ops=ops[0, :total], total=total,
                dense=dense_ops_to_records(dense, [total], pc, jec.ROW_B,
                                           plan.lane_start),
                lane_of=lane_of, base=bases[lane_of // spr], pc=pc,
                jax_bytes=jax_bytes, plan=plan, t=plan.tensors("cpu"))


def fast_ops_to_records(ops, lane_of, base, pc, lane_start):
    """The JAX package's ``compact_ops_fast`` words -> the port's
    positioned records: (pos, llen, clen, csrc, lit, inline bytes).  pos
    is range-local (the arena byte less the range's base); lit is the
    port's literal index (the arena byte less the guard row and the lane's
    pc offset, plus the port's lane start), -1 for an inline run, whose
    bytes (the run's first four, little-endian) come back instead."""
    w0, w1, w2 = (ops[:, k].astype(np.int64) & 0xFFFFFFFF for k in range(3))

    def window(x):
        return (x & 0x7FFF) * 512 + ((x >> 15) & 0x7F) * 4 + ((x >> 22) & 3)

    slow = (w2 >> 31) & 1 == 1
    inline = ~slow & ((w2 >> 25) & 1 == 1)
    q = (w2 >> 15) & 0x1FF
    cur = np.where(slow, w2 & 0x1FFFFFF, (w2 & 0x7FFF) * 512 + q)
    llen = np.where(slow, ((w0 >> 25) & 0x7F) | (((w1 >> 31) & 1) << 7)
                    | (((w2 >> 25) & 0x3F) << 8),
                    np.where(inline, (w2 >> 26) & 7, (w0 >> 24) & 0xFF))
    clen = np.where(slow, (w1 >> 17) & 0x3FFF, (w1 >> 24) & 0xFF)
    cur2 = cur + llen
    csrc = np.where(slow, w1 & 0x1FFFF, cur2 - (cur2 & 511) - window(w1))
    glob = np.where(slow, w0 & 0x1FFFFFF, window(w0) + q)
    lit = np.where(inline, -1, np.asarray(lane_start, np.int64)[lane_of]
                   + glob - jec.ROW_B - lane_of * pc)
    return cur - base, llen, clen, csrc, lit, np.where(inline, w0, 0)


def test_compact_ops_fast_matches_jax(chained):
    t = chained["t"]
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = tec.compact_ops_fast(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    assert int(total) == chained["total"] > 1000
    pos, llen, clen, csrc, lit, acc = fast_ops_to_records(
        chained["ops"], chained["lane_of"], chained["base"], chained["pc"],
        chained["plan"].lane_start)
    got = crec[:, :chained["total"]].numpy().astype(np.int64)
    for row, name, want in ((0, "pos", pos), (1, "llen", llen),
                            (2, "clen", clen), (3, "csrc", csrc)):
        np.testing.assert_array_equal(got[row], want, err_msg=name)
    direct = lit >= 0
    np.testing.assert_array_equal(got[4][direct], lit[direct])
    comp = t["comp"].numpy()
    for k in np.nonzero(~direct)[0]:
        run = comp[got[4][k]:got[4][k] + got[1][k]]
        assert int.from_bytes(run.tobytes(), "little") == acc[k]
    assert direct.sum() > 0 and (~direct).sum() > 0
    assert torch.equal(lane_out, tec.compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])[1])


def test_compact_ops_dense_matches_jax(chained):
    """llen, clen, csrc and the literal index of every record, after
    undoing the TPU arena offset of compact_ops_dense's words."""
    t = chained["t"]
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    drec, _, total = tec.compact_ops_dense(recs, counts, t["lane_start"],
                                           t["lane_len"])
    assert int(total) == chained["total"]
    for row, name in enumerate(("llen", "clen", "csrc", "lit")):
        np.testing.assert_array_equal(drec[row, :chained["total"]].numpy(),
                                      chained["dense"][row], err_msg=name)
    assert torch.equal(drec, tec.compact_records_dense(
        recs, counts, t["lane_start"], t["lane_len"])[0])


def test_execute_fast_matches_jax(chained):
    plan, t = chained["plan"], chained["t"]
    recs, counts = parse_segments(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = tec.compact_ops_fast(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    first = tec.range_firsts(lane_out, total, t["range_lane"])
    out = tec.execute_fast(crec, first, t["range_out"], t["range_span"],
                           t["comp"], plan.total_out, plan.max_span)
    assert out.dtype == torch.uint8 and out.numel() == plan.total_out
    assert out.numpy().tobytes() == chained["jax_bytes"][:plan.total_out]
    assert tec.trim_blocks(plan, out, [BLOCK] * 8) == chained["blocks"]


# ---- device_codec -----------------------------------------------------------

def test_get_device_codec_is_one_codec_a_device():
    codec = tdc.get_device_codec("cpu")
    assert codec is tdc.get_device_codec(torch.device("cpu"))
    assert isinstance(codec, tdc.DeviceCodec)
    assert codec.device == torch.device("cpu")
    buf = io.BytesIO()
    w = Writer(buf, device="cpu", block_size=SEG * 4)
    assert w.codec is codec
    before = codec.blocks_encoded
    with w:
        w.write(b"shared codec " * 4000)
    assert codec.blocks_encoded > before
    r = Reader(io.BytesIO(buf.getvalue()), device="cpu")
    assert r.codec is codec
    assert r.readall() == b"shared codec " * 4000
    assert Reader(io.BytesIO(buf.getvalue()), device=None).codec is None


def test_get_device_codec_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a device here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdc.get_device_codec("cuda")
