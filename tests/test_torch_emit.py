"""Device emission parity: minlz_tpu_torch.ops.emit against
minlz_tpu.ops.emit, stage by stage and end to end, and the codec's
encode_emit / encode_batch_emit against the JAX codec's, byte for byte.
Tolerance 0: every value is an integer or a byte.  Inputs come from numpy
seeds; blocks are kept small because the JAX emit jit on the CPU is the slow
side."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from minlz_tpu.ops import device_codec as jdc
from minlz_tpu.ops import emit as jemit
from minlz_tpu_torch.minlz import put_uvarint
from minlz_tpu_torch.ops import device_codec as tdc
from minlz_tpu_torch.ops import emit as temit
from minlz_tpu_torch.ops import greedy as tg
from minlz_tpu_torch.oracle import decode as odec

from test_torch_common import (EMIT_CASES, EMIT_CORPORA, SEG, both,
                               emit_corpus, emit_edge_case, pad_block,
                               real_proposals)

CORPORA = EMIT_CORPORA
_corpus = emit_corpus


def _parsed(data):
    """(flat [1, N] int32, n, take [N], tok_off [N]) numpy arrays: the
    block and its greedy parse, the input of verify_extend."""
    flat, n = pad_block(data)
    off, length = real_proposals(data)
    take, tok_off, _, _ = tg.greedy_parse(torch.from_numpy(off),
                                          torch.from_numpy(length), SEG)
    return flat, n, take.numpy().reshape(-1), tok_off.numpy().reshape(-1)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_verify_extend_and_emit_segments_match_jax(twain, name):
    flat, n, take, tok_off = _parsed(_corpus(twain, name))
    (jflat, jtake, joff), (tflat, ttake, toff) = both(flat, take, tok_off)
    jsurv, jvlen = jemit.verify_extend(jflat.reshape(-1), jtake, joff, n, SEG)
    tsurv, tvlen = temit.verify_extend(tflat, ttake[None], toff[None], [n],
                                       SEG)
    np.testing.assert_array_equal(tsurv.numpy()[0], np.asarray(jsurv))
    np.testing.assert_array_equal(tvlen.numpy()[0], np.asarray(jvlen))
    assert int(tsurv.sum()) > 0

    jout, jlens = jemit.emit_segments(jflat.reshape(-1), jsurv, joff, jvlen,
                                      n, SEG)
    tout, tlens = temit.emit_segments(tflat, tsurv, toff[None], tvlen, [n],
                                      SEG)
    assert tout.dtype == torch.uint8 and tlens.dtype == torch.int32
    assert tout.shape == (1, flat.shape[1] // SEG, SEG + temit.OUT_PAD)
    np.testing.assert_array_equal(tlens.numpy()[0], np.asarray(jlens))
    np.testing.assert_array_equal(tout.numpy()[0], np.asarray(jout))


@pytest.mark.parametrize("ctx", [0, 1])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_encode_block_emit_matches_jax(twain, name, ctx):
    data = _corpus(twain, name)
    flat, n = pad_block(data)
    jout, jlens = jemit.encode_block_emit(jnp.asarray(flat), n, SEG, ctx=ctx)
    tout, tlens = temit.encode_block_emit(torch.from_numpy(flat), [n], SEG,
                                          ctx=ctx)
    np.testing.assert_array_equal(tlens.numpy()[0], np.asarray(jlens))
    np.testing.assert_array_equal(tout.numpy()[0], np.asarray(jout))
    if ctx == 0:
        nseg = -(-n // SEG)
        lens = tlens.numpy()[0]
        assert not lens[nseg:].any()
        body = b"".join(tout.numpy()[0, i, : lens[i]].tobytes()
                        for i in range(nseg))
        assert len(body) < n
        assert odec.decode_block(b"\x00" + put_uvarint(n) + body) == data


def test_uint8_input_gives_the_same_bytes(twain):
    data = _corpus(twain, "partial_tail")
    flat, n = pad_block(data)
    want = temit.encode_block_emit(torch.from_numpy(flat), [n], SEG, 0, 2)
    got = temit.encode_block_emit(torch.from_numpy(flat.astype(np.uint8)),
                                  [n], SEG, 0, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_copy3_word_wraps_like_int32():
    """o << 11 leaves int32 for offsets near 2**21; the bytes must be those
    of the wrapped word, as in JAX."""
    off = np.array([[65600, 70000, (1 << 21) + 65535, 1 << 21]], np.int32)
    ln = np.array([[4, 64, 65, 400]], np.int32)
    nl = np.array([[0, 3, 1, 2]], np.int32)
    (joff, jln, jnl), (toff, tln, tnl) = both(off, ln, nl)
    jb, jl = jemit._copy3_tok(joff, jln, jnl)
    tb, tl = temit._copy3_tok(toff, tln, tnl)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def codecs():
    return jdc.get_device_codec(), tdc.DeviceCodec("cpu")


def _decode(block):
    return odec.decode_block(block)


def _far(twain):
    """Matches 70000 bytes back: copy3 tokens, fused and plain."""
    noise = np.random.default_rng(5).integers(0, 256, 70000, dtype=np.uint8)
    head = noise.tobytes()
    return head + head[:9000] + twain[:2000] + head[9001:20000]


@pytest.mark.parametrize("name", ["partial_tail", "runs", "far"])
def test_encode_emit_matches_jax_codec(twain, codecs, name):
    jcodec, tcodec = codecs
    data = _far(twain) if name == "far" else _corpus(twain, name)
    want = jcodec.encode_emit(data, 2)
    got = tcodec.encode_emit(data, 2)
    assert got == want
    block, payload = got
    assert _decode(block) == data
    assert tdc.parse_hints(payload)[0] == SEG
    assert tcodec.encode_emit(b"", 2) is None


def test_encode_batch_emit_unequal_blocks_match_jax_codec(twain, codecs):
    """Blocks of unequal length in one batch: each gets the bytes the JAX
    codec gives it, an incompressible and an empty block give None, and
    every emitted block decodes."""
    jcodec, tcodec = codecs
    rng = np.random.default_rng(7)
    blocks = [
        (twain * 2)[:40000],
        twain[5000:25000],
        rng.integers(0, 256, 30000, dtype=np.uint8).tobytes(),
        b"",
        bytes(9000) + twain[:3000],
    ]
    before = tcodec.blocks_encoded
    want = jcodec.encode_batch_emit(blocks, 2)
    got = tcodec.encode_batch_emit(blocks, 2)
    assert got == want
    assert got[2] is None and got[3] is None
    assert tcodec.blocks_encoded == before + len(blocks)
    for b, res in zip(blocks, got):
        if res is not None:
            assert _decode(res[0]) == b
            # The port's own device decoder reads its hints.
            _, want_len, pos = odec.parse_header(res[0])
            assert tcodec.decode(res[0][pos:], res[1], want_len) == b


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_emit_segments_dispatches_to_plain_on_the_cpu(twain, name):
    """On CPU tensors emit_segments is emit_segments_plain: the bytes of
    the JAX emission, no kernel launch, every segment row counted as the
    plain version's while a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    from minlz_tpu_torch import _build, trace

    flat, n, take, tok_off = _parsed(_corpus(twain, name))
    (jflat, jtake, joff), (tflat, ttake, toff) = both(flat, take, tok_off)
    jsurv, jvlen = jemit.verify_extend(jflat.reshape(-1), jtake, joff, n, SEG)
    jout, jlens = jemit.emit_segments(jflat.reshape(-1), jsurv, joff, jvlen,
                                      n, SEG)
    tsurv, tvlen = temit.verify_extend(tflat, ttake[None], toff[None], [n],
                                       SEG)
    before = _build.launch_counts()["emit"]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tout, tlens = temit.emit_segments(tflat, tsurv, toff[None], tvlen,
                                          [n], SEG)
    counters = trace.snapshot()["counters"]
    trace.reset()
    assert _build.launch_counts()["emit"] == before
    assert counters["emit.plain_rows"] == flat.shape[1] // SEG
    assert "emit.kernel_rows" not in counters
    pout, plens = temit.emit_segments_plain(tflat, tsurv, toff[None], tvlen,
                                            [n], SEG)
    assert torch.equal(tout, pout) and torch.equal(tlens, plens)
    np.testing.assert_array_equal(tlens.numpy()[0], np.asarray(jlens))
    np.testing.assert_array_equal(tout.numpy()[0], np.asarray(jout))


@pytest.mark.parametrize("case", EMIT_CASES)
def test_emit_segments_edge_cases_match_jax(case):
    """The token layouts the card test holds the kernel to (literal runs
    around every header size, repeats across multiples of 1024, fused2 and
    fused3, long copy1, copy3 words that wrap int32, a random mix; a
    partial and two empty segments), block by block against the JAX
    emission."""
    data, surv, off, vlen, ns = emit_edge_case(case, SEG)
    tout, tlens = temit.emit_segments(*(torch.from_numpy(a) for a in (
        data, surv, off, vlen)), torch.from_numpy(ns), SEG)
    assert int(tlens.max()) <= SEG + temit.OUT_PAD
    for b in range(data.shape[0]):
        jd, js, jo, jv = (jnp.asarray(a[b].astype(np.int32))
                          for a in (data, surv, off, vlen))
        jout, jlens = jemit.emit_segments(jd, js, jo, jv, int(ns[b]), SEG)
        np.testing.assert_array_equal(tlens.numpy()[b], np.asarray(jlens))
        np.testing.assert_array_equal(tout.numpy()[b], np.asarray(jout))


def test_emit_segments_rejects():
    z = torch.zeros((2, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of seg"):
        temit.emit_segments(z, z, z, z, [1, 1], 3000)
    with pytest.raises(ValueError, match="multiple of seg"):
        temit.emit_segments(z, z, z, z, [1, 1], 2 * temit.MAX_SEG)
    with pytest.raises(ValueError, match="shape"):
        temit.emit_segments(z, z[:1], z, z, [1, 1], 4096)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        temit.emit_segments(z[0], z[0], z[0], z[0], [1], 4096)
    with pytest.raises(ValueError, match="multiple of seg"):
        temit.emit_segments_plain(z, z, z, z, [1, 1], 3000)
