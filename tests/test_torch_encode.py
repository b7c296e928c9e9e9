"""Encode parity: the port's match finder (minlz_tpu_torch.ops.encode_kernel)
against the JAX one, bit for bit, and the encoded blocks and hints byte for
byte.  Both run on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minlz_tpu.ops import encode_kernel as jek
from minlz_tpu.ops import exec_chain as jec
from minlz_tpu_torch.ops import encode_kernel as tek
from minlz_tpu_torch.ops.device_codec import RANGE

N = 256 << 10


@pytest.fixture(scope="module")
def inputs(twain):
    """Twain and a 256 KiB prefix of the bench corpus, zero padded to one
    [2, N] batch with their valid lengths."""
    from minlz_tpu_torch.corpus import make_corpus

    corpus = make_corpus(N)
    arr = np.zeros((2, N), np.int32)
    arr[0, : len(twain)] = np.frombuffer(twain, np.uint8)
    arr[1] = np.frombuffer(corpus, np.uint8)
    return arr, np.array([len(twain), N], np.int32)


@pytest.mark.parametrize("rng", [0, RANGE])
@pytest.mark.parametrize("level", [-1, 1, 2, 3])
def test_find_matches_bit_identical(inputs, level, rng):
    arr, ns = inputs
    jax_fn = jax.jit(jax.vmap(
        lambda d, n: jek.find_matches_dyn(d[None], n, jek.SEG, rng, level)))
    jd, jl = (np.asarray(x)[:, 0] for x in jax_fn(jnp.asarray(arr),
                                                   jnp.asarray(ns)))
    td, tl = tek.find_matches_dyn(torch.from_numpy(arr), torch.from_numpy(ns),
                                  tek.SEG, rng, level)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert (td > 0).sum() > 1000  # the inputs do have matches


def test_constants_match():
    assert (tek.SEG, tek.WINDOW, RANGE) == (jek.SEG, jek.WINDOW, jec.RANGE)
    for total in (1, 4095, 4097, 20000, 32768, 32769, 1 << 20, 3 << 20):
        assert tek._size_class(total) == jek._size_class(total)


def test_encode_blocks_device_identical(twain):
    """The same blocks and hints as the JAX encode_blocks_device (one batch
    of mixed blocks, one of them incompressible)."""
    rng = np.random.default_rng(5)
    blocks = [
        (twain * 5)[: 64 << 10],
        rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        bytes(range(256)) * 100,
        twain[1000:9000],
    ]
    for level in (-1, 2):
        want = jek.encode_blocks_device(blocks, 4096, jec.RANGE, level)
        got = tek.encode_blocks_device(blocks, 4096, RANGE, level, "cpu")
        assert got == want
        assert got[1] == (None, None)


def test_encode_block_device_identical(twain):
    for data in (twain, (twain * 3)[: 40000]):
        want = jek.encode_block_device(data, 4096, RANGE, 3)
        got = tek.encode_block_device(data, 4096, RANGE, 3, "cpu")
        assert got == want
    assert tek.encode_block_device(b"", device="cpu") == (b"\x00", [])


def test_missing_native_codec_raises(monkeypatch):
    """Without the native library the default serializer raises; nothing
    switches to the greedy one by itself."""
    monkeypatch.setattr(tek, "get_codec", lambda: None)
    with pytest.raises(RuntimeError, match="native codec"):
        tek.encode_blocks_device([b"abcd" * 100], device="cpu")
    with pytest.raises(RuntimeError, match="native codec"):
        tek.encode_block_device(b"abcd" * 100, device="cpu")
    block, _ = tek.encode_block_device(b"abcd" * 100, device="cpu",
                                       serializer="greedy")
    assert block is not None
    with pytest.raises(ValueError, match="serializer"):
        tek.encode_block_device(b"abcd" * 100, device="cpu",
                                serializer="auto")


def _greedy_cases(twain):
    rng = np.random.default_rng(9)
    return {
        "text": (twain * 3)[: 64 << 10],
        "partial_tail": twain[2000:23000],
        "records": b"".join(b"id=%06d;flag=%d;name=user%03d\n"
                            % (i, i % 3, int(rng.integers(0, 200)))
                            for i in range(2500)),
        "noise": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("rng", [0, RANGE])
@pytest.mark.parametrize("name", ["text", "partial_tail", "records", "noise"])
def test_greedy_serializer_block_identical(twain, monkeypatch, name, rng):
    """serializer="greedy" gives the block and hints that the JAX package
    gives when its native codec is masked out (Pallas greedy parse in
    interpret mode, then serialize_block)."""
    import minlz_tpu.native.codec as jnative
    from minlz_tpu_torch.oracle import decode as odec

    data = _greedy_cases(twain)[name]
    monkeypatch.setattr(jnative, "get_codec", lambda: None)
    want = jek.encode_block_device(data, 4096, rng, 2)
    got = tek.encode_block_device(data, 4096, rng, 2, "cpu",
                                  serializer="greedy")
    assert got == want
    if name == "noise":
        assert got == (None, None)
    else:
        assert odec.decode_block(got[0]) == data
        assert [h[1] for h in got[1]] == list(range(0, len(data), 4096))


def test_serializers_match_jax(twain):
    """serialize_block and serialize_segment, given the same op arrays,
    write the JAX package's bytes."""
    from minlz_tpu_torch.ops import greedy as tg

    from test_torch_common import real_proposals

    data = (twain * 2)[:30000]
    off, length = real_proposals(data)
    toff, tlen = torch.from_numpy(off), torch.from_numpy(length)
    pos, o, ln, isrep, count = (
        x.numpy() if isinstance(x, torch.Tensor) else x
        for x in tg.greedy_parse_compact(toff, tlen, 4096))
    assert tek.serialize_block(data, pos, o, ln, isrep, count) \
        == jek.serialize_block(data, pos, o, ln, isrep, count)
    take, tok_off, tok_len, is_rep = (
        x.numpy() for x in tg.greedy_parse(toff, tlen, 4096))
    for si in (0, 3, 7):
        src = data[si * 4096:(si + 1) * 4096]
        args = (src, take[si], tok_off[si], tok_len[si], is_rep[si])
        assert tek.serialize_segment(*args) == jek.serialize_segment(*args)


def test_entry_matches_graft_entry():
    """The port's entry() step returns the sums of the JAX package's."""
    import __graft_entry__ as graft
    from minlz_tpu_torch.entry import entry

    jfn, jargs = graft.entry()
    tfn, targs = entry("cpu")
    np.testing.assert_array_equal(targs[0].numpy(), np.asarray(jargs[0]))
    want = [int(x) for x in jax.jit(jfn)(*jargs)]
    got = [int(x) for x in tfn(*targs)]
    assert got == want
    assert got[0] > 0
