"""LZ4 conversion in the port (minlz_tpu_torch.lz4): the cases of
test_lz4.py on the port, and parity with minlz_tpu.lz4 on the same seeded
inputs (tolerance 0: bytes)."""

import io

import numpy as np
import pytest

from minlz_tpu import lz4 as jlz4
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch import lz4
from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.stream import Reader, Writer

from conftest import load_corpus


def test_lz4_mini_codec_roundtrip(twain):
    enc = lz4.lz4_encode_block(twain)
    assert len(enc) < len(twain)
    assert lz4.lz4_decode_block(enc) == twain


def test_convert_block_twain(twain):
    enc = lz4.lz4_encode_block(twain)
    mlz = lz4.convert_block(enc)
    assert odec.decode_block(mlz) == twain
    # Conversion should not be drastically larger than the LZ4 input.
    assert len(mlz) <= len(enc) * 1.05


def _mixed(twain, seed):
    rng = np.random.default_rng(seed)
    return (
        twain[:4000]
        + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        + twain[:4000]
        + b"x" * 500
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convert_block_mixed(twain, seed):
    data = _mixed(twain, seed)
    enc = lz4.lz4_encode_block(data)
    assert lz4.lz4_decode_block(enc) == data
    mlz = lz4.convert_block(enc)
    assert odec.decode_block(mlz) == data


def test_convert_corpus():
    """Round-trip corpus inputs through lz4-encode -> convert -> decode."""
    n = 0
    for data in load_corpus("FuzzLZ4Block.zip"):
        if len(data) < 16 or len(data) > 100_000:
            continue
        enc = lz4.lz4_encode_block(data)
        if lz4.lz4_decode_block(enc) != data:
            continue
        mlz = lz4.convert_block(enc)
        assert odec.decode_block(mlz) == data
        n += 1
        if n >= 15:
            break
    assert n >= 5


def test_corrupt_lz4_rejected():
    with pytest.raises(lz4.LZ4CorruptError):
        lz4.convert_block(b"\xff\x01\x02")  # truncated literal ext
    with pytest.raises(lz4.LZ4CorruptError):
        # offset beyond output
        lz4.convert_block(bytes([1 << 4]) + b"A" + b"\x10\x00" + b"\x00")


def _frame(data, bs, raw_every=0):
    """An LZ4 frame by hand: version 01, independent blocks, no checksums
    or size; every ``raw_every``-th block stored raw."""
    frame = bytearray(lz4.LZ4_FRAME_MAGIC)
    frame.append(0x60)
    frame.append(0x40)  # BD: 64KB max block
    frame.append(0)     # header checksum (not validated by the converter)
    for k, i in enumerate(range(0, len(data), bs)):
        chunk = data[i : i + bs]
        if raw_every and k % raw_every == raw_every - 1:
            frame += (len(chunk) | 0x80000000).to_bytes(4, "little")
            frame += chunk
            continue
        blk = lz4.lz4_encode_block(chunk)
        frame += len(blk).to_bytes(4, "little")
        frame += blk
    frame += (0).to_bytes(4, "little")  # EndMark
    return bytes(frame)


def test_lz4_frame_conversion(twain):
    """Build an LZ4 frame by hand, convert it to a MinLZ stream, decode."""
    data = twain * 6
    bs = 64 << 10
    buf = io.BytesIO()
    w = Writer(buf, block_size=bs, add_index=False, device=None)
    n = lz4.convert_frame(_frame(data, bs), w)
    w.close()
    assert n == len(data)
    assert Reader(io.BytesIO(buf.getvalue()), device=None).readall() == data


def test_lz4_frame_dependent_blocks_rejected():
    frame = bytes(lz4.LZ4_FRAME_MAGIC) + bytes([0x40, 0x40, 0]) + b"\x00" * 4
    with pytest.raises(lz4.LZ4CorruptError):
        list(lz4.parse_lz4_frame(frame))


def _cases(twain):
    rng = np.random.default_rng(7)
    return [
        twain,
        twain[:100],
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        b"A" * 10000,
        bytes(rng.integers(65, 70, 20000, dtype=np.uint8)),
    ] + [_mixed(twain, seed) for seed in range(3)]


def test_convert_block_native_differential(twain):
    """The C++ converter (cvtLZ4BlockAsm analog) must emit byte-identical
    MinLZ blocks to the pure-Python walker on every input shape."""
    from minlz_tpu_torch.native.codec import get_codec

    assert get_codec() is not None
    assert hasattr(get_codec()._lib, "minlz_lz4_convert_block")
    for data in _cases(twain):
        enc = lz4.lz4_encode_block(data)
        assert lz4.convert_block(enc, native=True) == lz4.convert_block(
            enc, native=False
        )


# ---- against minlz_tpu.lz4 ------------------------------------------------

@pytest.mark.parametrize("native", [False, True])
def test_convert_block_matches_jax(twain, native):
    for data in _cases(twain):
        enc = lz4.lz4_encode_block(data)
        assert enc == jlz4.lz4_encode_block(data)
        assert lz4.lz4_decode_block(enc) == jlz4.lz4_decode_block(enc)
        got = lz4.convert_block(enc, native=native)
        assert got == jlz4.convert_block(enc, native=native)
        assert odec.decode_block(got) == data


@pytest.mark.parametrize("transcode", [True, False])
def test_convert_frame_matches_jax(twain, transcode):
    """convert_frame through the port's Writer writes the bytes of
    minlz_tpu's through its own, raw frame blocks included."""
    data = (twain * 9)[: 100_000] + _mixed(twain, 5)
    bs = 32 << 10
    frame = _frame(data, bs, raw_every=3)
    streams = []
    for writer_cls, mod, opts in ((Writer, lz4, {"device": None}),
                                  (JaxWriter, jlz4, {})):
        buf = io.BytesIO()
        w = writer_cls(buf, block_size=bs, add_index=True, **opts)
        assert mod.convert_frame(frame, w, transcode=transcode) == len(data)
        w.close()
        streams.append(buf.getvalue())
    assert streams[0] == streams[1]
    assert Reader(io.BytesIO(streams[0]), device=None).readall() == data
