"""The stream suite's random-access and framing cases (tests/test_stream.py)
recast on the port's device route in plain torch: minlz_tpu_torch.stream's
Writer and Reader with device="cpu", so every hinted block goes through the
DeviceCodec's decode path, the same Python around the kernels as on the
card.  Cases: seek and read_at, ReadSeeker over a loaded index,
concatenated streams with EOF enforcement, padding with an index, user
chunks, skip, decode_concurrent and device_emit.  Each case asserts that
the codec's blocks_decoded rose.  The corruption cases of a hinted stream
are tests/test_torch_stream_suite_hints.py's.

The device route decodes a block in seconds on the CPU (the plain parse steps
once a compressed byte row), so the inputs are the JAX suite's cut to at
most 256 KiB and blocks to 64 KiB or less, and random offsets come from a
seeded numpy generator.  The host route runs the whole matrix at the JAX
suite's sizes in tests/test_torch_stream_suite.py."""

import io

import numpy as np
import pytest

from minlz_tpu_torch import minlz
from minlz_tpu_torch.ops.device_codec import get_device_codec
from minlz_tpu_torch.stream import Index, Reader, ReadSeeker, Writer

from test_torch_common import Decoded, chunks

DEV = "cpu"
KB = 1 << 10


@pytest.fixture(scope="module")
def codec():
    return get_device_codec(DEV)


def write(data, **opts):
    buf = io.BytesIO()
    with Writer(buf, device=DEV, **opts) as w:
        w.write(data)
    return buf.getvalue()


@pytest.fixture(scope="module")
def seek_stream(twain):
    """256 KiB in four 64 KiB blocks with parse hints and an index."""
    data = (twain * 19)[:256 * KB]
    raw = write(data, block_size=64 * KB, add_index=True)
    assert sum(c[1] == minlz.CHUNK_TYPE_PARSE_HINT for c in chunks(raw)) == 4
    return data, raw


def test_seek_and_read_at(seek_stream, codec):
    """test_read_seeker_matrix's seeks, whence modes and read_at, on the
    device route: every span read from its block decoded on the device."""
    data, raw = seek_stream
    rs = ReadSeeker(io.BytesIO(raw), device=DEV)
    assert rs.codec is codec
    rng = np.random.default_rng(18)
    with Decoded(codec) as d:
        for off in rng.integers(0, len(data) - 100, 3):
            rs.seek(int(off))
            assert rs.read(100) == data[off:off + 100], off
        off = int(rng.integers(0, len(data) - 5000))
        assert rs.read_at(off, 5000) == data[off:off + 5000]
        assert rs.tell() == off + 5000
        rs.seek(-50, 2)
        assert rs.read(50) == data[-50:]
        rs.seek(1000)
        rs.seek(500, 1)
        assert rs.read(10) == data[1500:1510]
    assert d.n >= 6 and rs.hint_fallbacks == 0


def test_read_seeker_over_a_loaded_index(seek_stream, codec):
    """Index.load_stream, then ReadSeeker(index=...): a span across a block
    boundary decodes both blocks on the device."""
    data, raw = seek_stream
    idx = Index.load_stream(io.BytesIO(raw))
    assert idx.total_uncompressed == len(data)
    rs = ReadSeeker(io.BytesIO(raw), index=idx, device=DEV)
    with Decoded(codec) as d:
        off = 128 * KB - 3000
        rs.seek(off)
        assert rs.read(6000) == data[off:off + 6000]
    assert d.n == 2


def test_padding_with_index_load_stream(twain, codec):
    """The index chunk comes last, after the padding, so load_stream and
    seeking work on a padded stream; decompress drains it in one batch."""
    data = (twain * 10)[:128 * KB]
    raw = write(data, block_size=64 * KB, add_index=True, padding=4096)
    assert len(raw) % 4096 == 0
    idx = Index.load_stream(io.BytesIO(raw))
    assert idx.total_uncompressed == len(data)
    assert idx.total_compressed == -1
    rs = ReadSeeker(io.BytesIO(raw), device=DEV)
    with Decoded(codec) as d:
        for off in (100_000, len(data) - 17):
            rs.seek(off)
            assert rs.read(32) == data[off:off + 32]
        assert Reader(io.BytesIO(raw), device=DEV).readall() == data
    # Both seeks land in the second block, then the drain takes both.
    assert d.n == 4


def test_concatenated_streams_with_eof_enforcement(twain, codec):
    """Two complete streams decode back to back; a stream cut at its EOF
    chunk raises unless ignore_missing_eof."""
    one = write(twain, block_size=8 * KB, add_index=False)
    with Decoded(codec) as d:
        assert Reader(io.BytesIO(one + one), device=DEV).readall() == \
            twain + twain
    assert d.n == 4
    eof_at = next(pos for pos, ctype, _ in chunks(one)
                  if ctype == minlz.CHUNK_TYPE_EOF)
    with Decoded(codec) as d:
        with pytest.raises(minlz.CorruptError, match="missing EOF"):
            Reader(io.BytesIO(one[:eof_at]), device=DEV).readall()
        out = Reader(io.BytesIO(one[:eof_at]), device=DEV,
                     ignore_missing_eof=True).readall()
    assert out == twain and d.n == 4


def test_user_chunks(twain, codec):
    buf = io.BytesIO()
    with Writer(buf, device=DEV, block_size=8 * KB, add_index=False) as w:
        w.write(twain[:1000])
        w.add_user_chunk(0x90, b"metadata-payload")
        w.write(twain[1000:])
    seen = []
    r = Reader(io.BytesIO(buf.getvalue()), device=DEV)
    r.set_user_chunk_cb(0x90, seen.append)
    with Decoded(codec) as d:
        assert r.readall() == twain
    assert seen == [b"metadata-payload"] and d.n == 2


def test_skip(seek_stream, codec):
    """Reader.skip crosses whole blocks without decoding them and decodes
    the block it lands in on the device."""
    data, raw = seek_stream
    r = Reader(io.BytesIO(raw), device=DEV)
    with Decoded(codec) as d:
        r.skip(150_000)
        assert r.read(1000) == data[150_000:151_000]
        r.skip(5)
        assert r.read(10) == data[151_005:151_015]
    assert d.n == 1 and r.hint_fallbacks == 0


def test_decode_concurrent_ordered(seek_stream, codec):
    data, raw = seek_stream
    out = io.BytesIO()
    with Decoded(codec) as d:
        n = Reader(io.BytesIO(raw), device=DEV).decode_concurrent(
            out, concurrency=4)
    assert n == len(data) and out.getvalue() == data
    assert d.n == 4


def test_writer_device_emit_batched_roundtrip(twain, codec):
    """Writer(device_emit=True): the whole writer batch serializes in one
    device dispatch and the all-device stream decodes bit-exact through
    both readers."""
    payload = (twain * 8)[:64 * KB]
    raw = write(payload, device_emit=True, block_size=16 * KB,
                add_index=False, concurrency=1)
    with Decoded(codec) as d:
        assert Reader(io.BytesIO(raw), device=DEV).readall() == payload
    assert d.n == 4
    assert Reader(io.BytesIO(raw), device=None).readall() == payload


def test_skip_leaves_no_hints_to_the_next_block(twain, codec):
    """A block that skip passes over takes its parse hints with it: the
    next block, written without hints, decodes on the host, and no device
    decode is tried with the skipped block's hints."""
    data = (twain * 2)[:24 * KB]
    raw = write(data, block_size=16 * KB, add_index=False)
    hint = [c for c in chunks(raw) if c[1] == minlz.CHUNK_TYPE_PARSE_HINT]
    assert len(hint) == 2
    pos, _, clen = hint[1]
    raw = raw[:pos] + raw[pos + 4 + clen:]
    r = Reader(io.BytesIO(raw), device=DEV)
    with Decoded(codec) as d:
        r.skip(16 * KB + 100)
        assert r.read(1000) == data[16 * KB + 100:16 * KB + 1100]
    assert d.n == 0 and r.hint_fallbacks == 0
