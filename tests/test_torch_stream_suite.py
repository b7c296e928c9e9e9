"""The stream suite (tests/test_stream.py) recast on the port's own stream
layer: minlz_tpu_torch.stream's Writer, Reader, ReadSeeker, Index,
compress and decompress on the host route (device=None, the JAX package's
default: no DeviceCodec), case for case and with the same inputs: framing,
CRC, EOF, index and seek, concatenation, padding, user chunks, options.
Two cases change: the CRC case flips a byte inside the first data chunk,
found by walking the chunk headers (the stream's layout, not a fixed
offset), and the device_emit case, whose JAX form asks for the device,
runs on the device route in tests/test_torch_stream_suite_device.py with
the other device-route cases.  The mesh case is tests/test_torch_mesh.py's.
"""

import io
from functools import partial

import pytest

from minlz_tpu_torch import minlz, stream
from minlz_tpu_torch.stream import Index

from test_torch_common import chunks

# The host route, the JAX Reader's and Writer's default.
Writer = partial(stream.Writer, device=None)
Reader = partial(stream.Reader, device=None)
ReadSeeker = partial(stream.ReadSeeker, device=None)
compress = partial(stream.compress, device=None)
decompress = partial(stream.decompress, device=None)


def first_data_chunk(raw: bytes):
    """(offset, type, payload length) of the first data chunk."""
    return next(c for c in chunks(raw)
                if c[1] in (minlz.CHUNK_TYPE_MINLZ_COMPRESSED,
                            minlz.CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                            minlz.CHUNK_TYPE_UNCOMPRESSED_DATA))


def test_roundtrip_small(twain):
    enc = compress(twain)
    assert decompress(enc) == twain


def test_roundtrip_multiblock(twain):
    data = twain * 40  # ~566KB
    enc = compress(data, block_size=64 << 10)
    assert len(enc) < len(data)
    assert decompress(enc) == data


def test_roundtrip_incompressible():
    import numpy as np

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    enc = compress(data, block_size=64 << 10)
    # Incompressible data stored as uncompressed chunks; overhead is tiny.
    assert len(enc) < len(data) * 1.01
    assert decompress(enc) == data


def test_empty_stream():
    enc = compress(b"")
    assert decompress(enc) == b""


def test_stream_header_and_eof(twain):
    enc = compress(twain, block_size=64 << 10)
    assert enc.startswith(minlz.MAGIC_CHUNK)
    # Block size indicator: log2(64K)-10 = 6.
    assert enc[9] == 6


@pytest.mark.parametrize("where", ["crc", "body", "last"])
def test_crc_corruption_detected(twain, where):
    enc = bytearray(compress(twain))
    # Flip a byte inside the first data chunk's payload: its checksum, a
    # byte of its body, its last byte.
    pos, _, clen = first_data_chunk(bytes(enc))
    enc[pos + 4 + {"crc": 1, "body": clen // 2, "last": clen - 1}[where]] \
        ^= 0xFF
    with pytest.raises(minlz.CorruptError):
        decompress(bytes(enc))


def test_truncation_detected(twain):
    enc = compress(twain * 10, block_size=64 << 10)
    with pytest.raises((minlz.CorruptError, EOFError)):
        decompress(enc[: len(enc) // 2])


def test_eof_size_validated(twain):
    enc = bytearray(compress(twain))
    # Find the EOF chunk (0x20) and corrupt its uvarint size payload.
    i = len(enc) - 1
    # scan backwards for 0x20 chunk header; EOF payload is small varint
    pos = enc.rfind(b"\x20", 0, len(enc))
    # instead: decode normally to be sure baseline works
    assert decompress(bytes(enc)) == twain


def test_flush_partial_blocks(twain):
    buf = io.BytesIO()
    w = Writer(buf, block_size=64 << 10, add_index=False)
    w.write(twain[:1000])
    w.flush()
    w.write(twain[1000:])
    w.close()
    assert decompress(buf.getvalue()) == twain


def test_concatenated_streams(twain):
    enc = compress(twain) + compress(twain[::-1])
    assert decompress(enc) == twain + twain[::-1]


def test_padding():
    for pad in (64, 1024, 4096):
        enc = compress(b"hello world" * 100, padding=pad)
        assert len(enc) % pad == 0
        assert decompress(enc) == b"hello world" * 100


def test_padding_with_index_load_stream(twain):
    # Round-1 regression: index was emitted before padding, so load_stream
    # (which requires the trailer at EOF, reference index.go:416-448) failed
    # on padded+indexed streams.  The index chunk must come LAST.
    data = twain * 40
    for pad in (4096, 1 << 16):
        buf = io.BytesIO()
        with Writer(buf, block_size=64 << 10, add_index=True, padding=pad) as w:
            w.encode_buffer(data)
        raw = buf.getvalue()
        assert len(raw) % pad == 0
        buf.seek(0)
        idx = Index.load_stream(buf)
        assert idx.total_uncompressed == len(data)
        # Padded streams record unknown compressed total (reference
        # closeIndex sets compSize=-1 when padding is active).
        assert idx.total_compressed == -1
        # Seeking through the loaded index must still work.
        buf.seek(0)
        rs = ReadSeeker(buf)
        for off in (0, 100_000, len(data) - 17):
            rs.seek(off)
            assert rs.read(32) == data[off : off + 32]
        assert decompress(raw) == data


def test_writer_sticky_error(twain):
    # Reference writer.go:168-179: the first encoder failure is latched and
    # every subsequent call re-raises it.
    class Boom(RuntimeError):
        pass

    def bad_encoder(data, level):
        raise Boom("encoder exploded")

    buf = io.BytesIO()
    w = Writer(buf, block_size=4 << 10, add_index=False,
               custom_encoder=bad_encoder, concurrency=1)
    with pytest.raises(Boom):
        w.write(twain[: 64 << 10])
        w.flush()
    # Latched: subsequent API calls re-raise without touching the encoder.
    with pytest.raises(Boom):
        w.write(b"more")
    with pytest.raises(Boom):
        w.flush()


def test_user_chunks(twain):
    buf = io.BytesIO()
    w = Writer(buf, add_index=False)
    w.write(twain[:100])
    w.add_user_chunk(0x90, b"metadata!")
    w.write(twain[100:])
    w.close()
    # Default reader skips user chunks.
    assert decompress(buf.getvalue()) == twain
    # Callback reader sees them.
    seen = []
    r = Reader(io.BytesIO(buf.getvalue()), user_chunk_cb={0x90: seen.append})
    assert r.readall() == twain
    assert seen == [b"metadata!"]


def test_nonskippable_user_chunk_rejected(twain):
    buf = io.BytesIO()
    w = Writer(buf, add_index=False)
    w.write(twain)
    w.add_user_chunk(0xC5, b"must-understand")
    w.close()
    with pytest.raises(minlz.UnsupportedError):
        decompress(buf.getvalue())


def test_uncompressed_writer_option(twain):
    enc = compress(twain, uncompressed=True)
    assert decompress(enc) == twain
    assert len(enc) > len(twain)  # stored raw + framing


def test_skip(twain):
    data = twain * 40
    enc = compress(data, block_size=64 << 10)
    r = Reader(io.BytesIO(enc))
    r.skip(100_000)
    assert r.read(1000) == data[100_000:101_000]
    r.skip(5)
    assert r.read(10) == data[101_005:101_015]


def test_levels_roundtrip(twain):
    sizes = {}
    for level in (minlz.LEVEL_SUPER_FAST, minlz.LEVEL_FASTEST,
                  minlz.LEVEL_BALANCED, minlz.LEVEL_SMALLEST):
        enc = compress(twain * 4, level=level, block_size=64 << 10)
        assert decompress(enc) == twain * 4
        sizes[level] = len(enc)


def test_custom_encoder(twain):
    calls = []

    def custom(src, level):
        calls.append(len(src))
        return None  # fall back to builtin

    enc = compress(twain, custom_encoder=custom)
    assert decompress(enc) == twain
    assert calls


# --- Index / seek ----------------------------------------------------------


def test_index_roundtrip_wire():
    idx = Index()
    idx.total_uncompressed = 10_000_000
    idx.total_compressed = 3_000_000
    idx.est_block_uncomp = 1 << 20
    off = [(0, 0)]
    for i in range(1, 10):
        off.append((i * 300_000 + (i % 3) * 17, i * (1 << 20)))
    idx.info = off
    wire = idx.marshal()
    assert wire[0] == minlz.CHUNK_TYPE_INDEX
    idx2 = Index.load(wire)
    assert idx2.info == idx.info
    assert idx2.total_uncompressed == idx.total_uncompressed
    assert idx2.total_compressed == idx.total_compressed


def test_index_remove_restore_headers():
    idx = Index()
    idx.total_uncompressed = 500
    idx.total_compressed = 100
    idx.est_block_uncomp = 1 << 20
    idx.info = [(0, 0)]
    stripped = idx.remove_headers()
    restored = Index.restore_headers(stripped)
    idx2 = Index.load(restored)
    assert idx2.info == idx.info


def test_index_find():
    idx = Index()
    idx.total_uncompressed = 5 << 20
    idx.info = [(0, 0), (1000, 1 << 20), (2000, 2 << 20)]
    assert idx.find(0) == (0, 0)
    assert idx.find((1 << 20) - 1) == (0, 0)
    assert idx.find(1 << 20) == (1000, 1 << 20)
    assert idx.find((3 << 20) - 1) == (2000, 2 << 20)


@pytest.fixture(scope="module")
def indexed_stream(twain):
    """The stream that test_seek_stream and test_index_stream_load each
    write in the JAX suite, written once here: ~4.2MB => several
    1MB-indexed blocks at 256K blocks."""
    data = twain * 300
    buf = io.BytesIO()
    with Writer(buf, block_size=256 << 10, add_index=True) as w:
        w.encode_buffer(data)
    return data, buf.getvalue()


def test_seek_stream(indexed_stream):
    data, raw = indexed_stream
    buf = io.BytesIO(raw)
    rs = ReadSeeker(buf)
    for off in (0, 5, 1_000_000, 2_345_678, len(data) - 10):
        rs.seek(off)
        assert rs.read(64) == data[off : off + 64], off


def test_index_stream_load(indexed_stream):
    data, raw = indexed_stream
    idx = Index.load_stream(io.BytesIO(raw))
    assert idx.total_uncompressed == len(data)
    assert idx.info[0] == (0, 0) or idx.info[0][1] == 0


def test_truncated_stream_missing_eof_detected(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, add_index=False) as w:
        w.write(twain)
    raw = buf.getvalue()
    # Chop the stream at the EOF chunk boundary (simulated truncation).
    pos = 0
    eof_at = None
    while pos + 4 <= len(raw):
        ctype = raw[pos]
        clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
        if ctype == 0x20:
            eof_at = pos
            break
        pos += 4 + clen
    assert eof_at is not None
    trunc = raw[:eof_at]
    with pytest.raises(minlz.CorruptError):
        Reader(io.BytesIO(trunc)).readall()
    # Escape hatch for growing files (tail -f).
    out = Reader(io.BytesIO(trunc), ignore_missing_eof=True).readall()
    assert twain.startswith(out) or out == twain


def test_reader_eof_enforcement_concat_streams(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, add_index=False) as w:
        w.write(twain)
    one = buf.getvalue()
    # Two complete concatenated streams decode fine.
    assert Reader(io.BytesIO(one + one)).readall() == twain + twain


def test_decode_concurrent_ordered(twain):
    data = twain * 40
    buf = io.BytesIO()
    with Writer(buf, block_size=16 << 10) as w:
        w.encode_buffer(data)
    raw = buf.getvalue()
    out = io.BytesIO()
    n = Reader(io.BytesIO(raw)).decode_concurrent(out, concurrency=4)
    assert n == len(data)
    assert out.getvalue() == data
    # Sequential path agrees.
    out2 = io.BytesIO()
    Reader(io.BytesIO(raw)).decode_concurrent(out2, concurrency=1)
    assert out2.getvalue() == data


def test_writer_debug_validate(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, debug_validate=True,
                concurrency=1) as w:
        w.encode_buffer(twain * 4)
    assert Reader(io.BytesIO(buf.getvalue())).readall() == twain * 4


def test_writer_option_matrix(twain):
    """Sweep writer options the way the reference's writer_test does."""
    import itertools

    data = twain * 3
    for bs, level, idx, pad in itertools.product(
        (4 << 10, 32 << 10), (-1, 1, 2, 3), (False, True), (0, 4096)
    ):
        buf = io.BytesIO()
        with Writer(buf, block_size=bs, level=level, add_index=idx,
                    padding=pad, concurrency=1) as w:
            w.write(data)
        raw = buf.getvalue()
        if pad:
            assert len(raw) % pad == 0, (bs, level, idx, pad)
        assert Reader(io.BytesIO(raw)).readall() == data, (bs, level, idx, pad)


def test_writer_uncompressed_and_custom_encoder(twain):
    buf = io.BytesIO()
    with Writer(buf, uncompressed=True, block_size=8 << 10) as w:
        w.write(twain)
    raw = buf.getvalue()
    assert raw.count(b"\x01") >= 1  # uncompressed chunks present
    assert Reader(io.BytesIO(raw)).readall() == twain

    calls = []

    def custom(src, level):
        calls.append(len(src))
        return None  # decline; writer falls back to the builtin encoder

    buf = io.BytesIO()
    with Writer(buf, custom_encoder=custom, block_size=8 << 10,
                concurrency=1) as w:
        w.write(twain)
    assert calls, "custom encoder was not consulted"
    assert Reader(io.BytesIO(buf.getvalue())).readall() == twain


def test_reader_max_block_size_rejects(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=64 << 10) as w:
        w.write(twain)
    with pytest.raises(minlz.TooLargeError):
        Reader(io.BytesIO(buf.getvalue()), max_block_size=16 << 10).readall()


def test_user_chunk_roundtrip(twain):
    buf = io.BytesIO()
    with Writer(buf, add_index=False) as w:
        w.write(twain[:1000])
        w.add_user_chunk(0x90, b"metadata-payload")
        w.write(twain[1000:])
    seen = []
    r = Reader(io.BytesIO(buf.getvalue()))
    r.set_user_chunk_cb(0x90, seen.append)
    assert r.readall() == twain
    assert seen == [b"metadata-payload"]


def test_flush_on_write_and_async_flush(twain):
    buf = io.BytesIO()
    w = Writer(buf, block_size=1 << 20, flush_on_write=True, add_index=False)
    w.write(twain[:5000])
    mid = len(buf.getvalue())
    assert mid > 0  # flushed despite partial block
    w.write(twain[5000:])
    w.async_flush()
    w.close()
    assert Reader(io.BytesIO(buf.getvalue())).readall() == twain


def test_index_reduce_caps_entries(twain):
    """Indexes decimate to the entry cap like the reference (index.go:147)."""

    idx = Index()
    # Feed far more entries than the cap with >=1MB spacing.
    for i in range(300000):
        idx.add(i * 1200, i * (1 << 20))
    assert len(idx.info) <= 65536
    # Entries remain monotone and findable.
    idx.total_uncompressed = 300000 << 20
    idx.total_compressed = 300000 * 1200
    coff, uoff = idx.find(12345 << 20)
    assert uoff <= 12345 << 20


def test_concatenated_streams_and_seek(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, add_index=False) as w:
        w.write(twain)
    one = buf.getvalue()
    triple = one * 3
    assert Reader(io.BytesIO(triple)).readall() == twain * 3


def test_read_seeker_matrix(twain):
    data = twain * 10
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10) as w:
        w.encode_buffer(data)
    raw = buf.getvalue()
    rs = ReadSeeker(io.BytesIO(raw))
    import random

    rnd = random.Random(9)
    for _ in range(20):
        off = rnd.randrange(0, len(data) - 100)
        rs.seek(off)
        assert rs.read(100) == data[off : off + 100], off
    # whence modes
    rs.seek(-50, 2)
    assert rs.read(50) == data[-50:]
    rs.seek(1000)
    rs.seek(500, 1)
    assert rs.read(10) == data[1500:1510]
