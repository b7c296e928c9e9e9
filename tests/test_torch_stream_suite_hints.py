"""The stream suite's CRC case (tests/test_stream.py) recast on the port's
device route in plain torch (minlz_tpu_torch.stream with device="cpu"), on
a stream with parse hints: a flipped byte of a data chunk raises
CorruptError, and a flipped byte of the 0x88 parse-hint chunk that leaves
the hints corrupt leaves the block's bytes exact, decoded on the host,
since hints are advisory.  Hints that still parse but lie reach the device,
and its output then fails the chunk's CRC and raises, as the JAX package's
Reader does.  The chunks are found by walking their headers.  The JAX suite
flips byte 20 of its stream; in a stream with hints that byte lies in the
0x88 chunk.

Each device decode takes seconds on the CPU (the plain parse steps once a
compressed byte row), so the stream is one block of text that compresses
well."""

import io

import pytest

from minlz_tpu_torch import minlz
from minlz_tpu_torch.ops.device_codec import get_device_codec
from minlz_tpu_torch.stream import Reader, Writer

from test_torch_common import Decoded, chunks

DEV = "cpu"


@pytest.fixture(scope="module")
def codec():
    return get_device_codec(DEV)


@pytest.fixture(scope="module")
def text(twain):
    """Twain's first 2 KiB seven times, Twain's length: four segments, so
    the hints hold four offsets as Twain's do, but each lane compresses to
    a quarter of Twain's rows and a device decode costs a quarter."""
    return (twain[:2048] * 7)[:len(twain)]


@pytest.fixture(scope="module")
def hinted(text):
    """The text in one hinted block: (stream, its chunks)."""
    buf = io.BytesIO()
    with Writer(buf, device=DEV, block_size=64 << 10, add_index=False) as w:
        w.write(text)
    raw = buf.getvalue()
    return raw, chunks(raw)


def test_crc_corruption_in_a_data_chunk(hinted, codec):
    raw, cs = hinted
    pos, ctype, clen = next(c for c in cs
                            if c[1] == minlz.CHUNK_TYPE_MINLZ_COMPRESSED)
    with Decoded(codec) as d:
        for k in (1, clen // 2):
            bad = bytearray(raw)
            bad[pos + 4 + k] ^= 0xFF
            with pytest.raises(minlz.CorruptError):
                Reader(io.BytesIO(bytes(bad)), device=DEV).readall()
    # A flipped checksum leaves the block sound: the device decodes it.
    assert d.n >= 1


# The hint payload's head: "MZPH", the version, the segment size (4096,
# two uvarint bytes) and the count of offsets.  A flip there leaves hints
# that do not parse or do not cover the block.
HEAD = 8


@pytest.mark.parametrize("route", ["read", "readall"])
def test_corrupt_hints_decode_on_the_host(text, hinted, codec, route):
    """Every byte of the 0x88 chunk's payload flipped in turn, on both
    reader routes: one block a dispatch (read) and the batched drain
    (readall).  A flip in the payload's head leaves corrupt hints: the
    block reads back exact, decoded on the host.  Any other flip either
    leaves hints the device decodes right (the range clamp) or hints that
    lie: the device's output then fails the chunk's CRC and the read
    raises.  No output that fails its CRC is replaced by the host's."""
    raw, cs = hinted
    pos, _, clen = next(c for c in cs
                        if c[1] == minlz.CHUNK_TYPE_PARSE_HINT)
    with Decoded(codec) as d:
        r = Reader(io.BytesIO(raw), device=DEV)
        assert (r.read() if route == "read" else r.readall()) == text
    assert d.n == 1 and r.hint_fallbacks == 0
    seen = []
    for k in range(clen):
        bad = bytearray(raw)
        bad[pos + 4 + k] ^= 0xFF
        r = Reader(io.BytesIO(bytes(bad)), device=DEV)
        got = None
        with Decoded(codec) as d:
            try:
                got = r.read() if route == "read" else r.readall()
            except minlz.CorruptError as exc:
                assert "CRC mismatch" in str(exc), (k, exc)
        if got is None:
            assert d.n == 1 and r.hint_fallbacks == 0, k
            seen.append("lie")
            continue
        assert got == text, k
        if r.hint_fallbacks:
            assert r.hint_fallbacks == 1 and d.n == 0, k
            seen.append("host")
        else:
            assert d.n == 1, k
            seen.append("card")
    assert seen[:HEAD] == ["host"] * HEAD
    # Some flips leave hints that parse but lie.
    assert "lie" in seen
