"""The oracle suite (tests/test_oracle.py) recast on the port's own copies:
minlz_tpu_torch.oracle's golden decode, emitter unit tests and roundtrips,
minlz_tpu_torch.block's per-level ratios and minlz_tpu_torch.minlz's CRC
and varints, case for case.  Golden vectors produced by the Go reference
are the bit-exactness anchor.
"""

import os
import zlib

import pytest

from minlz_tpu_torch import minlz
from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.oracle import encode as oenc

from conftest import load_corpus


def test_golden_decode(twain, twain_mzb):
    """Decode the reference-encoder-produced block bit-exact."""
    got = odec.decode_block(twain_mzb)
    assert got == twain


def test_decoded_len_golden(twain, twain_mzb):
    assert odec.decoded_len(twain_mzb) == len(twain)


def test_roundtrip_twain(twain):
    enc = oenc.encode_block(twain)
    assert len(enc) < len(twain)
    assert odec.decode_block(enc) == twain


def test_ratio_close_to_reference(twain, twain_mzb):
    """The pure-Python oracle's greedy encoder stays within 10% of the
    golden size (it is a correctness anchor, not a ratio-critical path —
    per-level ratio parity is asserted in test_ratio_per_level below)."""
    enc = oenc.encode_block(twain)
    assert len(enc) <= len(twain_mzb) * 1.10, (len(enc), len(twain_mzb))


@pytest.mark.parametrize("level", [-1, 1, 2, 3])
def test_ratio_per_level(twain, twain_mzb, level):
    """Every block-API level must beat the reference golden block
    (testdata/Mark.Twain-Tom.Sawyer.txt.mzb, 8,875 B):
    BASELINE.md requires ratio <= reference at each level.  Measured
    watermarks (optimal-parse encoder): L-1 8767, L1 8763, L2 8745,
    L3 8741 — regressions beyond the golden size fail here."""
    from minlz_tpu_torch import block as blockapi

    enc = blockapi.encode(twain, level=level)
    assert len(enc) <= len(twain_mzb), (level, len(enc), len(twain_mzb))
    assert odec.decode_block(enc) == twain


def test_empty_and_tiny_blocks():
    assert odec.decode_block(b"\x00") == b""
    assert oenc.encode_block(b"") == b"\x00"
    for n in (1, 2, 15, 16, 17):
        data = bytes(range(n))
        enc = oenc.encode_block(data)
        assert odec.decode_block(enc) == data


def test_literal_only_block():
    # size field 0 => remainder is raw literals.
    raw = b"\x00\x00hello world"
    assert odec.decode_block(raw) == b"hello world"


def test_emitters_roundtrip_via_decoder():
    """Hand-built op sequences must decode to expected output
    (spec tables, SPEC.md §2.1-2.5)."""
    # Literal lengths across all extension widths.  A trailing repeat keeps
    # the block legal (compressed < decompressed; pure-literal blocks use the
    # size-0 raw representation instead).
    for n in (1, 29, 30, 285, 286, 65565, 65566, 70000):
        lits = bytes((i * 7) & 0xFF for i in range(n))
        rep = 64
        dst = bytearray()
        oenc.emit_literals(dst, lits)
        oenc.emit_repeat(dst, rep)
        block = b"\x00" + minlz.put_uvarint(n + rep) + bytes(dst)
        assert odec.decode_block(block) == lits + lits[-1:] * rep, n

    # Repeat lengths (offset-1 RLE of last prefix byte).  A large leading
    # repeat builds compression slack so even a 1-byte repeat op leaves the
    # block legal (compressed < decompressed, a spec requirement).
    lits, slack = b"abcdefgx", 100
    for n in (1, 28, 29, 30, 284, 285, 286, 65565, 65566, 70000):
        dst = bytearray()
        oenc.emit_literals(dst, lits)
        oenc.emit_repeat(dst, slack)
        oenc.emit_repeat(dst, n)
        block = b"\x00" + minlz.put_uvarint(len(lits) + slack + n) + bytes(dst)
        assert odec.decode_block(block) == lits + b"x" * (slack + n), n



_SLACK_LITS = b"qrstuvwx"
_SLACK = 200


def _slacked_block(body_ops: bytearray, expected_tail: bytes) -> tuple:
    """Wrap ops in a block with a cheap leading RLE run so the block always
    net-compresses (spec: compressed must be < decompressed).  Returns
    (block_bytes, expected_output)."""
    from minlz_tpu_torch.oracle import encode as _oe

    dst = bytearray()
    _oe.emit_literals(dst, _SLACK_LITS)
    _oe.emit_repeat(dst, _SLACK)
    dst += body_ops
    expected = _SLACK_LITS + _SLACK_LITS[-1:] * _SLACK + expected_tail
    block = b"\x00" + minlz.put_uvarint(len(expected)) + bytes(dst)
    return block, expected


@pytest.mark.parametrize("offset", [1, 2, 63, 64, 1023, 1024])
@pytest.mark.parametrize("length", [4, 17, 18, 19, 272, 273, 274, 1000])
def test_copy1_matrix(offset, length):
    prefix = bytes((i * 13 + 7) & 0xFF for i in range(offset))
    dst = bytearray()
    oenc.emit_literals(dst, prefix)
    oenc.emit_copy1(dst, offset, length)
    tail = bytearray(prefix)
    for i in range(length):
        tail.append(tail[len(tail) - offset])
    block, expect = _slacked_block(dst, bytes(tail))
    assert odec.decode_block(block) == expect


@pytest.mark.parametrize("offset", [64, 65, 65599])
@pytest.mark.parametrize("length", [4, 64, 67, 68, 69, 323, 324, 70000])
def test_copy2_matrix(offset, length):
    prefix = bytes((i * 31 + 3) & 0xFF for i in range(offset))
    dst = bytearray()
    oenc.emit_literals(dst, prefix)
    oenc.emit_copy2(dst, offset, length)
    tail = prefix + prefix * (length // offset) + prefix[: length % offset]
    block, expect = _slacked_block(dst, tail)
    assert odec.decode_block(block) == expect


@pytest.mark.parametrize("offset", [65536, 65537, 2162687])
@pytest.mark.parametrize("length", [4, 64, 67, 68, 323, 70000])
@pytest.mark.parametrize("nlits", [0, 1, 3])
def test_copy3_matrix(offset, length, nlits):
    prefix = bytes((i * 131 + 17) & 0xFF for i in range(offset))
    lits = bytes(range(nlits))
    dst = bytearray()
    oenc.emit_literals(dst, prefix)
    oenc.emit_copy3(dst, offset, length, lits)
    # Copy source is `offset` back from the position *after* the literals.
    tail = bytearray(prefix + lits)
    src_start = len(tail) - offset
    for i in range(length):
        tail.append(tail[src_start + i])
    block, expect = _slacked_block(dst, bytes(tail))
    assert odec.decode_block(block) == expect


@pytest.mark.parametrize("offset", [64, 100, 65599])
@pytest.mark.parametrize("length", [4, 11, 12, 50])
@pytest.mark.parametrize("nlits", [1, 2, 4])
def test_fused2_matrix(offset, length, nlits):
    prefix = bytes((i * 53 + 29) & 0xFF for i in range(offset))
    lits = bytes(range(64, 64 + nlits))
    dst = bytearray()
    oenc.emit_literals(dst, prefix)
    oenc.emit_fused2(dst, lits, offset, length)
    tail = bytearray(prefix + lits)
    src_start = len(tail) - offset
    for i in range(length):
        tail.append(tail[src_start + i])
    block, expect = _slacked_block(dst, bytes(tail))
    assert odec.decode_block(block) == expect


def test_decode_corpus_no_crash():
    """Fuzz corpus blocks must decode or raise CorruptError — never crash."""
    for data in load_corpus("block-corpus-dec.zip"):
        try:
            odec.decode_block(data)
        except minlz.CorruptError:
            pass


def test_encode_corpus_roundtrip():
    """Every corpus input must roundtrip through our encoder."""
    for data in load_corpus("block-corpus-enc.zip"):
        if len(data) > minlz.MAX_BLOCK_SIZE:
            continue
        enc = oenc.encode_block(data)
        assert len(enc) <= minlz.max_encoded_len(len(data))
        assert odec.decode_block(enc) == data


def test_crc32c_vectors():
    # RFC 3720 B.4 test vectors.
    assert minlz.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert minlz.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert minlz.crc32c(bytes(range(32))) == 0x46DD794E
    assert minlz.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C


def test_crc_masking():
    for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert minlz.unmask_checksum(minlz.mask_checksum(v)) == v


def test_varints():
    for v in (0, 1, 127, 128, 300, 1 << 20, (1 << 64) - 1):
        enc = minlz.put_uvarint(v)
        got, pos = minlz.read_uvarint(enc)
        assert got == v and pos == len(enc)
