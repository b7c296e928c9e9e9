"""Format identity, constants, varints and checksums for TPU-MinLZ.

Implements the MinLZ specification v1.0 (format constants mirror the
reference's ``minlz.go:24-140`` and ``SPEC.md``).  Everything in this module is
host-side, dependency-free Python — it is the single source of truth for wire
constants shared by the NumPy oracle, the Pallas kernels and the stream layer.
"""

from __future__ import annotations

import zlib

# --- Block limits (reference: minlz.go:24,92-106) -------------------------
MAX_BLOCK_SIZE = 8 << 20  # 8 MiB maximum uncompressed block size
MIN_BLOCK_SIZE = 4 << 10
DEFAULT_BLOCK_SIZE = 2 << 20
MAX_BLOCK_LOG = 23
MIN_NON_LITERAL_BLOCK_SIZE = 16  # blocks <= this are stored uncompressed

# Maximum offset reachable by any copy op: Copy3 21-bit + 65535.
MAX_COPY_OFFSET = (1 << 21) + 65535  # 2,162,687

# --- Compression levels (reference: encode.go levels) ---------------------
LEVEL_SUPER_FAST = -1  # aka L0 internally
LEVEL_FASTEST = 1
LEVEL_BALANCED = 2
LEVEL_SMALLEST = 3

# --- Tag constants (reference: minlz.go:74-80, SPEC.md §2) -----------------
TAG_LITERAL = 0
TAG_REPEAT = 0 | 4  # literal tag with bit 2 set
TAG_COPY1 = 1
TAG_COPY2 = 2
TAG_COPY2_FUSED = 3  # tag 3, bit 2 clear
TAG_COPY3 = 3 | 4  # tag 3, bit 2 set

# --- Copy op ranges (SPEC.md §2.3-2.5) -------------------------------------
COPY1_MAX_OFFSET = 1024
COPY2_MIN_OFFSET = 64
COPY2_MAX_OFFSET = 65535 + 64
COPY3_MIN_OFFSET = 65536

# --- Stream magics (reference: minlz.go:85-91) -----------------------------
MAGIC_BODY = b"MinLz"
MAGIC_CHUNK = b"\xff\x06\x00\x00MinLz"
MAGIC_BODY_SNAPPY = b"sNaPpY"
MAGIC_BODY_S2 = b"S2sTwO"

# --- Chunk IDs (reference: minlz.go:118-131, SPEC.md §4) -------------------
CHUNK_TYPE_LEGACY_COMPRESSED = 0x00
CHUNK_TYPE_UNCOMPRESSED_DATA = 0x01
CHUNK_TYPE_MINLZ_COMPRESSED = 0x02  # CRC of uncompressed payload
CHUNK_TYPE_MINLZ_COMPRESSED_CRC = 0x03  # CRC of compressed payload
CHUNK_TYPE_EOF = 0x20
CHUNK_TYPE_INDEX = 0x40
CHUNK_TYPE_SEARCH_INFO = 0x44
CHUNK_TYPE_SEARCH_TABLE = 0x45
CHUNK_TYPE_SEARCH_TABLE_COMPRESSED = 0x46
CHUNK_TYPE_REMOTE_BLOCK_REF = 0x47
# TPU-MinLZ extension: user-defined skippable chunk carrying parse hints that
# make a following data chunk decodable segment-parallel on a device.  Plain
# spec-conformant readers skip it (0x80-0xbf range is user-skippable).
CHUNK_TYPE_PARSE_HINT = 0x88
CHUNK_TYPE_PADDING = 0xFE
CHUNK_TYPE_STREAM_ID = 0xFF

MAX_CHUNK_SIZE = (1 << 24) - 1
CHUNK_HEADER_SIZE = 4
CHECKSUM_SIZE = 4

MAX_INDEX_ENTRIES = 1 << 16 - 1  # placeholder; see stream/index.py
S2_INDEX_HEADER = b"s2idx\x00"
S2_INDEX_TRAILER = b"\x00xdi2s"


def max_encoded_len(src_len: int) -> int:
    """Maximum size of an encoded block (reference: encode.go:234-244)."""
    if src_len < 0 or src_len > MAX_BLOCK_SIZE:
        return -1
    if src_len == 0:
        return 1
    return src_len + 2


# --- Varints (protobuf base-128 unsigned / zigzag) -------------------------

def put_uvarint(value: int) -> bytes:
    """Encode an unsigned base-128 varint."""
    if value < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def read_uvarint(buf, pos: int = 0):
    """Decode an unsigned varint from ``buf`` at ``pos``.

    Returns ``(value, new_pos)``.  Raises ``ValueError`` on truncation or
    64-bit overflow, mirroring the reference's strictness.
    """
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[pos]
        pos += 1
        if shift == 63 and b > 1:
            raise ValueError("uvarint overflows 64 bits")
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:
            raise ValueError("uvarint overflows 64 bits")


def put_varint(value: int) -> bytes:
    """Zigzag-encoded signed varint (used by the index codec)."""
    zz = (value << 1) ^ (value >> 63) if value < 0 else value << 1
    return put_uvarint(zz & ((1 << 64) - 1))


def read_varint(buf, pos: int = 0):
    zz, pos = read_uvarint(buf, pos)
    return (zz >> 1) ^ -(zz & 1), pos


# --- Checksums (SPEC.md §3; reference minlz.go:133-140) --------------------

try:  # crc32c comes from google-crc32c / crcmod if present; else table fallback
    from .utils._crc32c import crc32c as _crc32c_impl
except Exception:  # pragma: no cover
    _crc32c_impl = None

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        import numpy as np

        table = np.empty((8, 256), dtype=np.uint32)
        crc = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            crc = np.where(crc & 1, (crc >> 1) ^ _CRC32C_POLY, crc >> 1)
        table[0] = crc
        for t in range(1, 8):
            table[t] = table[0][table[t - 1] & 0xFF] ^ (table[t - 1] >> 8)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), as in RFC 3720 §12.1."""
    if _crc32c_impl is not None:
        return _crc32c_impl(data, crc)
    import numpy as np

    table = _crc32c_table()
    crc = (~crc) & 0xFFFFFFFF
    data = memoryview(data)
    n = len(data)
    # Slice-by-8: fold 8 bytes per table round; process the unaligned tail
    # byte-serially.  For long inputs the native extension is used instead.
    arr = np.frombuffer(data, dtype=np.uint8)
    tail = n % 8
    t0 = table[0]
    body = arr[: n - tail]
    if body.size:
        chunks = body.reshape(-1, 8)
        crc_arr = np.uint32(crc)
        # Process sequentially by 8-byte groups; each group is table lookups
        # only.  For long inputs prefer the native extension (utils/_crc32c).
        for row in chunks:
            x = crc_arr ^ (
                np.uint32(row[0])
                | np.uint32(row[1]) << 8
                | np.uint32(row[2]) << 16
                | np.uint32(row[3]) << 24
            )
            crc_arr = (
                table[7][x & 0xFF]
                ^ table[6][(x >> 8) & 0xFF]
                ^ table[5][(x >> 16) & 0xFF]
                ^ table[4][(x >> 24) & 0xFF]
                ^ table[3][row[4]]
                ^ table[2][row[5]]
                ^ table[1][row[6]]
                ^ table[0][row[7]]
            )
        crc = int(crc_arr)
    for b in arr[n - tail :]:
        crc = int(t0[(crc ^ int(b)) & 0xFF]) ^ (crc >> 8)
    return (~crc) & 0xFFFFFFFF


def mask_checksum(c: int) -> int:
    """Hadoop-style CRC masking (SPEC.md §3)."""
    c &= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def unmask_checksum(c: int) -> int:
    c = (c - 0xA282EAD8) & 0xFFFFFFFF
    return ((c >> 17) | (c << 15)) & 0xFFFFFFFF


def crc(data: bytes) -> int:
    """Masked CRC-32C over ``data`` (reference: minlz.go:137)."""
    return mask_checksum(crc32c(data))


class CorruptError(ValueError):
    """Input is not valid MinLZ-encoded data."""


class TooLargeError(ValueError):
    """Decoded block size exceeds MAX_BLOCK_SIZE or configured limit."""


class UnsupportedError(ValueError):
    """Stream contains an unsupported (non-skippable) chunk."""
