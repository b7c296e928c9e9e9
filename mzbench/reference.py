"""The plain reference that decides ``correct``: the MinLZ stream framing,
the parse-hint chunk (0x88), CRC-32C and the block decoder, written from
the MinLZ specification (SPEC.md §1-4) in plain Python and NumPy.

It imports nothing of the program under test and takes nothing the program
made: the framing, the CRCs and every decoded byte are worked out here
again from the stream's bytes, and compared with the bytes the benchmark
generated.
"""

from __future__ import annotations

import numpy as np

MAGIC_CHUNK = b"\xff\x06\x00\x00MinLz"
UNCOMPRESSED = 0x01
COMPRESSED = 0x02  # CRC of the uncompressed data
EOF = 0x20
INDEX = 0x40
PARSE_HINT = 0x88
PADDING = 0xFE
MAX_BLOCK = 8 << 20


class Corrupt(ValueError):
    """The bytes are not what the specification allows."""


def uvarint(buf, pos: int):
    """(value, next position) of the unsigned LEB128 varint at ``pos``."""
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise Corrupt("truncated or overlong uvarint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


# --- CRC-32C (Castagnoli), masked as the stream stores it -----------------

def _byte_table():
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t.astype(np.uint32)


_T = _byte_table()
_CHUNK = 256


def _zeros_tables():
    """Four byte tables of the linear map 'feed _CHUNK zero bytes'."""
    v = np.arange(256, dtype=np.uint32)
    out = []
    for b in range(4):
        r = v << np.uint32(8 * b)
        for _ in range(_CHUNK):
            r = (r >> np.uint32(8)) ^ _T[r & np.uint32(0xFF)]
        out.append(r)
    return out


_Z = None


def _feed(regs, mat):
    for j in range(mat.shape[1]):
        regs = (regs >> np.uint32(8)) ^ _T[(regs ^ mat[:, j]) & np.uint32(0xFF)]
    return regs


def crc32c_rows(mat: np.ndarray) -> np.ndarray:
    """CRC-32C of each row of a [n, L] uint8 array, as uint32 [n]: each
    row's 256-byte pieces are fed at once from a zero register, then the
    pieces are chained with the 'feed 256 zero bytes' map."""
    global _Z
    if _Z is None:
        _Z = _zeros_tables()
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    n, length = mat.shape
    whole = length // _CHUNK
    regs = np.full(n, 0xFFFFFFFF, np.uint32)
    if whole:
        pieces = mat[:, :whole * _CHUNK].reshape(n * whole, _CHUNK)
        raw = _feed(np.zeros(n * whole, np.uint32),
                    pieces.astype(np.uint32)).reshape(n, whole)
        z0, z1, z2, z3 = _Z
        for k in range(whole):
            regs = (z0[regs & 0xFF] ^ z1[(regs >> 8) & 0xFF]
                    ^ z2[(regs >> 16) & 0xFF] ^ z3[regs >> 24]) ^ raw[:, k]
    regs = _feed(regs, mat[:, whole * _CHUNK:].astype(np.uint32))
    return regs ^ np.uint32(0xFFFFFFFF)


def masked(c: int) -> int:
    """The stream's masked checksum of a CRC-32C."""
    c &= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- Stream framing -----------------------------------------------------

def chunks(stream):
    """Yield (type, payload memoryview) of every chunk after the stream
    identifier; raise Corrupt where the framing is broken."""
    view = memoryview(stream)
    if bytes(view[:len(MAGIC_CHUNK)]) != MAGIC_CHUNK:
        raise Corrupt("missing stream identifier")
    pos = 4 + 6  # the identifier's payload: "MinLz" and the block size
    while pos < len(view):
        if pos + 4 > len(view):
            raise Corrupt("truncated chunk header")
        ctype = view[pos]
        n = int.from_bytes(view[pos + 1:pos + 4], "little")
        if pos + 4 + n > len(view):
            raise Corrupt("chunk runs past the stream's end")
        yield ctype, view[pos + 4:pos + 4 + n]
        pos += 4 + n


def hints(payload) -> tuple:
    """(segment size, range, [compressed offsets]) of a parse-hint chunk."""
    payload = bytes(payload)
    if payload[:4] != b"MZPH" or len(payload) < 5:
        raise Corrupt("bad parse-hint magic")
    version = payload[4]
    if version not in (1, 2):
        raise Corrupt(f"parse-hint version {version}")
    seg, pos = uvarint(payload, 5)
    n, pos = uvarint(payload, pos)
    rng = 0
    if version == 2:
        rng, pos = uvarint(payload, pos)
    offs, cur = [], 0
    for _ in range(n):
        d, pos = uvarint(payload, pos)
        cur += d
        offs.append(cur)
    if pos != len(payload):
        raise Corrupt("trailing bytes after the parse hints")
    return seg, rng, offs


def data_blocks(stream):
    """Walk a stream: a list of blocks, each a dict with ``kind``
    ("compressed" or "raw"), ``crc`` (stored, masked), ``data`` (the block
    as stored after the CRC) and ``hints`` (the parse-hint payload before a
    compressed block, or None), and the EOF chunk's size (None if none)."""
    blocks, pending, eof = [], None, None
    for ctype, payload in chunks(stream):
        if eof is not None and ctype not in (INDEX, PADDING):
            raise Corrupt("a chunk after EOF")
        if ctype == PARSE_HINT:
            pending = payload
        elif ctype in (COMPRESSED, UNCOMPRESSED):
            if len(payload) < 4:
                raise Corrupt("data chunk without a checksum")
            blocks.append({
                "kind": "compressed" if ctype == COMPRESSED else "raw",
                "crc": int.from_bytes(payload[:4], "little"),
                "data": payload[4:],
                "hints": pending if ctype == COMPRESSED else None})
            pending = None
        elif ctype == EOF:
            eof, _ = uvarint(payload, 0)
        elif ctype in (INDEX, PADDING) or 0x80 <= ctype <= 0xFD:
            continue
        else:
            raise Corrupt(f"chunk type {ctype:#x} where data was expected")
    return blocks, eof


def block_size(block) -> int:
    """The decoded length a block's header (or raw length) states."""
    if block["kind"] == "raw":
        return len(block["data"])
    size, pos = uvarint(block["data"], 0)
    return len(block["data"]) - pos if size == 0 else size


def block_hints(block):
    """(segment size, range, [compressed offsets]) of a compressed block,
    checked to cover its body: one offset a segment, rising from 0."""
    if block["hints"] is None:
        raise Corrupt("a compressed block without parse hints")
    size, pos = uvarint(block["data"], 0)
    seg, rng, offs = hints(block["hints"])
    if seg <= 0 or len(offs) != -(-size // seg) or offs != sorted(offs) or \
            (offs and (offs[0] != 0 or offs[-1] > len(block["data"]) - pos)):
        raise Corrupt("parse hints do not cover the block")
    return seg, rng, offs


# --- Block decoder --------------------------------------------------------

def decode_block(data, overlap_safe: bool = True, hinted=None) -> bytes:
    """Decode one stored MinLZ block (uvarint size, then tokens).

    ``hinted`` (segment size, range, [compressed offsets]), from
    ``block_hints``, also holds the block to what its parse hints promise:
    a token starts at every segment boundary, at the compressed offset
    (counted from the end of the size) that the hints give it; no token
    of a segment needs the repeat offset of an earlier one (a segment's
    decoder starts it at 1); and every copy's source lies inside the range
    (``range`` bytes, aligned) of its destination.

    ``overlap_safe=False`` is the control: a copy whose source overlaps its
    destination is made as one slice move, as a vectorised decoder might,
    and not byte after byte as the specification says."""
    src = bytes(data)
    want, pos = uvarint(src, 0)
    if want == 0:
        return src[pos:]
    if want > MAX_BLOCK:
        raise Corrupt("block larger than 8 MiB")
    dst = bytearray(want)
    d, n, offset = 0, len(src), 1
    body = pos
    seg, rng, offs = hinted if hinted else (0, 0, ())
    nxt = 0  # the next segment whose first token is due
    lane_offset = 1  # the repeat offset as the segment's decoder has it

    def token_start():
        nonlocal nxt, lane_offset
        if nxt < len(offs) and d > nxt * seg:
            raise Corrupt(f"a token runs over the start of segment {nxt}")
        if nxt < len(offs) and d == nxt * seg:
            if pos - body != offs[nxt]:
                raise Corrupt(f"segment {nxt} starts at {pos - body}, its "
                              f"hint says {offs[nxt]}")
            nxt += 1
            lane_offset = 1

    def copy(off, length):
        nonlocal d
        if off > d or off <= 0:
            raise Corrupt("copy offset before the block's start")
        if d + length > want:
            raise Corrupt("copy past the block's end")
        s = d - off
        if rng and s < d // rng * rng:
            raise Corrupt(f"a copy to {d} reads {s}, before its range")
        if off >= length or not overlap_safe:
            dst[d:d + length] = dst[s:s + length]
        else:
            for i in range(length):
                dst[d + i] = dst[s + i]
        d += length

    def literal(length):
        nonlocal d, pos
        if pos + length > n or d + length > want:
            raise Corrupt("literal run past its end")
        dst[d:d + length] = src[pos:pos + length]
        d += length
        pos += length

    def ext(nb):
        nonlocal pos
        if pos + nb > n:
            raise Corrupt("truncated token")
        v = int.from_bytes(src[pos:pos + nb], "little")
        pos += nb
        return v

    while pos < n:
        token_start()
        tag_byte = src[pos]
        pos += 1
        tag, value = tag_byte & 3, tag_byte >> 2
        if tag == 0:
            code = value >> 1
            length = code + 1 if code < 29 else ext(code - 28) + 30
            if value & 1:
                if hinted and offset != lane_offset:
                    raise Corrupt(f"a repeat copy at {d} takes its offset "
                                  "from an earlier segment")
                copy(offset, length)
            else:
                literal(length)
            continue
        lits = 0
        if tag == 1:
            offset = (ext(1) << 2 | (value >> 4)) + 1
            length = value & 15
            length = ext(1) + 18 if length == 15 else length + 4
        elif tag == 2:
            offset = ext(2) + 64
            length = value + 4 if value <= 60 else ext(value - 60) + 64
        elif not value & 1:
            offset = ext(2) + 64
            length = (value >> 3) + 4
            lits = ((value >> 1) & 3) + 1
        else:
            full = value | ext(3) << 6
            offset = (full >> 9) + 65536
            code = (full >> 3) & 63
            length = code + 4 if code < 61 else ext(code - 60) + 64
            lits = (value >> 1) & 3
        lane_offset = offset
        if lits:
            literal(lits)
        copy(offset, length)
    if d != want:
        raise Corrupt(f"decoded {d} bytes, the header says {want}")
    if nxt != len(offs):
        raise Corrupt(f"no token starts segment {nxt}")
    return bytes(dst)


def decode_stream_block(block, overlap_safe: bool = True,
                        hinted: bool = False) -> bytes:
    """The decoded bytes of one block that ``data_blocks`` found; with
    ``hinted``, a compressed block is also held to its parse hints
    (``decode_block``)."""
    if block["kind"] == "raw":
        return bytes(block["data"])
    return decode_block(block["data"], overlap_safe,
                        block_hints(block) if hinted else None)
