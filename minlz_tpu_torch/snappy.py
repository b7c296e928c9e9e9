"""Snappy + S2 fallback decoding.

MinLZ blocks whose first byte is non-zero may be Snappy- or S2-compressed
data (SPEC.md §1.0: "decoders may implement fallback"), and streams may carry
the sNaPpY or S2sTwO identifiers.  The reference delegates both to the
klauspost/compress s2 package (decode.go:59-68, reader.go legacy chunk path);
``s2.Decode`` accepts classic Snappy as a subset, so this module implements
one superset decoder.

Snappy block format (google/snappy format_description.txt): uvarint
decompressed length then tagged elements — tag bits 00 literal / 01 copy with
1-byte offset / 10 copy with 2-byte offset / 11 copy with 4-byte offset.

S2 format extensions (klauspost/compress s2 README "Format Extensions"):
  * blocks may be up to 4 MiB decompressed (S2_MAX_BLOCK_SIZE);
  * a tag-01 copy whose 11-bit offset is 0 is a REPEAT — it reuses the
    offset of the most recent copy.  Its 3-bit length field L encodes:
        L 0-4  -> length 4..8
        L 5    -> 1 extra byte  b   -> length  8 + b
        L 6    -> 2 extra bytes u16 -> length 260 + u16   (little-endian)
        L 7    -> 3 extra bytes u24 -> length 65540 + u24 (little-endian)
    (consistent with the s2 emitRepeat length classes: the three extension
    forms store length-8, length-260 and length-65540 respectively).
"""

from __future__ import annotations

from .minlz import CorruptError, read_uvarint

# s2.MaxBlockSize — the largest decompressed block the S2 format permits.
S2_MAX_BLOCK_SIZE = 4 << 20


def snappy_decoded_len(src) -> int:
    n, _ = read_uvarint(src, 0)
    return n


def s2_decode_block(src) -> bytes:
    """Decode a raw Snappy or S2 block (uvarint length + token stream).

    Handles the full S2 superset: classic Snappy tags plus S2 repeat ops.
    Mirrors the behavior of ``s2.Decode`` used by the reference fallback
    (reference decode.go:59-68)."""
    src = bytes(src)
    try:
        want, pos = read_uvarint(src, 0)
    except ValueError as e:
        raise CorruptError(f"snappy: {e}") from e
    out = bytearray()
    n = len(src)
    last_off = 0  # S2 repeat state; 0 = no copy seen yet
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                if pos + nb > n:
                    raise CorruptError("snappy: truncated literal length")
                ln = int.from_bytes(src[pos : pos + nb], "little")
                pos += nb
            ln += 1
            if pos + ln > n:
                raise CorruptError("snappy: literal exceeds input")
            out += src[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy with 1-byte offset, or S2 repeat when offset==0
            if pos >= n:
                raise CorruptError("snappy: truncated copy1")
            lfield = (tag >> 2) & 7
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
            if off == 0:
                # S2 repeat op: reuse last offset, extended length coding.
                if lfield <= 4:
                    ln = lfield + 4
                elif lfield == 5:
                    if pos + 1 > n:
                        raise CorruptError("s2: truncated repeat length")
                    ln = 8 + src[pos]
                    pos += 1
                elif lfield == 6:
                    if pos + 2 > n:
                        raise CorruptError("s2: truncated repeat length")
                    ln = 260 + int.from_bytes(src[pos : pos + 2], "little")
                    pos += 2
                else:
                    if pos + 3 > n:
                        raise CorruptError("s2: truncated repeat length")
                    ln = 65540 + int.from_bytes(src[pos : pos + 3], "little")
                    pos += 3
                off = last_off
                if off == 0:
                    raise CorruptError("s2: repeat before any copy")
            else:
                ln = lfield + 4
        elif kind == 2:  # copy with 2-byte offset
            if pos + 2 > n:
                raise CorruptError("snappy: truncated copy2")
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 2], "little")
            pos += 2
        else:  # copy with 4-byte offset
            if pos + 4 > n:
                raise CorruptError("snappy: truncated copy4")
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise CorruptError("snappy: invalid copy offset")
        last_off = off
        if len(out) + ln > want:
            raise CorruptError("snappy: output exceeds declared size")
        start = len(out) - off
        if off >= ln:
            out += out[start : start + ln]
        else:
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != want:
        raise CorruptError(
            f"snappy: decoded {len(out)} bytes, expected {want}"
        )
    return bytes(out)


# Classic Snappy blocks are a strict subset of S2, exactly as in the
# reference where s2.Decode serves both (decode.go:59-68).
snappy_decode_block = s2_decode_block


def _emit_s2_repeat(out: bytearray, length: int) -> None:
    """Emit an S2 repeat op (tag-01 copy with offset 0) for ``length``
    covered bytes, mirroring s2's emitRepeat length classes."""
    while length > 0:
        if length <= 8:
            if length < 4:
                raise ValueError("repeat length < 4")
            out.append(1 | ((length - 4) << 2))
            out.append(0)
            return
        if length <= 263:
            out.append(1 | (5 << 2))
            out.append(0)
            out.append(length - 8)
            return
        if length <= 260 + 0xFFFF:
            out.append(1 | (6 << 2))
            out.append(0)
            out.extend((length - 260).to_bytes(2, "little"))
            return
        take = min(length, 65540 + 0xFFFFFF)
        if length - take in (1, 2, 3):
            take -= 4  # never leave a sub-4 tail
        out.append(1 | (7 << 2))
        out.append(0)
        out.extend((take - 65540).to_bytes(3, "little"))
        length -= take


def snappy_encode_block(src, *, use_repeats: bool = False) -> bytes:
    """Minimal Snappy/S2 encoder (hash-match greedy), used to produce
    fallback-path test vectors.  With ``use_repeats=True`` it emits S2
    repeat ops when consecutive matches share an offset."""
    from .minlz import put_uvarint

    src = bytes(src)
    out = bytearray(put_uvarint(len(src)))
    i = 0
    n = len(src)
    table = {}
    anchor = 0
    last_off = 0

    def emit_lit(lits):
        m = len(lits)
        while m > 0:
            take = min(m, 65536)
            chunk = lits[:take]
            lits = lits[take:]
            if take <= 60:
                out.append((take - 1) << 2)
            elif take <= 256:
                out.append(60 << 2)
                out.append(take - 1)
            else:
                out.append(61 << 2)
                out.extend((take - 1).to_bytes(2, "little"))
            out.extend(chunk)
            m -= take

    while i + 4 <= n:
        key = src[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand <= 65535:
            ln = 4
            while i + ln < n and src[i + ln] == src[cand + ln]:
                ln += 1
            emit_lit(src[anchor:i])
            off = i - cand
            rem = ln
            while rem > 0:
                # Long matches split into ≤64-byte pieces; every piece after
                # the first shares the offset, so S2 repeats cover them (and
                # any later match at the same offset) cheaply.
                if use_repeats and off == last_off:
                    _emit_s2_repeat(out, rem)
                    rem = 0
                    break
                take = min(rem, 64)
                if rem - take in (1, 2, 3) and take == 64:
                    take = 60  # avoid sub-4 tail copies
                if take >= 4 and take <= 11 and off < 2048:
                    out.append(1 | ((take - 4) << 2) | ((off >> 8) << 5))
                    out.append(off & 0xFF)
                else:
                    out.append(2 | ((take - 1) << 2))
                    out.extend(off.to_bytes(2, "little"))
                last_off = off
                rem -= take
            i += ln
            anchor = i
        else:
            i += 1
    emit_lit(src[anchor:])
    return bytes(out)
