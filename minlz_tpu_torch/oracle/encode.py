"""Spec-conformant MinLZ block encoder (pure Python oracle).

Greedy hash-4 LZ77 matcher plus the full set of token emitters, mirroring the
behavior (not the code) of the reference repo's ``internal/reference/
encoder.go``.  The emitters here are the canonical host-side implementation
shared by the level-0..3 encoders in ``block.py``; the device
encoders produce identical token encodings via their own vectorized emission.
"""

from __future__ import annotations

from ..minlz import (
    COPY1_MAX_OFFSET,
    COPY2_MAX_OFFSET,
    COPY2_MIN_OFFSET,
    MAX_BLOCK_SIZE,
    max_encoded_len,
    put_uvarint,
)

_PRIME4 = 2654435761


def hash4(v: int, bits: int) -> int:
    """Multiplicative hash of 4 little-endian bytes to ``bits`` bits."""
    return ((v * _PRIME4) & 0xFFFFFFFF) >> (32 - bits)


# --- Token emitters (SPEC.md §2.1-2.5) -------------------------------------

def emit_literals(dst: bytearray, lits) -> None:
    """Append a literal run op (tag 0)."""
    n = len(lits)
    if n == 0:
        return
    if n < 30:
        dst.append((n - 1) << 3)
    else:
        v = n - 30
        if v < 256:
            dst.append(29 << 3)
            dst.append(v)
        elif v < 65536:
            dst.append(30 << 3)
            dst += v.to_bytes(2, "little")
        else:
            dst.append(31 << 3)
            dst += v.to_bytes(3, "little")
    dst += lits


def emit_repeat(dst: bytearray, length: int) -> None:
    """Append a repeat op (tag 0 with repeat bit).  length >= 1."""
    v = length - 1
    if v < 29:
        dst.append(v << 3 | 4)
    else:
        v = length - 30
        if v < 256:
            dst.append(29 << 3 | 4)
            dst.append(v)
        elif v < 65536:
            dst.append(30 << 3 | 4)
            dst += v.to_bytes(2, "little")
        else:
            dst.append(31 << 3 | 4)
            dst += v.to_bytes(3, "little")


def emit_copy1(dst: bytearray, offset: int, length: int) -> None:
    """Copy1: offset 1-1024, length >= 4.  Long lengths chain a repeat."""
    o = offset - 1
    if length <= 18:
        x = o << 6 | (length - 4) << 2 | 1
        dst += x.to_bytes(2, "little")
    elif length <= 273:
        x = o << 6 | 15 << 2 | 1
        dst += x.to_bytes(2, "little")
        dst.append(length - 18)
    else:
        x = o << 6 | 14 << 2 | 1
        dst += x.to_bytes(2, "little")
        emit_repeat(dst, length - 18)


def emit_copy2(dst: bytearray, offset: int, length: int) -> None:
    """Copy2: offset 64-65599, length >= 4."""
    o = offset - 64
    length -= 4
    if length <= 60:
        dst.append(length << 2 | 2)
        dst += o.to_bytes(2, "little")
    else:
        length -= 60
        if length < 256:
            dst.append(61 << 2 | 2)
            dst += o.to_bytes(2, "little")
            dst.append(length)
        elif length < 65536:
            dst.append(62 << 2 | 2)
            dst += o.to_bytes(2, "little")
            dst += length.to_bytes(2, "little")
        else:
            dst.append(63 << 2 | 2)
            dst += o.to_bytes(2, "little")
            dst += length.to_bytes(3, "little")


def emit_copy3(dst: bytearray, offset: int, length: int, lits=b"") -> None:
    """Copy3: offset 65536-2162687, length >= 4, 0-3 fused literals."""
    o = offset - 65536
    length -= 4
    word = 7 | len(lits) << 3 | o << 11  # tag 3 + copy3 bit + litlen + offset
    if length <= 60:
        word |= length << 5
        dst += word.to_bytes(4, "little")
    else:
        length -= 60
        if length < 256:
            word |= 61 << 5
            dst += word.to_bytes(4, "little")
            dst.append(length)
        elif length < 65536:
            word |= 62 << 5
            dst += word.to_bytes(4, "little")
            dst += length.to_bytes(2, "little")
        else:
            word |= 63 << 5
            dst += word.to_bytes(4, "little")
            dst += length.to_bytes(3, "little")
    dst += lits


def emit_fused2(dst: bytearray, lits, offset: int, length: int) -> None:
    """Fused Copy2: 1-4 literals + copy len 4-11, offset 64-65599.

    Longer copies emit the max fused length then chain a repeat.
    """
    o = offset - 64
    l = length - 4
    if l > 7:
        dst.append(3 | (len(lits) - 1) << 3 | 7 << 5)
        dst += o.to_bytes(2, "little")
        dst += lits
        emit_repeat(dst, l - 7)
    else:
        dst.append(3 | (len(lits) - 1) << 3 | l << 5)
        dst += o.to_bytes(2, "little")
        dst += lits


def encode_uncompressed(src) -> bytes:
    """Store ``src`` as a literal-only block: 0x00 0x00 <raw>."""
    if len(src) == 0:
        return b"\x00"
    return b"\x00\x00" + bytes(src)


# --- Greedy block encoder ---------------------------------------------------

def encode_block(src, table_bits: int = 16) -> bytes:
    """Encode one block at a quality level comparable to the reference's
    simple greedy encoder.  Always produces valid output; falls back to an
    uncompressed representation when the data does not compress.
    """
    src = bytes(src)
    n = len(src)
    if n > MAX_BLOCK_SIZE:
        raise ValueError(f"block of {n} bytes exceeds 8MiB limit")
    if n <= 16:
        return encode_uncompressed(src)

    dst = bytearray(b"\x00" + put_uvarint(n))
    body = _encode_body(dst, src, table_bits)
    if body is None:
        return encode_uncompressed(src)
    return bytes(body)


def _encode_body(dst: bytearray, src: bytes, table_bits: int):
    n = len(src)
    dst_limit = n + len(dst) - 11  # must beat this or bail to uncompressed
    table = [0] * (1 << table_bits)
    s_limit = n - 4

    next_emit = 0
    s = 1
    repeat = 1

    def u32(i):
        return int.from_bytes(src[i : i + 4], "little")

    while True:
        # Scan for a 4-byte match via the single-slot hash table.
        candidate = 0
        while True:
            if s > s_limit:
                return _finish(dst, src, next_emit, dst_limit)
            cv = u32(s)
            h = hash4(cv, table_bits)
            candidate = table[h]
            table[h] = s
            if (
                candidate
                and s - candidate <= (2 << 20) + 65535
                and cv == u32(candidate)
            ):
                break
            s += 1

        base = s
        offset = s - candidate
        # Extend forwards.
        s += 4
        candidate += 4
        while s < n and src[s] == src[candidate]:
            s += 1
            candidate += 1
        # Extend backwards over pending literals.
        while base > next_emit and candidate - (s - base) > 0 and \
                src[base - 1] == src[candidate - (s - base) - 1]:
            base -= 1
        length = s - base

        lits = src[next_emit:base]
        emitted_fused = False
        if lits:
            can_fuse = offset >= COPY2_MIN_OFFSET and (
                len(lits) <= 3
                or (offset <= COPY2_MAX_OFFSET and len(lits) <= 4)
            ) and offset != repeat
            if can_fuse:
                if offset <= COPY2_MAX_OFFSET:
                    emit_fused2(dst, lits, offset, length)
                else:
                    emit_copy3(dst, offset, length, lits)
                emitted_fused = True
            else:
                if len(dst) + len(lits) > dst_limit:
                    return None
                emit_literals(dst, lits)
        if not emitted_fused:
            if offset == repeat:
                emit_repeat(dst, length)
            elif offset <= COPY1_MAX_OFFSET:
                emit_copy1(dst, offset, length)
            elif offset <= COPY2_MAX_OFFSET:
                emit_copy2(dst, offset, length)
            else:
                emit_copy3(dst, offset, length)

        repeat = offset
        next_emit = s
        if s > s_limit:
            return _finish(dst, src, next_emit, dst_limit)
        if len(dst) > dst_limit:
            return None

        # Index interior positions of the match region.
        step = 1 if length < 512 else 7
        for i in range(base + 1, min(s, n - 4), step):
            table[hash4(u32(i), table_bits)] = i

    raise AssertionError("unreachable")


def _finish(dst: bytearray, src: bytes, next_emit: int, dst_limit: int):
    if next_emit < len(src):
        if len(dst) + len(src) - next_emit > dst_limit:
            return None
        emit_literals(dst, src[next_emit:])
    return dst
