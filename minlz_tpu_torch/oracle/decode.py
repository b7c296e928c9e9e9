"""Spec-conformant MinLZ block decoder (pure Python oracle).

This is the readability-first reference implementation for the framework,
serving the same role as the reference repo's ``internal/reference/decoder.go``:
the oracle that every optimized path (NumPy, C++, CUDA) is differentially
tested against.  Decoding semantics follow MinLZ SPEC.md §1-2 exactly
(behavioral parity with reference ``decode.go:178`` / ``internal/reference/
decoder.go:26``).
"""

from __future__ import annotations

from ..minlz import MAX_BLOCK_SIZE, CorruptError, read_uvarint


def decoded_len(src) -> int:
    """Parse the block header, returning the decompressed length.

    Mirrors reference ``DecodedLen`` (decode.go:107): validates the MinLZ
    marker and the uvarint size field only.
    """
    _, want_size, _ = parse_header(src)
    return want_size


def parse_header(src):
    """Validate marker + size header.  Returns (lit_only, size, body_offset)."""
    if len(src) == 0:
        raise CorruptError("empty input")
    if src[0] != 0:
        raise CorruptError("not a MinLZ block (first byte != 0)")
    if len(src) == 1:
        return False, 0, 1
    try:
        want_size, pos = read_uvarint(src, 1)
    except ValueError as e:
        raise CorruptError(str(e)) from e
    if want_size > MAX_BLOCK_SIZE:
        raise CorruptError(f"decoded size {want_size} exceeds 8MiB limit")
    if want_size == 0:
        # Literal-only block: the remainder of src is raw output.
        return True, len(src) - pos, pos
    if want_size < len(src) - pos:
        raise CorruptError("compressed block larger than decompressed size")
    return False, want_size, pos


def decode_block(src) -> bytes:
    """Decode one MinLZ block, raising CorruptError on malformed input."""
    src = bytes(src)
    lit_only, want_size, pos = parse_header(src)
    if lit_only:
        return src[pos:]
    if want_size == 0:
        return b""
    return decode_body(src, pos, want_size)


def decode_body(src, pos, want_size, seed=b"") -> bytes:
    """Decode a token stream starting at ``pos``, optionally seeding the
    back-reference window with ``seed`` (dictionary decoding).  Returns only
    the newly produced bytes."""
    seed_len = len(seed)
    want_size += seed_len
    dst = bytearray(seed)
    n = len(src)
    offset = 1  # repeat offset, initial value 1 (SPEC.md §2.2)

    while pos < n:
        tag_byte = src[pos]
        pos += 1
        tag = tag_byte & 3
        value = tag_byte >> 2

        if tag == 0:
            # Literal run or repeat (SPEC.md §2.1).
            is_repeat = value & 1
            code = value >> 1
            if code < 29:
                length = code + 1
            else:
                nb = code - 28  # 1, 2 or 3 extension bytes
                if pos + nb > n:
                    raise CorruptError("literal length extension truncated")
                length = int.from_bytes(src[pos : pos + nb], "little") + 30
                pos += nb
            if is_repeat:
                _copy(dst, offset, length, want_size)
            else:
                if pos + length > n:
                    raise CorruptError("literal run exceeds source")
                if len(dst) + length > want_size:
                    raise CorruptError("literal run exceeds destination")
                dst += src[pos : pos + length]
                pos += length
            continue

        if tag == 1:
            # Copy1: 10-bit offset, 4-18(+ext) length (SPEC.md §2.3).
            if pos >= n:
                raise CorruptError("copy1 truncated")
            length = value & 15
            offset = (src[pos] << 2 | (value >> 4)) + 1
            pos += 1
            if length == 15:
                if pos >= n:
                    raise CorruptError("copy1 length extension truncated")
                length = src[pos] + 18
                pos += 1
            else:
                length += 4

        elif tag == 2:
            # Copy2: 16-bit offset + 64 (SPEC.md §2.4).
            if pos + 2 > n:
                raise CorruptError("copy2 truncated")
            offset = int.from_bytes(src[pos : pos + 2], "little") + 64
            pos += 2
            if value <= 60:
                length = value + 4
            else:
                nb = value - 60
                if pos + nb > n:
                    raise CorruptError("copy2 length extension truncated")
                length = int.from_bytes(src[pos : pos + nb], "little") + 64
                pos += nb

        else:
            # Tag 3: fused Copy2 or Copy3 (SPEC.md §2.5).
            is_copy3 = value & 1
            lit_len = (value >> 1) & 3
            if not is_copy3:
                # Fused Copy2: 3-bit length 4-11, 1-4 fused literals.
                if pos + 2 > n:
                    raise CorruptError("fused copy2 truncated")
                offset = int.from_bytes(src[pos : pos + 2], "little") + 64
                pos += 2
                length = (value >> 3) + 4
                lit_len += 1
            else:
                # Copy3: 21-bit offset + 65536, 6-bit length (+ext).
                if pos + 3 > n:
                    raise CorruptError("copy3 truncated")
                full = value | int.from_bytes(src[pos : pos + 3], "little") << 6
                pos += 3
                offset = (full >> 9) + 65536
                code = (full >> 3) & 63
                if code < 61:
                    length = code + 4
                else:
                    nb = code - 60
                    if pos + nb > n:
                        raise CorruptError("copy3 length extension truncated")
                    length = int.from_bytes(src[pos : pos + nb], "little") + 64
                    pos += nb
            if lit_len:
                if pos + lit_len > n:
                    raise CorruptError("fused literals exceed source")
                if len(dst) + lit_len > want_size:
                    raise CorruptError("fused literals exceed destination")
                dst += src[pos : pos + lit_len]
                pos += lit_len

        _copy(dst, offset, length, want_size)

    if len(dst) != want_size:
        raise CorruptError(
            f"decoded size mismatch: got {len(dst)}, want {want_size}"
        )
    return bytes(dst[seed_len:]) if seed_len else bytes(dst)


def iter_ops(src):
    """Parse a full block and yield one record per token WITHOUT executing
    it: (comp_pos, out_pos, kind, length, offset, fused_lits).  kind is one
    of 'lit', 'repeat', 'copy1', 'copy2', 'copy2f', 'copy3'.  Debug/stats
    tool (parity: mz d -block-debug, cmd/mz/decompress.go op dump)."""
    lit_only, want, pos = parse_header(src)
    if lit_only:
        yield (pos, 0, "lit", len(src) - pos, 0, 0)
        return
    n = len(src)
    out = 0
    while pos < n:
        start = pos
        tag_byte = src[pos]
        pos += 1
        tag = tag_byte & 3
        value = tag_byte >> 2
        if tag == 0:
            is_repeat = value & 1
            code = value >> 1
            if code < 29:
                length = code + 1
            else:
                nb = code - 28
                length = int.from_bytes(src[pos : pos + nb], "little") + 30
                pos += nb
            if is_repeat:
                yield (start, out, "repeat", length, 0, 0)
            else:
                yield (start, out, "lit", length, 0, 0)
                pos += length
            out += length
            continue
        lits = 0
        if tag == 1:
            length = value & 15
            offset = (src[pos] << 2 | (value >> 4)) + 1
            pos += 1
            if length == 15:
                length = src[pos] + 18
                pos += 1
            else:
                length += 4
            kind = "copy1"
        elif tag == 2:
            offset = int.from_bytes(src[pos : pos + 2], "little") + 64
            pos += 2
            if value <= 60:
                length = value + 4
            else:
                nb = value - 60
                length = int.from_bytes(src[pos : pos + nb], "little") + 64
                pos += nb
            kind = "copy2"
        else:
            is_copy3 = value & 1
            lits = (value >> 1) & 3
            if not is_copy3:
                offset = int.from_bytes(src[pos : pos + 2], "little") + 64
                pos += 2
                length = (value >> 3) + 4
                lits += 1
                kind = "copy2f"
            else:
                full = value | int.from_bytes(src[pos : pos + 3], "little") << 6
                pos += 3
                offset = (full >> 9) + 65536
                code = (full >> 3) & 63
                if code < 61:
                    length = code + 4
                else:
                    nb = code - 60
                    length = int.from_bytes(src[pos : pos + nb], "little") + 64
                    pos += nb
                kind = "copy3"
            pos += lits
        yield (start, out, kind, length, offset, lits)
        out += length + lits


def _copy(dst: bytearray, offset: int, length: int, want_size: int) -> None:
    d = len(dst)
    if offset > d:
        raise CorruptError(f"copy offset {offset} exceeds position {d}")
    if d + length > want_size:
        raise CorruptError("copy exceeds destination size")
    start = d - offset
    if offset >= length:
        dst += dst[start : start + length]
    else:
        # Overlapping copy: byte-serial semantics (RLE-style replication).
        for i in range(length):
            dst.append(dst[start + i])
