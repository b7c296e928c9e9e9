"""LZ4 block conversion: transcode LZ4 blocks to MinLZ without decompressing.

Parity with reference ``lz4convert.go:39`` (ConvertBlock): walk LZ4
literal/match sequences and re-emit them as MinLZ literal/copy/repeat tokens,
tracking the last offset for repeat compression.  Also provides a minimal
LZ4 block encoder/decoder (parity: ``internal/lz4ref/block.go``) used to
generate test inputs and verify conversions.
"""

from __future__ import annotations

from .minlz import MAX_BLOCK_SIZE, CorruptError, put_uvarint, read_uvarint
from .oracle import encode as oenc

MIN_MATCH = 4


class LZ4CorruptError(CorruptError):
    pass


def lz4_decode_block(src, max_size: int = MAX_BLOCK_SIZE) -> bytes:
    """Reference LZ4 block decoder (for tests/verification)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise LZ4CorruptError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise LZ4CorruptError("lz4: literal run exceeds input")
        out += src[i : i + lit_len]
        i += lit_len
        if i == n:
            break  # last sequence has no match
        if i + 2 > n:
            raise LZ4CorruptError("lz4: truncated offset")
        offset = src[i] | src[i + 1] << 8
        i += 2
        if offset == 0 or offset > len(out):
            raise LZ4CorruptError("lz4: invalid offset")
        m_len = token & 15
        if m_len == 15:
            while True:
                if i >= n:
                    raise LZ4CorruptError("lz4: truncated match length")
                b = src[i]
                i += 1
                m_len += b
                if b != 255:
                    break
        m_len += MIN_MATCH
        if len(out) + m_len > max_size:
            raise LZ4CorruptError("lz4: output exceeds limit")
        start = len(out) - offset
        for k in range(m_len):
            out.append(out[start + k])
    return bytes(out)


def lz4_encode_block(src) -> bytes:
    """Minimal greedy LZ4 block encoder (hash-table), for test inputs."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    if n == 0:
        return b""

    def emit_seq(lits, m_off, m_len):
        ll = len(lits)
        ml = 0 if m_len == 0 else m_len - MIN_MATCH
        token = (min(ll, 15) << 4) | (min(ml, 15) if m_len else 0)
        out.append(token)
        if ll >= 15:
            rem = ll - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(lits)
        if m_len:
            out.append(m_off & 0xFF)
            out.append(m_off >> 8)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    table = {}
    i = 0
    anchor = 0
    # LZ4 spec: last 5 bytes are always literals; matches must start 12
    # bytes before the end.
    limit = max(n - 12, 0)
    while i < limit:
        key = src[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand <= 65535:
            m_len = 4
            while i + m_len < n - 5 and src[i + m_len] == src[cand + m_len]:
                m_len += 1
            emit_seq(src[anchor:i], i - cand, m_len)
            i += m_len
            anchor = i
        else:
            i += 1
    emit_seq(src[anchor:], 0, 0)
    return bytes(out)


def convert_block(src, max_size: int = MAX_BLOCK_SIZE,
                  native: bool = True) -> bytes:
    """Transcode one LZ4 block into a MinLZ block without decompressing.

    Returns the full MinLZ block (0x00 marker + uvarint size + ops).
    Raises LZ4CorruptError on malformed input.  Reference:
    lz4convert.go:39 (ConvertBlock); the native C++ fast path is the
    cvtLZ4BlockAsm analog (differentially tested against this walker).
    """
    src = bytes(src)
    if native:
        from .native.codec import get_codec

        codec = get_codec()
        if codec is not None:
            try:
                blk = codec.lz4_convert_block(src, max_size)
            except ValueError as exc:
                raise LZ4CorruptError(f"lz4: {exc}") from None
            if blk is not None:
                return blk
    n = len(src)
    body = bytearray()
    out_len = 0
    last_offset = -1
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise LZ4CorruptError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise LZ4CorruptError("lz4: literal run exceeds input")
        lits = src[i : i + lit_len]
        i += lit_len

        if i == n:
            if lits:
                oenc.emit_literals(body, lits)
                out_len += lit_len
            break

        if i + 2 > n:
            raise LZ4CorruptError("lz4: truncated offset")
        offset = src[i] | src[i + 1] << 8
        i += 2
        if offset == 0 or offset > out_len + lit_len:
            raise LZ4CorruptError("lz4: invalid offset")
        m_len = token & 15
        if m_len == 15:
            while True:
                if i >= n:
                    raise LZ4CorruptError("lz4: truncated match length")
                b = src[i]
                i += 1
                m_len += b
                if b != 255:
                    break
        m_len += MIN_MATCH
        if out_len + lit_len + m_len > max_size:
            raise LZ4CorruptError("lz4: output exceeds 8MiB block limit")

        # Emit: prefer fused forms, repeat when the offset recurs.
        if lits and offset != last_offset and offset >= 64 and (
            len(lits) <= 3 or (offset <= 65599 and len(lits) <= 4)
        ):
            if offset <= 65599:
                oenc.emit_fused2(body, lits, offset, m_len)
            else:
                oenc.emit_copy3(body, offset, m_len, lits)
        else:
            if lits:
                oenc.emit_literals(body, lits)
            if offset == last_offset:
                oenc.emit_repeat(body, m_len)
            elif offset <= 1024:
                oenc.emit_copy1(body, offset, m_len)
            elif offset <= 65599:
                oenc.emit_copy2(body, offset, m_len)
            else:
                oenc.emit_copy3(body, offset, m_len)
        last_offset = offset
        out_len += lit_len + m_len

    block = b"\x00" + put_uvarint(out_len) + bytes(body)
    if len(body) >= out_len > 0:
        # MinLZ requires net compression; store raw instead.
        return b"\x00\x00" + lz4_decode_block(src, max_size)
    return block


def convert_stream(lz4_blocks, writer) -> None:
    """Wrap converted LZ4 blocks into a MinLZ stream via ``writer``
    (reference ConvertStream, lz4convert.go:233)."""
    for blk in lz4_blocks:
        data = lz4_decode_block(blk)
        writer.write(data)


LZ4_FRAME_MAGIC = b"\x04\x22\x4d\x18"


def parse_lz4_frame(raw: bytes):
    """Parse an LZ4 frame (magic 0x184D2204) into raw block payloads.

    Yields (block_bytes, is_uncompressed).  Checksums are skipped, not
    validated (xxhash is out of scope for conversion; MinLZ adds its own
    CRCs on re-framing)."""
    if raw[:4] != LZ4_FRAME_MAGIC:
        raise LZ4CorruptError("missing LZ4 frame magic")
    pos = 4
    flg = raw[pos]
    bd_ = raw[pos + 1]  # noqa: F841 - block max size, informational
    pos += 2
    version = flg >> 6
    if version != 1:
        raise LZ4CorruptError(f"unsupported LZ4 frame version {version}")
    block_indep = bool(flg & 0x20)
    block_checksum = bool(flg & 0x10)
    has_content_size = bool(flg & 0x08)
    has_content_checksum = bool(flg & 0x04)
    has_dict_id = bool(flg & 0x01)
    if has_content_size:
        pos += 8
    if has_dict_id:
        pos += 4
    pos += 1  # header checksum byte (not validated)
    if not block_indep:
        # Dependent blocks: matches may reach into earlier blocks, which a
        # block-for-block conversion cannot represent.  Callers must use the
        # decode-and-recompress path.
        raise LZ4CorruptError("LZ4 frame with dependent blocks")
    while pos + 4 <= len(raw):
        word = int.from_bytes(raw[pos : pos + 4], "little")
        pos += 4
        if word == 0:  # EndMark
            if has_content_checksum:
                pos += 4
            return
        size = word & 0x7FFFFFFF
        is_raw = bool(word & 0x80000000)
        blk = raw[pos : pos + size]
        if len(blk) != size:
            raise LZ4CorruptError("truncated LZ4 frame block")
        pos += size
        if block_checksum:
            pos += 4
        yield blk, is_raw
    raise LZ4CorruptError("LZ4 frame missing EndMark")


def convert_frame(raw: bytes, writer, transcode: bool = True) -> int:
    """Convert a full LZ4 frame into a MinLZ stream via ``writer``.

    With transcode=True each LZ4 block is converted token-for-token
    (convert_block — no decompression); raw LZ4 blocks and frames that
    cannot be transcoded fall back to decode-and-recompress.  Returns the
    number of uncompressed bytes processed."""
    total = 0
    for blk, is_raw in parse_lz4_frame(raw):
        if is_raw:
            writer.write(blk)
            total += len(blk)
            continue
        data_len = None
        if transcode:
            mz_block = convert_block(blk)
            v, p = read_uvarint(mz_block, 1)
            data_len = v if v else len(mz_block) - p
        if data_len is not None and data_len <= writer._block_size:
            writer.write_preencoded(mz_block, data_len)
            total += data_len
        else:
            data = lz4_decode_block(blk)
            writer.write(data)
            total += len(data)
    return total
