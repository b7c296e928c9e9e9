"""Compressed block search tables — chunk 0x46 (SPEC_SEARCH.md §2.2).

The bitmap is split into huff0 sub-blocks (32B..128KiB); each sub-block is
stored with one of four dispositions:

  h0_ti 0..15  huff0 4X entropy-coded (shared tables, up to 16)
  h0_ti 16     uncompressed
  h0_ti 17     RLE (single byte repeated)
  h0_ti 18     sparse bit table (byte-coded gaps between set bits,
               255-extension; reference search_compressed.go:56-108)

Parity: reference search_compressed.go (encoder appendSearchTableCompressed-
Chunk :292, decoder parseSearchTableCompressed :785).  The encoder here
builds ONE shared huff0 table over all tabled sub-blocks; the decoder
accepts up to 16 per the spec.
"""

from __future__ import annotations

import numpy as np

from ..minlz import (
    CHUNK_TYPE_SEARCH_TABLE_COMPRESSED,
    CorruptError,
    crc,
    put_uvarint,
    read_uvarint,
)
from ..utils import huff0

DISP_RAW = 16
DISP_RLE = 17
DISP_SPARSE = 18


# ---------------------------------------------------------------------------
# Sparse bit table (vectorized)
# ---------------------------------------------------------------------------

def sparse_encode(bitmap: bytes) -> bytes:
    """Byte-coded gaps between set bits, LSB-first within bytes."""
    bits = np.unpackbits(np.frombuffer(bitmap, np.uint8), bitorder="little")
    pos = np.nonzero(bits)[0]
    if len(pos) == 0:
        return b""
    gaps = np.empty(len(pos), np.int64)
    gaps[0] = pos[0]
    gaps[1:] = np.diff(pos) - 1
    n255 = gaps // 255
    total = int(n255.sum()) + len(gaps)
    out = np.full(total, 255, np.uint8)
    ends = np.cumsum(n255 + 1) - 1
    out[ends] = (gaps % 255).astype(np.uint8)
    return out.tobytes()


def sparse_decode(src: bytes, bitmap_len: int) -> bytes:
    """Inverse of sparse_encode; validates bounds and trailing state."""
    if not src:
        return bytes(bitmap_len)
    b = np.frombuffer(src, np.uint8).astype(np.int64)
    if b[-1] == 255:
        raise CorruptError("sparse bit table ends with a 255 extension")
    term = b != 255
    csum = np.cumsum(b)
    positions = csum[term] + np.cumsum(term)[term] - 1
    if positions[-1] >= bitmap_len * 8:
        raise CorruptError("sparse bit table position out of range")
    bits = np.zeros(bitmap_len * 8, np.uint8)
    bits[positions] = 1
    return np.packbits(bits, bitorder="little").tobytes()


# ---------------------------------------------------------------------------
# 0x46 encode
# ---------------------------------------------------------------------------

def _pick_block_log(n: int) -> int:
    """Largest legal huff0 sub-block that divides the bitmap, preferring
    ~4KiB sub-blocks so dispositions can adapt locally."""
    log = min(12, n.bit_length() - 1, 17)
    return max(5, log)


def marshal_compressed_table(cfg, block_size: int, table: bytes,
                             reductions: int):
    """Build a 0x46 chunk for the bitmap, or None when compression does not
    beat the plain 0x45 chunk (caller falls back)."""
    n = len(table)
    if n < 32:
        return None
    # Skip-compression heuristic: near 50% population entropy coding cannot
    # win (reference search_compressed.go:157-170).
    pop = int(np.unpackbits(np.frombuffer(table, np.uint8)).sum())
    if 0.42 * n * 8 < pop < 0.58 * n * 8:
        return None

    h0_bs = _pick_block_log(n)
    bs = 1 << h0_bs
    nblocks = n // bs
    subs = [table[i * bs : (i + 1) * bs] for i in range(nblocks)]

    # Up to 16 huff0 tables (wire format + reference
    # search_compressed.go:184-197): group consecutive sub-blocks by
    # distribution, opening a new group when cross-entropy under the
    # running group's histogram costs more than a fresh table header.
    hists = [np.bincount(np.frombuffer(s, np.uint8), minlength=256)
             for s in subs]

    def _entropy_bytes(c, q_hist):
        tot = int(q_hist.sum())
        if tot == 0:
            return 0.0
        q = (q_hist + 1) / (tot + 256)
        nz = c > 0
        return float(-(c[nz] * np.log2(q[nz])).sum()) / 8.0

    TABLE_HDR_COST = 48.0  # typical serialized huff0 table size
    groups = []  # list of [start, end) over subs
    acc = None
    for i, h in enumerate(hists):
        if acc is None:
            groups.append([i, i + 1])
            acc = h.astype(np.int64).copy()
            continue
        cross = _entropy_bytes(h, acc)
        own = _entropy_bytes(h, h)
        if cross - own > TABLE_HDR_COST and len(groups) < 16:
            groups.append([i, i + 1])
            acc = h.astype(np.int64).copy()
        else:
            groups[-1][1] = i + 1
            acc += h

    tables = []  # (header_tab, ctable) per group (None = unusable)
    group_of = [0] * nblocks
    for gi, (a, b) in enumerate(groups):
        counts = np.zeros(256, np.int64)
        for i in range(a, b):
            counts += hists[i]
            group_of[i] = gi
        built = huff0.build_ctable([int(x) for x in counts])
        tables.append(built)

    blocks_out = []
    used = set()
    for si, sub in enumerate(subs):
        a = np.frombuffer(sub, np.uint8)
        if (a == a[0]).all():
            blocks_out.append((None, bytes([DISP_RLE, a[0]])))
            continue
        candidates = [(None, bytes([DISP_RAW]) + sub)]
        spop = int(np.unpackbits(a).sum())
        if spop + (bs * 8 - spop) // 255 < bs:
            sp = sparse_encode(sub)
            candidates.append(
                (None, bytes([DISP_SPARSE]) + put_uvarint(len(sp)) + sp)
            )
        built = tables[group_of[si]]
        if built is not None:
            enc = huff0.encode_4x(built[1], sub)
            if enc is not None and len(enc) < bs:
                candidates.append(
                    (group_of[si], put_uvarint(len(enc)) + enc)
                )
        ti, best = min(candidates, key=lambda c: len(c[1]))
        if ti is not None:
            used.add(ti)
        blocks_out.append((ti, best))

    # Drop unused tables, remap indices densely.
    remap = {gi: k for k, gi in enumerate(sorted(used))}
    payload = bytearray([cfg.table_type, cfg.match_len,
                         cfg.auto_bits(block_size)])
    payload += cfg._prefix_field()
    payload.append(reductions)
    payload += crc(table).to_bytes(4, "little")
    payload.append(h0_bs)
    payload.append(len(remap))
    for gi in sorted(used):
        payload += tables[gi][0]
    for ti, b in blocks_out:
        if ti is None:
            payload += b
        else:
            payload.append(remap[ti])
            payload += b

    # Must beat the plain 0x45 representation to be worth emitting.
    if len(payload) >= len(table) + 12:
        return None
    return (
        bytes([CHUNK_TYPE_SEARCH_TABLE_COMPRESSED])
        + len(payload).to_bytes(3, "little")
        + bytes(payload)
    )


# ---------------------------------------------------------------------------
# 0x46 decode
# ---------------------------------------------------------------------------

def parse_compressed_table_chunk(payload: bytes):
    """Parse a 0x46 payload.  Returns (config, bits, reductions, table) —
    the same tuple shape as table.parse_table_chunk for 0x45."""
    from .table import parse_table_header

    cfg, bits, pos = parse_table_header(payload)
    if pos + 7 > len(payload):
        raise CorruptError("truncated compressed search table")
    reductions = payload[pos]
    want_crc = int.from_bytes(payload[pos + 1 : pos + 5], "little")
    h0_bs = payload[pos + 5]
    h0_tc = payload[pos + 6]
    pos += 7
    if not 5 <= h0_bs <= 17:
        raise CorruptError(f"huff0 block size log {h0_bs} out of range")
    if h0_tc > 16:
        raise CorruptError(f"huff0 table count {h0_tc} > 16")
    n = 1 << (bits - reductions - 3)
    bs = 1 << h0_bs
    if n % bs:
        raise CorruptError("bitmap not divisible by huff0 block size")

    dtables = []
    for _ in range(h0_tc):
        dt, consumed = huff0.read_table(payload[pos:])
        dtables.append(dt)
        pos += consumed

    out = bytearray()
    for _ in range(n // bs):
        if pos >= len(payload):
            raise CorruptError("truncated compressed table blocks")
        ti = payload[pos]
        pos += 1
        if ti <= 15:
            if ti >= len(dtables):
                raise CorruptError(f"huff0 table index {ti} out of range")
            ln, pos = read_uvarint(payload, pos)
            body = payload[pos : pos + ln]
            if len(body) != ln:
                raise CorruptError("truncated huff0 block")
            pos += ln
            out += huff0.decode_4x_body(dtables[ti], body, bs)
        elif ti == DISP_RAW:
            body = payload[pos : pos + bs]
            if len(body) != bs:
                raise CorruptError("truncated raw block")
            pos += bs
            out += body
        elif ti == DISP_RLE:
            if pos >= len(payload):
                raise CorruptError("truncated RLE block")
            out += bytes([payload[pos]]) * bs
            pos += 1
        elif ti == DISP_SPARSE:
            ln, pos = read_uvarint(payload, pos)
            body = payload[pos : pos + ln]
            if len(body) != ln:
                raise CorruptError("truncated sparse block")
            pos += ln
            out += sparse_decode(body, bs)
        else:
            raise CorruptError(f"reserved block disposition {ti}")
    table = bytes(out)
    if crc(table) != want_crc:
        raise CorruptError("compressed search table CRC mismatch")
    return cfg, bits, reductions, table


def disposition_stats(payload: bytes):
    """Per-disposition sub-block counts and on-wire bytes for a 0x46
    payload (the reference's CompressedSearchStatsHook / ``mz stats``
    disposition accounting, search_compressed.go:110-177).

    Returns {"tabled"|"raw"|"rle"|"sparse": {"count", "wire_bytes"}} plus
    "huff0_tables" and "bitmap_bytes"."""
    from .table import parse_table_header

    cfg, bits, pos = parse_table_header(payload)
    if pos + 7 > len(payload):
        raise CorruptError("truncated compressed table header")
    reductions = payload[pos]
    h0_bs = payload[pos + 5]
    h0_tc = payload[pos + 6]
    pos += 7
    for _ in range(h0_tc):
        _, consumed = huff0.read_table(payload[pos:])
        pos += consumed
    n = 1 << (bits - reductions - 3)
    bs = 1 << h0_bs
    stats = {
        k: {"count": 0, "wire_bytes": 0}
        for k in ("tabled", "raw", "rle", "sparse")
    }
    for _ in range(n // bs):
        if pos >= len(payload):
            raise CorruptError("truncated compressed table blocks")
        ti = payload[pos]
        start = pos
        pos += 1
        if ti <= 15:
            ln, pos = read_uvarint(payload, pos)
            pos += ln
            k = "tabled"
        elif ti == DISP_RAW:
            pos += bs
            k = "raw"
        elif ti == DISP_RLE:
            pos += 1
            k = "rle"
        elif ti == DISP_SPARSE:
            ln, pos = read_uvarint(payload, pos)
            pos += ln
            k = "sparse"
        else:
            raise CorruptError(f"reserved block disposition {ti}")
        if pos > len(payload):
            raise CorruptError("truncated compressed table blocks")
        stats[k]["count"] += 1
        stats[k]["wire_bytes"] += pos - start
    stats["huff0_tables"] = h0_tc
    stats["bitmap_bytes"] = n
    return stats
