"""Sidecar search index streams (SPEC_SEARCH.md §1.1, §2.3).

A sidecar carries search tables for an existing stream WITHOUT the data:
stream header + 0x44 info + per-block [0x45 table + 0x47 remote block
reference] + EOF.  Searching walks the small sidecar; the main stream is
touched only for must-decode blocks via ``ReaderAt``-style access.

Parity surface: reference sidecar.go (BuildSidecar/ExtractSidecar) and
sidecar_search.go (SidecarSearcher).
"""

from __future__ import annotations

import io

from .. import block as blockapi
from ..minlz import (
    CHUNK_TYPE_EOF,
    CHUNK_TYPE_MINLZ_COMPRESSED,
    CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
    CHUNK_TYPE_REMOTE_BLOCK_REF,
    CHUNK_TYPE_SEARCH_TABLE,
    CHUNK_TYPE_STREAM_ID,
    CHUNK_TYPE_UNCOMPRESSED_DATA,
    MAGIC_CHUNK,
    CorruptError,
    put_uvarint,
    read_uvarint,
)
from .build import build_table
from .searcher import BlockSearcher, SearchResult, SearchStats
from .table import SearchTableConfig, parse_table_chunk


def _remote_ref(block_offset: int, max_block: int, actual_uncomp: int) -> bytes:
    payload = put_uvarint(block_offset) + put_uvarint(
        max(max_block - actual_uncomp, 0)
    )
    return (
        bytes([CHUNK_TYPE_REMOTE_BLOCK_REF])
        + len(payload).to_bytes(3, "little")
        + payload
    )


def build_sidecar(src, cfg: SearchTableConfig) -> bytes:
    """Build a sidecar for an existing MinLZ stream: decode each block,
    build fresh search tables, and reference blocks remotely (reference
    BuildSidecar, sidecar.go:321)."""
    raw = src.read() if hasattr(src, "read") else bytes(src)
    out = bytearray()
    pos = 0
    max_block = 1 << 23
    wrote_header = False
    pending = []  # (chunk_offset, decoded_bytes)

    # First pass: collect blocks with offsets.
    blocks = []
    while pos + 4 <= len(raw):
        ctype = raw[pos]
        clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
        if ctype == CHUNK_TYPE_STREAM_ID:
            if not wrote_header:
                out += raw[pos : pos + 4 + clen]
                wrote_header = True
                max_block = 1 << ((raw[pos + 9] & 0x0F) + 10)
        elif ctype in (
            CHUNK_TYPE_MINLZ_COMPRESSED,
            CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            CHUNK_TYPE_UNCOMPRESSED_DATA,
        ):
            payload = raw[pos + 4 : pos + 4 + clen]
            if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
                data = payload[4:]
            else:
                data = blockapi.decode(b"\x00" + payload[4:])
            blocks.append((pos, data))
        pos += 4 + clen
    if not wrote_header:
        raise CorruptError("no stream identifier in source stream")

    out += cfg.marshal_info(max_block)
    for i, (boff, data) in enumerate(blocks):
        overlap = blocks[i + 1][1][:16] if i + 1 < len(blocks) else b""
        res = build_table(data, cfg, overlap, max_block)
        if res is not None:
            table, reductions = res
            out += cfg.marshal_table(max_block, table, reductions)
        out += _remote_ref(boff, max_block, len(data))
    out += bytes([CHUNK_TYPE_EOF, 0, 0, 0])
    return bytes(out)


def extract_sidecar(src) -> bytes:
    """Extract existing 0x44/0x45/0x46 chunks from a stream into a sidecar
    with remote refs (reference ExtractSidecar, sidecar.go:557)."""
    raw = src.read() if hasattr(src, "read") else bytes(src)
    out = bytearray()
    pos = 0
    pending_tables = bytearray()
    while pos + 4 <= len(raw):
        ctype = raw[pos]
        clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
        chunk = raw[pos : pos + 4 + clen]
        if ctype == CHUNK_TYPE_STREAM_ID and not out:
            out += chunk
        elif ctype in (0x44, 0x45, 0x46):
            pending_tables += chunk
        elif ctype in (
            CHUNK_TYPE_MINLZ_COMPRESSED,
            CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            CHUNK_TYPE_UNCOMPRESSED_DATA,
        ):
            payload = raw[pos + 4 : pos + 4 + clen]
            if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
                dlen = clen - 4
            else:
                dlen, _ = read_uvarint(payload, 4)
            out += pending_tables
            pending_tables = bytearray()
            out += _remote_ref(pos, 1 << 23, dlen)
        pos += 4 + clen
    out += bytes([CHUNK_TYPE_EOF, 0, 0, 0])
    return bytes(out)


class SidecarSearcher:
    """Search using a sidecar; fetch main-stream blocks only when needed
    (reference SidecarSearcher, sidecar_search.go)."""

    def __init__(self, sidecar, main_reader_at, pattern: bytes):
        self._sidecar = (
            sidecar.read() if hasattr(sidecar, "read") else bytes(sidecar)
        )
        self._main = main_reader_at  # object with .seek/.read
        self._pattern = bytes(pattern)
        self.stats = SearchStats()

    # Coalescing policy for main-stream fetches: bridge gaps up to _GAP
    # wasted bytes with one read; flush the decision queue at _MAX_BATCH.
    _GAP = 64 << 10
    _MAX_BATCH = 32

    def _fetch_one(self, offset: int):
        """(chunk_type, payload incl. CRC) of the chunk at ``offset``."""
        self._main.seek(offset)
        hdr = self._main.read(4)
        ctype = hdr[0]
        clen = int.from_bytes(hdr[1:4], "little")
        return ctype, self._main.read(clen)

    def _fetch_coalesced(self, entries):
        """Fetch many chunks with few reads: one read per run of entries
        whose inter-chunk gaps are <= _GAP (reference decodeBatch's single
        ReadAt over the whole batch span, sidecar_search.go:728-788).
        Returns {offset: (chunk_type, payload)}; entries whose chunk ran
        past the conservative size estimate fall back to a solo read."""
        out = {}
        runs = []
        for e in entries:
            # Upper bound on the chunk's on-wire size: header + CRC +
            # uvarint + data that never beats stored representation.
            est = e["dlen"] + (e["dlen"] >> 5) + 96
            if runs and e["boff"] - runs[-1][1] <= self._GAP:
                runs[-1][1] = max(runs[-1][1], e["boff"] + est)
                runs[-1][2].append(e)
            else:
                runs.append([e["boff"], e["boff"] + est, [e]])
        for start, end, es in runs:
            self._main.seek(start)
            buf = self._main.read(end - start)
            self.stats.reads_issued += 1
            for e in es:
                off = e["boff"] - start
                if off + 4 > len(buf):
                    continue  # solo fallback
                clen = int.from_bytes(buf[off + 1 : off + 4], "little")
                if off + 4 + clen <= len(buf):
                    out[e["boff"]] = (
                        buf[off],
                        buf[off + 4 : off + 4 + clen],
                    )
        return out

    def search(self, callback=None):
        """Walk the sidecar, deciding per block from its tables; fetch and
        decode main-stream blocks lazily.  Boundary-only blocks are
        DEFERRED until the next block's table resolves whether a straddle
        is possible (reference resolveSideDeferred,
        sidecar_search.go:645-686), and must-decode blocks are fetched in
        coalesced batches."""
        results = []
        searcher = BlockSearcher(io.BytesIO(b""), self._pattern)
        pos = 0
        raw = self._sidecar
        pending_table = None
        uoff = 0
        max_block = 1 << 23
        tail = [b""]
        force = [False]
        stop = [False]
        queue = []  # finalized decisions awaiting a batched flush
        deferred = None  # boundary block awaiting the next table

        def search_block(e, data):
            hay = tail[0] + data
            base = e["uoff"] - len(tail[0])
            start = 0
            while True:
                j = hay.find(self._pattern, start)
                if j < 0:
                    break
                r = SearchResult(offset=base + j, block_start=e["boff"])
                results.append(r)
                self.stats.matches += 1
                if callback is not None and callback(r) is False:
                    stop[0] = True
                    return
                start = j + 1
            keep = len(self._pattern) - 1
            tail[0] = hay[len(hay) - keep :] if keep else b""
            force[0] = any(
                tail[0].endswith(self._pattern[:k])
                for k in range(1, min(keep, len(self._pattern) - 1) + 1)
            )

        def flush():
            fetched = self._fetch_coalesced(
                [e for e in queue if e["decision"] == "decode"]
            )
            for e in queue:
                # A decoded tail ending in a pattern prefix forces the
                # next block regardless of its table verdict.
                if e["decision"] != "decode" and not force[0]:
                    self.stats.blocks_skipped += 1
                    tail[0] = b""
                    force[0] = False
                    continue
                item = fetched.get(e["boff"])
                if item is None:
                    item = self._fetch_one(e["boff"])
                ctype, payload = item
                if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
                    data = payload[4:]
                else:
                    data = blockapi.decode(b"\x00" + payload[4:])
                self.stats.blocks_decoded += 1
                search_block(e, data)
                if stop[0]:
                    return
            queue.clear()

        def resolve_deferred(next_table):
            nonlocal deferred
            if deferred is None:
                return
            e, dtab = deferred
            deferred = None
            if next_table is not None and not searcher._straddle_possible(
                dtab, next_table
            ):
                e["decision"] = "skip"
                self.stats.blocks_deferred_skipped += 1
            else:
                e["decision"] = "decode"
            queue.append(e)

        while pos + 4 <= len(raw) and not stop[0]:
            ctype = raw[pos]
            clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
            payload = raw[pos + 4 : pos + 4 + clen]
            pos += 4 + clen
            if ctype == CHUNK_TYPE_STREAM_ID:
                # Matches never straddle concatenated streams: a deferred
                # block had only boundary-straddle starts left, so it is
                # safe to skip unread.
                if deferred is not None:
                    deferred[0]["decision"] = "skip"
                    self.stats.blocks_deferred_skipped += 1
                    queue.append(deferred[0])
                    deferred = None
                if len(payload) >= 6 and payload[:5] == MAGIC_CHUNK[4:9]:
                    max_block = 1 << ((payload[5] & 0x0F) + 10)
                flush()
                tail[0] = b""
                force[0] = False
                uoff = 0
            elif ctype == CHUNK_TYPE_SEARCH_TABLE:
                pending_table = parse_table_chunk(payload)
                self.stats.tables_seen += 1
                self.stats.table_bytes += len(payload)
            elif ctype == 0x46:
                from .compressed import parse_compressed_table_chunk

                pending_table = parse_compressed_table_chunk(payload)
                self.stats.tables_seen += 1
                self.stats.tables_compressed += 1
                self.stats.table_bytes += len(payload)
            elif ctype == CHUNK_TYPE_REMOTE_BLOCK_REF:
                boff, p2 = read_uvarint(payload, 0)
                max_minus_actual, p2 = read_uvarint(payload, p2)
                dlen = max_block - max_minus_actual
                self.stats.blocks_total += 1
                table_info = pending_table
                pending_table = None
                resolve_deferred(table_info)
                e = {"boff": boff, "dlen": dlen, "uoff": uoff}
                # The remote ref encodes maxBlock - actualSize, so the
                # uncompressed offset stays exact across skips.
                uoff += dlen
                if table_info is None:
                    e["decision"] = "decode"
                    self.stats.blocks_no_table += 1
                    queue.append(e)
                else:
                    verdict = searcher._decide(table_info)
                    if verdict == "boundary":
                        # Hold: the NEXT block's table decides whether a
                        # straddle into it is possible at any split.
                        self.stats.blocks_deferred += 1
                        deferred = (e, table_info)
                    else:
                        e["decision"] = (
                            "decode" if verdict == "decode" else "skip"
                        )
                        queue.append(e)
                if len(queue) >= self._MAX_BATCH and deferred is None:
                    flush()
        if deferred is not None:
            # End of sidecar: no next table to prove the straddle
            # impossible — decode conservatively (reference finalize).
            deferred[0]["decision"] = "decode"
            queue.append(deferred[0])
        if not stop[0]:
            flush()
        return results
