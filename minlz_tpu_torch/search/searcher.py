"""BlockSearcher: pattern search over compressed streams with block skipping.

Parity surface: reference ``search_reader.go`` (chunk-driven state machine,
table decision, window enumeration per type, first-window boundary rule,
rolling decoded tail for straddling matches, deferred decode, compressed
0x46 tables, WindowStat-class statistics, and the forward-context protocol:
a callback may return ``SEARCH_FORWARD`` to have the next block decoded and
the same match re-delivered with extended context — reference
ErrSearchForward, search_reader.go:179-182).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import block as blockapi
from ..minlz import (
    CHUNK_TYPE_EOF,
    CHUNK_TYPE_MINLZ_COMPRESSED,
    CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
    CHUNK_TYPE_SEARCH_INFO,
    CHUNK_TYPE_SEARCH_TABLE,
    CHUNK_TYPE_STREAM_ID,
    CHUNK_TYPE_UNCOMPRESSED_DATA,
    CorruptError,
    read_uvarint,
)
from ..minlz import CHUNK_TYPE_SEARCH_TABLE_COMPRESSED
from .table import (
    TYPE_BYTE_PREFIX,
    TYPE_LONG_PREFIX,
    TYPE_MASK_PREFIX,
    TYPE_NO_PREFIX,
    hash_value,
    parse_table_chunk,
)


# Sentinel a search callback may return to request forward context: the
# searcher decodes the next block and re-calls the callback with the same
# match carrying extended ``context`` (reference ErrSearchForward protocol,
# search_reader.go:179-182).
SEARCH_FORWARD = object()


@dataclass
class SearchResult:
    offset: int  # uncompressed stream offset of the match
    block_start: int  # uncompressed offset of the containing block
    context: bytes = b""  # decoded bytes around the match
    context_start: int = 0  # uncompressed offset of context[0]


@dataclass
class WindowStat:
    """Per-pattern-window table-presence counts across all tables seen
    (reference search_reader.go:66-76)."""

    pos: int  # start index of the window within the pattern
    bytes: bytes = b""  # the match_len bytes that get hashed
    present: int = 0  # tables with the bit set
    absent: int = 0  # tables with the bit clear


@dataclass
class SearchStats:
    """Reference-class search statistics (search_reader.go:17-180)."""

    blocks_total: int = 0
    blocks_skipped: int = 0
    blocks_decoded: int = 0
    blocks_no_table: int = 0
    blocks_deferred: int = 0
    blocks_deferred_skipped: int = 0
    blocks_false_positive: int = 0
    blocks_boundary_scanned: int = 0
    comp_bytes_skipped: int = 0
    uncomp_bytes_searched: int = 0
    tables_seen: int = 0
    tables_unusable: int = 0
    tables_compressed: int = 0
    table_bytes: int = 0
    tables_compressed_bytes: int = 0
    table_bits_sum: int = 0
    table_reductions_sum: int = 0
    table_pop_min: float = 100.0
    table_pop_max: float = 0.0
    table_pop_sum: float = 0.0
    matches: int = 0
    reads_issued: int = 0  # sidecar: coalesced ReadAt batches issued
    windows: list = field(default_factory=list)  # list[WindowStat]

    def _win(self, pos: int, wbytes: bytes) -> WindowStat:
        for w in self.windows:
            if w.pos == pos:
                return w
        w = WindowStat(pos=pos, bytes=wbytes)
        self.windows.append(w)
        return w

    def fprint(self, f) -> None:
        total = max(self.blocks_total, 1)
        dec = max(self.blocks_decoded, 1)
        f.write(
            f"Blocks total: {self.blocks_total}, skipped: "
            f"{self.blocks_skipped} "
            f"({100 * self.blocks_skipped / total:.1f}%), deferred: "
            f"{self.blocks_deferred} ({self.blocks_deferred_skipped} "
            f"skipped)\n"
            f"Blocks searched: {self.blocks_decoded} "
            f"({100 * self.blocks_decoded / total:.1f}%), false positive: "
            f"{self.blocks_false_positive} "
            f"({100 * self.blocks_false_positive / dec:.1f}%), "
            f"boundary-scanned: {self.blocks_boundary_scanned}\n"
            f"Bytes skipped: {self.comp_bytes_skipped} compressed, "
            f"searched: {self.uncomp_bytes_searched} uncompressed\n"
            f"Tables: {self.tables_seen} present, {self.blocks_no_table} "
            f"missing, {self.tables_unusable} unusable "
            f"({self.tables_compressed} compressed, {self.table_bytes} "
            f"bytes)\n"
        )
        if self.tables_seen:
            f.write(
                f"Table bits avg: "
                f"{self.table_bits_sum / self.tables_seen:.1f}, reductions "
                f"avg: {self.table_reductions_sum / self.tables_seen:.1f}, "
                f"population avg {self.table_pop_sum / self.tables_seen:.1f}"
                f"% min {self.table_pop_min:.1f}% max "
                f"{self.table_pop_max:.1f}%\n"
            )
        f.write(f"Matches: {self.matches}\n")

    def fprint_extended(self, f) -> None:
        self.fprint(f)
        for w in sorted(self.windows, key=lambda w: w.pos):
            f.write(
                f"  window @{w.pos} {w.bytes!r}: present {w.present}, "
                f"absent {w.absent}\n"
            )


class BlockSearcher:
    """Search a MinLZ stream for a byte pattern using 0x45 block tables.

    Guarantee: tables may produce false positives (extra decodes) but never
    false negatives — every real occurrence is reported.
    """

    def __init__(self, src, pattern: bytes, *, bail_no_table: bool = False):
        if not pattern:
            raise ValueError("empty search pattern")
        self._src = src
        self._pattern = bytes(pattern)
        self._bail = bail_no_table
        self.stats = SearchStats()
        self._pending_table = None
        self._deferred = None  # held block awaiting the next table
        self._uoff = 0  # uncompressed offset of next block
        self._tail = b""  # rolling decoded tail for boundary straddles
        self._force_next = False  # previous decoded tail may start a match
        self._forward = []  # matches awaiting forward context (callback
        #                     returned SEARCH_FORWARD)

    def _table_stats(self, table_info) -> None:
        cfg, bits, reductions, table = table_info
        st = self.stats
        st.table_bits_sum += bits - reductions
        st.table_reductions_sum += reductions
        ones = sum(bin(b).count("1") for b in table)
        pop = 100.0 * ones / max(len(table) * 8, 1)
        st.table_pop_min = min(st.table_pop_min, pop)
        st.table_pop_max = max(st.table_pop_max, pop)
        st.table_pop_sum += pop

    # --- Table decision ----------------------------------------------------

    def _pattern_windows(self, cfg):
        """Hash windows of the pattern to check, per table type (Appendix A).

        Returns (windows, usable) where windows is a list of (index, is_first)
        and usable=False means the table cannot filter this pattern."""
        p = self._pattern
        m = cfg.match_len
        if len(p) < m:
            return [], False
        wins = []
        if cfg.table_type == TYPE_NO_PREFIX:
            for i in range(len(p) - m + 1):
                wins.append((i, i == 0))
            return wins, True
        if cfg.table_type in (TYPE_BYTE_PREFIX, TYPE_MASK_PREFIX):
            pset = (
                set(cfg.prefixes)
                if cfg.table_type == TYPE_BYTE_PREFIX
                else cfg.prefix_mask
            )
            for i in range(1, len(p) - m + 1):
                if p[i - 1] in pset:
                    wins.append((i, False))
            return wins, bool(wins)
        # Long prefix: find prefix occurrences inside the pattern.
        pl = cfg.prefixes
        start = 0
        while True:
            j = p.find(pl, start)
            if j < 0:
                break
            base = j + len(pl)
            for k in range(cfg.extra_matches + 1):
                if base + k + m <= len(p):
                    wins.append((base + k, False))
            start = j + 1
        return wins, bool(wins)

    def _window_presence(self, table_info, record=False):
        """{pattern window index: present?} for every window this table can
        check.  Uncheckable windows are omitted (assumed present).  With
        ``record`` the per-window presence counters are updated (once per
        table: only the primary _decide call records)."""
        cfg, bits, reductions, table = table_info
        wins, usable = self._pattern_windows(cfg)
        if not usable:
            return None
        mask = (1 << (bits - reductions)) - 1
        p = self._pattern
        m = cfg.match_len
        out = {}
        for i, _ in wins:
            val = int.from_bytes(p[i : i + m], "little")
            h = hash_value(val, bits, m) & mask
            out[i] = bool(table[h >> 3] & (1 << (h & 7)))
            if record:
                w = self.stats._win(i, p[i : i + m])
                if out[i]:
                    w.present += 1
                else:
                    w.absent += 1
        return out

    def _decide(self, table_info) -> str:
        """Per-block decision: 'decode', 'skip', or 'boundary' (a match can
        only straddle into the next block — candidate for deferred decode,
        SPEC_SEARCH.md B.3)."""
        presence = self._window_presence(table_info, record=True)
        if presence is None:
            self.stats.tables_unusable += 1
            return "decode"
        absent = [i for i, ok in presence.items() if not ok]
        if not absent:
            return "decode"
        # Any absent window rules out a fully-contained occurrence.  A
        # straddle starting j bytes before block end needs windows < j
        # present; window 0 is always among them, so its absence (when
        # checkable) rules the block out entirely.
        if presence.get(0) is False:
            return "skip"
        return "boundary"

    def _straddle_possible(self, prev_info, next_info) -> bool:
        """Can the pattern straddle prev block -> next block, given both
        tables?  Split j: first j pattern bytes end the previous block
        (windows starting at i < j are indexed by the previous table —
        overlap indexing — and i >= j by the next)."""
        if prev_info is None or next_info is None:
            return True
        prev_p = self._window_presence(prev_info)
        next_p = self._window_presence(next_info)
        if prev_p is None and next_p is None:
            return True
        n = len(self._pattern)
        for j in range(1, n):
            ok = True
            if prev_p is not None:
                for i, pres in prev_p.items():
                    if i < j and not pres:
                        ok = False
                        break
            if ok and next_p is not None:
                for i, pres in next_p.items():
                    if i >= j and not pres:
                        ok = False
                        break
            if ok:
                return True
        return False

    # --- Stream walk -------------------------------------------------------

    def search(self, callback=None):
        """Scan the stream; returns list of SearchResult (also passed to
        ``callback`` as they are found; callback returning False stops)."""
        results = []
        read = self._src.read
        while True:
            hdr = read(4)
            if len(hdr) < 4:
                break
            ctype = hdr[0]
            clen = int.from_bytes(hdr[1:4], "little")
            payload = read(clen)
            if len(payload) < clen:
                raise CorruptError("truncated stream during search")

            if ctype == CHUNK_TYPE_STREAM_ID:
                # A match never straddles concatenated streams: a deferred
                # block can only have contained boundary-straddle starts, so
                # it is safe to drop unread.
                if self._deferred is not None:
                    self._deferred = None
                    self.stats.blocks_skipped += 1
                self._pending_table = None
                self._tail = b""
                self._force_next = False
                self._uoff = 0
            elif ctype == CHUNK_TYPE_SEARCH_INFO:
                self.stats.tables_seen += 0  # informational only
            elif ctype == CHUNK_TYPE_SEARCH_TABLE:
                self._pending_table = parse_table_chunk(payload)
                self.stats.tables_seen += 1
                self.stats.table_bytes += len(payload)
                self._table_stats(self._pending_table)
            elif ctype == CHUNK_TYPE_SEARCH_TABLE_COMPRESSED:
                from .compressed import parse_compressed_table_chunk

                self._pending_table = parse_compressed_table_chunk(payload)
                self.stats.tables_seen += 1
                self.stats.tables_compressed += 1
                self.stats.table_bytes += len(payload)
                self.stats.tables_compressed_bytes += len(payload)
                self._table_stats(self._pending_table)
            elif ctype in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                CHUNK_TYPE_UNCOMPRESSED_DATA,
            ):
                stop = self._handle_block(ctype, payload, results, callback)
                if stop:
                    return results
            elif ctype == CHUNK_TYPE_EOF:
                if self._deferred is not None:
                    # Nothing follows: a straddle cannot complete.
                    self._deferred = None
                    self.stats.blocks_skipped += 1
            # Other chunks (index, hints, padding, user) are skipped.
        if self._deferred is not None:
            self._deferred = None
            self.stats.blocks_skipped += 1
        return results

    def _handle_block(self, ctype, payload, results, callback) -> bool:
        table_info = self._pending_table
        self._pending_table = None
        self.stats.blocks_total += 1

        if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
            dlen = len(payload) - 4
        else:
            body = payload[4:]
            dlen, _ = read_uvarint(body, 0)
            if dlen == 0:
                dlen = len(body) - 1  # literal-only approximation

        # Resolve a deferred block now that the follow-up table is known
        # (deferred decode, reference search_reader.go:1653-1797).
        if self._deferred is not None:
            d = self._deferred
            self._deferred = None
            if self._straddle_possible(d["table"], table_info):
                if self._decode_and_scan(
                    d["ctype"], d["payload"], d["uoff"], results, callback
                ):
                    return True
            else:
                self.stats.blocks_skipped += 1
                self.stats.blocks_deferred_skipped += 1
                self.stats.comp_bytes_skipped += len(d["payload"])
                self._tail = b""
                self._force_next = False

        if table_info is None:
            self.stats.blocks_no_table += 1
            if self._bail:
                raise CorruptError("block without search table (bail)")
            decision = "decode"
        else:
            decision = self._decide(table_info)
        if (self._force_next or self._forward) and decision != "decode":
            # The previous decoded block ends with a potential pattern start
            # (or a callback asked for forward context); this block must be
            # decoded regardless of the table's verdict (reference:
            # boundary scan / ErrSearchForward, search_reader.go:1034).
            self.stats.blocks_boundary_scanned += 1
            decision = "decode"

        if decision == "skip":
            self.stats.blocks_skipped += 1
            self.stats.comp_bytes_skipped += len(payload)
            self._tail = b""
            self._uoff += dlen
            return False
        if decision == "boundary":
            # A match can only straddle into the NEXT block; hold the
            # compressed chunk until that block's table decides.
            self.stats.blocks_deferred += 1
            self._deferred = {
                "ctype": ctype,
                "payload": payload,
                "table": table_info,
                "uoff": self._uoff,
            }
            self._uoff += dlen
            return False
        stop = self._decode_and_scan(
            ctype, payload, self._uoff, results, callback
        )
        self._uoff += dlen
        return stop

    def _decode_and_scan(self, ctype, payload, uoff, results,
                         callback) -> bool:
        """Decode a data chunk whose uncompressed start is ``uoff`` and scan
        it (with the rolling tail) for pattern occurrences."""
        self.stats.blocks_decoded += 1
        if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
            data = payload[4:]
        else:
            data = blockapi.decode(b"\x00" + payload[4:])
        self.stats.uncomp_bytes_searched += len(data)

        # Resolve matches waiting on forward context (callback returned
        # SEARCH_FORWARD): re-deliver with this block's bytes appended.
        if self._forward:
            pending, self._forward = self._forward, []
            for r in pending:
                r.context = r.context + data
                ret = callback(r) if callback is not None else None
                if ret is False:
                    return True
                if ret is SEARCH_FORWARD:
                    self._forward.append(r)

        hay = self._tail + data
        base = uoff - len(self._tail)
        start = 0
        found = 0
        while True:
            j = hay.find(self._pattern, start)
            if j < 0:
                break
            r = SearchResult(
                offset=base + j, block_start=uoff,
                context=hay, context_start=base,
            )
            results.append(r)
            self.stats.matches += 1
            found += 1
            if callback is not None:
                ret = callback(r)
                if ret is False:
                    return True
                if ret is SEARCH_FORWARD:
                    self._forward.append(r)
            start = j + 1
        if not found:
            self.stats.blocks_false_positive += 1
        keep = len(self._pattern) - 1
        self._tail = hay[len(hay) - keep :] if keep else b""
        # Straddle guard: if the tail ends with a proper pattern prefix, the
        # next block is decoded unconditionally.
        self._force_next = any(
            self._tail.endswith(self._pattern[:k])
            for k in range(1, min(keep, len(self._pattern) - 1) + 1)
        )
        return False
