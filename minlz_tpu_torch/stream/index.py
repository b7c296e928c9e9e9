"""Seek index codec (chunk 0x40) — parity with reference ``index.go``.

Wire format per SPEC.md §4.12: "s2idx\x00" header, varint totals, delta-coded
offset arrays, fixed trailer enabling backward search from EOF.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..minlz import (
    CHUNK_TYPE_INDEX,
    CorruptError,
    S2_INDEX_HEADER,
    S2_INDEX_TRAILER,
    put_uvarint,
    put_varint,
    read_uvarint,
    read_varint,
)

MAX_INDEX_ENTRIES = (1 << 16) - 1
# Minimum uncompressed distance between indexed blocks (reference index.go:26).
MIN_INDEX_DIST = 1 << 20


@dataclass
class Index:
    """Random-access index over a MinLZ stream.

    ``info`` holds (compressed_offset, uncompressed_offset) pairs in ascending
    order.  ``est_block_uncomp`` is the modal uncompressed block size used for
    delta coding.
    """

    total_uncompressed: int = -1
    total_compressed: int = -1
    est_block_uncomp: int = 0
    info: list = field(default_factory=list)

    # --- Building -----------------------------------------------------------

    def reset(self) -> None:
        self.total_compressed = -1
        self.total_uncompressed = -1
        self.info = []
        self.est_block_uncomp = 0

    def allocate(self, n: int) -> None:
        pass  # python lists grow dynamically

    def _gate(self) -> int:
        """Normalized entry-spacing gate: the block-size estimate doubled
        until it reaches MIN_INDEX_DIST (reference index.go:55-62); sticky,
        like the reference's init-time normalization."""
        est = self.est_block_uncomp
        if est <= 0:
            est = MIN_INDEX_DIST
        while est < MIN_INDEX_DIST:
            est *= 2
        self.est_block_uncomp = est  # sticky: reduce_light doubles THIS
        return est

    def add(self, compressed_offset: int, uncompressed_offset: int) -> None:
        """Record a block start.  Entries must be strictly increasing;
        entries closer than the current block estimate are skipped
        (reference index.go:80-103)."""
        est = self._gate()
        if self.info:
            latest_c, latest_u = self.info[-1]
            if latest_u == uncompressed_offset:
                # Update with the latest (equal uncompressed offset).
                self.info[-1] = (compressed_offset, uncompressed_offset)
                return
            if uncompressed_offset - latest_u < est:
                return
            if latest_c >= compressed_offset or latest_u >= uncompressed_offset:
                raise ValueError("index offsets must be monotonic")
        self.info.append((compressed_offset, uncompressed_offset))
        if len(self.info) > MAX_INDEX_ENTRIES:
            self._reduce_light()

    def _reduce_light(self) -> None:
        """Memory-bound reduction while building: double the block estimate
        and re-decimate to that spacing (reference index.go:172-185,
        including its keep-the-entry-after-the-first-far-one stride)."""
        self.est_block_uncomp *= 2
        est = self.est_block_uncomp
        src = self.info
        out = []
        idx = 0
        while idx < len(src):
            base = src[idx]
            out.append(base)
            while idx < len(src) and src[idx][1] - base[1] < est:
                idx += 1
            idx += 1  # the reference outer loop's increment
        self.info = out

    def _reduce(self) -> None:
        """Marshal-time reduction to the wire-format entry limit: drop
        removeN of every removeN+1 entries, growing removeN while the
        implied block estimate stays under MIN_INDEX_DIST and more than
        1000 entries would remain (reference index.go:147-170)."""
        if len(self.info) < MAX_INDEX_ENTRIES:
            return
        remove_n = (len(self.info) + 1) // MAX_INDEX_ENTRIES
        est = self.est_block_uncomp or MIN_INDEX_DIST
        while (
            est * (remove_n + 1) < MIN_INDEX_DIST
            and len(self.info) // (remove_n + 1) > 1000
        ):
            remove_n += 1
        self.info = self.info[:: remove_n + 1]
        self.est_block_uncomp = est + est * remove_n

    # --- Lookup -------------------------------------------------------------

    def find(self, offset: int):
        """Return (compressed_offset, uncompressed_offset) of the indexed
        block at or before ``offset`` (uncompressed).  Reference index.go:114.
        """
        if self.total_uncompressed < 0:
            raise CorruptError("index has no total size")
        if offset > self.total_uncompressed:
            raise ValueError("offset beyond stream end")
        if not self.info:
            return 0, 0
        lo, hi = 0, len(self.info)
        # Binary search for the last entry with uncompressed_offset <= offset.
        while lo < hi:
            mid = (lo + hi) // 2
            if self.info[mid][1] <= offset:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return 0, 0
        return self.info[lo - 1]

    # --- Wire format --------------------------------------------------------

    def marshal(self) -> bytes:
        """Serialize as a 0x40 skippable chunk."""
        self._reduce()
        est = self.est_block_uncomp or self._estimate_block_size()
        has_uoff = self._needs_uncompressed_offsets(est)
        return self._marshal(est, has_uoff)

    def _marshal(self, est: int, has_uoff: bool) -> bytes:
        body = bytearray()
        body += S2_INDEX_HEADER
        body += put_varint(self.total_uncompressed)
        body += put_varint(self.total_compressed)
        body += put_varint(est)
        body += put_varint(len(self.info))
        body.append(1 if has_uoff else 0)

        if has_uoff:
            prev_u = 0
            for i, (_, uoff) in enumerate(self.info):
                body += put_varint(uoff if i == 0 else uoff - prev_u - est)
                prev_u = uoff

        cguess = est // 2
        prev_c = 0
        for i, (coff, _) in enumerate(self.info):
            if i == 0:
                body += put_varint(coff)
            else:
                delta = coff - prev_c - cguess
                body += put_varint(delta)
                cguess += _trunc_div2(delta)
            prev_c = coff

        total_size = len(body) + 4 + 4 + 6  # body + chunk hdr + size field + trailer
        body += total_size.to_bytes(4, "little")
        body += S2_INDEX_TRAILER

        chunk = bytearray()
        chunk.append(CHUNK_TYPE_INDEX)
        chunk += len(body).to_bytes(3, "little")
        chunk += body
        return bytes(chunk)

    def _estimate_block_size(self) -> int:
        if len(self.info) < 2:
            return self.info[0][1] if self.info else 0
        deltas = [
            self.info[i + 1][1] - self.info[i][1]
            for i in range(len(self.info) - 1)
        ]
        deltas.sort()
        return deltas[len(deltas) // 2]

    def _needs_uncompressed_offsets(self, est: int) -> bool:
        prev = 0
        for i, (_, uoff) in enumerate(self.info):
            if i == 0 and uoff != 0:
                return True
            if i > 0 and uoff - prev != est:
                return True
            prev = uoff
        return False

    # --- Loading ------------------------------------------------------------

    @classmethod
    def load(cls, buf) -> "Index":
        """Parse an index from a 0x40 chunk (with header) or bare body."""
        idx = cls()
        idx._load(buf)
        return idx

    def _load(self, buf) -> int:
        buf = bytes(buf)
        pos = 0
        if buf[:1] == bytes([CHUNK_TYPE_INDEX]):
            clen = int.from_bytes(buf[1:4], "little")
            pos = 4
            if clen > len(buf) - 4:
                raise CorruptError("index chunk truncated")
        if buf[pos : pos + 6] != S2_INDEX_HEADER:
            raise CorruptError("bad index header")
        pos += 6
        self.total_uncompressed, pos = read_varint(buf, pos)
        self.total_compressed, pos = read_varint(buf, pos)
        est, pos = read_varint(buf, pos)
        if est < 0:
            raise CorruptError("negative EstBlockSize")
        self.est_block_uncomp = est
        entries, pos = read_varint(buf, pos)
        if entries < 0 or entries > MAX_INDEX_ENTRIES:
            raise CorruptError("invalid entry count")
        has_uoff = buf[pos]
        pos += 1
        if has_uoff not in (0, 1):
            raise CorruptError("invalid HasUncompressedOffsets")

        uoffs = []
        prev_u = 0
        for i in range(entries):
            if has_uoff:
                v, pos = read_varint(buf, pos)
            else:
                v = 0
            if i == 0:
                u = v if has_uoff else 0
            else:
                u = prev_u + est + v
            if i > 0 and u <= prev_u:
                raise CorruptError("non-monotonic uncompressed offsets")
            uoffs.append(u)
            prev_u = u

        coffs = []
        cguess = est // 2
        prev_c = 0
        for i in range(entries):
            v, pos = read_varint(buf, pos)
            if i == 0:
                c = v
            else:
                c = prev_c + cguess + v
                cguess += _trunc_div2(v)
            if i > 0 and c <= prev_c:
                raise CorruptError("non-monotonic compressed offsets")
            coffs.append(c)
            prev_c = c

        self.info = list(zip(coffs, uoffs))

        # Trailer validation when present.
        if len(buf) - pos >= 10:
            size = int.from_bytes(buf[pos : pos + 4], "little")
            if buf[pos + 4 : pos + 10] != S2_INDEX_TRAILER:
                raise CorruptError("bad index trailer")
            pos += 10
        return pos

    @classmethod
    def load_stream(cls, f) -> "Index":
        """Read an index from the tail of a seekable stream (reference
        LoadStream, index.go:416-448).  The writer guarantees the index chunk
        is the LAST thing in the stream (after any padding), so the trailer
        sits at EOF.  Raises UnsupportedError when no trailer signature is
        present, CorruptError on malformed contents."""
        from ..minlz import MAX_CHUNK_SIZE, UnsupportedError

        f.seek(-10, 2)
        tail = f.read(10)
        if len(tail) < 10 or tail[4:10] != S2_INDEX_TRAILER:
            raise UnsupportedError("no index trailer at stream end")
        size = int.from_bytes(tail[0:4], "little")
        if size > MAX_CHUNK_SIZE + 4:
            raise CorruptError("index size out of range")
        f.seek(-size, 2)
        chunk_hdr = f.read(4)
        if chunk_hdr[0] != CHUNK_TYPE_INDEX:
            raise CorruptError("trailer does not point at an index chunk")
        body = f.read(size - 4)
        return cls.load(bytes(chunk_hdr) + body)

    @classmethod
    def index_stream(cls, f) -> "Index":
        """Build an index by scanning an existing stream's chunk headers
        (no block decoding; reference IndexStream, index.go:455)."""
        from ..minlz import (
            CHUNK_TYPE_EOF,
            CHUNK_TYPE_MINLZ_COMPRESSED,
            CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            CHUNK_TYPE_STREAM_ID,
            CHUNK_TYPE_UNCOMPRESSED_DATA,
            CorruptError,
            read_uvarint,
        )

        idx = cls()
        coff = 0
        uoff = 0
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            ctype = hdr[0]
            clen = int.from_bytes(hdr[1:4], "little")
            if ctype in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                CHUNK_TYPE_UNCOMPRESSED_DATA,
            ):
                payload = f.read(clen)
                if len(payload) < clen:
                    raise CorruptError("truncated stream while indexing")
                if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
                    dlen = clen - 4
                else:
                    dlen, _ = read_uvarint(payload, 4)
                    if dlen == 0:
                        dlen = clen - 5
                idx.add(coff, uoff)
                uoff += dlen
            elif ctype == CHUNK_TYPE_STREAM_ID:
                f.read(clen)
            elif ctype == CHUNK_TYPE_EOF:
                f.read(clen)
            else:
                f.seek(clen, 1)
            coff += 4 + clen
        idx.total_uncompressed = uoff
        idx.total_compressed = coff
        return idx

    # --- Tools --------------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "total_uncompressed": self.total_uncompressed,
                "total_compressed": self.total_compressed,
                "est_block_uncomp": self.est_block_uncomp
                or self._estimate_block_size(),
                "entries": [
                    {"compressed": c, "uncompressed": u} for c, u in self.info
                ],
            },
            indent=2,
        )

    def remove_headers(self) -> bytes:
        """Strip the chunk header + trailer for compact external storage
        (reference RemoveIndexHeaders, index.go:581)."""
        full = self.marshal()
        return full[4 + 6 : -10]

    @classmethod
    def restore_headers(cls, body: bytes) -> bytes:
        inner = S2_INDEX_HEADER + body
        total_size = len(inner) + 4 + 4 + 6
        inner += total_size.to_bytes(4, "little") + S2_INDEX_TRAILER
        chunk = bytearray([CHUNK_TYPE_INDEX])
        chunk += len(inner).to_bytes(3, "little")
        chunk += inner
        return bytes(chunk)


def _trunc_div2(v: int) -> int:
    """Integer-truncating v/2 (toward zero), per the spec's CompressGuess."""
    return v // 2 if v >= 0 else -((-v) // 2)
