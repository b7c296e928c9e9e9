"""Framed stream reader — parity surface with reference ``reader.go``.

Chunk state machine: 0x02/0x03 MinLZ blocks (+CRC), 0x01 uncompressed, 0xff
stream id (incl. concatenated-stream resync), 0x20 EOF size validation,
skippable/user chunk dispatch, Skip without decode, and a ReadSeeker using the
0x40 index.

``device`` is a torch device or a string such as "cuda" or "cpu"; ``None``
decodes every block on the host.  The JAX package's bools also hold: True
is "cuda", False the host.  With a device every compressed block decodes
there, with parse hints or without (as the format's other writers leave
every block: its lanes are then derived on the device).  A device decode
that fails raises: it is not replaced by a host decode.  Only a
CorruptError sends a block to the host: corrupt parse hints, which are
advisory, or a block without hints that the device found unsound, which
the host decoder then names.  The reader's ``hint_fallbacks`` counts the
first, ``host_unhinted_blocks`` every compressed block without hints that
the reader decoded on the host (every such block on the host route), and
the codec's ``blocks_decoded`` count shows which blocks the device took.
A device output that fails the CRC its chunk carries raises, as a host
output does.
"""

from __future__ import annotations

import io

from .. import block as blockapi
from .. import trace
from ..minlz import (
    CHUNK_TYPE_EOF,
    CHUNK_TYPE_INDEX,
    CHUNK_TYPE_LEGACY_COMPRESSED,
    CHUNK_TYPE_MINLZ_COMPRESSED,
    CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
    CHUNK_TYPE_PADDING,
    CHUNK_TYPE_STREAM_ID,
    CHUNK_TYPE_UNCOMPRESSED_DATA,
    MAGIC_BODY,
    MAGIC_BODY_S2,
    MAGIC_BODY_SNAPPY,
    MAX_BLOCK_SIZE,
    CorruptError,
    UnsupportedError,
    crc,
    read_uvarint,
)
from .._device import stream_device
from ..oracle.decode import parse_header
from .index import Index


class Reader:
    """Streaming MinLZ reader over a file-like object.

    Options (parity with the reference's 6 ReaderOptions):
      max_block_size            — reject streams with larger declared blocks.
      ignore_stream_identifier  — allow streams with no leading magic.
      ignore_crc                — skip CRC validation (fuzz/bench use).
      user_chunk_cb             — {chunk_id: callable(bytes)} for user chunks.
      fallback                  — accept Snappy/S2 magics (decode via legacy
                                  path); off by default.
      ignore_missing_eof        — do not treat a stream that ends without an
                                  EOF chunk as truncated (tail -f use).
      device                    — torch device of the block codec ("cuda" by
                                  default; "cpu" runs the same path in plain
                                  torch); None (or False) decodes on the
                                  host, True is "cuda".
    """

    def __init__(
        self,
        src,
        *,
        max_block_size: int = MAX_BLOCK_SIZE,
        ignore_stream_identifier: bool = False,
        ignore_crc: bool = False,
        user_chunk_cb=None,
        fallback: bool = False,
        ignore_missing_eof: bool = False,
        decoder_backend=None,
        device="cuda",
    ):
        self._src = src
        self._max_block_size = max_block_size
        self._ignore_stream_id = ignore_stream_identifier
        self._ignore_crc = ignore_crc
        self._user_cb = dict(user_chunk_cb or {})
        self._fallback = fallback
        self._backend = decoder_backend
        device = stream_device(device)
        self._device = device
        if device is not None:
            from ..ops.device_codec import get_device_codec

            self._device_codec = get_device_codec(device)
        else:
            self._device_codec = None
        self._pending_hints = None
        # Blocks whose hints were set aside for the host decoder.
        self.hint_fallbacks = 0
        # Compressed blocks without hints decoded on the host.
        self.host_unhinted_blocks = 0
        self._decoded = b""
        self._decoded_pos = 0
        self._block_start = 0  # uncompressed offset of current window start
        self._read_header = ignore_stream_identifier
        self._ignore_missing_eof = ignore_missing_eof
        self._uncompressed_seen = 0
        self._seen_data = False  # data chunk since last stream id
        self._seen_eof_chunk = False
        self._eof = False

    # --- Public API ---------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._decoded_pos >= len(self._decoded):
                if not self._next_block():
                    break
            take = len(self._decoded) - self._decoded_pos
            if n >= 0:
                take = min(take, n - len(out))
            out += self._decoded[self._decoded_pos : self._decoded_pos + take]
            self._decoded_pos += take
        return bytes(out)

    @property
    def codec(self):
        """The DeviceCodec of this reader, or None on the host path."""
        return self._device_codec

    def readall(self) -> bytes:
        """The rest of the stream.  With a device codec it drains through
        the batched device path (up to 8 blocks per dispatch)."""
        if self._device_codec is None:
            return self.read(-1)
        buf = io.BytesIO()
        self.decode_concurrent(buf)
        return buf.getvalue()

    def read_byte(self) -> int:
        b = self.read(1)
        if not b:
            raise EOFError("end of stream")
        return b[0]

    def skip(self, n: int) -> None:
        """Skip forward ``n`` uncompressed bytes, without decoding whole
        chunks where possible (reference Skip, reader.go:1034)."""
        if n < 0:
            raise ValueError("cannot skip backwards")
        # First serve from the current decoded window.
        avail = len(self._decoded) - self._decoded_pos
        if n <= avail:
            self._decoded_pos += n
            return
        n -= avail
        self._decoded = b""
        self._decoded_pos = 0
        while n > 0:
            hdr = self._read_exact(4, allow_eof=True)
            if hdr is None:
                raise EOFError("skip past end of stream")
            ctype = hdr[0]
            clen = int.from_bytes(hdr[1:4], "little")
            if ctype in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            ):
                payload = self._read_exact(clen)
                # Peek decoded size from the uvarint header only.
                dlen = self._block_decoded_len(payload[4:])
                if dlen > n:
                    # Decode this block and keep the tail.
                    self._decode_data_chunk(ctype, payload)
                    self._decoded_pos = n
                    return
                # The skipped block's hints must not reach the next one.
                self._pending_hints = None
                n -= dlen
                self._uncompressed_seen += dlen
            elif ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
                dlen = clen - 4
                if dlen > n:
                    payload = self._read_exact(clen)
                    self._decode_data_chunk(ctype, payload)
                    self._decoded_pos = n
                    return
                self._skip_src(clen)
                n -= dlen
                self._uncompressed_seen += dlen
            else:
                self._handle_control_chunk(ctype, clen)

    def decode_concurrent(self, dst, concurrency: int = 0) -> int:
        """Decode the whole stream into file-like ``dst`` with up to
        ``concurrency`` blocks decoding in parallel; output order is
        preserved by draining futures FIFO (reference DecodeConcurrent,
        reader.go:548 — its write-token chain becomes an ordered queue).

        The native codec releases the GIL, so host threads scale; with
        concurrency <= 1 this is a plain sequential drain."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        if concurrency == 0:
            concurrency = min(os.cpu_count() or 1, 8)
        total = 0
        if self._decoded_pos < len(self._decoded):
            data = self._decoded[self._decoded_pos :]
            dst.write(data)
            total += len(data)
            self._decoded_pos = len(self._decoded)
        if self._device_codec is not None:
            return total + self._decode_concurrent_device(dst)
        if concurrency <= 1:
            while self._next_block():
                dst.write(self._decoded)
                total += len(self._decoded)
                self._decoded_pos = len(self._decoded)
            return total

        pending = []
        with ThreadPoolExecutor(concurrency) as pool:

            def drain_one():
                nonlocal total
                fut, unhinted = pending.pop(0)
                data = fut.result()
                if unhinted:
                    self._host_unhinted(1)
                dst.write(data)
                total += len(data)
                self._uncompressed_seen += len(data)

            while True:
                hdr = self._read_exact(4, allow_eof=True)
                if hdr is None:
                    self._check_eof()
                    break
                ctype = hdr[0]
                clen = int.from_bytes(hdr[1:4], "little")
                if not self._read_header and ctype != CHUNK_TYPE_STREAM_ID:
                    raise CorruptError(
                        "stream must start with stream identifier"
                    )
                if ctype in (
                    CHUNK_TYPE_MINLZ_COMPRESSED,
                    CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                    CHUNK_TYPE_UNCOMPRESSED_DATA,
                ):
                    payload = self._read_exact(clen)
                    self._seen_data = True
                    # Threads run the stateless payload decode only; reader
                    # bookkeeping happens in drain order.
                    pending.append((
                        pool.submit(self._decode_payload, ctype, payload),
                        ctype != CHUNK_TYPE_UNCOMPRESSED_DATA
                        and self._has_tokens(payload[4:]),
                    ))
                    while len(pending) > 2 * concurrency:
                        drain_one()
                else:
                    # Control chunks need ordered context; drain first.
                    while pending:
                        drain_one()
                    self._handle_control_chunk(ctype, clen)
            while pending:
                drain_one()
        self._decoded = b""
        self._decoded_pos = 0
        return total

    def _decode_concurrent_device(self, dst, max_batch: int = 8) -> int:
        """Batched device drain: collect consecutive compressed data chunks,
        with parse hints or without, and decode them in ONE dispatch per
        batch (reference DecodeConcurrent's goroutine fan-out,
        reader.go:575-668, realized as multi-block kernel batching).  A
        CorruptError (corrupt hints, or a block without hints the device
        found unsound) sends the batch to the host decoder; any other
        device failure raises."""
        from ..minlz import CHUNK_TYPE_PARSE_HINT

        total = 0
        batch = []  # (ctype, payload, body, pos, want, hints)

        def write_block(data, ctype, payload):
            nonlocal total
            if ctype == CHUNK_TYPE_MINLZ_COMPRESSED and not self._ignore_crc:
                if crc(data) != int.from_bytes(payload[:4], "little"):
                    raise CorruptError("decoded data CRC mismatch")
            self._block_start = self._uncompressed_seen
            self._uncompressed_seen += len(data)
            dst.write(data)
            total += len(data)

        def flush():
            if not batch:
                return
            with trace.span("reader.batch"):
                items = [(b[2][b[3] - 1 :], b[5], b[4]) for b in batch]
                try:
                    outs = self._device_codec.decode_batch(items)
                except CorruptError:
                    # Hints are advisory: the block itself may still be
                    # sound; the host decoder names what is not.
                    hinted = sum(b[5] is not None for b in batch)
                    self.hint_fallbacks += hinted
                    self._host_unhinted(len(batch) - hinted)
                    outs = [
                        blockapi.decode(b"\x00" + b[2]) for b in batch
                    ]
                with trace.span("reader.check"):
                    for b, data in zip(batch, outs):
                        write_block(data, b[0], b[1])
            batch.clear()

        while True:
            hdr = self._read_exact(4, allow_eof=True)
            if hdr is None:
                flush()
                self._check_eof()
                break
            ctype = hdr[0]
            clen = int.from_bytes(hdr[1:4], "little")
            if not self._read_header and ctype != CHUNK_TYPE_STREAM_ID:
                raise CorruptError("stream must start with stream identifier")
            if ctype == CHUNK_TYPE_PARSE_HINT:
                # Hints precede their data chunk; keep the batch open.
                self._pending_hints = self._read_exact(clen)
                continue
            hints = self._pending_hints
            batchable = False
            if ctype in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            ):
                payload = self._read_exact(clen)
                self._pending_hints = None
                self._seen_data = True
                if len(payload) < 4:
                    raise CorruptError("data chunk shorter than its checksum")
                body = payload[4:]
                if (
                    ctype == CHUNK_TYPE_MINLZ_COMPRESSED_CRC
                    and not self._ignore_crc
                    and crc(body) != int.from_bytes(payload[:4], "little")
                ):
                    raise CorruptError("compressed data CRC mismatch")
                if self._block_decoded_len(body) > self._max_block_size:
                    raise CorruptError("block exceeds maximum block size")
                lit_only, want, pos = parse_header(b"\x00" + body)
                if not lit_only and want > 0:
                    batch.append((ctype, payload, body, pos, want, hints))
                    batchable = True
                    if len(batch) >= max_batch:
                        flush()
                else:
                    flush()
                    write_block(blockapi.decode(b"\x00" + body), ctype,
                                payload)
            if batchable:
                continue
            if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA or (
                ctype == CHUNK_TYPE_LEGACY_COMPRESSED and self._fallback
            ):
                flush()
                payload = self._read_exact(clen)
                self._seen_data = True
                self._decode_data_chunk(ctype, payload)
                dst.write(self._decoded)
                total += len(self._decoded)
                self._decoded_pos = len(self._decoded)
            elif ctype not in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
            ):
                flush()
                self._handle_control_chunk(ctype, clen)
        self._decoded = b""
        self._decoded_pos = 0
        return total

    def _decode_payload(self, ctype: int, payload: bytes) -> bytes:
        """Stateless data-chunk decode (thread-safe): CRC check + block
        decode without touching reader position state."""
        if len(payload) < 4:
            raise CorruptError("data chunk shorter than its checksum")
        want_crc = int.from_bytes(payload[:4], "little")
        body = payload[4:]
        if ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
            data = body
            if not self._ignore_crc and crc(data) != want_crc:
                raise CorruptError("uncompressed data CRC mismatch")
            return data
        if ctype == CHUNK_TYPE_MINLZ_COMPRESSED_CRC:
            if not self._ignore_crc and crc(body) != want_crc:
                raise CorruptError("compressed data CRC mismatch")
        data = blockapi.decode(b"\x00" + body)
        if ctype == CHUNK_TYPE_MINLZ_COMPRESSED:
            if not self._ignore_crc and crc(data) != want_crc:
                raise CorruptError("decoded data CRC mismatch")
        return data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def set_user_chunk_cb(self, chunk_id: int, cb) -> None:
        """Register a user-chunk callback after construction (reference
        UserChunkCB, reader.go:1523-1530: ids 0x80-0xfd only — the
        0x40-0x7f range holds format-reserved skippable chunks like the
        seek index, which the reader must keep handling internally)."""
        if not (0x80 <= chunk_id <= 0xFD):
            raise ValueError("user chunk id must be 0x80..0xfd")
        self._user_cb[chunk_id] = cb

    # --- Chunk machinery ----------------------------------------------------

    def _next_block(self) -> bool:
        """Advance to the next data chunk; returns False at end of stream."""
        while True:
            hdr = self._read_exact(4, allow_eof=True)
            if hdr is None:
                self._check_eof()
                self._eof = True
                return False
            ctype = hdr[0]
            clen = int.from_bytes(hdr[1:4], "little")
            if not self._read_header and ctype != CHUNK_TYPE_STREAM_ID:
                raise CorruptError("stream must start with stream identifier")
            if ctype in (
                CHUNK_TYPE_MINLZ_COMPRESSED,
                CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                CHUNK_TYPE_UNCOMPRESSED_DATA,
            ) or (ctype == CHUNK_TYPE_LEGACY_COMPRESSED and self._fallback):
                payload = self._read_exact(clen)
                self._seen_data = True
                self._decode_data_chunk(ctype, payload)
                if self._decoded:
                    return True
                continue
            self._handle_control_chunk(ctype, clen)

    def _check_eof(self) -> None:
        """At the end of the source: truncation detection.  Every stream
        must end with an EOF chunk (SPEC.md §4.6; reference wantEOF,
        reader.go); Snappy-framed streams have none in their framing.  The
        same check on every route: read, decode_concurrent and the device
        drain."""
        if (
            self._seen_data
            and not self._seen_eof_chunk
            and not self._ignore_missing_eof
            and not getattr(self, "_snappy_frame", False)
        ):
            raise CorruptError("stream truncated: missing EOF chunk")

    def _handle_control_chunk(self, ctype: int, clen: int) -> None:
        if ctype == CHUNK_TYPE_STREAM_ID:
            payload = self._read_exact(clen)
            self._parse_stream_id(payload)
        elif ctype == CHUNK_TYPE_EOF:
            payload = self._read_exact(clen)
            if clen > 10:
                raise CorruptError("oversized EOF chunk")
            if clen > 0:
                want, _ = read_uvarint(payload, 0)
                if want != self._uncompressed_seen:
                    raise CorruptError(
                        f"EOF size mismatch: stream declares {want}, "
                        f"decoded {self._uncompressed_seen}"
                    )
            self._seen_eof_chunk = True
        elif ctype == CHUNK_TYPE_LEGACY_COMPRESSED:
            raise UnsupportedError(
                "legacy Snappy/S2 compressed chunk (enable fallback decoding)"
            )
        elif ctype == CHUNK_TYPE_PADDING or 0x40 <= ctype <= 0x7F:
            if ctype == CHUNK_TYPE_INDEX and CHUNK_TYPE_INDEX in self._user_cb:
                payload = self._read_exact(clen)
                self._user_cb[CHUNK_TYPE_INDEX](payload)
            else:
                self._skip_src(clen)
        elif 0x80 <= ctype <= 0xBF:
            from ..minlz import CHUNK_TYPE_PARSE_HINT

            if ctype == CHUNK_TYPE_PARSE_HINT and self._device_codec is not None:
                self._pending_hints = self._read_exact(clen)
            elif ctype in self._user_cb:
                payload = self._read_exact(clen)
                self._user_cb[ctype](payload)
            else:
                self._skip_src(clen)
        elif 0xC0 <= ctype <= 0xFD:
            if ctype in self._user_cb:
                payload = self._read_exact(clen)
                self._user_cb[ctype](payload)
            else:
                raise UnsupportedError(
                    f"unsupported non-skippable chunk 0x{ctype:02x}"
                )
        else:
            # 0x04-0x3f reserved non-skippable
            raise UnsupportedError(f"reserved non-skippable chunk 0x{ctype:02x}")

    def _parse_stream_id(self, payload: bytes) -> None:
        if len(payload) < 6:
            raise CorruptError("short stream identifier")
        magic = payload[:5]
        if magic == MAGIC_BODY:
            size_byte = payload[5]
            if size_byte & 0xC0:
                raise CorruptError("reserved stream-id bits set")
            log = (size_byte & 0x0F) + 10
            if log > 23:
                raise CorruptError("max block size indicator > 13")
            declared = 1 << log
            if declared > self._max_block_size:
                from ..minlz import TooLargeError

                raise TooLargeError(
                    f"stream block size {declared} exceeds configured limit"
                )
            self._stream_block_size = declared
        elif payload[:6] == MAGIC_BODY_SNAPPY:
            if not self._fallback:
                raise UnsupportedError(
                    "Snappy stream (enable fallback decoding)"
                )
            self._snappy_frame = True
        elif payload[:6] == MAGIC_BODY_S2:
            # S2 framed stream (reference reader.go legacy path): same chunk
            # framing as Snappy but blocks may be S2-extended and up to 4 MiB.
            if not self._fallback:
                raise UnsupportedError("S2 stream (enable fallback decoding)")
            self._snappy_frame = True
        else:
            raise CorruptError("bad stream identifier magic")
        self._read_header = True
        # Stream concatenation: size counter resets at each identifier.
        self._uncompressed_seen = 0
        self._block_start = 0
        self._seen_data = False
        self._seen_eof_chunk = False

    def _decode_data_chunk(self, ctype: int, payload: bytes) -> None:
        if len(payload) < 4:
            raise CorruptError("data chunk shorter than its checksum")
        want_crc = int.from_bytes(payload[:4], "little")
        body = payload[4:]
        if ctype == CHUNK_TYPE_LEGACY_COMPRESSED:
            # Snappy-framed legacy compressed chunk (fallback mode).
            from ..snappy import snappy_decode_block

            data = snappy_decode_block(body)
            if not self._ignore_crc and crc(data) != want_crc:
                raise CorruptError("legacy chunk CRC mismatch")
        elif ctype == CHUNK_TYPE_UNCOMPRESSED_DATA:
            if len(body) > self._max_block_size:
                raise CorruptError("uncompressed chunk exceeds block size")
            data = body
            if not self._ignore_crc and crc(data) != want_crc:
                raise CorruptError("uncompressed data CRC mismatch")
        else:
            if ctype == CHUNK_TYPE_MINLZ_COMPRESSED_CRC:
                if not self._ignore_crc and crc(body) != want_crc:
                    raise CorruptError("compressed data CRC mismatch")
            dlen = self._block_decoded_len(body)
            if dlen > self._max_block_size:
                raise CorruptError("block exceeds maximum block size")
            data = self._decode_block(body)
            if ctype == CHUNK_TYPE_MINLZ_COMPRESSED:
                if not self._ignore_crc and crc(data) != want_crc:
                    raise CorruptError("decoded data CRC mismatch")
        self._block_start = self._uncompressed_seen
        self._uncompressed_seen += len(data)
        self._decoded = data
        self._decoded_pos = 0

    def _decode_block(self, body: bytes) -> bytes:
        # Stream chunks omit the leading 0x00 marker; reconstruct it for the
        # block decoder.
        hints = self._pending_hints
        self._pending_hints = None
        if self._device_codec is not None:
            lit_only, want, pos = parse_header(b"\x00" + body)
            if not lit_only and want > 0:
                try:
                    return self._device_codec.decode(
                        body[pos - 1 :], hints, want
                    )
                except CorruptError:
                    # Hints are advisory: corrupt hints leave the block to
                    # the host decoder, as does a block without hints that
                    # the device found unsound: the host decoder names what
                    # is wrong.  Any other device failure raises.
                    if hints is not None:
                        self.hint_fallbacks += 1
                    else:
                        self._host_unhinted(1)
        elif self._has_tokens(body):  # the host route keeps no hints
            self._host_unhinted(1)
        if self._backend is not None:
            return self._backend(b"\x00" + body)
        return blockapi.decode(b"\x00" + body)

    def _host_unhinted(self, n: int) -> None:
        """Count ``n`` compressed blocks without hints decoded on the
        host."""
        self.host_unhinted_blocks += n
        trace.count("reader.host_unhinted_blocks", n)

    @staticmethod
    def _has_tokens(body: bytes) -> bool:
        """A compressed chunk's body that holds tokens: its uvarint is not
        0 (a literal-only block)."""
        try:
            return read_uvarint(body, 0)[0] > 0
        except ValueError:
            return False

    @staticmethod
    def _block_decoded_len(body: bytes) -> int:
        v, pos = read_uvarint(body, 0)
        if v == 0:
            return len(body) - pos
        return v

    # --- IO helpers ---------------------------------------------------------

    def _read_exact(self, n: int, allow_eof: bool = False):
        data = self._src.read(n)
        if data is None:
            data = b""
        if len(data) == 0 and allow_eof:
            return None
        while len(data) < n:
            more = self._src.read(n - len(data))
            if not more:
                raise CorruptError(
                    f"truncated stream: wanted {n} bytes, got {len(data)}"
                )
            data += more
        return data

    def _skip_src(self, n: int) -> None:
        if hasattr(self._src, "seek"):
            try:
                self._src.seek(n, 1)
                return
            except (OSError, io.UnsupportedOperation):
                pass
        left = n
        while left > 0:
            got = self._src.read(min(left, 1 << 20))
            if not got:
                raise CorruptError("truncated stream while skipping")
            left -= len(got)


class ReadSeeker(Reader):
    """Random-access reader over a seekable stream using the 0x40 index
    (reference ReadSeeker, reader.go:1306)."""

    def __init__(self, src, *, index: Index | None = None, **opts):
        super().__init__(src, **opts)
        if index is None:
            pos = src.tell()
            try:
                index = Index.load_stream(src)
            finally:
                src.seek(pos)
        self._index = index
        self._abs_pos = 0
        import threading

        self._read_at_mu = threading.Lock()

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            offset += self.tell()
        elif whence == 2:
            if self._index.total_uncompressed < 0:
                raise ValueError("stream total size unknown")
            offset += self._index.total_uncompressed
        if offset < 0:
            raise ValueError("negative seek")
        coff, uoff = self._index.find(offset)
        self._src.seek(coff)
        self._pending_hints = None
        self._decoded = b""
        self._decoded_pos = 0
        self._read_header = coff != 0 or self._ignore_stream_id
        self._uncompressed_seen = uoff
        self._abs_pos = uoff
        self.skip(offset - uoff)
        self._abs_pos = offset
        return offset

    def tell(self) -> int:
        return self._block_start + self._decoded_pos if self._decoded else self._abs_pos

    def read(self, n: int = -1) -> bytes:
        out = super().read(n)
        self._abs_pos = self._block_start + self._decoded_pos
        return out

    def read_at(self, offset: int, n: int) -> bytes:
        """io.ReaderAt analog (reference reader.go:1469-1487): seek+read under
        a mutex so concurrent read_at callers don't interleave state; like the
        reference, the shared seek position IS affected."""
        with self._read_at_mu:
            self.seek(offset)
            out = bytearray()
            while len(out) < n:
                got = self.read(n - len(out))
                if not got:
                    break
                out += got
            return bytes(out)


def decompress(data, **opts) -> bytes:
    """One-shot stream decompression convenience."""
    return Reader(io.BytesIO(data), **opts).readall()
