"""Stream-facing device codec: block encode/decode + parse-hint wire format.

The counterpart of ``minlz_tpu.ops.device_codec``.  The wire format is the
same, so streams interchange with the JAX package in both directions:
parse hints travel in the user-skippable chunk 0x88, payload
"MZPH" + version + uvarint(segment_size) + uvarint(n_segments)
[+ uvarint(range), version 2] + delta-uvarint compressed offsets.

Decoding takes one of two roads, both on the device.  Hints with a range
clamp that the range executors take go to ``exec_chain.decode_blocks_chained``
(ranges decode independently, each staged in shared memory).  Every other
well-formed hint payload (version 1, range 0, a range above ``RANGE`` or one
that is no multiple of the segment size) goes to
``exec_block.decode_blocks_whole``, where a copy may reach any earlier byte
of its block.
"""

from __future__ import annotations

import threading

from .. import trace
from .._device import resolve_device
from ..minlz import CorruptError, put_uvarint, read_uvarint

HINT_MAGIC = b"MZPH"
HINT_VERSION = 2
# Encoder match-source clamp granularity (hints v2): ranges decode
# independently.  The same value as minlz_tpu/ops/exec_chain.py RANGE.
RANGE = 128 * 1024
# Default segment size and match-finder window, as in
# minlz_tpu/ops/encode_kernel.py SEG and WINDOW.
SEG = 4096
WINDOW = 16384
# Largest decoded block the device path takes (the format's block limit).
MAX_BLOCK = 8 << 20

def marshal_hints(seg_size: int, hints, rng: int = 0) -> bytes:
    """hints: list of (comp_offset, out_offset); out offsets are implied by
    the fixed segment size, so only comp offsets go on the wire."""
    out = bytearray(HINT_MAGIC)
    out.append(HINT_VERSION)
    out += put_uvarint(seg_size)
    out += put_uvarint(len(hints))
    out += put_uvarint(rng)
    prev = 0
    for coff, _ in hints:
        out += put_uvarint(coff - prev)
        prev = coff
    return bytes(out)


def parse_hints(payload: bytes):
    """Returns (seg_size, [comp_offset...], rng) or raises CorruptError."""
    if payload[:4] != HINT_MAGIC:
        raise CorruptError("bad parse-hint magic")
    if len(payload) < 5:
        raise CorruptError("truncated parse hints")
    version = payload[4]
    if version not in (1, 2):
        raise CorruptError(f"unsupported parse-hint version {version}")
    try:
        pos = 5
        seg_size, pos = read_uvarint(payload, pos)
        n, pos = read_uvarint(payload, pos)
        rng = 0
        if version >= 2:
            rng, pos = read_uvarint(payload, pos)
        offs = []
        cur = 0
        for _ in range(n):
            d, pos = read_uvarint(payload, pos)
            cur += d
            offs.append(cur)
    except ValueError as exc:  # truncated or overlong uvarint
        raise CorruptError(f"bad parse hints: {exc}") from exc
    return seg_size, offs, rng


def split_body(body: bytes, comp_offsets):
    """Slice a block body into per-segment token streams."""
    segs = []
    for i, off in enumerate(comp_offsets):
        end = comp_offsets[i + 1] if i + 1 < len(comp_offsets) else len(body)
        segs.append(body[off:end])
    return segs


class DeviceCodec:
    """Block codec on a torch device, for the stream layer.

    encode(data, level) -> (block, hint_payload) | None
    decode(body, hint_payload, decoded_len) -> bytes

    ``blocks_encoded`` / ``blocks_decoded`` count the blocks that went
    through the device match finder and the device decoder, on either
    decode road (range-parallel or whole-block).  The stream Reader and
    Writer share one codec a device (``get_device_codec``), so there the
    counts are the process's on that device.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.blocks_encoded = 0
        self.blocks_decoded = 0

    @staticmethod
    def _seg_for(n: int) -> int:
        """Segment size scaling: <=2MiB blocks use 4KiB segments; bigger
        blocks grow segments so 8MiB still fits 512 lanes."""
        seg = SEG
        while n > seg * 512:
            seg *= 2
        return seg

    # encode_kernel and exec_chain take their constants from this module,
    # so they are imported where they are used.
    def encode(self, data: bytes, level: int = 2):
        from . import encode_kernel

        seg = self._seg_for(len(data))
        block, hints = encode_kernel.encode_block_device(
            bytes(data), seg, RANGE, level, self.device)
        self.blocks_encoded += 1
        if block is None:
            return None
        return block, marshal_hints(seg, hints, RANGE)

    def encode_batch(self, blocks, level: int = 2):
        """Encode many blocks with one match-finder pass.  Returns a list of
        (block, hint_payload) | None entries, aligned with the input."""
        from . import encode_kernel

        seg = self._seg_for(max(len(b) for b in blocks))
        with trace.span("codec.encode_batch"):
            results = encode_kernel.encode_blocks_device(
                [bytes(b) for b in blocks], seg, RANGE, level, self.device)
        self.blocks_encoded += len(blocks)
        return [None if block is None
                else (block, marshal_hints(seg, hints, RANGE))
                for block, hints in results]

    def encode_emit(self, data: bytes, level: int = 2):
        """Encode one block wholly on the device: match find -> greedy
        parse -> byte-exact verify -> token emission (``ops/emit.py``); the
        host only frames the header.  No short repeats are found, so the
        ratio is worse than ``encode``'s.  Returns (block, hint_payload),
        or None when the block is empty or does not compress."""
        if len(data) == 0:
            return None
        return self.encode_batch_emit([data], level)[0]

    def encode_batch_emit(self, blocks, level: int = 2):
        """Encode many blocks wholly on the device, in one pass over a
        [B, N] batch padded to one window-sized geometry.  Returns a list
        of (block, hint_payload) | None entries, aligned with the input."""
        import torch

        from . import emit

        with trace.span("codec.pack_batch"):
            seg, arr, ns = self._emit_batch(blocks)
        with trace.span("codec.copy_in", self.device):
            data = torch.from_numpy(arr).to(self.device)
        out, lens = emit.encode_block_emit(data, ns, seg, RANGE, level)
        self.blocks_encoded += len(blocks)
        return self._emit_results(blocks, seg, out, lens)

    def encode_batch_mesh(self, mesh, blocks, level: int = 2):
        """Data-parallel ``encode_batch_emit`` over a ``parallel.Mesh``.
        Every rank calls it with the same blocks.  The batch is padded to a
        multiple of the mesh size, each rank encodes its contiguous share
        (``parallel.sharded_encode_blocks``: match find -> parse -> verify
        -> emit, with the collective size scan), then the segment lengths
        and the segment bytes, padded to the longest segment, are
        all-gathered.  Returns the whole batch's (block, hint_payload) |
        None entries on every rank, in submission order."""
        import torch

        from ..parallel.mesh import all_gather, sharded_encode_blocks

        if mesh.device != self.device:
            raise ValueError(f"mesh device {mesh.device} is not the "
                             f"codec's {self.device}")
        seg, arr, ns = self._emit_batch(blocks, mesh.size)
        local = arr.shape[0] // mesh.size
        mine = slice(mesh.rank * local, (mesh.rank + 1) * local)
        out, lens, _, _ = sharded_encode_blocks(
            mesh, torch.from_numpy(arr[mine]), ns[mine], seg, RANGE, level)
        all_lens = all_gather(mesh, lens)
        longest = max(int(all_lens.max()), 1)
        all_out = all_gather(mesh, out[:, :, :longest])
        self.blocks_encoded += len(blocks[mine])
        return self._emit_results(blocks, seg, all_out, all_lens)

    def _emit_batch(self, blocks, multiple: int = 1):
        """(seg, [B, N] uint8 batch, [B] lengths) for the emit path: one
        window-sized geometry, B padded to a multiple of ``multiple`` with
        empty blocks.  Emission needs at least one byte per block."""
        import numpy as np

        seg = self._seg_for(max(len(b) for b in blocks))
        N = -(-max(max(len(b) for b in blocks), 1) // seg) * seg
        N = -(-N // (2 * WINDOW)) * (2 * WINDOW)
        B = -(-len(blocks) // multiple) * multiple
        arr = np.zeros((B, N), np.uint8)
        ns = np.ones(B, np.int32)
        for i, b in enumerate(blocks):
            arr[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
            ns[i] = max(len(b), 1)
        return seg, arr, ns

    @staticmethod
    def _emit_results(blocks, seg, out, lens):
        """Frame each block's emitted segments: (block, hint_payload), or
        None when the block is empty or does not compress."""
        import numpy as np

        trace.count("codec.copy_back_bytes",
                    out.numel() * out.element_size()
                    + lens.numel() * lens.element_size())
        with trace.span("codec.copy_back", out.device):
            out = out.cpu().numpy()
            lens = lens.cpu().numpy()
        with trace.span("codec.frame_segments"):
            results, kept = [], 0
            for i, b in enumerate(blocks):
                n = len(b)
                nseg = -(-n // seg)
                body = b"".join(
                    out[i, s, : lens[i, s]].tobytes() for s in range(nseg))
                if n == 0 or len(body) >= n:
                    results.append(None)
                    continue
                kept += len(body)
                offs = np.concatenate([[0], np.cumsum(lens[i, :nseg])[:-1]])
                hints = [(int(o), s * seg) for s, o in enumerate(offs)]
                block = b"\x00" + put_uvarint(n) + body
                results.append((block, marshal_hints(seg, hints, RANGE)))
        trace.count("codec.kept_bytes", kept)
        return results

    @staticmethod
    def _chained_ok(seg_size: int, rng: int, decoded_len: int) -> bool:
        """Which road a well-formed hinted block takes.  True: its hints
        carry a range clamp whose ranges are whole segments and fit the
        range executors' staging, so it decodes range by range
        (``decode_blocks_chained``).  False (no clamp, ``rng > RANGE`` or
        ``rng % seg_size != 0``): it decodes as one whole block
        (``decode_blocks_whole``)."""
        return bool(
            rng
            and rng % seg_size == 0
            and rng <= RANGE
            and decoded_len <= MAX_BLOCK
        )

    def _prepare(self, body: bytes, hint_payload: bytes, decoded_len: int):
        """(segment size, range or 0 for the whole-block road, segments)."""
        seg_size, offs, rng = parse_hints(hint_payload)
        if seg_size % 128 or not 4096 <= seg_size <= (1 << 20):
            raise CorruptError(f"unsupported hint segment size {seg_size}")
        if len(offs) != -(-decoded_len // seg_size):
            raise CorruptError("parse hints do not cover the block")
        if decoded_len > MAX_BLOCK:
            raise CorruptError(f"block of {decoded_len} bytes exceeds the "
                               f"format's {MAX_BLOCK}")
        if not self._chained_ok(seg_size, rng, decoded_len):
            rng = 0
        return seg_size, rng, split_body(body, offs)

    def decode(self, body: bytes, hint_payload: bytes, decoded_len: int):
        return self.decode_batch([(body, hint_payload, decoded_len)])[0]

    def decode_batch(self, items):
        """Decode many hinted blocks, one dispatch per group: blocks with a
        usable range clamp by (segment size, range), every other block by
        segment size on the whole-block road.  The whole list is one group
        when written by one Writer.  items: list of (body, hint_payload,
        decoded_len).  Returns a list of bytes, aligned with items."""
        from .exec_block import decode_blocks_whole
        from .exec_chain import decode_blocks_chained

        groups = {}
        for i, (body, hints, dlen) in enumerate(items):
            with trace.span("codec.prepare"):
                seg, rng, segs = self._prepare(body, hints, dlen)
            groups.setdefault((seg, rng), []).append((i, segs, dlen))
        out = [None] * len(items)
        for (seg, rng), entries in groups.items():
            segs = [e[1] for e in entries]
            wants = [e[2] for e in entries]
            if rng:
                res = decode_blocks_chained(segs, wants, seg, rng,
                                            self.device)
            else:
                res = decode_blocks_whole(segs, wants, seg, self.device)
            for (i, _, _), r in zip(entries, res):
                out[i] = r
        self.blocks_decoded += len(items)
        return out


_codecs = {}
_codecs_lock = threading.Lock()


def get_device_codec(device="cuda") -> DeviceCodec:
    """The process's codec on ``device`` (one a device, made at first use),
    which the stream Reader and Writer share, as the JAX package's
    ``get_device_codec`` is shared."""
    dev = resolve_device(device)
    with _codecs_lock:
        codec = _codecs.get(dev)
        if codec is None:
            codec = _codecs[dev] = DeviceCodec(dev)
    return codec
