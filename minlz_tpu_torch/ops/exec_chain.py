"""Range-parallel decode of hinted MinLZ blocks: plan, parse, compact, execute.

The counterpart of ``minlz_tpu.ops.exec_chain`` (``plan_batch`` ->
``_decode_batch_jit`` -> ``decode_blocks_chained``), both of its branches.
Parse hints v2 guarantee that every copy source lies in the ``RANGE``-aligned
range of its destination, so ranges decode independently.  A batch of blocks
decodes in one dispatch of three kernels:

1. parse (``ops/parse.py``, ``csrc/parse.cu``): every segment lane's
   compressed bytes -> the lane's record list;
2. compact: the lane lists -> one dense record list per range, in output
   order, with global literal indices and the hostile-input clamps;
3. execute: one range per thread block, staged in shared memory -> the
   decoded bytes.  ``execute_ranges`` (K3) resolves a range's bytes in
   parallel (``csrc/resolve.cuh``); ``execute_scheduled`` first scans each
   range's record lengths for their positions, then runs K3's core.

Steps 2 and 3 come in two forms, chosen by the ``executor`` argument of
``decode_blocks_chained``:

* ``"fast"`` (the default; ``compact_ops_fast`` / ``execute_fast`` of the
  TPU package): ``compact_records`` gives every record its range-local
  output position and ``execute_ranges`` places it there;
* ``"scheduled"`` (``compact_ops_dense`` / ``execute_scheduled`` of the TPU
  package, in its packed and its planar layout alike): records carry no
  position; ``compact_records_dense`` drops it and ``execute_scheduled``
  keeps an append-only cursor per range.  The bytes are the same on every
  valid stream.

The planning also serves the whole-block road of ``ops/exec_block.py``
(blocks without a usable range clamp): ``plan_batch(..., rng=0)`` lays out
one range per block, as many lanes wide as the block has segments.

Lanes and ranges keep the TPU package's meaning: lane ``r * spr + i`` holds
segment i of range r (``spr = rng // seg``), each block's lanes are padded
to whole ranges, and range j of a block owns output bytes
[j * rng, min((j + 1) * rng, nseg * seg)) of that block.  The TPU arena
(512-byte rows, per-lane comp margins, per-range op caps, MAXC chains, OP_T
tiles and the 14/17-bit field packing) does not carry over; every capacity
is sized from real counts.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain torch version, in this module, for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build, trace
from .._device import resolve_device
from .device_codec import RANGE
from .parse import parse_planned

_I32 = torch.int32
_I64 = torch.int64
_LIMIT = 1 << 31


# --------------------------------------------------------------------------
# Planning (host)
# --------------------------------------------------------------------------

@dataclass
class BatchPlan:
    """Host-side geometry of a batched decode (all numpy)."""

    comp: np.ndarray        # [n >= 1] uint8, the lanes' bytes back to back
    lane_start: np.ndarray  # [lanes] int32, exclusive prefix sum of lane_len
    lane_len: np.ndarray    # [lanes] int32
    lane_lo: np.ndarray     # [lanes] int32, range-local output span start
    lane_hi: np.ndarray     # [lanes] int32, range-local output span end
    range_out: np.ndarray   # [R] int64, output offset of each range
    range_span: np.ndarray  # [R] int32, output bytes of each range
    range_lane: np.ndarray  # [R + 1] int64, first lane of each range
    rng: int                # range size in bytes; 0: one range per block
    max_span: int           # the largest range span the executor must take
    block_out: list         # per block: (output offset, nseg * seg)
    total_out: int          # decoded bytes of the batch, before trimming

    def __post_init__(self):
        # The executors' check of the ranges, made here on the host once,
        # so that a decode of the plan reads nothing back from the card.
        check_spans(torch.from_numpy(self.range_out),
                    torch.from_numpy(self.range_span), self.total_out)

    def tensors(self, device) -> dict:
        dev = resolve_device(device)
        return {
            "comp": torch.from_numpy(self.comp).to(dev),
            "lane_start": torch.from_numpy(self.lane_start).to(dev),
            "lane_len": torch.from_numpy(self.lane_len).to(dev),
            "lane_lo": torch.from_numpy(self.lane_lo).to(dev),
            "lane_hi": torch.from_numpy(self.lane_hi).to(dev),
            "range_out": torch.from_numpy(self.range_out).to(dev),
            "range_span": torch.from_numpy(self.range_span).to(dev),
            "range_lane": torch.from_numpy(self.range_lane).to(dev),
        }


def _cat(parts, dtype):
    return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)


def plan_batch(blocks_segs, seg: int, rng: int = RANGE) -> BatchPlan:
    """Pack every block's segment streams into lanes and lay out the
    per-range output geometry.  blocks_segs: per block, the list of its
    segments' compressed bytes.  ``rng == 0`` plans whole blocks: one range
    per block, of ``nseg`` lanes and ``nseg * seg`` bytes."""
    if seg <= 0 or rng < 0 or rng % seg:
        raise ValueError("range must be 0 or a positive multiple of the "
                         "segment size")
    lens, lo, hi, r_out, r_span, r_lanes, block_out = [], [], [], [], [], [], []
    parts = []
    out_base = 0
    for segs in blocks_segs:
        nseg = len(segs)
        blk = nseg * seg
        if blk >= _LIMIT:
            raise ValueError("block exceeds 2 GiB")
        spr = rng // seg if rng else nseg
        nr = -(-nseg // spr) if rng else 1
        span_max = rng if rng else blk
        seg_len = np.zeros(nr * spr, np.int64)
        seg_len[:nseg] = [len(s) for s in segs]
        parts.extend(bytes(s) for s in segs)
        j = np.arange(nr, dtype=np.int64)
        span = np.minimum(span_max, blk - j * span_max)
        i_lo = (np.arange(nr * spr, dtype=np.int64) % max(spr, 1)) * seg
        lane_span = np.repeat(span, spr)
        lens.append(seg_len)
        lo.append(np.minimum(i_lo, lane_span))
        hi.append(np.minimum(i_lo + seg, lane_span))
        r_out.append(out_base + j * span_max)
        r_span.append(span)
        r_lanes.append(np.full(nr, spr, np.int64))
        block_out.append((out_base, blk))
        out_base += blk
    comp = np.frombuffer(b"".join(parts) or b"\x00", np.uint8).copy()
    lane_len = _cat(lens, np.int64)
    if len(comp) >= _LIMIT or out_base >= _LIMIT:
        raise ValueError("decode batch exceeds 2 GiB")
    lane_start = np.cumsum(lane_len) - lane_len
    range_span = _cat(r_span, np.int32)
    return BatchPlan(
        comp=comp,
        lane_start=lane_start.astype(np.int32),
        lane_len=lane_len.astype(np.int32),
        lane_lo=_cat(lo, np.int32),
        lane_hi=_cat(hi, np.int32),
        range_out=_cat(r_out, np.int64),
        range_span=range_span,
        range_lane=np.concatenate(
            [[0], np.cumsum(_cat(r_lanes, np.int64))]).astype(np.int64),
        rng=rng,
        max_span=rng if rng else int(range_span.max(initial=0)),
        block_out=block_out,
        total_out=out_base,
    )


# --------------------------------------------------------------------------
# Compaction: per-lane record lists -> per-range dense lists
# --------------------------------------------------------------------------

OFFSETS = "lane_offsets"
COMPACT = "compact"
COMPACT_DENSE = "compact_dense"
EXEC = "exec_range"
EXEC_SCHED = "exec_sched"


def lane_offsets(counts):
    """Exclusive prefix sum of the lane record counts [lanes] int32, in
    int64: each lane's first column in the dense lists.  Returns (lane_out
    [lanes], total [1]), both int64 tensors on the counts' device (views of
    one [lanes + 1] tensor); nothing comes back to the host.  A CUDA tensor
    launches ``csrc/compact.cu``'s scan, one block."""
    dev = counts.device
    if dev.type == "cpu":
        return lane_offsets_plain(counts)
    if dev.type != "cuda":
        raise ValueError(f"no lane offset kernel for device {dev}")
    if counts.dtype != _I32 or counts.dim() != 1:
        raise ValueError("counts must be a 1-D int32 tensor")
    off = torch.empty(counts.numel() + 1, dtype=_I64, device=dev)
    launch_offsets(counts.contiguous(), off)
    return off[:-1], off[-1:]


def launch_offsets(counts, off):
    """The bare launch of the lane offset scan: checked, contiguous CUDA
    ``counts`` [lanes] int32 in, ``off`` [lanes + 1] int64 written in
    place."""
    lib = _build.load()
    _build.check(lib, lib.minlz_lane_offsets(
        counts.data_ptr(), counts.numel(), off.data_ptr(),
        _build.stream_of(counts)))
    _build.count_launch(OFFSETS)


def lane_offsets_plain(counts):
    """Plain torch version of ``lane_offsets`` (any device)."""
    incl = torch.cumsum(counts, 0, dtype=_I64)
    off = torch.cat([incl.new_zeros(1), incl])
    return off[:-1], off[-1:]


def _compact_args(name, recs, counts, lanes, dtypes):
    """The checked, contiguous arguments of a compaction launch: recs, the
    lane arrays (lane_start, lane_len, counts[, lane_lo, lane_hi]) and,
    after counts, lane_out from the offset scan; then the total."""
    dev = recs.device
    if dev.type != "cuda":
        raise ValueError(f"no compaction kernel for device {dev}")
    if recs.dim() != 2 or recs.shape[0] != 7:
        raise ValueError("recs must be [7, n_slots]")
    args = [t.contiguous() for t in (recs, *lanes[:2], counts, *lanes[2:])]
    for t, dt in zip(args, (_I32, *dtypes)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: wrong dtype or device")
    if any(t.shape != args[1].shape for t in args[2:]):
        raise ValueError(f"{name}: lane arrays differ in length")
    lane_out, total = lane_offsets(args[3])
    return [*args[:4], lane_out, *args[4:]], total


def compact_records(recs, counts, lane_start, lane_len, lane_lo, lane_hi):
    """recs [7, n_slots] / counts [lanes]: the parse output.  Returns (out
    [5, n_slots] int32 with rows pos, llen, clen, csrc, lit; lane_out
    [lanes] int64; total [1] int64), all on the device, nothing read back.
    Columns [0, total) hold the records, lanes in range order, so range r's
    records are out[:, first[r]:first[r + 1]] with ``first =
    range_firsts(lane_out, total, ...)``; the columns past the total are
    unspecified (the kernel leaves them unwritten).  n_slots is the parse's
    slot capacity, len + 1 a lane, which no lane's count exceeds.

    With whole-block lane spans (``plan_batch(..., rng=0)``: lane i of a
    block owns [i * seg, (i + 1) * seg) of it) the same launch is the
    counterpart of ``minlz_tpu.ops.pallas_decode.compact_ops``: one dense
    list per block, in output order, with block-local positions."""
    if recs.device.type == "cpu":
        return compact_records_plain(recs, counts, lane_start, lane_len,
                                     lane_lo, lane_hi)
    args, total = _compact_args(
        "compact_records", recs, counts,
        (lane_start, lane_len, lane_lo, lane_hi), (_I32,) * 5)
    out = torch.empty((5, recs.shape[1]), dtype=_I32, device=recs.device)
    launch_compact(COMPACT, args, out)
    return out, args[4], total


def launch_compact(kernel: str, args, out):
    """The bare launch of a compaction kernel, ``COMPACT`` or
    ``COMPACT_DENSE``.  args: the checked, contiguous CUDA tensors (recs,
    lane_start, lane_len, counts, lane_out[, lane_lo, lane_hi]); ``out``
    [5 or 4, n_slots] is written in place, its first total columns.  No
    check, no allocation, no read back; measurements time this."""
    lib = _build.load()
    fn = lib.minlz_compact if kernel == COMPACT else lib.minlz_compact_dense
    _build.check(lib, fn(
        args[0].data_ptr(), ctypes.c_longlong(args[0].shape[1]),
        *(a.data_ptr() for a in args[1:]), args[2].numel(),
        out.data_ptr(), ctypes.c_longlong(out.shape[1]),
        _build.stream_of(args[0])))
    _build.count_launch(kernel)


def _lane_ranks(recs, counts, lane_start):
    """(lane_out, total, n, lane, rank, slot) of the plain compactions:
    each of the n = total records' lane, its rank in the lane and its
    parse slot.  Reads the total back (the plain versions are the CPU path
    and the reference)."""
    lane_out, total = lane_offsets_plain(counts)
    n = int(total)
    dev = recs.device
    lane = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                   counts.to(_I64), output_size=n)
    rank = torch.arange(n, device=dev) - lane_out[lane]
    slot = lane_start.to(_I64)[lane] + lane + rank
    return lane_out, total, n, lane, rank, slot


def compact_records_plain(recs, counts, lane_start, lane_len, lane_lo,
                          lane_hi):
    """Plain torch version of ``compact_records`` (any device): the same
    first total columns, zeros past them."""
    lane_out, total, n, lane, rank, slot = _lane_ranks(recs, counts,
                                                        lane_start)
    dst, clen, csrc, lsrc, llen = recs[1:6, slot].to(_I64)
    llen = llen.clamp(min=0)
    clen = clen.clamp(min=0)
    end = dst + llen + clen
    # Exclusive max of earlier record ends within each lane, from 0: a
    # cummax over keys that put each lane above every earlier lane.
    lane_key = lane << 36
    incl = torch.cummax(lane_key + (end + (1 << 33)), 0).values
    prev = torch.cat([incl.new_zeros(1), incl[:-1]]) - lane_key - (1 << 33)
    prior = torch.where(rank > 0, prev, 0).clamp(min=0)
    keep = dst >= prior
    lo = lane_lo.to(_I64)[lane]
    hi = lane_hi.to(_I64)[lane]
    p = torch.where(keep, torch.minimum(lo + dst, hi), hi)
    avail = hi - p
    ll = torch.minimum(llen, avail)
    cl = torch.minimum(clen, avail - ll)
    ls = torch.minimum(lsrc.clamp(min=0), lane_len.to(_I64)[lane])
    lit = lane_start.to(_I64)[lane] + ls
    out = recs.new_zeros((5, recs.shape[1]))
    out[:, :n] = torch.stack([p, ll, cl, csrc.clamp(min=1), lit]).to(_I32)
    return out, lane_out, total


def compact_records_dense(recs, counts, lane_start, lane_len):
    """The append-only compaction, counterpart of
    ``minlz_tpu.ops.exec_chain.compact_ops_dense``.  recs [7, n_slots] /
    counts [lanes]: the parse output.  Returns (out [4, n_slots] int32 with
    rows llen, clen, max(csrc, 1), lit; lane_out [lanes] int64; total [1]
    int64), in range order, under ``compact_records``' contract: columns
    [0, total) hold the records, those past it are unspecified.  No output
    position and no keep test: the executor's cursor only moves forward.
    llen and clen are clamped at 0 and the literal index into the lane's
    compressed bytes."""
    if recs.device.type == "cpu":
        return compact_records_dense_plain(recs, counts, lane_start,
                                           lane_len)
    args, total = _compact_args("compact_records_dense", recs, counts,
                                (lane_start, lane_len), (_I32,) * 3)
    out = torch.empty((4, recs.shape[1]), dtype=_I32, device=recs.device)
    launch_compact(COMPACT_DENSE, args, out)
    return out, args[4], total


def compact_records_dense_plain(recs, counts, lane_start, lane_len):
    """Plain torch version of ``compact_records_dense`` (any device): the
    same first total columns, zeros past them."""
    lane_out, total, n, lane, _, slot = _lane_ranks(recs, counts,
                                                    lane_start)
    clen, csrc, lsrc, llen = recs[2:6, slot].to(_I64)
    ls = torch.minimum(lsrc.clamp(min=0), lane_len.to(_I64)[lane])
    out = recs.new_zeros((4, recs.shape[1]))
    out[:, :n] = torch.stack([llen.clamp(min=0), clen.clamp(min=0),
                              csrc.clamp(min=1),
                              lane_start.to(_I64)[lane] + ls]).to(_I32)
    return out, lane_out, total


# --------------------------------------------------------------------------
# Execution: per-range record lists -> decoded bytes
# --------------------------------------------------------------------------

def range_firsts(lane_out, total, range_lane):
    """[R + 1] int64 record offsets of each range in the dense lists, from
    the first lane of every range (``range_lane`` [R + 1] int64).
    ``total``: the record total, the end of the last range; a [1] tensor
    as the compactions return it (nothing is read back) or an int."""
    end = total.reshape(1) if torch.is_tensor(total) else \
        lane_out.new_full((1,), total)
    return torch.cat([lane_out, end.to(lane_out)])[range_lane]


def check_spans(range_out, range_span, total_out: int):
    """Raise ValueError unless every range [range_out[r], range_out[r] +
    range_span[r]) lies within the output [0, total_out).  Tensors on any
    device; on the card two reductions come back to the host."""
    if range_span.numel() and (
            int(range_out.min()) < 0
            or int((range_out + range_span.to(_I64)).max()) > total_out):
        raise ValueError("a range lies outside the output")


def range_args(name, crec, rows, range_first, range_out, range_span, comp,
               total_out, spans_checked: bool = False):
    """The contiguous, checked arguments of a range executor's launch.
    ``spans_checked``: the ranges are a ``BatchPlan``'s, whose spans were
    checked on the host when it was made, so ``check_spans`` (two reads
    back from the card) is skipped."""
    dev = crec.device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if crec.dim() != 2 or crec.shape[0] != rows:
        raise ValueError(f"{name}: records must be [{rows}, n]")
    args = [t.contiguous() for t in (crec, range_first, range_out,
                                     range_span, comp)]
    for t, dt in zip(args, (_I32, _I64, _I64, _I32, torch.uint8)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: wrong dtype or device")
    if range_first.numel() != range_span.numel() + 1 \
            or range_out.numel() != range_span.numel():
        raise ValueError("range_first must have one entry per range + 1")
    if not spans_checked:
        check_spans(args[2], args[3], total_out)
    return args


def execute_ranges(crec, range_first, range_out, range_span, comp,
                   total_out: int, max_span: int = RANGE,
                   spans_checked: bool = False):
    """crec [5, n] int32 (pos, llen, clen, csrc, lit); range_first [R + 1]
    int64; range_out [R] int64; range_span [R] int32 (each <= max_span);
    comp [m] uint8.  Returns the decoded bytes, [total_out] uint8.  Range r
    reads records [range_first[r], range_first[r + 1]) only (clamped into
    [0, n]), so columns outside every range may hold anything.  On the
    card a range outside the output raises ValueError, unless
    ``spans_checked`` says the ranges are a ``BatchPlan``'s.  The
    ranges are expected to tile the output, as a plan's do: the kernels
    leave bytes outside every range unwritten (the plain versions give 0).
    Each range's records that hold any bytes are expected to move forward
    without overlapping, as compaction leaves them (a record of no bytes
    may stand anywhere): overlapping records have no last writer, in the
    kernel or in the plain version, and their bytes are unspecified."""
    if crec.device.type == "cpu":
        return execute_ranges_plain(crec, range_first, range_out,
                                    range_span, comp, total_out, max_span)
    args = range_args("execute_ranges", crec, 5, range_first, range_out,
                      range_span, comp, total_out, spans_checked)
    out = torch.empty(total_out, dtype=torch.uint8, device=crec.device)
    launch_execute(EXEC, args, max_span, out)
    return out


def launch_execute(kernel: str, args, max_span: int, out, scratch=None):
    """The bare launch of a range executor, ``EXEC`` or ``EXEC_SCHED``.
    args: what ``range_args`` returned (records, range_first, range_out,
    range_span, comp); ``out`` [total_out] uint8 is written in place;
    ``scratch``: for ``EXEC_SCHED``, what ``sched_scratch`` returned.  No
    check, no allocation, no read back; measurements time this."""
    lib = _build.load()
    common = (args[0].data_ptr(), ctypes.c_longlong(args[0].shape[1]),
              args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
              args[3].numel(), max_span, args[4].data_ptr(),
              ctypes.c_longlong(args[4].numel()), out.data_ptr())
    if kernel == EXEC:
        err = lib.minlz_exec_ranges(*common, _build.stream_of(args[0]))
    else:
        err = lib.minlz_exec_sched(*common, scratch.data_ptr(),
                                   _build.stream_of(args[0]))
    _build.check(lib, err)
    _build.count_launch(kernel)


def expand_bytes(crec, range_first, range_out, range_span, comp,
                 total_out: int, max_span: int = RANGE):
    """Every output byte as the executors see it before any copy is
    resolved.  Returns (val [total_out] uint8, ptr [total_out] int64, term
    [total_out] bool): a terminal byte has its value in ``val`` (a literal
    byte from comp, or 0 for a byte no record writes and for a copy from
    before the range start); any other byte takes the value of output byte
    ``ptr``, an earlier byte of its range.  Records are taken in order,
    with the kernel's clamps."""
    dev = crec.device
    n = crec.shape[1]
    R = range_span.numel()
    first = range_first[:-1].clamp(0, n)
    last = torch.maximum(range_first[1:].clamp(0, n), first)
    cnt = last - first
    nk = int(cnt.sum()) if R else 0
    rr = torch.repeat_interleave(torch.arange(R, device=dev), cnt,
                                 output_size=nk)
    k = first[rr] + torch.arange(nk, device=dev) - (torch.cumsum(cnt, 0)
                                                    - cnt)[rr]
    pos, llen, clen, csrc, lit = crec[:, k].to(_I64)
    S = range_span.to(_I64).clamp(0, max_span)[rr]
    p = torch.minimum(pos.clamp(min=0), S)
    llen = torch.minimum(llen.clamp(min=0), S - p)
    clen = torch.minimum(clen.clamp(min=0), S - p - llen)
    csrc = csrc.clamp(min=1)
    base = range_out[rr]

    L = llen + clen
    nb = int(L.sum()) if nk else 0
    rb = torch.repeat_interleave(torch.arange(nk, device=dev), L,
                                 output_size=nb)
    off = torch.arange(nb, device=dev) - (torch.cumsum(L, 0) - L)[rb]
    q = base[rb] + p[rb] + off
    is_lit = off < llen[rb]

    val = torch.zeros(total_out, dtype=torch.uint8, device=dev)
    term = torch.ones(total_out, dtype=torch.bool, device=dev)
    ptr = torch.arange(total_out, device=dev)
    ql = q[is_lit]
    if comp.numel():
        g = (lit[rb] + off)[is_lit].clamp(0, comp.numel() - 1)
        val[ql] = comp[g]
    cp = ~is_lit
    i = (off - llen[rb])[cp]
    c_csrc = csrc[rb][cp]
    s = (p + llen)[rb][cp] - c_csrc + torch.where(
        c_csrc < clen[rb][cp], i % c_csrc, i)
    qc = q[cp]
    inside = s >= 0
    ptr[qc[inside]] = base[rb][cp][inside] + s[inside]
    term[qc[inside]] = False
    return val, ptr, term


def execute_ranges_plain(crec, range_first, range_out, range_span, comp,
                         total_out: int, max_span: int = RANGE):
    """Plain torch version of ``execute_ranges`` by pointer jumping: every
    output byte is either terminal (a literal byte from comp, or 0) or
    points to an earlier byte of its range (``expand_bytes``); about
    log2(max_span) rounds of gathers over the whole output resolve every
    pointer.  It agrees with the kernel whenever each range's records that
    hold any bytes move forward without overlapping, which compaction
    guarantees (a record of no bytes may stand anywhere); on overlapping
    records neither has a last writer and the bytes are unspecified."""
    val, ptr, term = expand_bytes(crec, range_first, range_out, range_span,
                                  comp, total_out, max_span)
    for _ in range(64):
        if bool(term.all()):
            return val
        t_term = term[ptr]
        t_val = val[ptr]
        t_ptr = ptr[ptr]
        open_ = ~term
        val = torch.where(open_ & t_term, t_val, val)
        ptr = torch.where(open_ & ~t_term, t_ptr, ptr)
        term = term | t_term
    raise RuntimeError("pointer resolution did not converge")


def execute_scheduled(drec, range_first, range_out, range_span, comp,
                      total_out: int, max_span: int = RANGE,
                      spans_checked: bool = False):
    """The append-only executor, counterpart of
    ``minlz_tpu.ops.exec_chain.execute_scheduled`` in both of its arena
    layouts.  drec [4, n] int32 (llen, clen, csrc, lit) from
    ``compact_records_dense``; the other arguments as ``execute_ranges``,
    which reads the same columns.
    Per range a cursor starts at 0; each record places its literals at the
    cursor and then its copy, each clipped to the range span, and the
    cursor never passes the span.  A record belongs to one range at most
    (``scheduled_bounds``).  Returns [total_out] uint8.  On the card
    two launches: a scan of each range's lengths writes every record's
    position, then K3 places the positioned records."""
    if drec.device.type == "cpu":
        return execute_scheduled_plain(drec, range_first, range_out,
                                       range_span, comp, total_out, max_span)
    args = range_args("execute_scheduled", drec, 4, range_first, range_out,
                      range_span, comp, total_out, spans_checked)
    out = torch.empty(total_out, dtype=torch.uint8, device=drec.device)
    launch_execute(EXEC_SCHED, args, max_span, out, sched_scratch(args))
    return out


def sched_scratch(args):
    """The scratch of one ``EXEC_SCHED`` launch, uninitialised: int64, the
    ranges as taken (``scheduled_bounds``, R + 1 words), then each record's
    position as int32 (``scheduled_positions``)."""
    n, ranges = args[0].shape[1], args[3].numel()
    return torch.empty(ranges + 1 + (n + 1) // 2, dtype=_I64,
                       device=args[0].device)


def scheduled_bounds(range_first, n: int):
    """The ranges as the append-only executor takes them: range r is
    records [M[r], M[r + 1]) with M the running maximum of range_first
    clamped into [0, n], so a record belongs to one range at most; a range
    that goes backwards is empty and takes back no record of an earlier one.
    For a plan's non-decreasing range_first, M is range_first."""
    if range_first.numel() == 0:
        return range_first.to(_I64)
    return torch.cummax(range_first.to(_I64).clamp(0, n), 0).values


def scheduled_positions(drec, range_first, range_span,
                        max_span: int = RANGE):
    """What the append-only kernel's cursor scan writes: [n] int32, each
    record's position, the sum of the clamped lengths (max(llen, 0) +
    max(clen, 0)) before it in its range (``scheduled_bounds``), in int64,
    stopped at the range span.  Records outside every range (never read)
    get 0."""
    dev = drec.device
    n = drec.shape[1]
    R = range_span.numel()
    llen, clen = drec[:2].to(_I64)
    step = llen.clamp(min=0) + clen.clamp(min=0)
    before = torch.cat([step.new_zeros(1), torch.cumsum(step, 0)])
    bounds = scheduled_bounds(range_first, n)
    first, last = bounds[:-1], bounds[1:]
    cnt = last - first
    pos = torch.zeros(n, dtype=_I64, device=dev)
    rr = torch.repeat_interleave(torch.arange(R, device=dev), cnt)
    k = first[rr] + torch.arange(rr.numel(), device=dev) - (
        torch.cumsum(cnt, 0) - cnt)[rr]
    S = range_span.to(_I64).clamp(0, max_span)[rr]
    pos[k] = torch.minimum(before[k] - before[first[rr]], S)
    return pos.to(_I32)


def execute_scheduled_plain(drec, range_first, range_out, range_span, comp,
                            total_out: int, max_span: int = RANGE):
    """Plain torch version of ``execute_scheduled``, the kernel's two steps:
    ``scheduled_positions`` (where the kernel's cursor stops, it stops too),
    then ``execute_ranges_plain`` on the positioned records and the ranges
    as taken (``scheduled_bounds``)."""
    pos = scheduled_positions(drec, range_first, range_span, max_span)
    crec = torch.cat([pos[None], drec.to(_I32)])
    return execute_ranges_plain(
        crec, scheduled_bounds(range_first, drec.shape[1]), range_out,
        range_span, comp, total_out, max_span)


# --------------------------------------------------------------------------
# The JAX package's names of the range road's steps
# --------------------------------------------------------------------------
#
# The JAX functions of these names take and return the TPU arena's layout:
# per-row records [P, sub, 128], per-chain op lists of cap_chain slots in
# OP_T tiles, three packed words a record (512-byte arena rows, 14- and
# 17-bit fields), an int32 arena with a guard row.  None of that carries
# over (module docstring), so each name here is the port's step, on the
# port's layout: the same records unpacked, and the same decoded bytes.

compact_ops_fast = compact_records        # kernel 2, positioned records
compact_ops_dense = compact_records_dense  # kernel 6, append-only records
execute_fast = execute_ranges             # kernel 3, the range executor


# --------------------------------------------------------------------------
# Batched decode entry points
# --------------------------------------------------------------------------

EXECUTORS = ("fast", "scheduled")


def decode_planned(plan: BatchPlan, device="cuda", executor: str = "fast",
                   tensors: dict | None = None):
    """Run parse -> compact -> execute for a plan on ``device``; returns the
    batch's decoded bytes as a [plan.total_out] uint8 tensor there.
    ``tensors``: the plan's arrays already on the device
    (``plan.tensors(device)``), for a caller that decodes one plan many
    times; by default they are copied there now.  From those tensors to the
    result nothing is read back from the card: the record total stays
    there and the plan's ranges were checked when it was made."""
    if executor not in EXECUTORS:
        raise ValueError(f"executor must be one of {EXECUTORS}")
    if not 0 < plan.rng <= RANGE:
        raise ValueError(f"the range executors stage at most {RANGE} bytes "
                         f"and no whole block")
    with trace.span("decode.planned"):
        t = plan.tensors(device) if tensors is None else tensors
        with trace.span("decode.parse"):
            recs, counts = parse_planned(t["comp"], t["lane_start"],
                                         t["lane_len"])
        with trace.span("decode.compact"):
            if executor == "fast":
                crec, lane_out, total = compact_records(
                    recs, counts, t["lane_start"], t["lane_len"],
                    t["lane_lo"], t["lane_hi"])
                execute = execute_ranges
            else:
                crec, lane_out, total = compact_records_dense(
                    recs, counts, t["lane_start"], t["lane_len"])
                execute = execute_scheduled
        with trace.span("decode.range_firsts"):
            first = range_firsts(lane_out, total, t["range_lane"])
        with trace.span("decode.execute"):
            return execute(crec, first, t["range_out"], t["range_span"],
                           t["comp"], plan.total_out, plan.max_span,
                           spans_checked=True)


def trim_blocks(plan: BatchPlan, out, out_totals):
    """The batch's decoded tensor -> one bytes object per block, each
    trimmed to its ``out_totals`` entry."""
    host = out.cpu().numpy()
    return [host[o : o + min(n, want)].tobytes()
            for (o, n), want in zip(plan.block_out, out_totals)]


def decode_blocks_chained(blocks_segs, out_totals, seg: int,
                          rng: int = RANGE, device="cuda",
                          executor: str = "fast"):
    """Decode a batch of blocks whose parse hints guarantee that match
    sources stay within ``rng``-byte ranges (hints v2), in one dispatch.
    ``executor``: ``"fast"`` (positioned records) or ``"scheduled"``
    (append-only cursor), the counterpart of the TPU package's ``planar``
    argument and ``v2`` switch.  Host bytes in, host bytes out: a list of
    bytes objects, one per block, each trimmed to its ``out_totals``
    entry."""
    if not blocks_segs:
        return []
    with trace.span("decode.plan"):
        plan = plan_batch(blocks_segs, seg, rng)
    out = decode_planned(plan, device, executor)
    with trace.span("decode.trim"):
        return trim_blocks(plan, out, out_totals)


def decode_block_chained(seg_bytes_list, out_total: int, seg: int,
                         rng: int = RANGE, device="cuda",
                         executor: str = "fast"):
    """Decode one block (a batch of one)."""
    return decode_blocks_chained([seg_bytes_list], [out_total], seg, rng,
                                 device, executor)[0]
