"""Whole-block decode of hinted MinLZ blocks: the road without a range clamp.

The counterpart of ``minlz_tpu.ops.pallas_decode.decode_block_tpu`` (the
Pallas parse, ``compact_ops`` and ``execute_ops_pallas``).  A block whose
hints carry no usable range clamp (hint payload version 1, ``rng == 0``, or
a range the range executors of ``ops/exec_chain.py`` do not take) may copy
from any earlier byte of the block, so the whole block is one range:

1. parse (``ops/parse.py``, ``csrc/parse.cu``), as on the other road;
2. compact (``exec_chain.compact_records``, ``csrc/compact.cu``) with
   whole-block lane spans from ``plan_batch(..., rng=0)``: one dense record
   list per block, in output order, with block-local positions;
3. execute (``execute_blocks``, ``csrc/exec_block.cu``): every 128 KiB
   tile of every block is resolved at once in shared memory, as a range is
   on the other road; a copy byte that reads before its tile keeps its
   source index (a residual) and a fix-up pass follows the residuals
   through the finished tiles.  Three kernel launches a call.

A batch of blocks of any sizes decodes in one dispatch.  The TPU road's
limits (512 lanes, 4 KiB segments, 1-2 MiB) do not carry over: the limit is
the format's 8 MiB block.

Blocks without parse hints, as every other MinLZ writer leaves them, take
the same road from a plan derived on the device (``decode_unhinted``):
``derive.derive_plan`` cuts each body into lanes at token starts and gives
each lane its output span and incoming repeat offset, which the parse
takes as ``lane_rep``.

``execute_blocks`` launches its CUDA kernel for CUDA tensors and runs the
plain torch version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, trace
from .._device import resolve_device
from ..minlz import CorruptError
from . import derive
from .device_codec import MAX_BLOCK, SEG
from .exec_chain import (range_args, compact_records, execute_ranges_plain,
                         plan_batch, range_firsts, trim_blocks)
from .parse import parse_planned
from .parse_model import parse_segments_model

KERNEL = "exec_block"
TILE = 128 << 10    # csrc/resolve.cuh: kTile
TILES, FIXUP = 1, 2  # the phases of a launch


def execute_blocks(crec, block_first, block_out, block_span, comp,
                   total_out: int, spans_checked: bool = False):
    """crec [5, n] int32 (pos, llen, clen, csrc, lit) with block-local
    positions; block_first [B + 1] int64 record offsets; block_out [B] int64
    output offsets; block_span [B] int32; comp [m] uint8.  Returns the
    decoded bytes, [total_out] uint8.  Block b reads records
    [block_first[b], block_first[b + 1]) only (clamped into [0, n]).  On
    the card a block outside the output raises ValueError, unless
    ``spans_checked`` says the blocks are a ``BatchPlan``'s ranges.  The
    blocks are expected to tile the
    output, and each block's records that hold any bytes to move forward
    without overlapping, as compaction leaves them (a record of no bytes may
    stand anywhere): overlapping records have no last writer here or in the
    plain version, and their bytes are unspecified."""
    if crec.device.type == "cpu":
        return execute_blocks_plain(crec, block_first, block_out,
                                    block_span, comp, total_out)
    args = range_args("execute_blocks", crec, 5, block_first, block_out,
                      block_span, comp, total_out, spans_checked)
    out = torch.empty(total_out, dtype=torch.uint8, device=crec.device)
    launch_blocks(args, out, blocks_scratch(args, out))
    return out


def blocks_scratch(args, out):
    """The scratch of one ``launch_blocks`` call, uninitialised: int32, one
    word per output byte (after the tile phase -1 for a final byte, else the
    block-local source index of a residual), then two words per block and
    128 KiB tile of the output (the tile's window of records)."""
    tiles = -(-out.numel() // TILE)
    return torch.empty(out.numel() + 2 * args[3].numel() * tiles,
                       dtype=torch.int32, device=out.device)


def launch_blocks(args, out, scratch, phases: int = TILES | FIXUP):
    """The bare launch of the whole-block executor.  args: what
    ``range_args`` returned (records, block_first, block_out, block_span,
    comp); ``out`` [total_out] uint8 is written in place; ``scratch``: what
    ``blocks_scratch`` returned.  ``phases``: ``TILES`` runs the index and
    tile kernels, ``FIXUP`` the fix-up kernel on the scratch a tile phase
    left; both by default, on one stream.  No check, no allocation, no read
    back; measurements time this."""
    lib = _build.load()
    _build.check(lib, lib.minlz_exec_blocks(
        args[0].data_ptr(), ctypes.c_longlong(args[0].shape[1]),
        args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
        args[3].numel(), args[4].data_ptr(),
        ctypes.c_longlong(args[4].numel()), out.data_ptr(),
        ctypes.c_longlong(out.numel()), scratch.data_ptr(), phases,
        _build.stream_of(args[0])))
    if phases & TILES:
        _build.count_launch(KERNEL)


def execute_blocks_plain(crec, block_first, block_out, block_span, comp,
                         total_out: int):
    """Plain torch version of ``execute_blocks``: the pointer-jumping
    resolution of ``execute_ranges_plain`` with the largest block span as
    the range limit."""
    max_span = int(block_span.max()) if block_span.numel() else 0
    return execute_ranges_plain(crec, block_first, block_out, block_span,
                                comp, total_out, max(max_span, 0))


def decode_planned_whole(plan, device="cuda", tensors: dict | None = None):
    """Run parse -> compact -> execute for a whole-block plan
    (``plan_batch(..., rng=0)``) on ``device``; returns the batch's decoded
    bytes as a [plan.total_out] uint8 tensor there.  ``tensors`` as for
    ``exec_chain.decode_planned``; as there, nothing is read back from the
    card on the way from them to the result."""
    if plan.rng:
        raise ValueError("not a whole-block plan")
    t = plan.tensors(device) if tensors is None else tensors
    return _decode_whole(t, plan.total_out)


def _decode_whole(t, total_out: int):
    """parse -> compact -> execute on whole-block plan tensors ``t``, each
    lane from its ``t["lane_rep"]`` where the plan has one; the batch's
    [total_out] uint8 output."""
    recs, counts = _parse_lanes(t)
    crec, lane_out, total = compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    first = range_firsts(lane_out, total, t["range_lane"])
    return execute_blocks(crec, first, t["range_out"], t["range_span"],
                          t["comp"], total_out, spans_checked=True)


def _parse_lanes(t):
    """K1 on a plan's lanes.  A derived plan's lanes (``lane_rep``) take,
    on CPU tensors, the token-level statement of K1
    (``parse_model.parse_segments_model``): one step a token of the longest
    lane, where the plain version steps a byte, and a derived lane is about
    ``seg`` bytes however its block was written."""
    rep = t.get("lane_rep")
    if rep is not None and t["comp"].device.type == "cpu":
        recs, counts, _ = parse_segments_model(
            t["comp"], t["lane_start"], t["lane_len"], lane_rep=rep)
        return recs, counts
    return parse_planned(t["comp"], t["lane_start"], t["lane_len"], rep)


def decode_blocks_whole(blocks_segs, out_totals, seg: int, device="cuda"):
    """Decode a batch of hinted blocks whose copies may reach any earlier
    byte of their block, in one dispatch.  blocks_segs: per block, the list
    of its segments' compressed bytes.  Host bytes in, host bytes out: one
    bytes object per block, trimmed to its ``out_totals`` entry."""
    if not blocks_segs:
        return []
    plan = plan_batch(blocks_segs, seg, 0)
    return trim_blocks(plan, decode_planned_whole(plan, device), out_totals)


def decode_block_whole(seg_bytes_list, out_total: int, seg: int,
                       device="cuda"):
    """Decode one block (a batch of one)."""
    return decode_blocks_whole([seg_bytes_list], [out_total], seg,
                               device)[0]


def decode_unhinted(comp, body_off, out_len, total_out: int,
                    seg: int = SEG):
    """Decode a batch of unhinted blocks whose bodies are on the device:
    derive (``derive.derive_plan``) -> parse -> compact -> execute, one
    range per block.  Arguments as ``derive_plan``'s.  Returns (out
    [total_out] uint8, bad [1] int32), both on comp's device: the decoded
    blocks back to back, and the derivation's verdict, 0 where the batch is
    sound (``derive.check`` reads it; where it is not, out is unspecified).
    Nothing is read back from the device, and nothing derived is kept."""
    with trace.span("decode.unhinted"):
        trace.count("decode.unhinted_blocks", out_len.numel())
        with trace.span("decode.derive", comp.device):
            t = derive.derive_plan(comp, body_off, out_len, total_out, seg)
        trace.count("decode.derived_lanes", t["lane_len"].numel())
        return _decode_whole(t, total_out), t["bad"]


def decode_blocks_unhinted(bodies, out_totals, seg: int = SEG,
                           device="cuda"):
    """Decode a batch of blocks without parse hints in one dispatch.
    bodies: each block's bytes after its uvarint; out_totals: each one's
    decoded length (the uvarint).  Host bytes in, host bytes out: one bytes
    object per block.  Raises CorruptError where a block is unsound
    (``derive.check``)."""
    if not bodies:
        return []
    wants = [int(w) for w in out_totals]
    if len(wants) != len(bodies) or not all(
            0 < w <= MAX_BLOCK for w in wants):
        raise CorruptError(f"unhinted block: a decoded length outside "
                           f"1..{MAX_BLOCK}")
    dev = resolve_device(device)
    lens = np.array([len(b) for b in bodies], np.int64)
    body_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    comp = np.frombuffer(b"".join(bytes(b) for b in bodies) or b"\x00",
                         np.uint8)
    out, bad = decode_unhinted(
        torch.from_numpy(comp.copy()).to(dev),
        torch.from_numpy(body_off).to(dev),
        torch.tensor(wants, dtype=torch.int32).to(dev), sum(wants), seg)
    host = out.cpu().numpy()
    derive.check(bad)
    ends = np.cumsum(wants)
    return [host[e - w:e].tobytes() for e, w in zip(ends, wants)]
