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

``execute_blocks`` launches its CUDA kernel for CUDA tensors and runs the
plain torch version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .exec_chain import (range_args, compact_records, execute_ranges_plain,
                         plan_batch, range_firsts, trim_blocks)
from .parse import parse_planned

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
    recs, counts = parse_planned(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = compact_records(
        recs, counts, t["lane_start"], t["lane_len"], t["lane_lo"],
        t["lane_hi"])
    first = range_firsts(lane_out, total, t["range_lane"])
    return execute_blocks(crec, first, t["range_out"], t["range_span"],
                          t["comp"], plan.total_out, spans_checked=True)


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
