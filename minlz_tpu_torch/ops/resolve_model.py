"""Plain torch model of the tiled resolution of ``csrc/resolve.cuh``.

The positioned executors (``csrc/exec_range.cu``'s K3 and
``csrc/exec_block.cu``) do not resolve a range's or block's copy chains over
the whole output at once, as ``exec_chain.execute_ranges_plain`` does, but
tile by tile: a tile of at most ``tile`` bytes is resolved in sub-tiles of
``sub`` bytes, in output order.  Within a sub-tile a copy byte that reads an
earlier sub-tile of its tile takes that byte's finished state, a byte that
reads its own sub-tile is a pointer, and the pointers are resolved by
doubling rounds.  On the whole-block road a copy byte that reads before its
tile (but inside its block) is a *residual*: it keeps its block-local source
index, every byte whose chain ends at it inherits that index, and a fix-up
pass follows the indices through the finished tiles.

This module states that algorithm in torch ops, with the tile and sub-tile
sizes as arguments, so that small inputs cross many tiles.  The tests hold
it equal to the plain versions and to the host referee, and the card run
reads its counts (rounds, residual bytes, hops) beside the kernels' times.
Nothing on a decode path calls it.
"""

from __future__ import annotations

import torch

from .device_codec import RANGE
from .exec_block import TILE
from .exec_chain import expand_bytes

SUB = 32 << 10     # csrc/resolve.cuh: kSub
_I64 = torch.int64


def execute_tiled(crec, first, out_off, span, comp, total_out: int,
                  max_span: int, tile: int, sub: int):
    """The arguments of ``execute_ranges_plain``, then the tile and sub-tile
    sizes.  Returns (out [total_out] uint8, info): ``info["rounds"]`` is the
    largest number of doubling rounds any sub-tile step took (all tiles take
    a step together, as the grid does), ``info["round_sum"]`` the sum over
    the steps, ``info["residual"]`` the number of residual bytes after the
    tile phase, ``info["hops"]`` the longest walk of the fix-up."""
    if tile <= 0 or sub <= 0:
        raise ValueError("tile and sub-tile sizes must be positive")
    val, ptr, term = expand_bytes(crec, first, out_off, span, comp,
                                  total_out, max_span)
    dev = val.device
    S = span.to(_I64).clamp(0, max_span)
    nb = int(S.sum()) if S.numel() else 0
    rr = torch.repeat_interleave(torch.arange(S.numel(), device=dev), S,
                                 output_size=nb)
    local = torch.arange(nb, device=dev) - (torch.cumsum(S, 0) - S)[rr]
    g = out_off[rr] + local
    loc = torch.zeros(total_out, dtype=_I64, device=dev)
    base = torch.zeros(total_out, dtype=_I64, device=dev)
    loc[g] = local
    base[g] = out_off[rr]
    tile_id = loc // tile
    sub_id = (loc % tile) // sub
    res = torch.full((total_out,), -1, dtype=_I64, device=dev)
    info = {"rounds": 0, "round_sum": 0, "residual": 0, "hops": 0}

    for step in range(-(-min(tile, max(max_span, 1)) // sub)):
        idx = torch.nonzero((sub_id == step) & ~term).flatten()
        src = ptr[idx]
        # A source before the tile: a residual, by its block-local index.
        before = tile_id[src] < tile_id[idx]
        res[idx[before]] = loc[src[before]]
        # A source in an earlier sub-tile of the tile is finished: take its
        # residual if it has one, else its value.
        done = ~before & (sub_id[src] < step)
        res[idx[done]] = res[src[done]]
        val[idx[done]] = val[src[done]]
        term[idx[before | done]] = True
        idx = idx[~(before | done)]
        rounds = 0
        while idx.numel():
            rounds += 1
            src = ptr[idx]
            hit = term[src]
            val[idx] = torch.where(hit, val[src], val[idx])
            res[idx] = torch.where(hit, res[src], res[idx])
            ptr[idx] = torch.where(hit, src, ptr[src])
            term[idx] = hit
            idx = idx[~hit]
        info["rounds"] = max(info["rounds"], rounds)
        info["round_sum"] += rounds
    if not bool(term.all()):
        raise RuntimeError("the tiled resolution left open bytes")

    idx = torch.nonzero(res >= 0).flatten()
    info["residual"] = idx.numel()
    at = base[idx] + res[idx]
    while idx.numel() and bool((res[at] >= 0).any()):
        info["hops"] += 1
        at = torch.where(res[at] >= 0, base[idx] + res[at], at)
    val[idx] = val[at]
    info["hops"] += bool(idx.numel())
    return val, info


def execute_ranges_tiled(crec, range_first, range_out, range_span, comp,
                         total_out: int, max_span: int = RANGE,
                         sub: int = SUB):
    """The range road as K3 resolves it: one tile per range, sub-tiles of
    ``sub`` bytes.  Returns (out, info); no byte is a residual."""
    return execute_tiled(crec, range_first, range_out, range_span, comp,
                         total_out, max_span, max(max_span, 1), sub)


def execute_blocks_tiled(crec, block_first, block_out, block_span, comp,
                         total_out: int, tile: int = TILE, sub: int = SUB):
    """The whole-block road as the tile phase and the fix-up resolve it:
    tiles of ``tile`` bytes, sub-tiles of ``sub`` bytes, residuals across
    tiles.  Returns (out, info)."""
    max_span = int(block_span.max()) if block_span.numel() else 0
    return execute_tiled(crec, block_first, block_out, block_span, comp,
                         total_out, max(max_span, 0), tile, sub)
