"""The lane plan of unhinted MinLZ blocks, derived on the device.

A MinLZ block as the format's own writers leave it carries no parse hints
(chunk 0x88 is this package's): nothing says where a token starts but the
token before it.  ``derive_plan`` takes a batch of such blocks whose bodies
(the bytes after each block's uvarint) are already on the device, and cuts
every body into lanes at token starts, lane k of a block at the first token
start at or after ``k * seg`` compressed bytes.  It gives each lane its
output span in its block, by a scan of the tokens' output lengths, and its
incoming repeat offset, the offset of the last token before the lane that
sets one (1, the format's initial value, where none does).  The result is
the whole-block plan that ``exec_block``'s road decodes (parse with
``lane_rep``, compact, ``execute_blocks``): lanes, one range per block.

``derive_plan`` launches ``csrc/derive.cu`` (three kernels: the block
table, a table per window of ``seg`` bytes by pointer jumping, one chain
step a window) for CUDA tensors and runs ``derive_plan_plain``, the same
algorithm in torch ops, for CPU tensors.  Nothing is read back to the host:
sizes the format does not allow, a chain that runs past its body or stops
short of it, and tokens that decode to another length than the block says
set bits in the plan's ``bad`` tensor, which a caller reads with the
output (``check``); the lanes stay inside comp and inside their block's
span whatever the bytes, so the kernels after the derivation cannot fault.
``oracle/derive.py`` states the lanes by the sequential token walk.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..minlz import CorruptError
from .device_codec import MAX_BLOCK, SEG
from .parse_model import HALO, decode

KERNEL = "derive"
MAX_SEG = 4096          # csrc/derive.cu: kMaxSeg, the kernel's window
SAT = MAX_BLOCK + 1     # output bytes along a chain, saturated
INT_MAX = (1 << 31) - 1
CHUNK = 1 << 18         # offsets the plain version decodes at once
# Bits of the plan's ``bad``.
BAD_TABLE = 1   # body offsets outside comp or decreasing
BAD_SIZE = 2    # a decoded length outside 1..8 MiB or below its body's
                # length, or lengths that do not add up to the output
BAD_CHAIN = 4   # a body whose tokens do not end exactly at its end, or do
                # not decode to its block's length
LANES = ("lane_start", "lane_len", "lane_lo", "lane_hi", "lane_rep")
RANGES = ("range_lane", "range_out", "range_span")

_I32 = torch.int32
_I64 = torch.int64


def lanes_bound(n_comp: int, n_blocks: int, seg: int) -> int:
    """The plan's lane count: ceil(n_comp / seg) + n_blocks, at least the
    sum of every block's ceil(n / seg), known from the shapes alone."""
    return -(-n_comp // seg) + n_blocks


def _check(comp, body_off, out_len, total_out: int, seg: int):
    if comp.dtype != torch.uint8 or comp.dim() != 1:
        raise ValueError("comp must be a 1-D uint8 tensor")
    if body_off.dtype != _I64 or body_off.dim() != 1:
        raise ValueError("body_off must be a 1-D int64 tensor")
    if out_len.dtype != _I32 or out_len.dim() != 1:
        raise ValueError("out_len must be a 1-D int32 tensor")
    if body_off.numel() != out_len.numel() + 1:
        raise ValueError("body_off must have one entry per block + 1")
    if out_len.numel() == 0:
        raise ValueError("no blocks to plan")
    for name, t in (("body_off", body_off), ("out_len", out_len)):
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on "
                             f"{comp.device}")
    if seg <= 0:
        raise ValueError("segment must be positive")
    if comp.numel() >= INT_MAX or not 0 <= total_out < 1 << 31:
        raise ValueError("a derived plan holds less than 2 GiB")


def derive_plan(comp, body_off, out_len, total_out: int, seg: int = SEG):
    """The whole-block plan of a batch of unhinted blocks, on comp's
    device.  comp: [n] uint8, the bodies; body_off: [B + 1] int64, body b is
    comp[body_off[b], body_off[b + 1]); out_len: [B] int32, each block's
    decoded length (its uvarint); total_out: their sum, a host int (the
    output's size); seg: the lane cut in compressed bytes (at most
    ``MAX_SEG`` on the card).  Returns a dict of device tensors: ``comp``;
    ``lane_start``, ``lane_len``, ``lane_lo``, ``lane_hi`` (block-local
    output spans), ``lane_rep`` (incoming repeat offsets), [L] int32 each
    with L = ``lanes_bound(n, B, seg)``, block b's lanes
    [range_lane[b], range_lane[b + 1]) and empty ones past the last
    block's; ``range_lane`` [B + 1] int64, ``range_out`` [B] int64,
    ``range_span`` [B] int32; ``bad`` [1] int32, 0 for a sound batch."""
    _check(comp, body_off, out_len, total_out, seg)
    dev = comp.device
    if dev.type == "cpu":
        return derive_plan_plain(comp, body_off, out_len, total_out, seg)
    if dev.type != "cuda":
        raise ValueError(f"no derivation kernel for device {dev}")
    if seg > MAX_SEG:
        raise ValueError(f"the derivation kernel cuts lanes of at most "
                         f"{MAX_SEG} bytes")
    plan = empty_plan(comp, out_len.numel(), seg)
    launch_derive(plan, body_off.contiguous(), out_len.contiguous(),
                  total_out, seg, derive_scratch(comp, out_len.numel()))
    return plan


def empty_plan(comp, n_blocks: int, seg: int) -> dict:
    """The plan's tensors, uninitialised: the derivation writes all of
    them."""
    dev = comp.device
    lanes = lanes_bound(comp.numel(), n_blocks, seg)
    plan = {"comp": comp.contiguous()}
    for k in LANES:
        plan[k] = torch.empty(lanes, dtype=_I32, device=dev)
    plan["range_lane"] = torch.empty(n_blocks + 1, dtype=_I64, device=dev)
    plan["range_out"] = torch.empty(n_blocks, dtype=_I64, device=dev)
    plan["range_span"] = torch.empty(n_blocks, dtype=_I32, device=dev)
    plan["bad"] = torch.empty(1, dtype=_I32, device=dev)
    return plan


def derive_scratch(comp, n_blocks: int):
    """The scratch of one ``launch_derive`` call, uninitialised: the clamped
    body offsets (int64 [B + 1]) and, per compressed byte, the chain's exit,
    output bytes and offset set (int32 [3 * n])."""
    return (torch.empty(n_blocks + 1, dtype=_I64, device=comp.device),
            torch.empty(max(3 * comp.numel(), 1), dtype=_I32,
                        device=comp.device))


def launch_derive(plan, body_off, out_len, total_out: int, seg: int,
                  scratch):
    """The bare launch of the derivation: ``empty_plan``'s tensors written
    in place from checked, contiguous CUDA ``body_off`` and ``out_len``;
    ``scratch``: what ``derive_scratch`` returned.  No check, no
    allocation, no read back; measurements time this."""
    lib = _build.load()
    comp = plan["comp"]
    boff, tab = scratch
    _build.check(lib, lib.minlz_derive(
        comp.data_ptr(), ctypes.c_longlong(comp.numel()),
        body_off.data_ptr(), out_len.data_ptr(), out_len.numel(),
        ctypes.c_longlong(total_out), seg, plan["lane_len"].numel(),
        *(plan[k].data_ptr() for k in LANES + RANGES + ("bad",)),
        boff.data_ptr(), tab.data_ptr(), _build.stream_of(comp)))
    _build.count_launch(KERNEL)


def check(bad) -> None:
    """Raise CorruptError where a plan's ``bad`` says the derivation found
    its batch unsound.  Reads ``bad`` back from the device."""
    bad = int(bad)
    if bad:
        why = [w for bit, w in ((BAD_TABLE, "body offsets outside comp"),
                                (BAD_SIZE, "a block's sizes"),
                                (BAD_CHAIN, "a token chain")) if bad & bit]
        raise CorruptError(f"unhinted block: {', '.join(why)} "
                           f"out of the format's bounds")


def derive_plan_plain(comp, body_off, out_len, total_out: int,
                      seg: int = SEG):
    """Plain torch version of ``derive_plan`` (any device), the kernels'
    steps in torch ops: the block table, every window's table by pointer
    jumping over all offsets at once, then the chain a window a step,
    across the blocks at once."""
    _check(comp, body_off, out_len, total_out, seg)
    dev = comp.device
    N, B = comp.numel(), out_len.numel()
    L = lanes_bound(N, B, seg)
    bad = torch.zeros(1, dtype=_I32, device=dev)

    # 1. The block table.
    off = body_off.to(_I64)
    boff = torch.cummax(off.clamp(0, N), 0).values
    bad |= BAD_TABLE * (boff != off).any().to(_I32)
    n = boff[1:] - boff[:-1]
    cnt = (n + seg - 1) // seg
    want = out_len.to(_I64)
    span = want.clamp(0, MAX_BLOCK)
    bad |= BAD_SIZE * ((want < 1) | (want > MAX_BLOCK) | (n > want)).any(
    ).to(_I32)
    bad |= BAD_SIZE * (span.sum() != total_out).to(_I32)
    range_lane = torch.cat([n.new_zeros(1), torch.cumsum(cnt, 0)])
    range_out = (torch.cumsum(span, 0) - span).clamp(max=total_out)
    range_span = torch.minimum(span, total_out - range_out)

    # 2. Every window's table: from each offset, where its chain leaves
    #    the window, the output bytes on the way and the last offset set.
    total = int(boff[-1] - boff[0])
    blk = torch.repeat_interleave(torch.arange(B, device=dev), n,
                                  output_size=total)
    i = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[blk]
    nb = n[blk]
    we = torch.minimum((i // seg + 1) * seg, nb)
    to, w, rep = (torch.empty(total, dtype=_I64, device=dev)
                  for _ in range(3))
    src = comp if N else comp.new_zeros(1)
    for a in range(0, total, CHUNK):
        z = slice(a, a + CHUNK)
        at = i[z, None] + torch.arange(HALO, device=dev)
        g = (boff[blk[z]][:, None] + at).clamp(0, max(N - 1, 0))
        t = decode(torch.where(at < nb[z, None], src[g].to(_I64), 0), i[z],
                   nb[z])
        to[z] = t["nxt"].clamp(max=INT_MAX)
        w[z] = t["w"].clamp(max=SAT)
        rep[z] = torch.where(t["sets"], t["off"], 0)
    first = (boff[:-1] - boff[0])[blk]  # each offset's body, in the arrays
    open_ = to < we
    while bool(open_.any()):
        q = (first + to)[open_]
        to_q, w_q, rep_q = to[q], w[q], rep[q]
        w[open_] = (w[open_] + w_q).clamp(max=SAT)
        rep[open_] = torch.where(rep_q != 0, rep_q, rep[open_])
        to[open_] = to_q
        open_ = to < we

    # 3. The chain, one window a step, every block at once.
    lanes = {k: torch.zeros(L, dtype=_I64, device=dev) for k in LANES}
    lanes["lane_start"][:] = boff[-1]
    lanes["lane_rep"][:] = 1
    e = torch.zeros(B, dtype=_I64, device=dev)
    out = torch.zeros(B, dtype=_I64, device=dev)
    crep = torch.ones(B, dtype=_I64, device=dev)
    sat = torch.zeros(B, dtype=torch.bool, device=dev)
    prev_s = torch.zeros(B, dtype=_I64, device=dev)
    body0 = boff[:-1] - boff[0]
    for k in range(int(cnt.max())):
        act = k < cnt
        lane = (range_lane[:-1] + k)[act]
        s = torch.minimum(e, n)
        lo = torch.minimum(out, span)
        if k:
            lanes["lane_len"][lane - 1] = (s - prev_s)[act]
            lanes["lane_hi"][lane - 1] = lo[act]
        lanes["lane_start"][lane] = (boff[:-1] + s)[act]
        lanes["lane_lo"][lane] = lo[act]
        lanes["lane_rep"][lane] = crep[act]
        prev_s = torch.where(act, s, prev_s)
        step = act & (e < (k + 1) * seg) & (e < n)
        gi = (body0 + e)[step]
        w_g, rep_g = w[gi], rep[gi]
        e[step] = to[gi]
        out[step] += w_g
        sat[step] |= w_g >= SAT
        crep[step] = torch.where(rep_g != 0, rep_g, crep[step])
    last = (range_lane[1:] - 1)[cnt > 0]
    lanes["lane_len"][last] = (n - prev_s)[cnt > 0]
    lanes["lane_hi"][last] = torch.minimum(out, span)[cnt > 0]
    bad |= BAD_CHAIN * ((e != n) | (out != want) | sat).any().to(_I32)

    plan = {"comp": comp}
    plan.update({k: v.to(_I32) for k, v in lanes.items()})
    plan.update({"range_lane": range_lane, "range_out": range_out,
                 "range_span": range_span.to(_I32), "bad": bad})
    return plan
