"""Segment-parallel MinLZ parse: compressed lanes -> per-lane record lists.

The counterpart of ``minlz_tpu.ops.pallas_decode.parse_segments_pallas``.
The TPU version returns one record row per compressed byte row; here each
lane's records are dense: record k of lane l sits in slot
``lane_start[l] + l + k`` of seven int32 field arrays (kind, dst, clen, csrc,
lsrc, llen, lacc), and ``counts[l]`` says how many there are.  A lane emits
at most len + 1 records (one per byte row plus its flush row), so that slot
layout always has room.  Unused slots hold zeros.  The records are the
non-zero rows (kind > 0) of the TPU parse, in row order.

Every lane starts at a token with the repeat offset 1, the format's
initial value, as a hinted segment does; ``lane_rep`` ([lanes] int32, the
offset each lane enters with) serves lanes cut out of a block at token
starts where the hints do not say so (``ops/derive.py``).

``parse_segments`` launches the CUDA kernel ``csrc/parse.cu`` for CUDA
tensors and runs ``parse_segments_plain`` for CPU tensors;
``parse_planned`` does the same without the checks that read back from the
device.  The kernel's algorithm (token table, chain, scans) is stated in
torch in ``ops/parse_model.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .transducer import LIT, init_state, parse_step

N_FIELDS = 7
KERNEL = "parse"


def _check(comp, lane_start, lane_len, lane_rep=None):
    """Types, shapes and devices: no read back from the device."""
    if comp.dtype != torch.uint8 or comp.dim() != 1:
        raise ValueError("comp must be a 1-D uint8 tensor")
    lanes = [("lane_start", lane_start), ("lane_len", lane_len)]
    if lane_rep is not None:
        lanes.append(("lane_rep", lane_rep))
        if lane_rep.shape != lane_len.shape:
            raise ValueError("lane_rep and lane_len differ in shape")
    for name, t in lanes:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")
    if lane_start.shape != lane_len.shape:
        raise ValueError("lane_start and lane_len differ in shape")


def _check_tiling(comp, lane_start, lane_len):
    """The kernel reads comp[lane_start + row] and writes its records to
    the lane's own slots, so the lanes must tile comp exactly.  Three reads
    back from the device."""
    lens = lane_len.to(torch.int64)
    if lens.numel() and (bool((lens < 0).any()) or not torch.equal(
            lane_start.to(torch.int64), torch.cumsum(lens, 0) - lens)
            or int(lens.sum()) > comp.numel()):
        raise ValueError("lane_start must be the exclusive prefix sum of "
                         "lane_len, within comp")


def n_slots(comp_len: int, lanes: int) -> int:
    """Slot count of the dense record layout: len + 1 slots per lane."""
    return comp_len + lanes


def parse_segments(comp, lane_start, lane_len, lane_rep=None):
    """Parse every lane.  comp: [n] uint8, the lanes' compressed bytes back
    to back; lane_len: [lanes] int32; lane_start: [lanes] int32, the
    exclusive prefix sum of lane_len; lane_rep: None (1 in every lane) or
    [lanes] int32, each lane's incoming repeat offset.  Returns (recs [7,
    n + lanes] int32, counts [lanes] int32)."""
    _check(comp, lane_start, lane_len, lane_rep)
    _check_tiling(comp, lane_start, lane_len)
    return _parse(comp, lane_start, lane_len, lane_rep)


def parse_planned(comp, lane_start, lane_len, lane_rep=None):
    """``parse_segments`` on lane arrays that are in order and disjoint
    inside comp by construction, as ``exec_chain.plan_batch``'s and
    ``derive.derive_plan``'s are: nothing is checked that would read back
    from the device."""
    _check(comp, lane_start, lane_len, lane_rep)
    return _parse(comp, lane_start, lane_len, lane_rep)


def _parse(comp, lane_start, lane_len, lane_rep=None):
    if comp.device.type == "cpu":
        return parse_segments_plain(comp, lane_start, lane_len, lane_rep)
    if comp.device.type != "cuda":
        raise ValueError(f"no parse kernel for device {comp.device}")
    lanes = lane_len.numel()
    slots = n_slots(comp.numel(), lanes)
    # The kernel writes every slot, those past the lanes in its last block.
    alloc = torch.empty if lanes else torch.zeros
    recs = alloc((N_FIELDS, slots), dtype=torch.int32, device=comp.device)
    counts = torch.empty(lanes, dtype=torch.int32, device=comp.device)
    launch_parse(comp.contiguous(), lane_start.contiguous(),
                 lane_len.contiguous(), recs, counts,
                 None if lane_rep is None else lane_rep.contiguous())
    return recs, counts


def launch_parse(comp, lane_start, lane_len, recs, counts, lane_rep=None):
    """The bare launch of the parse kernel: checked, contiguous CUDA
    tensors in, ``recs`` [7, n + lanes] and ``counts`` [lanes] written in
    place, every slot of every lane (unused ones with zeros).  No check, no
    allocation, no read back; measurements time this."""
    lib = _build.load()
    _build.check(lib, lib.minlz_parse(
        comp.data_ptr(), ctypes.c_longlong(comp.numel()),
        lane_start.data_ptr(), lane_len.data_ptr(),
        None if lane_rep is None else lane_rep.data_ptr(), lane_len.numel(),
        recs.data_ptr(), ctypes.c_longlong(recs.shape[1]), counts.data_ptr(),
        _build.stream_of(comp)))
    _build.count_launch(KERNEL)


def parse_segments_plain(comp, lane_start, lane_len, lane_rep=None):
    """Plain torch version (any device): a row loop of
    ``transducer.parse_step`` vectorised over lanes, then a lane-major
    gather of the rows with kind > 0 into the dense slot layout."""
    _check(comp, lane_start, lane_len, lane_rep)
    _check_tiling(comp, lane_start, lane_len)
    dev = comp.device
    lanes = lane_len.numel()
    slots = n_slots(comp.numel(), lanes)
    recs = torch.zeros((N_FIELDS, slots), dtype=torch.int32, device=dev)
    if lanes == 0:
        return recs, torch.zeros(0, dtype=torch.int32, device=dev)
    lens = lane_len.to(torch.int32)
    start = lane_start.to(torch.int64)
    last = max(comp.numel() - 1, 0)
    src = comp if comp.numel() else comp.new_zeros(1)

    # Each lane keeps its own row cursor, so a lane can jump over the inner
    # bytes of a literal run: those rows emit nothing and only advance
    # lit_left/lit_pos (once lit_pos >= 4, lit_acc is complete).  Every
    # other row goes through parse_step exactly as in lockstep.
    row = torch.zeros(lanes, dtype=torch.int32, device=dev)
    st = init_state(lanes, dev)
    if lane_rep is not None:
        st["rep"] = lane_rep.to(device=dev, dtype=torch.int32).clone()
    emits = [[] for _ in range(N_FIELDS)]
    while bool((row <= lens).any()):
        active = row < lens
        byte = torch.where(
            active, src[(start + row).clamp(max=last)].to(torch.int32), 0)
        st, e = parse_step(st, byte, active, row, row == lens)
        for f in range(N_FIELDS):
            emits[f].append(e[f])
        row = row + 1
        skip = torch.where(
            active & (st["mode"] == LIT) & (st["lit_pos"] >= 4),
            torch.minimum(st["lit_left"] - 1, lens - row), 0).clamp(min=0)
        st["lit_left"] = st["lit_left"] - skip
        st["lit_pos"] = st["lit_pos"] + skip
        row = row + skip
    fields = torch.stack([torch.stack(e, dim=1) for e in emits])  # [7,L,R]

    sel = fields[0] > 0
    counts = sel.sum(dim=1, dtype=torch.int32)
    lane_of, row_of = sel.nonzero(as_tuple=True)  # lane-major, rows ascending
    first = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    rank = torch.arange(lane_of.numel(), device=dev) - first[lane_of]
    slot = lane_start.to(torch.int64)[lane_of] + lane_of + rank
    recs[:, slot] = fields[:, lane_of, row_of]
    return recs, counts
