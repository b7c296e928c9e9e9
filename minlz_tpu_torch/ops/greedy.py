"""Greedy token selection of the encoder over per-segment lanes.

The counterpart of ``minlz_tpu.ops.pallas_encode`` and of ``greedy_parse``
/ ``greedy_parse_compact`` in ``minlz_tpu.ops.encode_kernel``.  Arrays are
``[B, seg]`` int32, lane-major: row = one segment, in position order.  Per
lane, with ``skip = 0`` and ``rep = -1``, at each position ``r`` in order::

    take   = (skip == 0) & (len[r] >= 4)
    is_rep = take & (off[r] == rep)
    skip   = len[r] - 1 if take else max(skip - 1, 0)
    rep    = off[r] if take else rep

``greedy_parse`` launches the CUDA kernel ``csrc/greedy.cu`` for CUDA
tensors and runs ``greedy_parse_plain`` for CPU tensors.  ``off`` and
``length`` are proposals and may hold any int32.  The kernel's algorithm
(windows staged in shared memory, a next-candidate table, a token chain) is
stated in torch in ``ops/greedy_model.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .device_codec import SEG

KERNEL = "greedy"


def _check(off, length, seg: int):
    for name, t in (("off", off), ("length", length)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a [B, seg] int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if off.shape != length.shape or off.shape[1] != seg:
        raise ValueError(
            f"off {tuple(off.shape)} and length {tuple(length.shape)} must "
            f"both be [B, {seg}]")
    if off.device != length.device:
        raise ValueError(f"off is on {off.device}, length on {length.device}")


def greedy_parse(off, length, seg: int = SEG):
    """Greedy token selection.  off, length: [B, seg] int32.  Returns
    (take, tok_off, tok_len, is_rep), each [B, seg] int32: a token starts,
    its offset and length (0 elsewhere), and whether its offset equals the
    lane's previous token's."""
    _check(off, length, seg)
    if off.device.type == "cpu":
        return greedy_parse_plain(off, length, seg)
    if off.device.type != "cuda":
        raise ValueError(f"no greedy kernel for device {off.device}")
    out = torch.empty((4, off.shape[0], seg), dtype=torch.int32,
                      device=off.device)
    with torch.cuda.device(off.device):
        launch_greedy(off, length, seg, out)
    return out[0], out[1], out[2], out[3]


def launch_greedy(off, length, seg: int, out):
    """The bare launch of the greedy kernel: checked, contiguous CUDA
    tensors in, ``out`` [4, B, seg] int32 (take, tok_off, tok_len, is_rep)
    written in place, every element (any contents before).  No check, no
    allocation; measurements time this."""
    lib = _build.load()
    _build.check(lib, lib.minlz_greedy(
        off.data_ptr(), length.data_ptr(), off.shape[0], seg,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), _build.stream_of(off)))
    _build.count_launch(KERNEL)


def kernel_attrs() -> dict:
    """What the card made of the kernel: registers a thread, static shared
    memory a block (bytes), threads a block, blocks resident on one SM."""
    lib = _build.load()
    got = (ctypes.c_int * 4)()
    _build.check(lib, lib.minlz_greedy_attrs(got))
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm"),
                    got))


def greedy_parse_plain(off, length, seg: int = SEG):
    """Plain torch version (any device): a loop over the positions, the
    state machine vectorised over lanes."""
    _check(off, length, seg)
    lanes = off.shape[0]
    dev = off.device
    take = torch.zeros((lanes, seg), dtype=torch.bool, device=dev)
    is_rep = torch.zeros((lanes, seg), dtype=torch.bool, device=dev)
    skip = torch.zeros(lanes, dtype=torch.int32, device=dev)
    rep = torch.full((lanes,), -1, dtype=torch.int32, device=dev)
    for r in range(seg):
        o = off[:, r]
        ln = length[:, r]
        t = (skip == 0) & (ln >= 4)
        take[:, r] = t
        is_rep[:, r] = t & (o == rep)
        skip = torch.where(t, ln - 1, (skip - 1).clamp(min=0))
        rep = torch.where(t, o, rep)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (take.to(torch.int32), torch.where(take, off, zero),
            torch.where(take, length, zero), is_rep.to(torch.int32))


def greedy_parse_compact(off, length, seg: int = SEG):
    """Greedy parse, then compaction to a dense token list.

    off, length: [nrows, seg] int32 (row = segment span, ascending).
    Returns (pos, off, len, is_rep, count): int32 tensors of exactly
    ``count`` entries, global positions ascending.  The JAX version pads
    its arrays to a static size; their first ``count`` entries are these.
    """
    take, tok_off, tok_len, is_rep = greedy_parse(off, length, seg)
    sel = take.reshape(-1).nonzero(as_tuple=True)[0]
    return (sel.to(torch.int32), tok_off.reshape(-1)[sel],
            tok_len.reshape(-1)[sel], is_rep.reshape(-1)[sel],
            int(sel.numel()))
