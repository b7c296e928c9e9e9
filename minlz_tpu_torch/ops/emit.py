"""Device token emission: greedy-parse arrays -> exact MinLZ segment bytes.

The counterpart of ``minlz_tpu.ops.emit``.  After the device match finder
and the greedy parse, this module verifies every proposed match
byte-exactly on the device (gather + log-doubling run extension) and then
serializes each segment's token stream with parallel primitives: prefix
sums for output cursors, monotone fills for literal-run bases, and scatters
for byte materialization.  No sequential per-byte loop exists anywhere.

The emitted stream mirrors ``encode_kernel.serialize_segment`` decision for
decision (fused literals when profitable, repeat on offset match, smallest
copy op otherwise), so the two paths are differentially testable byte for
byte.  Because verification is byte-exact here, the emitted blocks are
correct by construction even for hash-only match proposals.

The JAX package writes these functions for one block and ``vmap``s them;
here the batch is written out: every array is ``[B, N]`` (B blocks of N
padded bytes) with a per-block valid length ``n``.  Two kernels are on the
path: the greedy parse (``greedy.greedy_parse``) and, for CUDA tensors,
``emit_segments`` (``csrc/emit.cu``, a thread block a segment); the rest is
plain torch ops on the arrays' device.  ``emit_segments_plain`` is the
emission in torch ops, run for CPU tensors.  All arithmetic is integer and
matches the JAX package bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace
from . import encode_kernel as ek
from .device_codec import SEG
from .greedy import greedy_parse

OUT_PAD = 64  # per-lane output slack beyond the segment size
KERNEL = "emit"
# The kernel stages 2 * seg + OUT_PAD bytes a block in shared memory.
MAX_SEG = 1 << 16

_I32 = torch.int32
_I64 = torch.int64


def _pick(cond, a: int, b: int):
    """``a`` where cond else ``b``, int32 (torch.where of two Python
    numbers would give int64)."""
    return torch.where(cond, a, b).to(_I32)


def _iota(like):
    """Position along the last axis, int32, broadcastable to ``like``."""
    shape = [1] * (like.dim() - 1) + [like.shape[-1]]
    return torch.arange(like.shape[-1], dtype=_I32,
                        device=like.device).reshape(shape)


def _ffill_idx(valid):
    """Per-row forward fill along the last axis: index of the most recent
    True at or before each position (-1 if none).  int64."""
    marked = torch.where(valid, _iota(valid), -1)
    return torch.cummax(marked, dim=-1).values.to(_I64)


def _bfill_idx(valid):
    """Index of the nearest True at or after each position (-1 if none).
    int64."""
    n = valid.shape[-1]
    marked = torch.where(valid, n - 1 - _iota(valid), -1)
    rev = torch.cummax(marked.flip(-1), dim=-1).values.flip(-1).to(_I64)
    return torch.where(rev >= 0, n - 1 - rev, -1)


def _lengths(n, B: int, device):
    """Per-block valid lengths as a [B, 1] int32 tensor."""
    return torch.as_tensor(n, dtype=_I32, device=device).reshape(B, 1)


def verify_extend(data, take, off, n, seg: int):
    """Byte-exact verification + extension of parsed match proposals.

    data: [B, N] block bytes (any integer dtype, zero padded); take/off:
    [B, N] int32 parse arrays in global position order; n: [B] valid byte
    counts (tensor or sequence).  Returns (surv, vlen), [B, N] int32:
    surviving takes and their verified lengths.
    """
    B, N = data.shape
    n = _lengths(n, B, data.device)
    pos = _iota(data)
    tk = take > 0

    # Forward-fill each take's distance over the positions after it, so a
    # single gather verifies every byte: ok[q] = data[q] == data[q - D].
    fi = _ffill_idx(tk)
    D = torch.where(fi >= 0, torch.gather(off, 1, fi.clamp(min=0)), 0)
    src = (pos - D).clamp(0, N - 1).to(_I64)
    ok = (D > 0) & (data == torch.gather(data, 1, src)) & (pos < n)

    # Run length of consecutive ok with constant distance, starting at q.
    same = torch.roll(D, -1, dims=1) == D
    ext = ok & torch.roll(ok, -1, dims=1) & same
    runs = ek._run_doubling(ext, min(seg, 8192)).to(_I32)
    mlen = torch.where(ok, 1 + runs, 0)

    # Caps: segment boundary, block end, and the next take's position
    # (extension past it would double-cover its output).
    seg_room = seg - (pos % seg)
    nxt = _bfill_idx(torch.roll(tk, -1, dims=1) & (pos + 1 < N))
    # nearest take strictly after q: index of next take at or after q+1
    nxt_pos = torch.where(nxt >= 0, nxt + 1, N).to(_I32)
    gap = nxt_pos - pos
    vlen = torch.minimum(torch.minimum(mlen, seg_room),
                         torch.minimum(gap, n - pos))
    vlen = torch.where(tk, vlen, 0)
    surv = tk & (vlen >= 4)
    return surv.to(_I32), torch.where(surv, vlen, 0)


def _lit_hdr(nl):
    """Literal-run header bytes/length for runs < 65566 (seg-bounded)."""
    b0 = torch.where(
        nl < 30, (nl - 1) << 3, _pick(nl < 286, 29 << 3, 30 << 3)
    )
    b1 = torch.where(nl < 286, nl - 30, (nl - 30) & 255)
    b2 = (nl - 30) >> 8
    ln = torch.where(nl < 30, 1, _pick(nl < 286, 2, 3))
    ln = torch.where(nl > 0, ln, 0)
    return torch.stack([b0, b1, b2], -1), ln


def _rep_tok(l):
    v = l - 1
    v2 = l - 30
    b0 = torch.where(
        v < 29, v << 3 | 4,
        _pick(v2 < 256, 29 << 3 | 4, 30 << 3 | 4))
    b1 = torch.where(v2 < 256, v2, v2 & 255)
    b2 = v2 >> 8
    ln = torch.where(v < 29, 1, _pick(v2 < 256, 2, 3))
    return torch.stack([b0, b1, b2], -1), ln


def _copy_tok(off, l):
    """Copy token bytes for the non-fused path (copy1/2/3 incl. repeat
    extension for long copy1).  Returns (bytes [..,7], len)."""
    z = torch.zeros_like(off)
    # copy1 (off <= 1024)
    o1 = off - 1
    x_s = o1 << 6 | (l - 4) << 2 | 1          # short, l<=18
    x_m = o1 << 6 | 15 << 2 | 1               # +1 ext, l<=273
    x_l = o1 << 6 | 14 << 2 | 1               # l=18 + repeat(l-18)
    rep_b, rep_l = _rep_tok((l - 18).clamp(min=1))
    c1b = torch.where(
        (l <= 18)[..., None],
        torch.stack([x_s & 255, x_s >> 8, z, z, z, z, z], -1),
        torch.where(
            (l <= 273)[..., None],
            torch.stack([x_m & 255, x_m >> 8, l - 18, z, z, z, z], -1),
            torch.stack(
                [x_l & 255, x_l >> 8, rep_b[..., 0], rep_b[..., 1],
                 rep_b[..., 2], z, z], -1,
            ),
        ),
    )
    c1l = torch.where(l <= 18, 2, torch.where(l <= 273, 3, 2 + rep_l))
    # copy2 (64 <= off <= 65599); l2 <= 8192-4 so <=2 ext bytes
    o2 = off - 64
    l2 = l - 4
    c2b = torch.where(
        (l2 <= 60)[..., None],
        torch.stack([l2 << 2 | 2, o2 & 255, o2 >> 8, z, z, z, z], -1),
        torch.where(
            (l2 - 60 < 256)[..., None],
            torch.stack(
                [z + (61 << 2 | 2), o2 & 255, o2 >> 8, l2 - 60, z, z, z], -1
            ),
            torch.stack(
                [z + (62 << 2 | 2), o2 & 255, o2 >> 8, (l2 - 60) & 255,
                 (l2 - 60) >> 8, z, z], -1,
            ),
        ),
    )
    c2l = torch.where(l2 <= 60, 3, _pick(l2 - 60 < 256, 4, 5))
    # copy3 (off > 65599) with no fused literals
    c3b, c3l = _copy3_tok(off, l, z)
    return (
        torch.where(
            (off <= 1024)[..., None],
            c1b,
            torch.where((off <= 65599)[..., None], c2b, c3b),
        ),
        torch.where(off <= 1024, c1l, torch.where(off <= 65599, c2l, c3l)),
    )


def _copy3_tok(off, l, nlits):
    """Copy3 token bytes (ext bytes precede fused literal data)."""
    z = torch.zeros_like(off)
    o = off - 65536
    l3 = l - 4
    code = torch.where(l3 <= 60, l3, _pick(l3 - 60 < 256, 61, 62))
    # o reaches 2**21, so o << 11 leaves int32: the word is built in int64
    # and cut into bytes, which are the bits an int32 that wraps would give.
    word = (7 | nlits.to(_I64) << 3 | code.to(_I64) << 5
            | o.to(_I64) << 11)
    ext = l3 - 60
    b = torch.stack(
        [(word & 255).to(_I32), ((word >> 8) & 255).to(_I32),
         ((word >> 16) & 255).to(_I32), ((word >> 24) & 255).to(_I32),
         torch.where(code >= 61, ext & 255, z),
         torch.where(code >= 62, ext >> 8, z), z], -1,
    )
    ln = 4 + (code >= 61).to(_I32) + (code >= 62).to(_I32)
    return b, ln


def _pad7(b):
    """Zero-pad the last axis of a token-byte array to 7."""
    return torch.nn.functional.pad(b, (0, 7 - b.shape[-1]))


def _scatter_bytes(out, addr, vals):
    """out[row, addr] = vals & 255 along rows; addr: int32, same shape as
    vals.  The last column of ``out`` is the spare one that takes every
    dropped write."""
    rows = out.shape[0]
    out.scatter_(1, addr.reshape(rows, -1).to(_I64),
                 (vals.reshape(rows, -1) & 255).to(torch.uint8))


def _check(data, surv, off, vlen, seg: int):
    if data.dim() != 2:
        raise ValueError("data must be a [B, N] tensor")
    for name, t in (("surv", surv), ("off", off), ("vlen", vlen)):
        if t.shape != data.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have data's "
                             f"shape {tuple(data.shape)}")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on "
                             f"{data.device}")
    if not 0 < seg <= MAX_SEG or data.shape[1] % seg:
        raise ValueError(f"N = {data.shape[1]} must be a multiple of seg "
                         f"{seg}, 0 < seg <= {MAX_SEG}")


def emit_segments(data, surv, off, vlen, n, seg: int):
    """Serialize verified tokens into per-segment MinLZ byte streams.

    data: [B, N] block bytes (any integer dtype); surv/off/vlen: [B, N]
    int32 verified parse arrays; n: [B] valid bytes (tensor or sequence).
    N must be a multiple of seg.  Returns (out [B, nseg, seg + OUT_PAD]
    uint8, out_lens [B, nseg] int32), zeros after each segment's length.

    CUDA tensors: one launch of the emit kernel, a thread block a segment,
    no synchronisation; CPU tensors: ``emit_segments_plain``.  Both give
    the same bytes.
    """
    _check(data, surv, off, vlen, seg)
    if data.device.type == "cpu":
        return emit_segments_plain(data, surv, off, vlen, n, seg)
    if data.device.type != "cuda":
        raise ValueError(f"no emit kernel for device {data.device}")
    B, N = data.shape
    nseg = N // seg
    trace.count("emit.kernel_rows", B * nseg)
    dev = data.device
    args = [data.to(torch.uint8).contiguous()]
    args += [t.to(_I32).contiguous() for t in (surv, off, vlen)]
    args.append(_lengths(n, B, dev).contiguous())
    out = torch.empty((B, nseg, seg + OUT_PAD), dtype=torch.uint8,
                      device=dev)
    out_lens = torch.empty((B, nseg), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        launch_emit(*args, seg, out, out_lens)
    return out, out_lens


def launch_emit(data, surv, off, vlen, n, seg: int, out, out_lens):
    """The bare launch of the emit kernel: checked, contiguous CUDA tensors
    in (data [B, N] uint8, surv/off/vlen [B, N] int32, n [B] int32), out
    [B, N // seg, seg + OUT_PAD] uint8 and out_lens [B, N // seg] int32
    written in place, every element (any contents before).  No check, no
    allocation; measurements time this."""
    lib = _build.load()
    B, N = data.shape
    _build.check(lib, lib.minlz_emit(
        data.data_ptr(), surv.data_ptr(), off.data_ptr(), vlen.data_ptr(),
        n.data_ptr(), B * (N // seg), N // seg, seg, out.data_ptr(),
        out_lens.data_ptr(), _build.stream_of(data)))
    _build.count_launch(KERNEL)


def kernel_attrs(seg: int = SEG) -> dict:
    """What the card made of the kernel at this seg: registers a thread,
    shared memory a block (bytes, static and dynamic), threads a block,
    blocks resident on one SM."""
    lib = _build.load()
    got = (ctypes.c_int * 4)()
    _build.check(lib, lib.minlz_emit_attrs(seg, got))
    return dict(zip(("registers", "shared_bytes", "threads", "blocks_per_sm"),
                    got))


def emit_segments_plain(data, surv, off, vlen, n, seg: int):
    """``emit_segments`` in torch ops, on any device.

    Every segment is one row of the work arrays, whatever block it belongs
    to: all the steps run along a segment's positions.
    """
    _check(data, surv, off, vlen, seg)
    B, N = data.shape
    nseg = N // seg
    S = seg
    R = B * nseg
    trace.count("emit.plain_rows", R)
    dev = data.device
    d = data.reshape(R, S)
    take = surv.reshape(R, S) > 0
    off = off.reshape(R, S)
    ln = vlen.reshape(R, S)
    pos = _iota(d)
    seg_first = torch.arange(nseg, dtype=_I32, device=dev)[None, :] * S
    seg_n = (_lengths(n, B, dev) - seg_first).clamp(0, S).reshape(R, 1)

    # --- run geometry -----------------------------------------------------
    # cover end (exclusive) of the most recent token at or before q.
    cov = torch.cummax(torch.where(take, pos + ln, 0), dim=1).values
    lit_start = torch.where(take, torch.roll(cov, 1, dims=1), 0)
    lit_start[:, 0] = 0
    # tokens never start inside a previous token's span (greedy parse), so
    # lit_start at a take is the previous cover end.
    nlits = torch.where(take, pos - lit_start, 0)

    # previous surviving take's offset (repeat detection).
    prev_i = torch.roll(_ffill_idx(take), 1, dims=1)
    prev_i[:, 0] = -1
    rep_prev = torch.where(
        prev_i >= 0, torch.gather(off, 1, prev_i.clamp(min=0)), -1)
    del prev_i

    # --- token selection (mirrors serialize_segment) ----------------------
    is_rep = take & (off == rep_prev)
    del rep_prev
    can_fuse = (
        take
        & (nlits >= 1)
        & (off >= 64)
        & ~is_rep
        & ((nlits <= 3) | ((off <= 65599) & (nlits <= 4)))
    )
    fuse2 = can_fuse & (off <= 65599)
    fuse3 = can_fuse & (off > 65599)

    lit_b, lit_l = _lit_hdr(nlits)
    rep_b, rep_l = _rep_tok(ln.clamp(min=1))
    cop_b, cop_l = _copy_tok(off.clamp(min=1), ln.clamp(min=4))
    c3f_b, c3f_l = _copy3_tok(off.clamp(min=65600), ln.clamp(min=4), nlits)
    # fused2: 3-byte token; l>7 adds a repeat extension after the literals.
    o2 = off - 64
    l2 = ln.clamp(min=4) - 4
    f2code = l2.clamp(max=7)
    f2_b = torch.stack(
        [3 | (nlits - 1) << 3 | f2code << 5, o2 & 255, o2 >> 8], -1)
    f2ext_b, f2ext_l = _rep_tok((ln - 11).clamp(min=1))
    f2ext_l = torch.where(l2 > 7, f2ext_l, 0)

    # prefix = bytes before the run's literal data; suffix = bytes after.
    pre_b = torch.where(
        fuse2[..., None],
        _pad7(f2_b),
        torch.where(fuse3[..., None], c3f_b, _pad7(lit_b)),
    )
    del f2_b, c3f_b, lit_b
    pre_l = torch.where(
        fuse2, 3,
        torch.where(fuse3, c3f_l, torch.where(nlits > 0, lit_l, 0)))
    suf_b = torch.where(
        is_rep[..., None],
        _pad7(rep_b),
        torch.where(
            fuse2[..., None],
            _pad7(f2ext_b),
            torch.where(fuse3[..., None], 0, cop_b),
        ),
    )
    del rep_b, f2ext_b, cop_b
    suf_l = torch.where(
        is_rep, rep_l,
        torch.where(fuse2, f2ext_l, torch.where(fuse3, 0, cop_l)))
    pre_l = torch.where(take, pre_l, 0)
    suf_l = torch.where(take, suf_l, 0)

    # --- output cursors ---------------------------------------------------
    tok_total = pre_l + nlits + suf_l
    csum = torch.cumsum(tok_total, dim=1, dtype=_I32)
    out_before = csum - tok_total  # exclusive
    data_base = out_before + pre_l

    # trailing literal flush per lane
    last_cov = cov[:, -1:]
    trail = (seg_n - last_cov).clamp(min=0)
    fl_b, fl_l = _lit_hdr(trail.clamp(min=1))
    fl_l = torch.where(trail > 0, fl_l, 0)
    flush_base = csum[:, -1:]
    out_lens = (flush_base + fl_l + trail).reshape(B, nseg)

    # --- literal byte addresses (backward fill of data_base - lit_start) --
    C_tok = torch.where(take, data_base - lit_start, 0)
    nx = _bfill_idx(take)
    C_fill = torch.where(
        nx >= 0,
        torch.gather(C_tok, 1, nx.clamp(min=0)),
        flush_base + fl_l - last_cov,  # flush run
    )
    del nx, C_tok
    is_lit = (cov <= pos) & (pos < seg_n)
    # Address OUT means "drop": it is a spare column, cut off at the end.
    # Apart from it no two writes share an address.
    OUT = S + OUT_PAD
    lit_addr = torch.where(is_lit, C_fill + pos, OUT)

    out = torch.zeros((R, OUT + 1), dtype=torch.uint8, device=dev)
    _scatter_bytes(out, lit_addr, d)
    del lit_addr, C_fill

    # --- token/header byte scatter ----------------------------------------
    j = torch.arange(7, dtype=_I32, device=dev)
    pre_addr = torch.where(
        take[..., None] & (j < pre_l[..., None]),
        out_before[..., None] + j,
        OUT,
    )
    _scatter_bytes(out, pre_addr, pre_b)
    del pre_addr, pre_b
    suf_addr = torch.where(
        take[..., None] & (j < suf_l[..., None]),
        (out_before + pre_l + nlits)[..., None] + j,
        OUT,
    )
    _scatter_bytes(out, suf_addr, suf_b)
    del suf_addr, suf_b

    # flush headers (3 bytes max) at flush_base
    fj = torch.arange(3, dtype=_I32, device=dev)
    fl_addr = torch.where((trail > 0) & (fj < fl_l), flush_base + fj, OUT)
    _scatter_bytes(out, fl_addr, fl_b.reshape(R, 3))

    return out[:, :OUT].reshape(B, nseg, OUT), out_lens


def encode_block_emit(data, n, seg: int, rng: int = 0, level: int = 2,
                      ctx: int = 0):
    """Full device encode: match find -> greedy parse -> verify -> emit.

    data: [B, N] block bytes (any integer dtype, zero padded, N a multiple
    of seg); n: [B] valid lengths.  Returns (out [B, nseg - ctx,
    seg + OUT_PAD] uint8, out_lens [B, nseg - ctx] int32).  Correct by
    construction (byte-exact verification).  On a CUDA tensor the greedy
    parse and the emission launch their kernels.

    ctx > 0: the first ``ctx`` segments are dictionary/context history —
    match finding, parsing and verification see them (copies may reach
    back into them), but serialization covers only the remaining
    ``nseg - ctx`` block segments."""
    B, N = data.shape
    dev = data.device
    with trace.span("emit.match", dev):
        n = _lengths(n, B, dev)
        dist, length = ek.find_matches_dyn(data, n, seg, rng, level)
    nseg = N // seg
    with trace.span("emit.greedy", dev):
        take, tok_off, _, _ = greedy_parse(
            dist.to(_I32).reshape(B * nseg, seg),
            length.to(_I32).reshape(B * nseg, seg), seg)
        del dist, length
        take = take.reshape(B, N)
        tok_off = tok_off.reshape(B, N)
    with trace.span("emit.verify", dev):
        surv, vlen = verify_extend(data, take, tok_off, n, seg)
    C = ctx * seg
    with trace.span("emit.segments", dev):
        return emit_segments(data[:, C:], surv[:, C:], tok_off[:, C:],
                             vlen[:, C:], n - C, seg)
