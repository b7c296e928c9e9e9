"""Device half of the batched block encode: sort-based match finding.

The counterpart of ``minlz_tpu.ops.encode_kernel``'s device path.  The JAX
package writes it in plain jnp with no Pallas kernel, so this port is plain
torch ops: ``torch.sort`` takes the place of ``lax.sort``, the vmapped block
batch is a tensor dimension with a per-block valid length, and the uint32
arithmetic that wraps in JAX is done in int64 and masked to 32 bits.

Two serializers turn the match proposals into the block body and the parse
hints, and the caller names the one it wants: ``serializer="native"`` (the
default) is the host C++ ``parse_serialize`` of ``native.codec`` and raises
when the native library did not build; ``serializer="greedy"`` is the device
greedy parse (``greedy.greedy_parse_compact``) followed by the host Python
``serialize_block``.  Nothing switches from one to the other by itself.

``greedy_parse`` and ``greedy_parse_compact`` are ``ops/greedy.py``'s (the
greedy kernel, ``csrc/greedy.cu``), named here as the JAX module names them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._device import resolve_device
from ..minlz import put_uvarint
from ..native.build import build_error
from ..native.codec import get_codec
from ..oracle import encode as oenc
from .device_codec import SEG, WINDOW
from .greedy import greedy_parse, greedy_parse_compact  # noqa: F401

_HASH_BITS = 17
_POS_BITS = 14
_PRIME4 = 2654435761
_MIX2 = 0x9E3779B1
_XOR2 = 0x85EBCA6B
_M32 = 0xFFFFFFFF
_MAX_OFFSET = (1 << 21) + 65535

_I64 = torch.int64


def _roll(x, shift: int):
    return torch.roll(x, shift, dims=1) if shift else x


def _window_pass(keyflat, vals, M: int, W: int, shift: int, nback: int,
                 pos_bits: int = _POS_BITS):
    """One batched windowed-sort candidate pass over M samples per block.

    keyflat: [B, M] int64 = hash << pos_bits (invalid samples carry a
    sentinel above every valid key); vals: co-verified value arrays ([B, M]
    each) — a candidate needs an equal hash AND equal values.  Returns nback
    candidate arrays ([B, M] global sample index or -1): the 1st..nback-th
    previous same-key sample within the window.
    """
    B = keyflat.shape[0]
    k = _roll(keyflat, shift)
    vs = [_roll(v, shift) for v in vals]
    nwin = M // W
    lpos = torch.arange(W, dtype=_I64, device=keyflat.device)
    key = k.reshape(B, nwin, W) | lpos
    # Keys carry the window position in their low bits, so they are unique
    # and a stable sort fixes the same order as lax.sort.
    key_s, order = torch.sort(key, dim=2, stable=True)
    vs_s = [torch.gather(v.reshape(B, nwin, W), 2, order) for v in vs]
    pos_s = key_s & ((1 << pos_bits) - 1)
    h_s = key_s >> pos_bits
    idx = torch.arange(W, device=keyflat.device)
    cs = []
    for back in range(1, nback + 1):
        ok = (h_s == torch.roll(h_s, back, dims=2)) & (idx >= back)
        for v in vs_s:
            ok &= v == torch.roll(v, back, dims=2)
        cs.append(torch.where(ok, torch.roll(pos_s, back, dims=2), -1))
    base = (torch.arange(nwin, dtype=_I64, device=keyflat.device) * W)[:, None]
    out = []
    for c in cs:
        # Back to window order: pos_s is a permutation of 0..W-1, so the
        # JAX re-sort by pos_s is this scatter.
        c = torch.empty_like(c).scatter_(2, pos_s, c)
        g = torch.where(c >= 0, c + base, -1).reshape(B, M)
        if shift:
            # Undo the roll: array index -> original sample index.
            g = _roll(g, -shift)
            g = torch.where(g >= 0, torch.remainder(g - shift, M), -1)
        out.append(g)
    return out


def _run_doubling(ext, cap: int):
    """Length of the run of consecutive True values starting at each
    position, by log-doubling, capped near ``cap``."""
    runs = ext.to(_I64)
    shift = 1
    while shift < cap:
        carry = torch.roll(runs, -shift, dims=1)
        runs = runs + torch.where(runs == shift, carry, 0)
        shift *= 2
    return runs


def find_matches_dyn(data, n, seg: int = SEG, rng: int = 0, level: int = 2,
                     exact: bool = False):
    """data: [B, N] bytes of B blocks (any integer dtype, values 0..255,
    zero padded); n: [B] valid lengths (tensor or sequence).

    rng (power of two, 0 = off) clamps match sources to the rng-aligned
    range of their destination.  ``level`` picks the tiers and candidate
    depth as in ``minlz_tpu.ops.encode_kernel.find_matches_dyn``: -1 one
    aligned short pass; 1 both short passes + the stride-8 tier; 2 adds the
    stride-64 tier; 3 deepens every candidate set.  ``exact`` co-sorts each
    position's 4-byte value with its hash in the short tier's passes, so a
    short candidate needs equal bytes and not only an equal 16-bit hash;
    off (the default, and what every encode path runs), the host serializer
    verifies the proposals instead.

    Returns (dist, length) as [B, N] int64.
    """
    B, N = data.shape
    dev = data.device
    d = data.to(_I64)
    n = torch.as_tensor(n, dtype=_I64, device=dev).reshape(B, 1)
    pos = torch.arange(N, dtype=_I64, device=dev)[None, :]

    best_dist = torch.zeros((B, N), dtype=_I64, device=dev)
    best_len = torch.zeros((B, N), dtype=_I64, device=dev)
    deep = 1 if level >= 3 else 0

    # ---- short tier: stride 1, exact 4-byte windows ----------------------
    v0 = (d | _roll(d, -1) << 8 | _roll(d, -2) << 16 | _roll(d, -3) << 24)
    W = 2 * WINDOW if N % (2 * WINDOW) == 0 else min(WINDOW, N)
    pos_bits0 = W.bit_length() - 1 if W < 32768 else 15
    h = ((v0 * _PRIME4) & _M32) >> (32 - 16)
    valid = pos <= n - 4
    sentinel0 = (1 << 31) - (1 << pos_bits0)
    keyflat = torch.where(valid, h << pos_bits0, sentinel0)
    # The payload is only compared for equality, so its unsigned 32-bit
    # values serve as well as the wrapped int32 that lax.sort carries.
    v0s = [v0] if exact else []
    cands = _window_pass(keyflat, v0s, N, W, 0,
                         nback=(1 if level < 1 else 2 + deep),
                         pos_bits=pos_bits0)
    if N > W and level >= 1:
        cands += _window_pass(keyflat, v0s, N, W, W // 2, nback=1 + deep,
                              pos_bits=pos_bits0)

    for cand in cands:
        dist = torch.where(cand >= 0, pos - cand, 0)
        dist = torch.where((dist > 0) & (dist <= _MAX_OFFSET), dist, 0)
        if rng:
            dist = torch.where(dist <= (pos & (rng - 1)), dist, 0)
        dist1 = _roll(dist, -1)
        ext = (dist > 0) & (dist1 == dist) & (pos + 5 <= n)
        runs = _run_doubling(ext, min(seg, 256))
        length = torch.where(dist > 0, 4 + runs, 0)
        better = length > best_len
        best_dist = torch.where(better, dist, best_dist)
        best_len = torch.where(better, length, best_len)

    # ---- mid/long tiers: strided samples for long-range matches ----------
    tiers = []
    if level >= 1:
        tiers.append((8, False))
    if level >= 2 and not (rng and rng <= 8 * WINDOW):
        tiers.append((64, True))
    for stride, mixed in tiers:
        M = N // stride
        if M < 256:
            break
        words = d.reshape(B, M, stride)
        w32 = [
            words[:, :, k] | words[:, :, k + 1] << 8
            | words[:, :, k + 2] << 16 | words[:, :, k + 3] << 24
            for k in range(0, stride, 4)
        ]
        if mixed:
            m1 = torch.zeros_like(w32[0])
            m2 = torch.zeros_like(w32[0])
            for w in w32:
                m1 = (m1 * _PRIME4 + w) & _M32
                m2 = (m2 * _MIX2 + (w ^ _XOR2)) & _M32
            vals = [m1, m2]
            hs = ((((m1 ^ m2) * _PRIME4) & _M32) >> (32 - _HASH_BITS))
        else:
            vals = w32
            hs = ((((w32[0] * _PRIME4) & _M32) ^ ((w32[1] * _MIX2) & _M32))
                  >> (32 - _HASH_BITS))
        spos = torch.arange(M, dtype=_I64, device=dev)[None, :]
        svalid = spos * stride + stride <= n
        sentinel = (1 << 31) - (1 << _POS_BITS)
        keyflat = torch.where(svalid, hs << _POS_BITS, sentinel)
        Ws = min(WINDOW, M)
        while M % Ws:  # sort rows must tile M exactly
            Ws //= 2
        scands = _window_pass(keyflat, vals, M, Ws, 0, nback=1 + deep)
        cross_useful = not (rng and (stride * Ws) % rng == 0)
        if M > Ws and cross_useful:
            scands += _window_pass(keyflat, vals, M, Ws, Ws // 2,
                                   nback=1 + deep)
        run_cap = max(seg // stride, 2)
        sd_best = torch.zeros((B, M), dtype=_I64, device=dev)
        sl_best = torch.zeros((B, M), dtype=_I64, device=dev)
        for cand in scands:
            sd = torch.where(cand >= 0, spos - cand, 0)
            sdist = sd * stride
            sdist = torch.where((sd > 0) & (sdist <= _MAX_OFFSET), sdist, 0)
            if rng:
                sdist = torch.where(
                    sdist <= ((spos * stride) & (rng - 1)), sdist, 0)
            sd1 = _roll(sdist, -1)
            ext = (sdist > 0) & (sd1 == sdist)
            runs = _run_doubling(ext, run_cap)
            ln = torch.where(sdist > 0, stride * (1 + runs), 0)
            better = ln > sl_best
            sd_best = torch.where(better, sdist, sd_best)
            sl_best = torch.where(better, ln, sl_best)
        # Expand sample hits to full resolution (value at sample position).
        dist_full = torch.zeros((B, M, stride), dtype=_I64, device=dev)
        len_full = torch.zeros((B, M, stride), dtype=_I64, device=dev)
        dist_full[:, :, 0] = sd_best
        len_full[:, :, 0] = sl_best
        dist_full = dist_full.reshape(B, N)
        len_full = len_full.reshape(B, N)
        better = len_full > best_len
        best_dist = torch.where(better, dist_full, best_dist)
        best_len = torch.where(better, len_full, best_len)

    # No match may cross its segment end nor the block end.
    seg_room = seg - (pos % seg)
    best_len = torch.minimum(best_len, torch.minimum(seg_room, n - pos))
    best_len = torch.where(best_len >= 4, best_len, 0)
    best_dist = torch.where(best_len >= 4, best_dist, 0)
    return best_dist, best_len


def find_matches(data_flat, n: int, seg: int = SEG, rng: int = 0,
                 level: int = 2):
    """``find_matches_dyn`` for one block of a fixed length, as the JAX
    ``find_matches`` (its jit-cached wrapper for static sizes) takes and
    returns it: data_flat [1, N] bytes, n an int; returns (dist, length),
    [1, N] int32.  torch runs eagerly, so there is no compiled graph to
    cache."""
    dist, length = find_matches_dyn(data_flat, [int(n)], seg, rng, level)
    return dist.to(torch.int32), length.to(torch.int32)


def serialize_block(data: bytes, pos, off, ln, is_rep, count,
                    seg: int = SEG):
    """Serialize a whole block from a compacted global op list.

    Returns (body_bytes, hints) with hints = [(comp_off, out_off), ...] per
    segment.  Ops must be ascending by position and never cross segment
    boundaries (guaranteed by find_matches_dyn's length cap).
    """
    n = len(data)
    nseg = -(-n // seg)
    body = bytearray()
    hints = []
    i = 0
    count = int(count)
    for si in range(nseg):
        s0 = si * seg
        s1 = min(s0 + seg, n)
        hints.append((len(body), s0))
        lit_start = s0
        rep = -1
        while i < count and pos[i] < s1:
            p = int(pos[i])
            o = int(off[i])
            l = int(ln[i])
            # Device lengths are proposals (coarse levels are hash-verified
            # only): confirm byte-exactly, truncating at first mismatch.
            lv = 0
            while lv < l and data[p + lv] == data[p - o + lv]:
                lv += 1
            l = lv
            if l < 4:
                i += 1
                continue
            lits = data[lit_start:p]
            if is_rep[i] and o == rep:
                if lits:
                    oenc.emit_literals(body, lits)
                oenc.emit_repeat(body, l)
            else:
                can_fuse = (
                    lits
                    and o >= 64
                    and o != rep
                    and (len(lits) <= 3 or (o <= 65599 and len(lits) <= 4))
                )
                if can_fuse:
                    if o <= 65599:
                        oenc.emit_fused2(body, lits, o, l)
                    else:
                        oenc.emit_copy3(body, o, l, lits)
                else:
                    if lits:
                        oenc.emit_literals(body, lits)
                    if o == rep:
                        oenc.emit_repeat(body, l)
                    elif o <= 1024:
                        oenc.emit_copy1(body, o, l)
                    elif o <= 65599:
                        oenc.emit_copy2(body, o, l)
                    else:
                        oenc.emit_copy3(body, o, l)
                rep = o
            lit_start = p + l
            i += 1
        if lit_start < s1:
            oenc.emit_literals(body, data[lit_start:s1])
    return bytes(body), hints


def serialize_segment(src: bytes, take, tok_off, tok_len, is_rep) -> bytes:
    """Emit the MinLZ token stream for one segment from parse arrays
    (numpy, one entry per position).

    Token choice mirrors the upstream greedy encoder's decision tree
    (internal/reference/encoder.go:174-221): fused literals when possible,
    repeat when the offset matches, otherwise the smallest copy op.
    """
    dst = bytearray()
    n = len(src)
    rows = np.nonzero(take[:n])[0]
    lit_start = 0
    rep = -1
    for p in rows:
        p = int(p)
        off = int(tok_off[p])
        ln = int(tok_len[p])
        lits = src[lit_start:p]
        if is_rep[p]:
            if lits:
                oenc.emit_literals(dst, lits)
            oenc.emit_repeat(dst, ln)
        else:
            can_fuse = (
                lits
                and off >= 64
                and off != rep
                and (len(lits) <= 3 or (off <= 65599 and len(lits) <= 4))
            )
            if can_fuse:
                if off <= 65599:
                    oenc.emit_fused2(dst, lits, off, ln)
                else:
                    oenc.emit_copy3(dst, off, ln, lits)
            else:
                if lits:
                    oenc.emit_literals(dst, lits)
                if off == rep:
                    oenc.emit_repeat(dst, ln)
                elif off <= 1024:
                    oenc.emit_copy1(dst, off, ln)
                elif off <= 65599:
                    oenc.emit_copy2(dst, off, ln)
                else:
                    oenc.emit_copy3(dst, off, ln)
            rep = off
        lit_start = p + ln
    if lit_start < n:
        oenc.emit_literals(dst, src[lit_start:])
    return bytes(dst)


def _find_matches_batch(data_u8, ns, seg: int = SEG, rng: int = 0,
                        level: int = 2):
    """Match distances for [B, N] blocks with per-block valid lengths, in
    one batch.  Returns [B, N] int32."""
    dist, _ = find_matches_dyn(data_u8, ns, seg, rng, level)
    return dist.to(torch.int32)


def _size_class(total: int) -> int:
    """Sort-geometry size class: the smallest power-of-two row that holds
    the block, up to the full 2*WINDOW row (then multiples of it)."""
    if total >= 2 * WINDOW:
        return -(-total // (2 * WINDOW)) * (2 * WINDOW)
    return 1 << max((total - 1).bit_length(), 12)


def _native_codec():
    codec = get_codec()
    if codec is None:
        raise RuntimeError(
            "the native codec (minlz_tpu_torch.native) did not build "
            f"({build_error()}): serializer=\"native\" needs its "
            "parse_serialize; ask for serializer=\"greedy\" to serialize "
            "without it"
        )
    return codec


def _serialize(codec, block: bytes, dist, seg: int, rng: int, level: int):
    res = codec.parse_serialize(block, dist, seg, rng, level)
    if res is None:
        return None, None
    body, hints = res
    if len(body) >= len(block):
        return None, None
    return b"\x00" + put_uvarint(len(block)) + body, hints


def encode_blocks_device(blocks, seg: int = SEG, rng: int = 0,
                         level: int = 2, device="cuda"):
    """Encode a batch of blocks with one match-finder pass on ``device``.

    rng > 0 clamps match sources to rng-aligned ranges (both in the match
    finder and the native parse), as parse hints v2 record.  Returns a list
    of (block_bytes, hints) tuples, (None, None) for incompressible blocks.
    """
    if not blocks:
        return []
    dev = resolve_device(device)
    codec = _native_codec()
    with trace.span("encode.match"):
        N = _size_class(max(len(b) for b in blocks))
        arr = np.zeros((len(blocks), N), np.uint8)
        for i, b in enumerate(blocks):
            arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        ns = [len(b) for b in blocks]
        dists = _find_matches_batch(
            torch.from_numpy(arr).to(dev), ns, seg, rng, level
        ).cpu().numpy()
    with trace.span("encode.serialize"):
        return [_serialize(codec, b, dists[i, : len(b)], seg, rng, level)
                for i, b in enumerate(blocks)]


def encode_block_device(data: bytes, seg: int = SEG, rng: int = 0,
                        level: int = 2, device="cuda",
                        serializer: str = "native"):
    """Encode one block; the sort geometry is sized from its segments, as
    in the JAX ``encode_block_device``.  ``serializer`` is "native" (host
    C++ parse_serialize; raises if the native library did not build) or
    "greedy" (device greedy parse, then ``serialize_block``).  Returns
    (block_bytes, hints), or (None, None) when the data does not
    compress."""
    if serializer not in ("native", "greedy"):
        raise ValueError(f"unknown serializer {serializer!r}")
    n = len(data)
    if n == 0:
        return b"\x00", []
    dev = resolve_device(device)
    codec = _native_codec() if serializer == "native" else None
    nseg = -(-n // seg)
    N = _size_class(nseg * seg)
    flat = np.zeros((1, N), np.uint8)
    flat[0, :n] = np.frombuffer(data, np.uint8)
    dist, length = find_matches_dyn(
        torch.from_numpy(flat).to(dev), [n], seg, rng, level)
    if codec is not None:
        dist = dist.to(torch.int32).cpu().numpy()[0, :n]
        return _serialize(codec, data, dist, seg, rng, level)
    nrows = N // seg
    pos, off, ln, isrep, count = greedy_parse_compact(
        dist.to(torch.int32).reshape(nrows, seg),
        length.to(torch.int32).reshape(nrows, seg), seg)
    body, hints = serialize_block(
        data, pos.cpu().numpy(), off.cpu().numpy(), ln.cpu().numpy(),
        isrep.cpu().numpy(), count, seg)
    if len(body) >= n:
        return None, None
    return b"\x00" + put_uvarint(n) + body, hints
