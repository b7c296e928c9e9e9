"""Token-level model of K1 (``csrc/parse.cu``) in plain torch.

``parse_segments_plain`` steps every lane through the byte transducer of
``ops/transducer.py``, one compressed byte per step.  The kernel does not:
it finds the lane's tokens and computes each token's records at once.  This
module states that algorithm in torch ops, with the window size as an
argument, so that small inputs cross many windows; the tests hold it equal
to ``parse_segments_plain`` on every field, and the card run reads its counts
(tokens, windows) beside the kernel's time.  One decode path calls it: the
road for blocks without parse hints parses its derived lanes with it on CPU
tensors (``exec_block.decode_unhinted``), a step a token where the plain
version steps a byte; ``decode_kernel.scan_layout`` uses its token table
(``decode``) and ``token_events`` to put K1's records at the rows of the JAX
scan, and the derivation (``ops/derive.py``) its token table.

1. **Table.**  For every byte offset i of a lane, the token that would start
   there: its kind, header length h (1-7 bytes: a Copy3's length-extension
   count comes from its offset bytes), its literal count L (a literal run's
   declared length, a Fused2's or Copy3's 1-4 literals, else 0) and
   ``nxt[i] = i + h + L``.  No offset depends on another.
2. **Chain.**  The tokens are the offsets reached from 0 by ``nxt`` while
   they lie inside the lane.  A window holds the tokens from its first one,
   w0, up to w0 + window; the first token past it starts the next window.
3. **Records.**  Per token, what the transducer carries from token to token
   is a scan: ``dpos`` (the int32-wrapping sum of output lengths), ``rep``
   (the offset of the last token that sets one, from 1), the literal
   accumulator (the first <= 4 bytes of the last literal phase, from 0) and
   the record count.  Scans run window by window; each window starts from
   the carry of the one before, as the kernel's do.

What a token emits, in the transducer's row order (``have_lit`` at a token
is "the token before was a literal run", whose run is held):

* a literal run, or a Fused2 / Copy3 with literals: first the held run, as
  an OP_LIT record, if there is one;
* an immediate copy (Repeat, Copy1, Copy2, Copy3 without literals): one
  OP_COPY record, carrying the held run's dst / lsrc / llen if there is one;
* a Fused2 / Copy3 with literals, once its literals are all in the lane: an
  OP_COPY record at the start of its literals;
* a token whose header runs past the lane end: nothing;
* at the lane end (the flush row) the held run, if the last token whose
  header is complete is a literal run, even one cut short.

``lacc`` is the accumulator at the emitting row: the last literal phase's
first bytes before the token, a pending copy's own literals, and at the
flush row the held run's bytes that are in the lane.
"""

from __future__ import annotations

import torch

from .parse import N_FIELDS, n_slots

WINDOW = 2048      # csrc/parse.cu: kWindow
HALO = 16          # bytes past a token start that decoding may read
OP_LIT, OP_COPY = 1, 2
_I64 = torch.int64


def wrap32(x):
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def decode(b, i, n):
    """The token starting at each of M offsets.  b: [M, HALO] int64, the
    lane's bytes at offsets i .. i + HALO - 1 (0 at and past the lane end);
    i, n: [M] int64, the offset and its lane's length.  Returns a dict of
    [M] tensors: ``lit`` / ``imm`` / ``pend`` (the class), ``rep`` (a
    Repeat), ``h``, ``L``, ``e`` (i + h: the lane offset after the header),
    ``nxt``, ``w`` (the output bytes the token adds), ``clen`` and ``off``
    (its copy), ``sets`` (it sets the repeat offset), ``litcnt``,
    ``complete`` (its header is in the lane), ``done`` (so are its
    literals), ``pa`` (its literal phase's first <= 4 bytes that are in the
    lane, packed little-endian)."""
    w = torch.where
    col = lambda k: b[:, k]  # noqa: E731
    b0 = col(0)
    tag, val = b0 & 3, b0 >> 2
    c3 = (val & 1) == 1
    t0, t1, t2, t3 = tag == 0, tag == 1, tag == 2, tag == 3
    code0 = val >> 1
    c3_code = (val >> 3) | ((col(1) & 7) << 3)
    off_bytes = w(t0, 0, w(t1, 1, w(t3 & c3, 3, 2)))
    code = w(t0, code0, w(t1, val & 15, w(t2, val,
                                          w(c3, c3_code, (val >> 3) & 7))))
    lext = w(t0, (code0 - 28).clamp(min=0),
             w(t1, (code == 15).to(_I64),
               w(t2, (val - 60).clamp(min=0),
                 w(c3, (c3_code - 60).clamp(min=0), 0))))
    h = 1 + off_bytes + lext
    acc_off = torch.zeros_like(b0)
    acc_len = torch.zeros_like(b0)
    for k in range(3):
        acc_off |= w(k < off_bytes, col(1 + k), 0) << (8 * k)
        at = (1 + off_bytes + k).clamp(max=HALO - 1)
        acc_len |= w(k < lext, b.gather(1, at[:, None])[:, 0], 0) << (8 * k)
    litcnt = w(t3, w(c3, (val >> 1) & 3, ((val >> 1) & 3) + 1), 0)

    lit_len = w(code < 29, code + 1, acc_len + 30)
    len_c1 = w(code < 15, code + 4, acc_len + 18)
    len_c23 = w(code < 61, code + 4, acc_len + 64)
    rep = t0 & c3
    lit = t0 & ~c3
    pend = t3 & (~c3 | (litcnt > 0))
    imm = ~lit & ~pend
    clen = w(t0, lit_len, w(t1, len_c1, w(t3 & ~c3, code + 4, len_c23)))
    off = w(t1, ((acc_off << 2) | (val >> 4)) + 1,
            w(t3 & c3, (acc_off >> 3) + 65536, acc_off + 64))
    L = w(lit, lit_len, w(pend, litcnt, 0))
    e = i + h
    pa = torch.zeros_like(b0)
    for k in range(4):
        at = (h + k).clamp(max=HALO - 1)
        pa |= w(k < L, b.gather(1, at[:, None])[:, 0], 0) << (8 * k)
    return {
        "lit": lit, "imm": imm, "pend": pend, "rep": rep, "h": h, "L": L,
        "e": e, "nxt": e + L, "w": w(lit, lit_len, w(imm, clen,
                                                     litcnt + clen)),
        "clen": clen, "off": off, "sets": ~t0, "litcnt": litcnt,
        "complete": e <= n, "done": e + litcnt <= n, "pa": pa,
    }


def lane_bytes(comp, lane_start, lane_len, lane, i):
    """[M, HALO] int64: lane ``lane``'s bytes at offsets i .. i + HALO - 1,
    0 at and past the lane end."""
    k = torch.arange(HALO, device=comp.device)
    at = i[:, None] + k
    inside = at < lane_len.to(_I64)[lane][:, None]
    g = (lane_start.to(_I64)[lane][:, None] + at).clamp(
        0, max(comp.numel() - 1, 0))
    src = comp if comp.numel() else comp.new_zeros(1)
    return torch.where(inside, src[g].to(_I64), 0)


def chain(nxt, lane_start, lane_len, window: int):
    """Follow ``nxt`` (per compressed byte, the lane offset of the next
    token) from offset 0 of every lane.  Returns (lane, offset, win) of
    every token, lane-major in chain order: ``win`` counts the windows of
    its lane before the token's."""
    dev = lane_len.device
    lens = lane_len.to(_I64)
    start = lane_start.to(_I64)
    cur = torch.zeros_like(lens)
    w0 = torch.zeros_like(lens)
    win = torch.zeros_like(lens)
    lanes = torch.arange(lens.numel(), device=dev)
    out = []
    live = cur < lens
    while bool(live.any()):
        idx = lanes[live]
        out.append(torch.stack([idx, cur[idx], win[idx]]))
        nx = nxt[start[idx] + cur[idx]]
        fresh = nx >= w0[idx] + window
        w0[idx] = torch.where(fresh, nx, w0[idx])
        win[idx] += fresh.to(_I64)
        cur[idx] = nx
        live = cur < lens
    if not out:
        return (torch.zeros(0, dtype=_I64, device=dev),) * 3
    lane, off, wid = torch.cat(out, dim=1)
    order = torch.sort(lane, stable=True).indices
    return lane[order], off[order], wid[order]


def token_events(t, lane, lanes: int) -> dict:
    """What each token emits.  t: ``decode``'s fields of the tokens, lane:
    each one's lane (lane-major, chain order, as ``chain`` gives them).
    Returns [n] tensors ``first`` (the lane's first token), ``prev`` (the
    token before, 0 for the first), ``held`` (the token before is a literal
    run of the same lane, held), ``ok`` (the header is in the lane),
    ``lit_prev`` (it emits the held run alone first), ``own`` (it emits its
    own record), and [lanes] tensors ``last_ok`` (the lane's last complete
    token, -1 for none) and ``flush`` (that token is a literal run, whose
    held run the flush row emits)."""
    n = lane.numel()
    idx = torch.arange(n, device=lane.device)
    first = torch.ones(n, dtype=torch.bool, device=lane.device)
    first[1:] = lane[1:] != lane[:-1]
    prev = (idx - 1).clamp(min=0)
    held = ~first & t["lit"][prev]
    ok = t["complete"]
    last_ok = torch.full((lanes,), -1, dtype=_I64, device=lane.device)
    last_ok.scatter_reduce_(0, lane[ok], idx[ok], "amax")
    flush = last_ok >= 0
    flush[flush.clone()] = t["lit"][last_ok[flush]]
    return {"first": first, "prev": prev, "held": held, "ok": ok,
            "lit_prev": ok & held & (t["lit"] | t["pend"]),
            "own": ok & (t["imm"] | (t["pend"] & t["done"])),
            "last_ok": last_ok, "flush": flush}


def _last_set(flag, value, first_of_seg):
    """Exclusive carry-forward within segments: for each element, the value
    of the last earlier element of its segment with ``flag``, and whether
    there is one (where not, the value is 0).  Returns (value, found)."""
    pos = torch.arange(flag.numel(), device=flag.device)
    incl = torch.cummax(torch.where(flag, pos, -1), 0).values
    excl = torch.cat([incl.new_full((1,), -1), incl])[:-1]
    found = excl >= first_of_seg
    return torch.where(found, value[excl.clamp(min=0)], 0), found


def parse_segments_model(comp, lane_start, lane_len, window: int = WINDOW,
                         lane_rep=None):
    """The arguments and result of ``parse.parse_segments`` (recs [7, n +
    lanes] int32, counts [lanes] int32), computed token by token, window by
    window; ``lane_rep`` as there.  Also returns info: ``tokens`` (chain
    hops over all lanes), ``windows`` (over all lanes), ``max_tokens`` (of
    one window)."""
    if window <= 0:
        raise ValueError("window must be positive")
    dev = comp.device
    lanes = lane_len.numel()
    lens = lane_len.to(_I64)
    start = lane_start.to(_I64)
    recs = torch.zeros((N_FIELDS, n_slots(comp.numel(), lanes)),
                       dtype=torch.int32, device=dev)
    counts = torch.zeros(lanes, dtype=_I64, device=dev)
    info = {"tokens": 0, "windows": 0, "max_tokens": 0}
    if lanes == 0:
        return recs, counts.to(torch.int32), info

    # 1. Table: the next token start from every byte of every lane.
    total = int(lens.sum())
    lane_of = torch.repeat_interleave(torch.arange(lanes, device=dev), lens,
                                      output_size=total)
    at = torch.arange(total, device=dev) - (torch.cumsum(lens, 0)
                                            - lens)[lane_of]
    tab = decode(lane_bytes(comp, lane_start, lane_len, lane_of, at), at,
                 lens[lane_of])
    nxt = torch.zeros(max(comp.numel(), 1), dtype=_I64, device=dev)
    nxt[start[lane_of] + at] = tab["nxt"]

    # 2. Chain: the token starts, window by window.
    lane, off, wid = chain(nxt, lane_start, lane_len, window)
    n = lane.numel()
    t = decode(lane_bytes(comp, lane_start, lane_len, lane, off), off,
               lens[lane])
    seg = torch.stack([lane, wid])
    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = (seg[:, 1:] != seg[:, :-1]).any(0)
    seg_id = torch.cumsum(new_seg.to(_I64), 0) - 1
    first_of_seg = torch.nonzero(new_seg)[:, 0][seg_id]
    info["tokens"] = n
    info["windows"] = int(new_seg.sum())
    if n:
        info["max_tokens"] = int(torch.bincount(seg_id).max())

    # 3. Per token: the held run before it and what it emits.
    ev = token_events(t, lane, lanes)
    prev, held, ok = ev["prev"], ev["held"], ev["ok"]
    lit_prev, own = ev["lit_prev"], ev["own"]
    cnt = lit_prev.to(_I64) + own.to(_I64)
    phase = ok & (t["lit"] | t["pend"])
    sets = ok & t["sets"]

    # Scans inside each window, exclusive ...
    def seg_excl_sum(x):
        c = torch.cumsum(x, 0)
        return c - x - (c - x)[first_of_seg]

    d_loc = seg_excl_sum(t["w"])
    n_loc = seg_excl_sum(cnt)
    rep_loc, rep_found = _last_set(sets, t["off"], first_of_seg)
    pa_loc, pa_found = _last_set(phase, t["pa"], first_of_seg)

    # ... then each window from the carry of its lane's window before.
    d = torch.zeros(n, dtype=_I64, device=dev)
    k = torch.zeros(n, dtype=_I64, device=dev)
    rep = torch.zeros(n, dtype=_I64, device=dev)
    pa = torch.zeros(n, dtype=_I64, device=dev)
    c_d = torch.zeros(lanes, dtype=_I64, device=dev)
    c_n = torch.zeros(lanes, dtype=_I64, device=dev)
    c_rep = (torch.ones(lanes, dtype=_I64, device=dev) if lane_rep is None
             else lane_rep.to(device=dev, dtype=_I64).clone())
    c_pa = torch.zeros(lanes, dtype=_I64, device=dev)
    last_of_seg = torch.ones(n, dtype=torch.bool, device=dev)
    last_of_seg[:-1] = new_seg[1:]
    for j in range(int(wid.max()) + 1 if n else 0):
        inw = wid == j
        ln = lane[inw]
        d[inw] = c_d[ln] + d_loc[inw]
        k[inw] = c_n[ln] + n_loc[inw]
        rep[inw] = torch.where(rep_found[inw], rep_loc[inw], c_rep[ln])
        pa[inw] = torch.where(pa_found[inw], pa_loc[inw], c_pa[ln])
        end = inw & last_of_seg
        le = lane[end]
        c_d[le] = d[end] + t["w"][end]
        c_n[le] = k[end] + cnt[end]
        c_rep[le] = torch.where(sets[end], t["off"][end], rep[end])
        c_pa[le] = torch.where(phase[end], t["pa"][end], pa[end])

    zero = torch.zeros_like(d)
    hl_dst = torch.where(held, d[prev], zero)
    hl_src = torch.where(held, t["e"][prev], zero)
    hl_len = torch.where(held, t["L"][prev], zero)
    imm = t["imm"]
    rec_lit = torch.stack([torch.full_like(d, OP_LIT), hl_dst, zero, zero,
                           hl_src, hl_len, pa])
    rec_own = torch.stack([
        torch.full_like(d, OP_COPY),
        torch.where(imm, torch.where(held, hl_dst, d), d),
        t["clen"],
        torch.where(imm & t["rep"], rep, t["off"]),
        torch.where(imm, hl_src, t["e"]),
        torch.where(imm, hl_len, t["litcnt"]),
        torch.where(imm, pa, t["pa"])])

    # The flush row: the held run of a lane whose last complete token is a
    # literal run.
    flush = ev["flush"]
    j = ev["last_ok"][flush]
    lf = torch.nonzero(flush)[:, 0]
    rec_flush = torch.stack([
        torch.full_like(j, OP_LIT), d[j], torch.zeros_like(j),
        torch.zeros_like(j), t["e"][j], t["L"][j], c_pa[lf]])
    counts = c_n + flush.to(_I64)

    slot0 = start + torch.arange(lanes, device=dev)
    for sel, rows, at_slot in (
            (lit_prev, rec_lit, k),
            (own, rec_own, k + lit_prev.to(_I64)),
    ):
        recs[:, slot0[lane[sel]] + at_slot[sel]] = wrap32(
            rows[:, sel]).to(torch.int32)
    recs[:, slot0[lf] + c_n[lf]] = wrap32(rec_flush).to(torch.int32)
    return recs, counts.to(torch.int32), info
