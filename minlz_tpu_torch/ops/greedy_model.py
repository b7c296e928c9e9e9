"""Windowed model of the greedy kernel (``csrc/greedy.cu``) in plain torch.

``greedy_parse_plain`` steps every lane through the greedy state machine,
one position per step.  The kernel does not: it finds a lane's tokens by
following a chain through a table.  This module states that algorithm in
torch ops, with the window size as an argument, so that small inputs cross
many windows; the tests hold it equal to ``greedy_parse_plain`` and to the
JAX package's scan.  Nothing on an encode path calls it.

A candidate is a position q with ``len[q] >= 4``.  Per lane, a window
``[w0, w0 + wn)`` at a time, carrying ``cur`` (the first lane position that
may start a token; 0 at the start of a lane) and ``rep`` (the offset of the
last token; -1 at the start):

1. **Table.**  ``nextc[i]``: the first candidate at or after window
   position i, or ``wn`` for none (a suffix minimum).  For a candidate i,
   ``hop[i] = nextc[i + len[i]]``, or ``wn`` where ``i + len[i]`` leaves the
   window (taken in 64 bits: ``len`` may be 2^31 - 1).
2. **Chain.**  From ``s = nextc[cur - w0]`` while ``s < wn``: s is a token,
   ``is_rep = off[s] == rep``, ``rep = off[s]``, ``s = hop[s]``.  A window
   that starts at or after ``w0 + wn`` has no token.
3. **Carry.**  ``cur = max(cur, w0 + wn, w0 + last + len[last])`` for the
   window's last token ``last``: the token after it can start no earlier.

Each step of the chain here is one token, and a window has at most
``ceil(wn / 4)`` of them.  The kernel's thread takes two tokens a step: it
also keeps ``hop[hop[i]]`` and the next token's offset as tables, so that it
waits on one shared memory load per two tokens.
"""

from __future__ import annotations

import torch

from .greedy import _check

WINDOW = 512       # csrc/greedy.cu: kWindow
_I64 = torch.int64


def greedy_parse_model(off, length, seg: int, window: int = WINDOW):
    """The windowed chain over [B, seg] int32 proposals.  Returns
    ((take, tok_off, tok_len, is_rep), info): the four [B, seg] int32
    outputs of ``greedy_parse_plain``, and counts of the run: ``tokens``
    (chain hops, all lanes), ``windows`` (lane windows with a chain to
    follow; the others are covered by a token and write zeros) and
    ``max_hops`` (the longest chain of one window)."""
    _check(off, length, seg)
    if window < 1:
        raise ValueError("window must be positive")
    lanes, dev = off.shape[0], off.device
    take = torch.zeros((lanes, seg), dtype=torch.bool, device=dev)
    is_rep = torch.zeros((lanes, seg), dtype=torch.bool, device=dev)
    cur = torch.zeros(lanes, dtype=_I64, device=dev)
    rep = torch.full((lanes,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(lanes, device=dev)
    info = {"tokens": 0, "windows": 0, "max_hops": 0}
    for w0 in range(0, seg, window):
        wn = min(window, seg - w0)
        ln = length[:, w0:w0 + wn].to(_I64)
        of = off[:, w0:w0 + wn]
        idx = torch.arange(wn, device=dev)
        cand = ln >= 4
        # 1. table
        first = torch.where(cand, idx, wn)
        nextc = torch.cat([first, first.new_full((lanes, 1), wn)], 1)
        nextc = nextc.flip(1).cummin(1).values.flip(1)  # [lanes, wn + 1]
        to = torch.where(cand, idx + ln, wn).clamp(max=wn)
        hop = nextc.gather(1, to)
        # 2. chain, all lanes in step
        start = (cur - w0).clamp(max=wn)
        s = nextc.gather(1, start[:, None])[:, 0]
        info["windows"] += int((start < wn).sum())
        last = torch.full((lanes,), -1, dtype=_I64, device=dev)
        hops = 0
        while True:
            live = s < wn
            if not bool(live.any()):
                break
            hops += 1
            info["tokens"] += int(live.sum())
            r, p = rows[live], s[live]
            o = of[r, p]
            take[r, w0 + p] = True
            is_rep[r, w0 + p] = o == rep[r]
            rep[r] = o
            last[r] = p
            s[r] = hop[r, p]
        info["max_hops"] = max(info["max_hops"], hops)
        # 3. carry
        end = w0 + last + ln.gather(1, last.clamp(min=0)[:, None])[:, 0]
        cur = torch.maximum(cur, torch.full_like(cur, w0 + wn))
        cur = torch.where(last >= 0, torch.maximum(cur, end), cur)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return ((take.to(torch.int32), torch.where(take, off, zero),
             torch.where(take, length, zero), is_rep.to(torch.int32)), info)
