"""The plain reference of the lanes an unhinted block is decoded in, and the
byte count of the derivation's roofline.

A block without parse hints says nowhere where a token starts but in the
token before it.  The program cuts each block's body into lanes at token
starts on the card; what those lanes are is stated here by the format's
sequential token walk (SPEC.md §2), in plain Python, importing nothing of
the program:

* ``walk(body)``: every token of a body (the bytes after the block's
  uvarint): its compressed start, output start, output bytes and the
  repeat offset it sets (0 for none);
* ``lane_table(body, decoded_len, seg)``: lane k starts at the first token
  start at or after ``k * seg`` compressed bytes (or at the body's end),
  owns the output of the tokens before the next lane's start, and enters
  with the offset of the last token before it that sets one (1, the
  format's initial offset, where none does).  Each lane is (comp start,
  comp length, output lo, output hi, incoming offset), block-local.

``plan_bytes`` counts what a derivation must move at least: every
compressed byte read once and the plan written once, the lanes a block's
walk cuts (five int32 words a lane) and three words a block (its first
lane and output offset as int64, its span as int32), whatever implements
it.
"""

from __future__ import annotations

from .reference import Corrupt

MAX_BLOCK = 8 << 20
LANE_BYTES = 5 * 4
BLOCK_BYTES = 8 + 8 + 4


def _token(body, pos: int):
    """(next pos, output bytes, offset set or 0, kind) of the token at
    ``pos``; Corrupt where it runs past the body."""
    n = len(body)

    def take(at, k):
        if at + k > n:
            raise Corrupt("a token runs past the body")
        return int.from_bytes(body[at:at + k], "little")

    b0 = body[pos]
    tag, value = b0 & 3, b0 >> 2
    pos += 1
    if tag == 0:
        code = value >> 1
        length = code + 1
        if code >= 29:
            nb = code - 28
            length = take(pos, nb) + 30
            pos += nb
        if value & 1:
            return pos, length, 0, "repeat"
        if pos + length > n:
            raise Corrupt("a literal run runs past the body")
        return pos + length, length, 0, "lit"
    lits = 0
    if tag == 1:
        offset = (take(pos, 1) << 2 | (value >> 4)) + 1
        pos += 1
        length = (value & 15) + 4
        if value & 15 == 15:
            length = take(pos, 1) + 18
            pos += 1
    elif tag == 2:
        offset = take(pos, 2) + 64
        pos += 2
        length = value + 4
        if value > 60:
            nb = value - 60
            length = take(pos, nb) + 64
            pos += nb
    elif not value & 1:
        offset = take(pos, 2) + 64
        pos += 2
        length = (value >> 3) + 4
        lits = ((value >> 1) & 3) + 1
    else:
        full = value | take(pos, 3) << 6
        pos += 3
        offset = (full >> 9) + 65536
        code = (full >> 3) & 63
        length = code + 4
        if code >= 61:
            nb = code - 60
            length = take(pos, nb) + 64
            pos += nb
        lits = (value >> 1) & 3
    if pos + lits > n:
        raise Corrupt("fused literals run past the body")
    return pos + lits, length + lits, offset, "copy"


def walk(body):
    """Every token of ``body`` in order: (comp start, output start, output
    bytes, offset set or 0, kind)."""
    body = bytes(body)
    out, pos, toks = 0, 0, []
    while pos < len(body):
        nxt, w, off, kind = _token(body, pos)
        toks.append((pos, out, w, off, kind))
        pos, out = nxt, out + w
    return toks


def lane_table(body, decoded_len: int, seg: int):
    """The lanes of an unhinted block (module docstring); Corrupt where the
    block is unsound."""
    body = bytes(body)
    if not 0 < decoded_len <= MAX_BLOCK or len(body) > decoded_len:
        raise Corrupt("a block's sizes out of the format's bounds")
    toks = walk(body)
    total = toks[-1][1] + toks[-1][2] if toks else 0
    if total != decoded_len:
        raise Corrupt(f"tokens decode to {total} bytes, the block says "
                      f"{decoded_len}")
    n = len(body)
    starts, t, rep = [], 0, 1
    for k in range(-(-n // seg)):
        while t < len(toks) and toks[t][0] < k * seg:
            rep = toks[t][3] or rep
            t += 1
        at = toks[t] if t < len(toks) else (n, total)
        starts.append((at[0], at[1], rep))
    ends = starts[1:] + [(n, total, 0)]
    return [(s, e[0] - s, lo, e[1], rep)
            for (s, lo, rep), e in zip(starts, ends)]


def plan_bytes(body_lens, seg: int) -> int:
    """Bytes a derivation of one batch must move at least: the bodies read
    once, and the plan of their walk's lanes written once."""
    lanes = sum(-(-n // seg) for n in body_lens)
    return sum(body_lens) + LANE_BYTES * lanes + BLOCK_BYTES * len(body_lens)
