"""Plain reference of the unhinted decode plan (pure Python).

A MinLZ block as any writer of the format leaves it carries no parse
hints: nothing says where a token starts but the token before it.  The
device road cuts such a block's body into lanes at token starts and
decodes the lanes at once; this module states what those lanes are, by the
sequential walk of ``decode.iter_ops``, so that the device's derivation
(``ops/derive.py``) can be held to it:

* ``walk(body)``: every token of a body (the bytes after the block's
  uvarint), in order, with its compressed start, its output start and
  length, and the repeat offset it sets, if it sets one;
* ``lane_table(body, decoded_len, seg)``: lane k starts at the first token
  start at or after ``k * seg`` compressed bytes (or at the body's end), and
  owns the output of the tokens that start before the next lane's start; it
  enters with the repeat offset of the last token before it that sets one
  (1, the format's initial value, where none does);
* ``decode_lanes(body, decoded_len, seg)``: the block decoded lane by lane
  from that table, each lane's tokens walked on their own from their lane's
  incoming repeat offset, into one output; it equals
  ``decode.decode_block`` on every sound block.

A hostile body raises ``CorruptError``: a token cut short by the body's
end, a chain that does not end exactly at the body's end, a decoded length
that disagrees with the tokens' output, a decoded length above the format's
8 MiB or below the body's length.  Nothing here imports a kernel of the
port or anything of JAX.
"""

from __future__ import annotations

from ..minlz import MAX_BLOCK_SIZE, CorruptError, put_uvarint
from .decode import decode_block

# The format's initial repeat offset (SPEC.md §2.2).
REP0 = 1


def _token(body, pos: int):
    """The token at ``pos``: (next pos, output bytes, offset it sets or 0,
    kind, fused literals).  Raises CorruptError where it runs past the
    body."""
    n = len(body)
    b0 = body[pos]
    tag, value = b0 & 3, b0 >> 2
    pos += 1

    def take(k):
        if pos + k > n:
            raise CorruptError("token runs past the body")
        return int.from_bytes(body[pos:pos + k], "little")

    if tag == 0:
        code = value >> 1
        length = code + 1
        if code >= 29:
            nb = code - 28
            length = take(nb) + 30
            pos += nb
        if value & 1:
            return pos, length, 0, "repeat", 0
        if pos + length > n:
            raise CorruptError("literal run runs past the body")
        return pos + length, length, 0, "lit", 0
    lits = 0
    if tag == 1:
        offset = (take(1) << 2 | (value >> 4)) + 1
        pos += 1
        length = (value & 15) + 4
        if value & 15 == 15:
            length = take(1) + 18
            pos += 1
        kind = "copy1"
    elif tag == 2:
        offset = take(2) + 64
        pos += 2
        length = value + 4
        if value > 60:
            nb = value - 60
            length = take(nb) + 64
            pos += nb
        kind = "copy2"
    elif not value & 1:
        offset = take(2) + 64
        pos += 2
        length = (value >> 3) + 4
        lits = ((value >> 1) & 3) + 1
        kind = "copy2f"
    else:
        full = value | take(3) << 6
        pos += 3
        offset = (full >> 9) + 65536
        code = (full >> 3) & 63
        length = code + 4
        if code >= 61:
            nb = code - 60
            length = take(nb) + 64
            pos += nb
        lits = (value >> 1) & 3
        kind = "copy3"
    if pos + lits > n:
        raise CorruptError("fused literals run past the body")
    return pos + lits, length + lits, offset, kind, lits


def walk(body):
    """Every token of ``body`` in order: a list of (comp start, output
    start, output bytes, offset set or 0, kind)."""
    body = bytes(body)
    out, pos, toks = 0, 0, []
    while pos < len(body):
        nxt, w, off, kind, _ = _token(body, pos)
        toks.append((pos, out, w, off, kind))
        pos, out = nxt, out + w
    return toks


def _check_sizes(body, decoded_len: int):
    if not 0 < decoded_len <= MAX_BLOCK_SIZE:
        raise CorruptError(f"decoded length {decoded_len} outside the "
                           f"format's 1..{MAX_BLOCK_SIZE}")
    if len(body) > decoded_len:
        raise CorruptError("compressed body longer than its decoded length")


def lane_table(body, decoded_len: int, seg: int):
    """The lanes of an unhinted block: a list, one entry per ``seg``
    compressed bytes of the body, of (comp start, comp length, output lo,
    output hi, incoming repeat offset), all block-local."""
    if seg <= 0:
        raise ValueError("segment must be positive")
    body = bytes(body)
    _check_sizes(body, decoded_len)
    toks = walk(body)
    total = toks[-1][1] + toks[-1][2] if toks else 0
    if total != decoded_len:
        raise CorruptError(f"tokens decode to {total} bytes, the block "
                           f"says {decoded_len}")
    n = len(body)
    lanes = []
    t, rep = 0, REP0
    for k in range(-(-n // seg)):
        while t < len(toks) and toks[t][0] < k * seg:
            rep = toks[t][3] or rep
            t += 1
        start = toks[t][0] if t < len(toks) else n
        lo = toks[t][1] if t < len(toks) else total
        lanes.append([start, 0, lo, 0, rep])
    for k, lane in enumerate(lanes):
        nxt = lanes[k + 1] if k + 1 < len(lanes) else (n, 0, total)
        lane[1] = nxt[0] - lane[0]
        lane[3] = nxt[2]
    return [tuple(lane) for lane in lanes]


def decode_lanes(body, decoded_len: int, seg: int) -> bytes:
    """Decode the block lane by lane from ``lane_table``: each lane's
    tokens from its own start and incoming repeat offset, its output placed
    at its lo, every copy read from the one output of the block."""
    body = bytes(body)
    dst = bytearray(decoded_len)
    for start, length, lo, hi, rep in lane_table(body, decoded_len, seg):
        pos, out = start, lo
        while pos < start + length:
            nxt, w, off, kind, lits = _token(body, pos)
            if kind == "lit":
                dst[out:out + w] = body[nxt - w:nxt]
                pos, out = nxt, out + w
                continue
            dst[out:out + lits] = body[nxt - lits:nxt]
            rep = off or rep
            out += lits
            length_c = w - lits
            if rep > out:
                raise CorruptError(f"copy offset {rep} exceeds position "
                                   f"{out}")
            for i in range(length_c):  # byte by byte: copies may overlap
                dst[out + i] = dst[out - rep + i]
            pos, out = nxt, out + length_c
        if out != hi:
            raise CorruptError("a lane's output disagrees with its span")
    return bytes(dst)


def decode_unhinted(body, decoded_len: int) -> bytes:
    """The whole unhinted decode of one block body, by the format's own
    decoder (``decode.decode_block``) on the block it frames."""
    return decode_block(b"\x00" + put_uvarint(decoded_len) + bytes(body))
