"""Helpers for tests and smoke runs of the port."""

from __future__ import annotations

import numpy as np


def mutate(rng: np.random.Generator, data: bytes) -> bytes:
    """One structure-aware mutation of a byte string: a bit flip, a byte
    set, a truncation, a splice, an insertion or a huge varint."""
    if not data:
        return data
    b = bytearray(data)
    op = int(rng.integers(0, 6))
    i = int(rng.integers(0, len(b)))
    if op == 0:  # bit flip
        b[i] ^= 1 << int(rng.integers(0, 8))
    elif op == 1:  # byte set
        b[i] = int(rng.integers(0, 256))
    elif op == 2:  # truncate
        del b[i:]
    elif op == 3:  # splice a chunk elsewhere
        j = int(rng.integers(0, len(b)))
        ln = int(rng.integers(1, 64))
        b[i : i + ln] = b[j : j + ln]
    elif op == 4:  # insert random bytes
        b[i:i] = rng.integers(0, 256, int(rng.integers(1, 16)),
                              dtype=np.uint8).tobytes()
    else:  # overwrite a varint-looking region with big values
        b[i : i + 4] = b"\xff\xff\xff\x7f"
    return bytes(b)


# --------------------------------------------------------------------------
# Positioned records made for the executors (no encoder would write them)
# --------------------------------------------------------------------------

RECORD_KINDS = ("literals", "dense", "deep_1", "deep_3", "long", "far")

# Rows (pos, llen, clen, csrc, lit) as only a direct caller of an executor
# can supply them, for a span of HOSTILE_SPAN bytes and a comp of about
# 2 KiB: fields outside every bound, but records with bytes move forward
# without overlapping, which is the executors' contract.
HOSTILE_SPAN = 900
HOSTILE_RECORDS = (
    (0, 4, 10, 9, 0),            # copy source before the span: zeros
    (14, 0, 7, 1 << 30, 0),      # a huge offset
    (21, -5, 3, 0, 5),           # negative literal length, csrc 0 -> 1
    (24, 3, -9, 4, -50),         # negative copy length, literal index < 0
    (1500, 0, 0, 1, 0),          # records of no bytes stand anywhere
    (-3, 0, 0, 1, 0),
    (27, 40, 0, 1, 1 << 30),     # literal index beyond comp
    (67, 5, 300, 2, 2000),       # literals run off comp's end, then RLE
    (372, 0, 5000, 370, 0),      # clen clipped to the span
    (1 << 30, 9, 9, 9, 9),       # a position beyond the span
)


def synthetic_records(kind: str, span: int, rng: np.random.Generator,
                      n_comp: int) -> np.ndarray:
    """One span's records, [5, n] int32 (pos, llen, clen, csrc, lit), back
    to back from position 0 until the span is full; the executors clip the
    last one.  Kinds:

    * ``literals``: 4 KiB literal runs, no copy;
    * ``dense``: 2-4 byte records, a literal byte or two and a short copy
      from a few bytes back: many records, shallow to middling chains;
    * ``deep_1`` / ``deep_3``: one record per byte, each copying the byte 1
      or 3 back: the chain is as deep as the span is long;
    * ``long``: 4 KiB literal runs and 4 KiB overlapping (RLE) copies of
      periods 1, 7 and 100 in turn;
    * ``far``: pieces of 4099 bytes; a piece that can copies from 128 KiB
      and more back (plainly, or with a period of 3 from just before it),
      so on the whole-block road copies straddle every tile boundary and
      chains of residuals run back through every tile."""
    if kind not in RECORD_KINDS:
        raise ValueError(f"kind must be one of {RECORD_KINDS}")
    if kind == "literals":
        n = -(-span // 4096)
        llen, clen, csrc = np.full(n, 4096), np.zeros(n, int), np.ones(n, int)
    elif kind == "dense":
        n = span // 2 + 1
        llen = rng.integers(1, 3, n)
        clen = rng.integers(1, 3, n)
        csrc = rng.integers(1, 9, n)
    elif kind in ("deep_1", "deep_3"):
        back = int(kind[-1])
        n = max(span, 1)
        llen = np.zeros(n, int)
        llen[0] = back
        clen = np.ones(n, int)
        clen[0] = 0
        csrc = np.full(n, back)
    elif kind == "long":
        n = -(-span // 4096)
        lit_run = np.arange(n) % 2 == 0
        llen = np.where(lit_run, 4096, 0)
        clen = np.where(lit_run, 0, 4096)
        csrc = np.array([1, 1, 1, 7, 1, 100])[np.arange(n) % 6]
    else:
        n = -(-span // 4099)
        start = np.arange(n) * 4099
        reach = (128 << 10) + 17 + 4099 * (np.arange(n) % 3)
        can = start >= reach
        rle = can & (np.arange(n) % 5 == 4)
        llen = np.where(can, np.where(rle, 3, 0), 4099)
        clen = np.where(can, 4099 - llen, 0)
        csrc = np.where(rle, 3, np.where(can, reach, 1))
    step = llen + clen
    pos = np.cumsum(step) - step
    keep = pos < span
    lit = rng.integers(0, max(n_comp - 4096, 1), n)
    return np.stack([pos, llen, clen, csrc, lit])[:, keep].astype(np.int32)


def record_batch(kind: str, spans, seed: int = 0, n_comp: int = 1 << 20):
    """A batch of spans of ``synthetic_records(kind, ...)``, as the numpy
    arguments of ``execute_ranges`` / ``execute_blocks``: (crec [5, n] int32,
    first [R + 1] int64, out_off [R] int64, span [R] int32, comp [n_comp]
    uint8, total_out).  The spans lie back to back in the output."""
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, 256, n_comp, dtype=np.uint8)
    parts = [synthetic_records(kind, int(s), rng, n_comp) for s in spans]
    spans = np.asarray(spans, np.int64)
    first = np.cumsum([0] + [p.shape[1] for p in parts]).astype(np.int64)
    crec = np.ascontiguousarray(np.concatenate(parts, axis=1)) if parts \
        else np.zeros((5, 0), np.int32)
    return (crec, first, np.cumsum(spans) - spans, spans.astype(np.int32),
            comp, int(spans.sum()))
