"""Deterministic mixed corpus for smoke runs and measurements.

Text, json-ish records, csv-ish rows, structured binary and random bytes in
turn, roughly Silesia-like in compressibility; byte for byte the corpus of
the JAX package's benchmark script, so ratios compare.  The text part is
``testdata/Mark.Twain-Tom.Sawyer.txt`` at the root of the checkout.
"""

from __future__ import annotations

import os

import numpy as np

_TWAIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "testdata", "Mark.Twain-Tom.Sawyer.txt")


def make_corpus(total_bytes: int) -> bytes:
    """``total_bytes`` of the mixed corpus, made from a fixed seed."""
    rng = np.random.default_rng(1234)
    with open(_TWAIN, "rb") as f:
        twain = f.read()

    parts = []
    size = 0
    i = 0
    words = [w for w in twain.split() if w][:4000]
    while size < total_bytes:
        kind = i % 5
        if kind == 0:  # text with mutations (no trivial global period)
            t = bytearray(twain)
            for _ in range(len(t) // 200):
                t[int(rng.integers(0, len(t)))] = int(rng.integers(32, 127))
            parts.append(bytes(t))
        elif kind == 1:  # json-ish log records
            recs = []
            for k in range(2000):
                recs.append(
                    b'{"ts":%d,"user":"u%d","op":"%s","n":%d}\n'
                    % (
                        1700000000 + i * 1000 + k,
                        int(rng.integers(0, 500)),
                        words[int(rng.integers(0, len(words)))][:12],
                        int(rng.integers(0, 10000)),
                    )
                )
            parts.append(b"".join(recs))
        elif kind == 2:  # csv-ish
            rows = []
            for k in range(3000):
                rows.append(
                    b"%d,%0.2f,%s,%d\n"
                    % (
                        k,
                        float(rng.random() * 100),
                        words[int(rng.integers(0, len(words)))][:10],
                        int(rng.integers(0, 2)),
                    )
                )
            parts.append(b"".join(rows))
        elif kind == 3:  # structured binary (sorted ints, small deltas)
            base = rng.integers(0, 1 << 20, 40000).astype(np.uint32)
            base.sort()
            parts.append(base.tobytes())
        else:  # incompressible
            parts.append(rng.integers(0, 256, 65536, dtype=np.uint8).tobytes())
        size += len(parts[-1])
        i += 1
    return b"".join(parts)[:total_bytes]
