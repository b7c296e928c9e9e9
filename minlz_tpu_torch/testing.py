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
