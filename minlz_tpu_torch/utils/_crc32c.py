"""ctypes bridge to the native CRC-32C implementation."""

from __future__ import annotations

from ..native.build import get_lib

_lib = get_lib()
if _lib is None:  # force fallback path in minlz.py
    raise ImportError("native crc32c unavailable")


def crc32c(data, crc: int = 0) -> int:
    data = bytes(data)
    return _lib.minlz_crc32c(data, len(data), crc & 0xFFFFFFFF)
