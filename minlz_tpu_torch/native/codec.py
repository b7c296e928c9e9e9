"""ctypes bridge to the native (C++) host block codec.

Returns None from get_codec() until the native codec is built; callers fall
back to the Python oracle.
"""

from __future__ import annotations

import ctypes

from .build import get_lib

_codec = None
_checked = False


class _NativeCodec:
    def __init__(self, lib):
        self._lib = lib

    def encode_block(self, src: bytes, level: int) -> bytes:
        n = len(src)
        cap = max(n + 16, 32)
        out = ctypes.create_string_buffer(cap)
        wrote = self._lib.minlz_encode_block(src, n, out, cap, level)
        if wrote < 0:
            raise ValueError(f"native encode failed ({wrote})")
        return out.raw[:wrote]

    def encode_block_dict(self, src: bytes, dict_bytes: bytes,
                          level: int) -> bytes:
        """Dict-aware optimal-parse encode: copies may reach back into the
        dictionary prefix."""
        combined = bytes(dict_bytes) + bytes(src)
        cap = max(len(src) + 16, 32)
        out = ctypes.create_string_buffer(cap)
        wrote = self._lib.minlz_encode_block_dict(
            combined, len(combined), len(dict_bytes), out, cap, level
        )
        if wrote < 0:
            raise ValueError(f"native dict encode failed ({wrote})")
        return out.raw[:wrote]

    def decode_block_dict(self, src: bytes, dict_bytes: bytes) -> bytes:
        """Decode a dict-encoded block (window seeded with the dict)."""
        from ..oracle.decode import decoded_len

        want = decoded_len(src)
        ctx = len(dict_bytes)
        cap = ctx + max(want, 1)
        out = ctypes.create_string_buffer(cap)
        ctypes.memmove(out, bytes(dict_bytes), ctx)
        wrote = self._lib.minlz_decode_block_dict(
            src, len(src), out, cap, ctx
        )
        if wrote < 0:
            raise ValueError(f"native dict decode failed ({wrote})")
        return out.raw[ctx : ctx + wrote]

    def serialize_ops(self, src: bytes, pos, off, ln, isrep, count: int,
                      seg: int):
        """Native op-list serializer.  Returns (body, hints) or None."""
        import numpy as np

        if not hasattr(self._lib, "minlz_serialize_ops"):
            return None
        n = len(src)
        nseg = -(-n // seg) if n else 0
        cap = n + 64 + 8 * max(nseg, 1)
        out = ctypes.create_string_buffer(cap)
        hints = np.zeros(max(nseg, 1), np.int64)
        count = min(count, len(pos))
        pos = np.ascontiguousarray(pos, np.int32)
        off = np.ascontiguousarray(off, np.int32)
        ln = np.ascontiguousarray(ln, np.int32)
        isrep = np.ascontiguousarray(isrep, np.int32)
        wrote = self._lib.minlz_serialize_ops(
            src, n,
            pos.ctypes.data, off.ctypes.data, ln.ctypes.data,
            isrep.ctypes.data, count, seg, out, cap,
            hints.ctypes.data,
        )
        if wrote < 0:
            return None
        return out.raw[:wrote], [(int(h), i * seg) for i, h in enumerate(hints[:nseg])]

    def parse_serialize(self, src: bytes, dist, seg: int, rng: int = 0,
                        level: int = 1):
        """Fused greedy parse + serialize from device match proposals.

        dist: int32[n] candidate distances (0 = none).  Every chosen match
        is byte-verified and re-extended natively.  rng > 0 (power of two)
        clamps match sources to the rng-aligned range of their destination
        (chained decode contract).  level tunes the emit policy: -1 skips
        lazy lookahead, 3 adds a 2-byte lookahead and relaxes the copy2
        token-profit gate.  Returns (body, hints) or None when the body
        would not be smaller than the input."""
        import numpy as np

        if not hasattr(self._lib, "minlz_parse_serialize"):
            return None
        n = len(src)
        nseg = -(-n // seg) if n else 0
        cap = n + 64 + 8 * max(nseg, 1)
        out = ctypes.create_string_buffer(cap)
        hints = np.zeros(max(nseg, 1), np.int64)
        dist = np.ascontiguousarray(dist, np.int32)
        lens = np.zeros(1, np.int32)  # lengths are recomputed natively
        wrote = self._lib.minlz_parse_serialize(
            src, n, dist.ctypes.data, lens.ctypes.data, seg, out, cap,
            max(n - 1, 1), hints.ctypes.data, rng, level,
        )
        if wrote < 0:
            return None
        return (
            out.raw[:wrote],
            [(int(h), i * seg) for i, h in enumerate(hints[:nseg])],
        )

    def lz4_convert_block(self, src: bytes, max_size: int = 8 << 20):
        """Native LZ4 block -> MinLZ block transcode (no decompression).
        Returns the MinLZ block bytes or None when unsupported; raises
        ValueError on corrupt LZ4 input."""
        if not hasattr(self._lib, "minlz_lz4_convert_block"):
            return None
        # Escalating output caps: create_string_buffer zeroes its memory,
        # so starting at 8 MiB would cost more than the conversion itself.
        cap = min(max_size + 16, max(len(src) * 4, 4096))
        while True:
            out = ctypes.create_string_buffer(cap)
            wrote = self._lib.minlz_lz4_convert_block(
                src, len(src), out, cap, max_size
            )
            if wrote == -1:
                raise ValueError("corrupt LZ4 block")
            if wrote == -2 and cap < max_size + 16:
                cap = min(cap * 4, max_size + 16)
                continue
            if wrote < 0:
                return None
            return out.raw[:wrote]

    def decode_block(self, src: bytes) -> bytes:
        from ..minlz import CorruptError
        from ..oracle.decode import parse_header

        lit_only, want, _ = parse_header(src)
        out = ctypes.create_string_buffer(max(want, 1))
        wrote = self._lib.minlz_decode_block(src, len(src), out, want)
        if wrote < 0:
            raise CorruptError(f"native decode failed ({wrote})")
        return out.raw[:wrote]


def get_codec():
    global _codec, _checked
    if _checked:
        return _codec
    _checked = True
    lib = get_lib()
    if lib is None or not hasattr(lib, "minlz_encode_block"):
        return None
    lib.minlz_encode_block.restype = ctypes.c_long
    lib.minlz_encode_block.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.minlz_decode_block.restype = ctypes.c_long
    lib.minlz_decode_block.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    if hasattr(lib, "minlz_encode_block_dict"):
        lib.minlz_encode_block_dict.restype = ctypes.c_long
        lib.minlz_encode_block_dict.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.minlz_decode_block_dict.restype = ctypes.c_long
        lib.minlz_decode_block_dict.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ]
    if hasattr(lib, "minlz_parse_serialize"):
        lib.minlz_parse_serialize.restype = ctypes.c_long
        lib.minlz_parse_serialize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
    if hasattr(lib, "minlz_lz4_convert_block"):
        lib.minlz_lz4_convert_block.restype = ctypes.c_long
        lib.minlz_lz4_convert_block.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ]
    if hasattr(lib, "minlz_serialize_ops"):
        lib.minlz_serialize_ops.restype = ctypes.c_long
        lib.minlz_serialize_ops.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
    _codec = _NativeCodec(lib)
    return _codec
