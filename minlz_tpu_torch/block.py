"""Public block API: encode/decode single MinLZ blocks on the host.

Parity surface with the reference block API (``encode.go:74`` Encode,
``decode.go:50`` Decode, TryEncode/AppendEncoded/AppendDecoded/DecodedLen/
IsMinLZ, levels SuperFast..Smallest).  Dispatches to the native C++ runtime
when available, falling back to the pure-Python oracle.  Batched, device-side
encode/decode lives in ``minlz_tpu_torch.ops`` — this module is the scalar host
path used by the stream layer and CLI for small/one-off work.
"""

from __future__ import annotations

from . import minlz
from .minlz import (
    LEVEL_BALANCED,
    LEVEL_FASTEST,
    LEVEL_SMALLEST,
    LEVEL_SUPER_FAST,
    MAX_BLOCK_SIZE,
    CorruptError,
    TooLargeError,
    max_encoded_len,
)
from .oracle import decode as _odec
from .oracle import encode as _oenc

# Per-level hash-table sizing, matching the spirit of the reference ladder
# (encode_l0.go: 13-bit hash8 ... encode_l3.go: 20+18-bit dual).  The host
# greedy encoder approximates levels by search effort; exact level parity on
# ratio is tracked by tests against the golden corpus.
_LEVEL_TABLE_BITS = {
    LEVEL_SUPER_FAST: 13,
    LEVEL_FASTEST: 15,
    LEVEL_BALANCED: 17,
    LEVEL_SMALLEST: 18,
}


def _native_codec():
    from .native.codec import get_codec

    return get_codec()


def encode(src, level: int = LEVEL_FASTEST) -> bytes:
    """Encode ``src`` as a single MinLZ block (with leading 0x00 marker).

    Raises TooLargeError for blocks over 8MiB.  Always succeeds otherwise —
    incompressible input is stored as a literal-only block.
    """
    if len(src) > MAX_BLOCK_SIZE:
        raise TooLargeError(f"block of {len(src)} bytes exceeds 8MiB limit")
    if level not in _LEVEL_TABLE_BITS:
        raise ValueError(f"invalid level {level}")
    codec = _native_codec()
    if codec is not None:
        return codec.encode_block(bytes(src), level)
    return _oenc.encode_block(src, _LEVEL_TABLE_BITS[level])


def try_encode(src, level: int = LEVEL_FASTEST):
    """Encode, returning None when output would not be smaller than input.

    Parity: reference ``TryEncode``.
    """
    out = encode(src, level)
    if len(out) >= len(src):
        return None
    return out


def append_encoded(dst: bytearray, src, level: int = LEVEL_FASTEST) -> bytearray:
    """Append the encoded form of ``src`` to ``dst`` and return it."""
    dst += encode(src, level)
    return dst


def decode(src) -> bytes:
    """Decode a single MinLZ block.  Raises CorruptError on bad input.

    A non-zero first byte triggers Snappy fallback decoding (SPEC.md §1.0;
    reference decode.go:59-68 falls back to the s2 package)."""
    src = bytes(src)
    if src and src[0] != 0:
        from .minlz import TooLargeError
        from .snappy import S2_MAX_BLOCK_SIZE, s2_decode_block, snappy_decoded_len

        # Reference decode.go:59-62: fallback blocks are capped at
        # s2.MaxBlockSize (4 MiB) and return ErrTooLarge beyond it.
        try:
            dlen = snappy_decoded_len(src)
        except ValueError:
            dlen = 0  # bad varint -> let the decoder report corruption
        if dlen > S2_MAX_BLOCK_SIZE:
            raise TooLargeError("fallback block exceeds S2 max block size")
        return s2_decode_block(src)
    codec = _native_codec()
    if codec is not None:
        return codec.decode_block(src)
    return _odec.decode_block(src)


def append_decoded(dst: bytearray, src) -> bytearray:
    dst += decode(src)
    return dst


def decoded_len(src) -> int:
    """Decoded size of a block without decoding it."""
    return _odec.decoded_len(src)


def is_minlz(src) -> bool:
    """True when ``src`` parses as a MinLZ block header (reference
    ``IsMinLZ``, decode.go:114)."""
    try:
        _odec.parse_header(src)
        return True
    except (CorruptError, ValueError):
        return False


def encode_uncompressed(src) -> bytes:
    return _oenc.encode_uncompressed(src)
