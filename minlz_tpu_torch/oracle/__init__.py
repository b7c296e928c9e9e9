"""Pure-Python spec oracle for TPU-MinLZ (differential-test anchor)."""

from .decode import decode_block, decoded_len, parse_header
from .encode import (
    emit_copy1,
    emit_copy2,
    emit_copy3,
    emit_fused2,
    emit_literals,
    emit_repeat,
    encode_block,
    encode_uncompressed,
    hash4,
)

__all__ = [
    "decode_block",
    "decoded_len",
    "parse_header",
    "encode_block",
    "encode_uncompressed",
    "emit_literals",
    "emit_repeat",
    "emit_copy1",
    "emit_copy2",
    "emit_copy3",
    "emit_fused2",
    "hash4",
]
