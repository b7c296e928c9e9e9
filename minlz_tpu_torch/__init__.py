"""TPU-MinLZ on PyTorch and CUDA: the device codec of ``minlz_tpu``, ported.

The JAX package ``minlz_tpu`` stays the reference.  This package stands on
its own: it imports torch, never jax, and nothing of ``minlz_tpu``.  It
keeps its own copy of the host layer (``minlz``, ``oracle``, ``block``,
``snappy``, ``native``, ``stream``, ``lz4``, ``cli``) and ports the device
path: the match finder and the token emission in plain torch, the greedy
parse and the three decode kernels in CUDA C++ under ``csrc/``.  The wire
format is the JAX package's, so streams interchange in both directions.
The block API at the top is ``minlz_tpu``'s.
"""

from .minlz import (
    LEVEL_BALANCED,
    LEVEL_FASTEST,
    LEVEL_SMALLEST,
    LEVEL_SUPER_FAST,
    MAX_BLOCK_SIZE,
    CorruptError,
    TooLargeError,
    UnsupportedError,
    max_encoded_len,
)
from .block import (
    append_decoded,
    append_encoded,
    decode,
    decoded_len,
    encode,
    is_minlz,
    try_encode,
)
from ._device import resolve_device
from .ops.device_codec import DeviceCodec
from .stream import Reader, Writer

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "try_encode",
    "append_encoded",
    "append_decoded",
    "decoded_len",
    "is_minlz",
    "max_encoded_len",
    "MAX_BLOCK_SIZE",
    "LEVEL_SUPER_FAST",
    "LEVEL_FASTEST",
    "LEVEL_BALANCED",
    "LEVEL_SMALLEST",
    "CorruptError",
    "TooLargeError",
    "UnsupportedError",
    "DeviceCodec",
    "Reader",
    "Writer",
    "resolve_device",
]
