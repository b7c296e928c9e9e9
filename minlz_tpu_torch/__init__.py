"""TPU-MinLZ on PyTorch and CUDA: the device codec of ``minlz_tpu``, ported.

The JAX package ``minlz_tpu`` stays the reference.  This package stands on
its own: it imports torch, never jax, and nothing of ``minlz_tpu``.  It
keeps its own copy of the host layer (``minlz``, ``oracle``, ``block``,
``snappy``, ``native``, ``stream``) and ports the device path: the match
finder and the token emission in plain torch, the greedy parse and the
three decode kernels in CUDA C++ under ``csrc/``.  The wire format is the
JAX package's, so streams interchange in both directions.
"""

from ._device import resolve_device
from .ops.device_codec import DeviceCodec
from .stream import Reader, Writer

__all__ = ["DeviceCodec", "Reader", "Writer", "resolve_device"]
