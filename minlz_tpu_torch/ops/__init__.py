"""Device operators of the port: match finding, parse, compaction,
execution and the stream-facing codec.  Exports ``decode_segments_jnp``,
the reference decoder, as ``minlz_tpu.ops`` does."""

from .decode_kernel import decode_segments_jnp

__all__ = ["decode_segments_jnp"]
