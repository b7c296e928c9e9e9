"""The reference's seeded fuzz campaigns on the port: FuzzEncodingBlocks and
FuzzStreamDecode (tests/test_fuzz.py, whose input generator, mutator and
iteration count are imported, so the two campaigns stay the same).

Streams are written by the port's Writer on the host (``device=None``, the
JAX Writer's default: the same bytes as ``minlz_tpu``'s) and on the CPU
device path (``device="cpu"``: every block carries parse hints), and read
back through ``Reader(device="cpu")``, which decodes hinted blocks through
the device codec's plain versions.  A mutated stream must raise a clean
error or give the exact bytes; a single bit flip inside the stream must be
caught or leave the bytes exact, never a crash or silent corruption."""

import io

import numpy as np
import pytest

from minlz_tpu import block as jblock
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch import block as blockapi
from minlz_tpu_torch.minlz import (CorruptError, TooLargeError,
                                   UnsupportedError)
from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.stream import Reader, Writer

from test_fuzz import ITERS, _gen_input, _mutate

CLEAN_ERRORS = (CorruptError, UnsupportedError, TooLargeError, ValueError,
                EOFError, IndexError, OverflowError)


def test_fuzz_encoding_blocks():
    """Random inputs x every level: the port's block encoder gives the JAX
    package's bytes, and they round-trip through the port's decoder and
    its spec oracle."""
    rng = np.random.default_rng(0xF00D)
    for it in range(max(ITERS // 4, 10)):
        data = _gen_input(rng, int(rng.integers(1, 40_000)))
        for level in (-1, 1, 2, 3):
            enc = blockapi.encode(data, level)
            assert enc == jblock.encode(data, level), (it, level)
            assert blockapi.decode(enc) == data, (it, level)
            assert odec.decode_block(enc) == data, (it, level)


def _read(stream, **opts):
    """(bytes, None) or (None, the clean error) of Reader(device="cpu")."""
    try:
        return Reader(io.BytesIO(stream), device="cpu", **opts).readall(), None
    except CLEAN_ERRORS as exc:
        return None, exc


@pytest.mark.parametrize("device", [None, "cpu"])
def test_fuzz_stream_decode(device):
    rng = np.random.default_rng(0xCAFE)
    base = _gen_input(rng, 60_000)
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, add_index=True,
                device=device) as w:
        w.write(base)
    enc = buf.getvalue()
    reader = Reader(io.BytesIO(enc), device="cpu")
    before = reader.codec.blocks_decoded  # the process's codec on the CPU
    assert reader.readall() == base
    if device is None:
        jbuf = io.BytesIO()
        with JaxWriter(jbuf, block_size=8 << 10, add_index=True) as w:
            w.write(base)
        assert enc == jbuf.getvalue()
    else:
        # all on the device path
        assert reader.codec.blocks_decoded - before == 8
    raised = 0
    for it in range(ITERS):
        bad = _mutate(rng, enc)
        out, err = _read(bad, ignore_missing_eof=True)
        assert err is not None or out == base, f"mutation {it}: wrong bytes"
        raised += err is not None
    assert raised >= ITERS // 2
    # Single bit flips inside the stream: caught, or the bytes are exact.
    caught = 0
    for it in range(ITERS // 2):
        pos = int(rng.integers(20, len(enc) - 12))
        bad = bytearray(enc)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        out, err = _read(bytes(bad))
        assert err is not None or out == base, f"silent corruption at {pos}"
        caught += err is not None
    assert caught >= ITERS // 4
