"""huff0 parity: minlz_tpu_torch.utils.huff0 against minlz_tpu.utils.huff0
on seeded inputs: compressed payloads, tree descriptions and decoded bytes
equal exactly (tolerance 0: bytes), with the port's native library and
with the pure-Python stream decoder."""

import numpy as np
import pytest

from minlz_tpu.utils import huff0 as jh
from minlz_tpu_torch.utils import huff0 as th


def _inputs():
    rng = np.random.default_rng(17)
    out = {}
    for trial in range(4):
        probs = np.random.default_rng(trial).dirichlet(np.ones(256) * 0.2)
        out[f"skewed{trial}"] = bytes(
            rng.choice(256, 4096, p=probs).astype(np.uint8))
    out["zipf"] = bytes((rng.zipf(1.4, 900) % 40).astype(np.uint8))
    out["few"] = bytes(rng.integers(0, 3, 5000, dtype=np.uint8))
    out["text"] = (b"the quick brown fox jumps over the lazy dog " * 60)
    out["one_symbol"] = b"\x07" * 3000
    out["random"] = bytes(rng.integers(0, 256, 2000, dtype=np.uint8))
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_compress_matches_jax(name):
    data = INPUTS[name]
    for fn in ("compress_4x", "compress_1x"):
        got = getattr(th, fn)(data)
        assert got == getattr(jh, fn)(data), fn
        if got is not None and fn == "compress_4x":
            assert th.decompress_4x(got, len(data)) == data
            assert jh.decompress_4x(got, len(data)) == data
        elif got is not None:
            assert th.decompress_1x(got, len(data)) == data


@pytest.mark.parametrize("name", ["skewed0", "zipf", "text"])
def test_tables_and_bodies_match_jax(name, monkeypatch):
    data = INPUTS[name]
    counts = th._count(data)
    assert counts == jh._count(data)
    ct = th.build_ctable(counts)
    assert ct == jh.build_ctable(counts)
    header, ctable = ct
    assert th.encode_4x(ctable, data) == jh.encode_4x(jh.build_ctable(
        counts)[1], data)
    payload = th.compress_4x(data)
    dtable, used = th.read_table(payload)
    assert (dtable, used) == jh.read_table(payload)
    assert used == len(header)
    assert th.decode_4x_body(dtable, payload[used:], len(data)) == data
    # The pure-Python stream decoder (no native library) agrees too.
    monkeypatch.setattr(th, "_native", lambda: None)
    assert th.decompress_4x(payload, len(data)) == data


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:  # the error class is what is compared
        return type(exc).__name__


def test_corrupt_input_behaves_as_jax():
    """Truncated and overwritten payloads: the same error class, or the
    same (wrong) bytes, as the JAX package; a truncated table raises."""
    data = INPUTS["skewed1"]
    payload = th.compress_4x(data)
    bad = [payload[:5], payload[:-3] + b"\xff\xff\xff", payload[:1],
           bytes([payload[0] ^ 0x80]) + payload[1:]]
    for b in bad:
        assert _outcome(th.decompress_4x, b, len(data)) == \
            _outcome(jh.decompress_4x, b, len(data))
    with pytest.raises(th.Huff0Error):
        th.read_table(payload[:1])
