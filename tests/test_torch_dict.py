"""Dictionary parity: minlz_tpu_torch.dict against minlz_tpu.dict, recast
from tests/test_dict.py.  Encoded blocks, decoded bytes and the marshalled
dictionary equal the JAX package's exactly (tolerance 0: bytes)."""

import pytest

from minlz_tpu import dict as jdict
from minlz_tpu_torch import block as blockapi
from minlz_tpu_torch import dict as tdict
from minlz_tpu_torch.native.codec import get_codec


def _both(dict_bytes, data, **kw):
    """(port block, JAX block) for the same input."""
    got = tdict.encode_with_dict(data, tdict.Dict(dict_bytes), **kw)
    want = jdict.encode_with_dict(data, jdict.Dict(dict_bytes), **kw)
    return got, want


@pytest.mark.parametrize("level", [-1, 1, 2, 3])
def test_levels_match_jax_and_beat_nondict(twain, level):
    d = twain[:8192]
    data = twain[4096:40000]
    got, want = _both(d, data, level=level)
    assert got == want
    assert tdict.decode_with_dict(got, tdict.Dict(d)) == data
    assert get_codec().decode_block_dict(got, d) == data
    assert len(got) < len(blockapi.encode(data, level=level))


@pytest.mark.parametrize("case", ["overlap", "disjoint", "empty", "tiny",
                                  "short"])
def test_cases_match_jax(twain, case):
    d, data = {
        "overlap": (twain[:8000], twain[6000:14000]),
        "disjoint": (b"\x01\x02\x03\x04" * 64, twain[:5000]),
        "empty": (twain[:100], b""),
        "tiny": (twain[:100], b"abc"),
        "short": (twain[:100], twain[:20]),
    }[case]
    got, want = _both(d, data)
    assert got == want
    assert tdict.decode_with_dict(got, tdict.Dict(d)) == data
    assert jdict.decode_with_dict(got, jdict.Dict(d)) == data


def test_python_body_matches_jax(twain):
    """The greedy Python encoder behind the native one (used when the
    native library is missing) gives the JAX package's bytes."""
    d = twain[:4096]
    combined = d + twain[3000:12000]
    got = tdict._encode_dict_body(combined, len(d), 14)
    assert got == jdict._encode_dict_body(combined, len(d), 14)
    src = twain[3000:12000]
    from minlz_tpu_torch.minlz import put_uvarint

    block = b"\x00" + put_uvarint(len(src)) + bytes(got)
    assert tdict.decode_with_dict(block, tdict.Dict(d)) == src


def test_marshal_and_limits(twain):
    d = tdict.Dict(twain[:1000])
    assert d.marshal() == jdict.Dict(twain[:1000]).marshal()
    assert tdict.Dict.load(d.marshal()).bytes == d.bytes
    assert len(d) == 1000
    for bad in (b"short", b"x" * 70000):
        with pytest.raises(ValueError):
            tdict.Dict(bad)
    from minlz_tpu_torch.minlz import CorruptError

    with pytest.raises(CorruptError):
        tdict.Dict.load(b"MZDICT2" + d.marshal()[7:])
    with pytest.raises(CorruptError):
        tdict.Dict.load(d.marshal()[:-1])
