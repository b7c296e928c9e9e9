"""Concurrency stress for the port's own native parse+serialize
(``minlz_tpu_torch/native``, built into ``build/minlz_tpu_torch/``): the
reference's thread stress (tests/test_native_threads.py) on the port.

``minlz_parse_serialize`` threads across segment ranges inside the call, and
ctypes releases the GIL during it; many Python threads call it and
``encode_block`` over and over, and every output is compared byte for byte
with a single-threaded baseline, which itself equals the JAX package's
native codec's.  ``minlz_tpu_torch/scripts/sanitize_native.sh`` runs this
module against a ThreadSanitizer or AddressSanitizer build."""

import concurrent.futures as cf

import pytest

from minlz_tpu_torch.minlz import put_uvarint
from minlz_tpu_torch.native.build import build_error
from minlz_tpu_torch.native.codec import get_codec
from minlz_tpu_torch.oracle import decode as odec

from test_native_threads import SEG, _dists, corpus  # noqa: F401 (fixture)


def _codec():
    codec = get_codec()
    if codec is None:
        pytest.skip(f"the port's native codec did not build: {build_error()}")
    return codec


def test_parse_serialize_thread_stress(corpus):
    from minlz_tpu.native.codec import get_codec as jax_codec

    codec = _codec()
    dists = _dists(corpus)
    baseline = [
        codec.parse_serialize(b, d, SEG) for b, d in zip(corpus, dists)
    ]
    ref = jax_codec()
    for b, d, res in zip(corpus, dists, baseline):
        body, hints = res
        blk = b"\x00" + put_uvarint(len(b)) + body
        assert odec.decode_block(blk) == b
        if ref is not None:
            assert res == ref.parse_serialize(b, d, SEG)

    def worker(k):
        i = k % len(corpus)
        return i, codec.parse_serialize(corpus[i], dists[i], SEG)

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        for i, res in ex.map(worker, range(96)):
            assert res == baseline[i], f"thread output diverged on block {i}"


def test_encode_block_thread_stress(corpus):
    codec = _codec()
    baseline = [codec.encode_block(b, 2) for b in corpus]
    for b, enc in zip(corpus, baseline):
        assert odec.decode_block(enc) == b

    def worker(k):
        i = k % len(corpus)
        return i, codec.encode_block(corpus[i], 2)

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        for i, enc in ex.map(worker, range(48)):
            assert enc == baseline[i]
