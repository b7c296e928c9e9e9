"""Greedy parse parity: minlz_tpu_torch.ops.greedy against the JAX package's
lax.scan (encode_kernel.greedy_parse) and its Pallas kernel in interpret
mode (encode_kernel.greedy_parse_compact), on real proposals and on random
and hostile int32.  Tolerance 0: all outputs are integers.  On the CPU the
port's wrapper runs its plain torch version."""

import numpy as np
import pytest
import torch

from minlz_tpu.ops import encode_kernel as jek
from minlz_tpu_torch.ops import greedy as tg

from test_torch_common import (both, greedy_reference, random_proposals,
                               real_proposals)

CASES = {
    "real_l2": lambda t: real_proposals((t * 3)[: 64 << 10]),
    "real_l1_clamped": lambda t: real_proposals(
        bytes(3000) + t[: 50000], rng=32 << 10, level=1),
    "tame": lambda t: random_proposals(1, 5, 512, hostile=False),
    "hostile": lambda t: random_proposals(2, 7, 1024, hostile=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_parse_matches_jax_scan(twain, case):
    off, length = CASES[case](twain)
    seg = off.shape[1]
    (joff, jlen), (toff, tlen) = both(off, length)
    want = jek.greedy_parse(joff, jlen, seg)
    got = tg.greedy_parse(toff, tlen, seg)
    for name, g, w in zip(("take", "tok_off", "tok_len", "is_rep"), got,
                          want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_parse_compact_matches_jax_pallas(twain, case):
    off, length = CASES[case](twain)
    seg = off.shape[1]
    (joff, jlen), (toff, tlen) = both(off, length)
    *want, wcount = jek.greedy_parse_compact(joff, jlen, seg)
    *got, count = tg.greedy_parse_compact(toff, tlen, seg)
    assert count == int(wcount) > 0
    for name, g, w in zip(("pos", "off", "len", "is_rep"), got, want):
        assert g.shape == (count,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:count],
                                      err_msg=name)


@pytest.mark.parametrize("hostile", [False, True])
def test_greedy_parse_matches_sequential_reference(hostile):
    off, length = random_proposals(3, 6, 200, hostile)
    got = tg.greedy_parse(torch.from_numpy(off), torch.from_numpy(length),
                          200)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  greedy_reference(off, length))


def test_greedy_parse_rejects_what_the_kernel_does_not_take():
    off = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tg.greedy_parse(off.to(torch.int64), off, 64)
    with pytest.raises(ValueError, match=r"\[B, 32\]"):
        tg.greedy_parse(off, off, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tg.greedy_parse(off.t().contiguous().t(), off, 64)
    with pytest.raises(ValueError, match="int32"):
        tg.greedy_parse(off[0], off[0], 64)
