"""The windowed model of the greedy kernel (minlz_tpu_torch.ops.greedy_model)
against the position-step plain version (greedy.greedy_parse_plain) and the
JAX package's lax.scan (minlz_tpu.ops.encode_kernel.greedy_parse): all four
outputs, exactly, at window sizes 64, 256, the kernel's own and 4096, on
random proposals at segment sizes 1000, 4096 and 16384, on the cases of
test_torch_greedy.py and on proposals made to corner the chain.  Tolerance
0: every compared value is an integer."""

import functools

import numpy as np
import pytest
import torch

from minlz_tpu.ops import encode_kernel as jek
from minlz_tpu_torch.ops import greedy as tg
from minlz_tpu_torch.ops import greedy_model as gm

from conftest import TESTDATA
from test_torch_common import (GREEDY_WINDOWS, both, greedy_edge_cases,
                               random_proposals)
from test_torch_greedy import CASES

SEGS = (1000, 4096, 16384)
EDGE_SEG = 16384 + 100
NAMES = ("take", "tok_off", "tok_len", "is_rep")


def _twain() -> bytes:
    with open(f"{TESTDATA}/Mark.Twain-Tom.Sawyer.txt", "rb") as f:
        return f.read()


def _random(seg):
    """Tame and hostile lanes at one segment size."""
    tame = random_proposals(seg, 3, seg, hostile=False)
    hostile = random_proposals(seg + 1, 3, seg, hostile=True)
    return tuple(np.concatenate(a) for a in zip(tame, hostile))


@functools.lru_cache(maxsize=None)
def _inputs(kind, name):
    if kind == "random":
        return _random(name)
    if kind == "case":
        return CASES[name](_twain())
    return greedy_edge_cases(EDGE_SEG)[name]


@functools.lru_cache(maxsize=None)
def _references(kind, name):
    """(plain, JAX scan) outputs, each four [lanes, seg] numpy arrays; the
    two must agree."""
    off, length = _inputs(kind, name)
    seg = off.shape[1]
    (joff, jlen), (toff, tlen) = both(off, length)
    plain = [t.numpy() for t in tg.greedy_parse_plain(toff, tlen, seg)]
    scan = [np.asarray(a) for a in jek.greedy_parse(joff, jlen, seg)]
    for nm, p, s in zip(NAMES, plain, scan):
        np.testing.assert_array_equal(p, s, err_msg=nm)
    return plain


def _check_model(kind, name, window):
    off, length = _inputs(kind, name)
    seg = off.shape[1]
    want = _references(kind, name)
    got, info = gm.greedy_parse_model(torch.from_numpy(off),
                                      torch.from_numpy(length), seg, window)
    for nm, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=nm)
    # One chain hop per token, at most ceil(window / 4) hops a window.
    assert info["tokens"] == int(want[0].sum())
    assert info["max_hops"] <= -(-window // 4)
    assert info["windows"] <= off.shape[0] * -(-seg // window)
    return info


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("window", GREEDY_WINDOWS)
def test_model_matches_plain_and_jax_on_random_lanes(window, seg):
    info = _check_model("random", seg, window)
    assert info["tokens"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("window", GREEDY_WINDOWS)
def test_model_matches_plain_and_jax_on_greedy_cases(window, case):
    _check_model("case", case, window)


@pytest.mark.parametrize("edge", sorted(greedy_edge_cases(EDGE_SEG)))
@pytest.mark.parametrize("window", GREEDY_WINDOWS)
def test_model_matches_plain_and_jax_on_edge_cases(window, edge):
    _check_model("edge", edge, window)


def test_edge_cases_corner_what_they_name():
    """The edge inputs hold what their names promise, read off the plain
    version's outputs."""
    cases = greedy_edge_cases(EDGE_SEG)
    out = {}
    for name in ("no_candidates", "every_length_4", "first_off_minus_one",
                 "max_len_first", "ends_on_window_boundary",
                 "crosses_two_windows"):
        out[name] = _references("edge", name)
    assert out["no_candidates"][0].sum() == 0
    take4 = out["every_length_4"][0]
    assert (take4[:, ::4] == 1).all() and take4.sum() == take4.size // 4
    assert (out["first_off_minus_one"][3][:, 0] == 1).all()
    assert (out["max_len_first"][0].sum(axis=1) == 1).all()
    ends = out["ends_on_window_boundary"][0]
    for lane, w in enumerate(GREEDY_WINDOWS):
        assert ends[lane, w - 8] == 1 and ends[lane, w] == 1
        assert ends[lane, w - 4] == 0
    cross = out["crosses_two_windows"][0]
    for lane, w in enumerate(w for w in GREEDY_WINDOWS
                             if 3 * w < EDGE_SEG):
        assert cross[lane, w - 4] == 1
        assert cross[lane, w:3 * w + 4].sum() == 0
        assert cross[lane, 3 * w + 4] == 1
    off, length = cases["min_len"]
    assert (length == np.iinfo(np.int32).min).any()


def test_model_rejects_a_window_below_one():
    off = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        gm.greedy_parse_model(off, off, 8, 0)
