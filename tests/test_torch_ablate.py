"""The port's kernel 9 (ops/probe.py::ablate_exec, five variants) against the
Pallas kernel of scripts/ablate_exec.py in interpret mode, on a seeded
non-zero arena.  Tolerance 0: bytes.

What is compared follows from the JAX kernel's own state.  Its accumulator
row is never initialised and is carried across row boundaries, so the bytes
of a chain's last row beyond its final cursor are stale: ``full``, ``onewin``
and ``norealign`` are compared on every chain's span [start, final cursor).
``nomask`` and ``minimal`` store whole rows taken from the arena, so their
whole arena is determined and compared.  The sizes stay where both packages
are determined: no chain outgrows its region or reaches the 2000 bytes
before its neighbour's start, and no chain but chain 0 reads a literal that
runs past the literal rows into chain 0's first bytes."""

import numpy as np
import pytest
import torch

from minlz_tpu.ops.exec_chain import OP_T, tile_words
from minlz_tpu_torch.ops import probe

from test_torch_probe import Capture, T, jax_script

CHAIN_ROWS = 64      # the JAX script's fixed region: 32 KiB per chain
BASE = 8 * 512       # first byte after the literal rows
SIZES = [(1, 300), (2, 600), (3, 1200), (4, 2048)]


def detile(ops_flat, nchain, n):
    """The JAX script's op tiles -> [nchain, n, 3]."""
    cap = -(-n // OP_T) * OP_T
    tiles = ops_flat.reshape(cap // OP_T, tile_words(nchain))
    ops = tiles[:, :nchain * OP_T * 3].reshape(cap // OP_T, nchain, OP_T, 3)
    return ops.transpose(1, 0, 2, 3).reshape(nchain, cap, 3)[:, :n]


def chain_bytes(ops):
    a = ops[..., 0]
    return ((a & 0x3FFF) + ((a >> 14) & 0x3FFF)).sum(1)


def run_both(variant, nchain, n):
    """(JAX arena bytes, port arena bytes, ops) on the same inputs."""
    ae = jax_script("ablate_exec")
    counts, ops, arena = probe.ablate_inputs(nchain, n, CHAIN_ROWS,
                                             fill=True)
    total = chain_bytes(ops)
    assert total.max() <= CHAIN_ROWS * 512 - 2000
    llen = ops[..., 0] & 0x3FFF
    assert (ops[1:, :, 2] + llen[1:] <= BASE).all()
    cap = ae.timed_device = Capture({2: arena})
    ae.run(variant, nchain=nchain, ops_per_chain=n)
    np.testing.assert_array_equal(detile(cap.args[1], nchain, n), ops)
    assert cap.result.shape == arena.shape
    out = probe.ablate_exec(T(counts), T(ops), T(arena), variant,
                            chain_rows=CHAIN_ROWS).numpy()
    return (cap.result.view(np.uint8).reshape(-1),
            out.view(np.uint8).reshape(-1), ops)


def spans(ops):
    for ch, total in enumerate(chain_bytes(ops)):
        lo = BASE + ch * CHAIN_ROWS * 512
        yield lo, lo + int(total)


@pytest.mark.parametrize("nchain,n", SIZES)
@pytest.mark.parametrize("variant", ["full", "onewin", "norealign"])
def test_masked_variants_match_jax_on_every_span(variant, nchain, n, capsys):
    jax_b, port_b, ops = run_both(variant, nchain, n)
    for lo, hi in spans(ops):
        np.testing.assert_array_equal(port_b[lo:hi], jax_b[lo:hi])
        assert port_b[lo:hi].any()
    # The port writes nothing beyond a chain's cursor or outside its region.
    arena_b = probe.ablate_inputs(nchain, n, CHAIN_ROWS, fill=True)[2].view(
        np.uint8).reshape(-1)
    untouched = np.ones(arena_b.size, bool)
    for lo, hi in spans(ops):
        untouched[lo:hi] = False
    np.testing.assert_array_equal(port_b[untouched], arena_b[untouched])


@pytest.mark.parametrize("nchain,n", SIZES)
@pytest.mark.parametrize("variant", ["nomask", "minimal"])
def test_row_variants_match_jax_on_the_whole_arena(variant, nchain, n,
                                                   capsys):
    jax_b, port_b, _ = run_both(variant, nchain, n)
    np.testing.assert_array_equal(port_b, jax_b)


def lz_reference(ops, arena, chain_rows):
    """An independent byte-by-byte LZ loop: literals, then a copy that may
    overlap its own output."""
    inp = arena.view(np.uint8).reshape(-1)
    out = inp.copy()
    for ch in range(ops.shape[0]):
        cur = BASE + ch * chain_rows * 512
        start = cur
        for a, off, lit in ops[ch].tolist():
            for i in range(a & 0x3FFF):
                out[cur] = inp[lit + i] if lit + i < start else out[lit + i]
                cur += 1
            for _ in range((a >> 14) & 0x3FFF):
                s = cur - max(off, 1)
                out[cur] = out[s] if s >= start else inp[s]
                cur += 1
    return out


@pytest.mark.parametrize("nchain,n,chain_rows", [(2, 700, 64), (3, 150, 4)])
def test_full_and_onewin_are_the_lz_copy(nchain, n, chain_rows):
    counts, ops, arena = probe.ablate_inputs(nchain, n, chain_rows, fill=True)
    # Some copies that overlap their own output, some long ones.
    g = np.random.default_rng(7)
    pick = g.random((nchain, n)) < 0.15
    long_a = g.integers(0, 6, (nchain, n)) | (g.integers(20, 90, (nchain, n))
                                              << 14)
    ops[..., 0] = np.where(pick, long_a, ops[..., 0])
    ops[..., 1] = np.where(pick, g.integers(1, 12, (nchain, n)), ops[..., 1])
    big = chain_rows * 512 < chain_bytes(ops).max()
    if big:
        with pytest.raises(ValueError):
            probe.ablate_exec(T(counts), T(ops), T(arena), "full",
                              chain_rows=chain_rows)
        return
    want = lz_reference(ops, arena, chain_rows)
    for variant in ("full", "onewin"):
        got = probe.ablate_exec(T(counts), T(ops), T(arena), variant,
                                chain_rows=chain_rows).numpy()
        np.testing.assert_array_equal(got.view(np.uint8).reshape(-1), want)


def test_counts_and_checks():
    counts, ops, arena = probe.ablate_inputs(2, 40, 4, fill=True)
    part = counts.copy()
    part[1] = 10
    got = probe.ablate_exec(T(part), T(ops), T(arena), "full").numpy()
    cut = ops.copy()
    cut[1, 10:] = 0
    np.testing.assert_array_equal(
        got, probe.ablate_exec(T(counts), T(cut), T(arena), "full").numpy())
    with pytest.raises(ValueError):
        probe.ablate_exec(T(counts), T(ops), T(arena), "fast")
    with pytest.raises(ValueError):
        probe.ablate_exec(T(counts), T(ops), T(arena[:9]), "full")
    with pytest.raises(ValueError):
        probe.ablate_exec(T(counts), T(ops[:, :, :2].copy()), T(arena))


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_chains_walked_alone_merge_to_the_lockstep_walk(variant):
    """The premise of a block a chain: on the scripts' inputs (8 chains,
    regions of 128 rows) each chain walked alone by the plain version, its
    region where it is in the lockstep walk, changes only its region, and
    the regions merged equal the lockstep walk."""
    nchain, n, rows = 8, 256, 128
    counts, ops, arena = probe.ablate_inputs(nchain, n, rows, fill=True)
    want = probe.ablate_exec_plain(T(counts), T(ops), T(arena), variant,
                                   chain_rows=rows).numpy()
    merged = arena.copy()
    for ch in range(nchain):
        base = 8 + ch * rows
        alone = probe.ablate_exec_plain(
            T(counts[ch:ch + 1].copy()), T(ops[ch:ch + 1].copy()), T(arena),
            variant, out_base_row=base, chain_rows=rows).numpy()
        outside = np.ones(arena.shape[0], bool)
        outside[base:base + rows] = False
        np.testing.assert_array_equal(alone[outside], arena[outside])
        merged[base:base + rows] = alone[base:base + rows]
    np.testing.assert_array_equal(merged, want)
    assert (want != arena).any(axis=1).sum() >= nchain


def test_regions_must_fit_shared_memory():
    """A region is staged in one block's shared memory: 454 rows fit, 455
    raise, on any device."""
    assert 454 * 512 <= probe.SHARED_LIMIT < 455 * 512
    for rows in (454, 455):
        counts, ops, arena = probe.ablate_inputs(1, 20, rows, fill=True)
        args = (T(counts), T(ops), T(arena), "full")
        if rows == 454:
            np.testing.assert_array_equal(
                probe.ablate_exec(*args, chain_rows=rows).numpy(),
                probe.ablate_exec_plain(*args, chain_rows=rows).numpy())
        else:
            with pytest.raises(ValueError, match="region of 455 rows"):
                probe.ablate_exec(*args, chain_rows=rows)
            probe.ablate_exec_plain(*args, chain_rows=rows)
