"""The port's probe kernels 10-13 (ops/probe.py: probe_scalar, probe_gather,
probe_taa, probe_chain_body) against the Pallas kernels of
scripts/kernel_probe.py and scripts/exec_probe.py, and bench.timed_device.

The JAX side runs as its scripts run off the TPU: in interpret mode.  The
scripts print and return nothing, so their module-level ``timed_device`` is
replaced by a function that calls the jitted kernel once and keeps the
result; it also swaps the scripts' all-zero (or small) data argument for the
port generator's seeded non-zero (or full-range) one.  The same numpy arrays
go into the port as tensors.  Tolerance 0: every compared value is an
integer.  The two chain kernels return row 0 only on the JAX side; with four
rows per chain, chain 0 stores into row 0 many times."""

import os
import sys

import numpy as np
import pytest
import torch

from minlz_tpu_torch import bench as tbench
from minlz_tpu_torch.ops import probe

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")

T = torch.from_numpy


class Capture:
    """Stands in for a JAX script's ``timed_device``: one call, result and
    arguments kept; ``swap`` maps an argument's index to its replacement."""

    def __init__(self, swap=None):
        self.swap = swap or {}

    def __call__(self, fn, args, iters, chain=32):
        import jax.numpy as jnp

        args = list(args)
        for i, value in self.swap.items():
            args[i] = jnp.asarray(value)
        self.args = [np.asarray(a) for a in args]
        self.result = np.asarray(fn(*args))
        return 1.0, self.result


def jax_script(name):
    """A module of scripts/, importable by its file name."""
    import importlib

    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_probe_scalar_matches_jax(n_chains, capsys):
    kp = jax_script("kernel_probe")
    rows, buf = probe.scalar_inputs(64, n_chains, 4 * n_chains, fill=True)
    cap = kp.timed_device = Capture({1: buf})
    kp.bench_scalar(n_ops=64, n_chains=n_chains, rows=4 * n_chains)
    np.testing.assert_array_equal(cap.args[0], rows)
    out = probe.probe_scalar(T(rows), T(buf), n_chains).numpy()
    np.testing.assert_array_equal(out[0], cap.result[0])
    assert (out[0] != buf[0]).all()          # row 0 carries the walk
    assert (out != buf).any(axis=1).sum() > n_chains


@pytest.mark.parametrize("tbl_vregs", [1, 2, 9])
def test_probe_gather_matches_jax(tbl_vregs, capsys):
    kp = jax_script("kernel_probe")
    tbl, idx = probe.gather_inputs(8, tbl_vregs, wrap=True)
    cap = kp.timed_device = Capture({0: tbl})
    kp.bench_gather(n_iters=8, tbl_vregs=tbl_vregs)
    np.testing.assert_array_equal(cap.args[1], idx)
    out = probe.probe_gather(T(tbl), T(idx)).numpy()
    np.testing.assert_array_equal(out, cap.result)
    exact = tbl.reshape(-1).astype(np.int64)[idx].reshape(8, 8, 128).sum(0)
    assert (np.abs(exact) > np.iinfo(np.int32).max).any()   # the sum wrapped
    # The script's own small table: the generators agree without the swap.
    small, _ = probe.gather_inputs(8, tbl_vregs)
    cap = kp.timed_device = Capture()
    kp.bench_gather(n_iters=8, tbl_vregs=tbl_vregs)
    np.testing.assert_array_equal(cap.args[0], small)
    np.testing.assert_array_equal(
        probe.probe_gather(T(small), T(idx)).numpy(), cap.result)


def test_probe_taa_matches_jax(capsys):
    kp = jax_script("kernel_probe")
    a, idx = probe.taa_inputs(8, wrap=True)
    cap = kp.timed_device = Capture({0: a})
    kp.bench_taa(n_iters=8)
    np.testing.assert_array_equal(cap.args[1], idx)
    out = probe.probe_taa(T(a), T(idx)).numpy()
    np.testing.assert_array_equal(out, cap.result)
    exact = np.take_along_axis(
        np.broadcast_to(a.astype(np.int64), (8, 8, 128)),
        idx.reshape(8, 8, 128).astype(np.int64), axis=2).sum(0)
    assert (np.abs(exact) > np.iinfo(np.int32).max).any()
    small, _ = probe.taa_inputs(8)
    cap = kp.timed_device = Capture()
    kp.bench_taa(n_iters=8)
    np.testing.assert_array_equal(cap.args[0], small)


# Every step masks its row down to 64 bytes, so a long walk decays to zeros;
# these (steps, rows per chain) leave row 0 non-zero and changed.
@pytest.mark.parametrize("n_chains", [1, 2, 4])
@pytest.mark.parametrize("n_ops,rows_per_chain", [(8, 4), (16, 16), (24, 16)])
@pytest.mark.parametrize("mode", ["minimal", "taa", "roll"])
def test_probe_chain_body_matches_jax(mode, n_ops, rows_per_chain, n_chains,
                                      capsys):
    ep = jax_script("exec_probe")
    rows = rows_per_chain * n_chains
    meta, buf = probe.chain_body_inputs(n_ops, n_chains, rows, fill=True)
    cap = ep.timed_device = Capture({1: buf})
    ep.bench_chain_body(n_ops=n_ops, n_chains=n_chains, rows=rows, mode=mode)
    np.testing.assert_array_equal(cap.args[0], meta)
    out = probe.probe_chain_body(T(meta), T(buf), n_chains, mode).numpy()
    np.testing.assert_array_equal(out[0], cap.result[0])
    assert (out[0] != buf[0]).any() and out[0].any()
    if mode != "minimal":
        both = probe.probe_chain_body(T(meta), T(buf), n_chains,
                                      "realign").numpy()
        np.testing.assert_array_equal(out, both)


def test_chain_step_references():
    """One step of each chain kernel, written out in numpy."""
    buf = probe._fill((6, 128), 3)
    out = probe.probe_scalar(T(np.array([4, 1], np.int32)), T(buf),
                             1).numpy()
    want = buf.copy()
    want[1] = (buf[4].astype(np.int64) + 1).astype(np.int32)
    np.testing.assert_array_equal(out, want)

    for off in (0, 5, 130, 470, 511):
        meta = np.array([2, 2, off], np.int32)        # dst is a source row
        got = probe.probe_chain_body(T(meta), T(buf), 1).numpy()
        joined = np.concatenate([buf[2], buf[3]]).view(np.uint8)
        window = joined[4 * (off >> 2):4 * (off >> 2) + 512].copy()
        keep = np.zeros(512, bool)
        keep[off:min(off + 64, 512)] = True
        want = buf.copy()
        want[2] = np.where(keep, window, 0).astype(np.uint8).view(np.int32)
        np.testing.assert_array_equal(got, want)


def test_probe_inputs_are_clamped_and_checked():
    buf = probe._fill((4, 128), 4)
    wild = np.array([-7, 99, 3, -1], np.int32)            # two steps
    tame = np.array([0, 3, 3, 0], np.int32)
    np.testing.assert_array_equal(
        probe.probe_scalar(T(wild), T(buf), 1).numpy(),
        probe.probe_scalar(T(tame), T(buf), 1).numpy())
    tbl, idx = probe.gather_inputs(2, 1, wrap=True)
    far = idx.copy()
    far[0, 0], far[1, 1] = -5, 1 << 30
    near = idx.copy()
    near[0, 0], near[1, 1] = 0, tbl.size - 1
    np.testing.assert_array_equal(
        probe.probe_gather(T(tbl), T(far)).numpy(),
        probe.probe_gather(T(tbl), T(near)).numpy())
    with pytest.raises(ValueError):
        probe.probe_scalar(T(tame), T(buf), 33)
    with pytest.raises(ValueError):
        probe.probe_scalar(T(tame), T(probe._fill((4096, 128), 5)), 1,
                           space="shared")
    with pytest.raises(ValueError):
        probe.probe_chain_body(T(tame), T(buf), 1, mode="shift")
    with pytest.raises(ValueError):
        probe.probe_gather(T(tbl.astype(np.int64)), T(idx))
    with pytest.raises(ValueError):
        probe.probe_taa(T(tbl[:4]), T(idx))


def test_timed_device_on_the_cpu():
    calls = []

    def fn(x, k):
        calls.append(k)
        return x + k

    t, r = tbench.timed_device(fn, (torch.arange(4), 2), 3)
    assert t > 0 and r.tolist() == [2, 3, 4, 5]
    assert len(calls) == 3                      # no warm-up call on the CPU
    t, r = tbench.timed_device(fn, (torch.arange(4), 1), 2, chain=4,
                               device="cpu")
    assert t > 0 and r.tolist() == [1, 2, 3, 4] and len(calls) == 3 + 8
    assert tbench.card("cpu") == "cpu"
    assert tbench.make_corpus(1000) == tbench.make_corpus(2000)[:1000]


# ---- the chain body a block a chain: what the kernel's design relies on ----

def chain_steps(meta, n_chains):
    """[n_chains, n_ops, 3] int64 of meta."""
    return meta.reshape(n_chains, -1, 3).astype(np.int64)


def strayed(meta, rows, n_chains):
    """meta with every row number moved on by half a region, modulo rows:
    the chains still own disjoint rows, but half of each chain's rows lie
    in the next chain's region."""
    shift = rows // n_chains // 2
    out = chain_steps(meta, n_chains).copy()
    out[..., :2] = (out[..., :2] + shift) % rows
    return out.astype(np.int32).reshape(-1)


def body_step(r0, r1, off, mode):
    """One step of the chain body in numpy: the window, then the mask."""
    if probe.MODES[mode]:
        w = np.concatenate([r0, r1])[off >> 2:(off >> 2) + 128]
    else:
        w = (r0.astype(np.int64) + r1).astype(np.uint32).view(np.int32)
    keep = np.zeros(512, bool)
    keep[off:min(off + 64, 512)] = True
    return w & np.where(keep, 0xFF, 0).astype(np.uint8).view(np.int32)


def block_model(meta, buf, n_chains, mode):
    """The shared-space kernel's bookkeeping in numpy, on the schedule that
    is hardest for it: every block stages its chain's region, then the
    blocks walk one after another in reverse order, then every block writes
    back.  A block reads and stores the rows of its region in its stage and
    every other row in the buffer, and writes back the region rows it
    stored."""
    rows = buf.shape[0]
    r = rows // n_chains
    out = buf.copy()
    steps = chain_steps(meta, n_chains)
    stages = [out[c * r:(c + 1) * r].copy() for c in range(n_chains)]
    stored = [np.zeros(r, bool) for _ in range(n_chains)]
    for c in reversed(range(n_chains)):
        lo, stage = c * r, stages[c]

        def row(i):
            return (stage[i - lo] if lo <= i < lo + r else out[i]).copy()

        for src, dst, off in steps[c]:
            src = min(max(src, 0), rows - 1)
            dst = min(max(dst, 0), rows - 1)
            val = body_step(row(src), row(min(src + 1, rows - 1)),
                            int(off) & 511, mode)
            if lo <= dst < lo + r:
                stage[dst - lo] = val
                stored[c][dst - lo] = True
            else:
                out[dst] = val
    for c in range(n_chains):
        out[c * r:(c + 1) * r][stored[c]] = stages[c][stored[c]]
    return out


@pytest.mark.parametrize("mode", ["minimal", "realign"])
def test_chain_body_chains_keep_to_their_regions(mode):
    """On the scripts' inputs (16 chains over 4096 rows) every row of chain
    c lies in its region; each chain walked alone by the plain version
    changes only its region and reads nothing outside it, and the regions
    merged equal the lockstep walk."""
    n_chains, rows, n_ops = 16, 4096, 40
    r = rows // n_chains
    meta, buf = probe.chain_body_inputs(n_ops, n_chains, rows, fill=True)
    steps = chain_steps(meta, n_chains)
    lo = (np.arange(n_chains) * r)[:, None]
    assert ((steps[..., 0] >= lo) & (steps[..., 0] + 1 < lo + r)).all()
    assert ((steps[..., 1] >= lo) & (steps[..., 1] < lo + r)).all()
    want = probe.probe_chain_body_plain(T(meta), T(buf), n_chains,
                                        mode).numpy()
    other = probe._fill(buf.shape, 21)
    merged = buf.copy()
    for c in range(n_chains):
        region = slice(c * r, (c + 1) * r)
        alone = probe.probe_chain_body_plain(
            T(steps[c].astype(np.int32).reshape(-1)), T(buf), 1,
            mode).numpy()
        outside = np.ones(rows, bool)
        outside[region] = False
        np.testing.assert_array_equal(alone[outside], buf[outside])
        # Another buffer around the region: the region walks the same.
        around = other.copy()
        around[region] = buf[region]
        np.testing.assert_array_equal(
            probe.probe_chain_body_plain(
                T(steps[c].astype(np.int32).reshape(-1)), T(around), 1,
                mode).numpy()[region], alone[region])
        merged[region] = alone[region]
    np.testing.assert_array_equal(merged, want)
    assert (want != buf).any(axis=1).sum() > n_chains
    np.testing.assert_array_equal(block_model(meta, buf, n_chains, mode),
                                  want)


@pytest.mark.parametrize("mode", ["minimal", "realign"])
@pytest.mark.parametrize("n_chains,rows", [(4, 64), (5, 83)])
def test_chain_body_rows_off_their_region_stay_exact(mode, n_chains, rows):
    """Chains that own disjoint rows but stray into the next chain's region
    (and, at 83 rows, onto the rows past the last region): each chain
    walked alone and merged by the rows it stored, and the kernel's
    bookkeeping (``block_model``), equal the lockstep walk."""
    meta, buf = probe.chain_body_inputs(30, n_chains, rows, fill=True)
    meta = strayed(meta, rows, n_chains)
    steps = chain_steps(meta, n_chains)
    r = rows // n_chains
    own = np.arange(n_chains)[:, None]
    assert (steps[..., 1] // r != own).any()        # stores off the region
    # At 83 rows also the three rows past the last region.
    assert (steps[..., :2] >= n_chains * r).any() == bool(rows % n_chains)
    touched = [set(s[:, :2].reshape(-1)) | set(np.minimum(s[:, 0] + 1,
                                                          rows - 1))
               for s in steps]
    for a in range(n_chains):
        for b in range(a):
            assert not touched[a] & touched[b]      # disjoint rows
    want = probe.probe_chain_body_plain(T(meta), T(buf), n_chains,
                                        mode).numpy()
    merged = buf.copy()
    for c in range(n_chains):
        alone = probe.probe_chain_body_plain(
            T(steps[c].astype(np.int32).reshape(-1)), T(buf), 1,
            mode).numpy()
        stored = np.unique(steps[c, :, 1])
        merged[stored] = alone[stored]
    np.testing.assert_array_equal(merged, want)
    np.testing.assert_array_equal(block_model(meta, buf, n_chains, mode),
                                  want)


def test_chain_body_shared_space_checks_each_region():
    """The shared space takes a buffer whose every region fits a block
    (with its flag bytes), not a buffer that fits one block."""
    meta, buf = probe.chain_body_inputs(8, 16, 4096, fill=True)
    assert probe.body_shared_bytes(4096, 16) == 256 * 512 + 256
    assert probe.body_shared_bytes(4096, 32) == 128 * 512 + 128
    np.testing.assert_array_equal(
        probe.probe_chain_body(T(meta), T(buf), 16, space="shared").numpy(),
        probe.probe_chain_body_plain(T(meta), T(buf), 16).numpy())
    meta8, _ = probe.chain_body_inputs(8, 8, 4096, fill=True)
    with pytest.raises(ValueError, match="region of 512 rows"):
        probe.probe_chain_body(T(meta8), T(buf), 8, space="shared")
    probe.probe_chain_body(T(meta8), T(buf), 8, space="global")
    assert (probe.body_shared_bytes(453, 1) <= probe.SHARED_LIMIT
            < probe.body_shared_bytes(454, 1))
    one = np.array([0, 1, 7], np.int32)
    probe.probe_chain_body(T(one), T(buf[:453].copy()), 1, space="shared")
    with pytest.raises(ValueError, match="region of 454 rows"):
        probe.probe_chain_body(T(one), T(buf[:454].copy()), 1,
                               space="shared")
