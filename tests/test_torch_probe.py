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
