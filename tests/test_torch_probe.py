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
    with pytest.raises(ValueError, match="more than 16"):
        probe.probe_scalar(T(tame), T(probe._fill((8192, 128), 5)), 1,
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


def strayed(meta, rows, n_chains, per_step=3):
    """meta (``per_step`` entries a step, the first two row numbers) with
    every row number moved on by half a region, modulo rows: the chains
    still own disjoint rows, but half of each chain's rows lie in the next
    chain's region."""
    shift = rows // n_chains // 2
    out = meta.reshape(n_chains, -1, per_step).astype(np.int64)
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


# ---- probe_scalar a block or a cluster a chain, the gathers over the card --

@pytest.mark.parametrize("n_chains,cluster,share",
                         [(1, 16, 256), (2, 8, 256), (4, 4, 256),
                          (8, 2, 256), (16, 1, 256), (32, 1, 128)])
def test_scalar_plan_at_4096_rows(n_chains, cluster, share):
    """The TPU script's 4096 rows in the shared space at every chain count:
    a cluster of the smallest power of two whose shares fit a block."""
    plan = probe.scalar_plan(4096, n_chains, "shared")
    assert plan == (n_chains * cluster, cluster, share,
                    probe.stage_bytes(share))
    assert plan.shared_bytes <= probe.SHARED_LIMIT
    assert probe.scalar_plan(4096, n_chains, "global") == (n_chains, 1, 0, 0)


def test_scalar_plan_refuses_more_than_16_blocks():
    """A region that needs a cluster of 32 blocks raises, on the CPU too,
    through the plan and through the wrapper; 16 x 453 rows is the most a
    cluster stages."""
    assert probe.SHARE_ROWS == 453
    assert probe.scalar_plan(16 * 453, 1, "shared").cluster == 16
    with pytest.raises(ValueError, match="needs a cluster of 32 blocks"):
        probe.scalar_plan(16 * 453 + 1, 1, "shared")
    rows, buf = probe.scalar_inputs(8, 2, 2 * (16 * 453 + 1))
    with pytest.raises(ValueError, match="2 chains x 14498 rows"):
        probe.probe_scalar(T(rows), T(buf), 2, space="shared")
    np.testing.assert_array_equal(
        probe.probe_scalar(T(rows), T(buf), 2, space="global").numpy(),
        probe.probe_scalar_plain(T(rows), T(buf), 2).numpy())


def cluster_model(rows_arr, buf, n_chains, cluster):
    """The shared-space kernel of probe_scalar in numpy, on the schedule
    that is hardest for it: every block of every chain's cluster stages its
    share of the region (ceil(region / cluster) rows), then the chains walk
    one after another in reverse order, each reading and storing a row of
    its region in the stage of the rank that holds it and every other row
    in the buffer, then every block writes back the share rows that a step
    of its chain stores to (the flags come from the step list)."""
    rows = buf.shape[0]
    region = rows // n_chains
    share = max(-(-region // cluster), 1)
    out = buf.copy()
    steps = np.clip(rows_arr.reshape(n_chains, -1, 2).astype(np.int64), 0,
                    rows - 1)
    stages = {}
    for c in range(n_chains):
        for q in range(cluster):
            lo = c * region + q * share
            hi = min(lo + share, (c + 1) * region)
            stages[c, q] = (lo, out[lo:hi].copy())

    def where(c, row):
        rel = row - c * region
        if 0 <= rel < region:
            lo, stage = stages[c, rel // share]
            return stage, row - lo
        return out, row

    for c in reversed(range(n_chains)):
        for src, dst in steps[c]:
            arr, i = where(c, src)
            val = (arr[i].astype(np.int64) + 1).astype(np.uint32)
            arr, i = where(c, dst)
            arr[i] = val.view(np.int32)
    for (c, q), (lo, stage) in stages.items():
        for dst in set(steps[c, :, 1].tolist()):
            if lo <= dst < lo + len(stage):
                out[dst] = stage[dst - lo]
    return out


def alias_heavy(rows_arr, n_chains, rows):
    """Steps whose src is the previous step's dst every other step, in
    regions of a few rows."""
    steps = rows_arr.reshape(n_chains, -1, 2).copy()
    steps[:, 1::2, 0] = steps[:, 0:-1:2, 1]
    return steps.reshape(-1)


@pytest.mark.parametrize("inputs", ["script", "strayed", "alias"])
@pytest.mark.parametrize("n_chains,rows,cluster",
                         [(1, 64, 16), (2, 64, 4), (4, 64, 1), (5, 83, 4),
                          (3, 50, 4), (8, 24, 2)])
def test_scalar_cluster_walk_matches_plain(n_chains, rows, cluster, inputs):
    """The cluster's bookkeeping (``cluster_model``) equals the plain
    lockstep walk on the script's inputs, on chains that stray into the
    next region (and onto the rows past the last region), and on steps
    that read the row the step before stored, in regions of 3 rows."""
    rows_arr, buf = probe.scalar_inputs(48, n_chains, rows, fill=True)
    if inputs == "strayed":
        rows_arr = strayed(rows_arr, rows, n_chains, per_step=2)
        steps = rows_arr.reshape(n_chains, -1, 2)
        assert (steps[..., 1] // (rows // n_chains)
                != np.arange(n_chains)[:, None]).any() == (n_chains > 1)
    elif inputs == "alias":
        rows = 3 * n_chains
        rows_arr, buf = probe.scalar_inputs(48, n_chains, rows, fill=True)
        rows_arr = alias_heavy(rows_arr, n_chains, rows)
    want = probe.probe_scalar_plain(T(rows_arr), T(buf), n_chains).numpy()
    assert (want != buf).any(axis=1).sum() >= n_chains
    np.testing.assert_array_equal(
        cluster_model(rows_arr, buf, n_chains, cluster), want)
    np.testing.assert_array_equal(
        probe.probe_scalar(T(rows_arr), T(buf), n_chains, "shared").numpy(),
        want)


def split_model(lookup, idx, plan):
    """The split of probe_gather and probe_taa in numpy: ``lookup`` maps an
    iteration's indices [n_iters, 1024] (int64) to their words; block b
    sums iterations [n b / grid, n (b + 1) / grid), rank q of each cluster
    adds slice q of the cluster's sums, and the last ticket of slice q adds
    it over the clusters; every sum mod 2^32."""
    n = idx.shape[0] // 8
    picked = lookup(idx.astype(np.int64).reshape(n, probe.GATHER_ELEMS))
    parts = np.stack([picked[n * b // plan.grid:n * (b + 1) // plan.grid]
                      .sum(0) % (1 << 32) for b in range(plan.grid)])
    clusters = parts.reshape(-1, plan.cluster, probe.GATHER_ELEMS)
    slice_w = probe.GATHER_ELEMS // plan.cluster
    out = np.zeros(probe.GATHER_ELEMS, np.int64)
    for q in range(plan.cluster):
        cols = slice(q * slice_w, (q + 1) * slice_w)
        per_cluster = clusters[:, :, cols].sum(1) % (1 << 32)
        out[cols] = per_cluster.sum(0) % (1 << 32)
    return out.astype(np.uint32).view(np.int32).reshape(8, probe.ROW_WORDS)


def table_lookup(tbl):
    """probe_gather's lookup: flat indices into the table, clamped."""
    flat = tbl.reshape(-1).astype(np.int64)
    return lambda ix: flat[np.clip(ix, 0, flat.size - 1)]


def row_lookup(a):
    """probe_taa's lookup as its kernel does it: element e of an iteration
    belongs to thread e >> 2, whose warp (e >> 7) holds row e >> 7 of ``a``
    with word 32 q + k in register q of lane k; a clamped index ix is
    register ix >> 5 shuffled from lane ix & 31."""
    regs = a.astype(np.int64).reshape(8, 4, 32)
    warp = (np.arange(probe.GATHER_ELEMS) >> 7)[None, :]

    def look(ix):
        ix = np.clip(ix, 0, probe.ROW_WORDS - 1)
        return regs[warp, ix >> 5, ix & 31]
    return look


@pytest.mark.parametrize("n_iters", [1, 3, 37, 257])
@pytest.mark.parametrize("tbl_rows", [1, 8, 33, 72])
def test_gather_split_matches_plain(tbl_rows, n_iters):
    """Ragged iteration counts over the plan's grid, partial sums merged
    with int32 wrap, indices clamped from below 0 and past the table."""
    plan = probe.gather_plan(n_iters, tbl_rows * probe.ROW_WORDS)
    assert plan.grid % probe.GATHER_CLUSTER == 0
    assert plan.grid <= probe.GATHER_CLUSTER * probe.MAX_GATHER_CLUSTERS
    g = np.random.default_rng(n_iters)
    tbl = probe._fill((tbl_rows, probe.ROW_WORDS), tbl_rows)
    idx = g.integers(-9, tbl.size + 9, (8 * n_iters, probe.ROW_WORDS),
                     dtype=np.int32)
    want = probe.probe_gather_plain(T(tbl), T(idx)).numpy()
    np.testing.assert_array_equal(split_model(table_lookup(tbl), idx, plan),
                                  want)
    np.testing.assert_array_equal(probe.probe_gather(T(tbl), T(idx)).numpy(),
                                  want)


@pytest.mark.parametrize("n_iters", [0, 1, 3, 37, 257])
def test_taa_split_matches_plain(n_iters):
    """probe_taa on gather_plan's grid with no table: ragged iteration
    counts (none at all gives zeros), the in-warp lookup from registers,
    partial sums merged with int32 wrap, positions clamped from below 0 and
    past the row."""
    plan = probe.gather_plan(n_iters, 0)
    assert plan.shared_bytes == 4 * probe.GATHER_ELEMS
    g = np.random.default_rng(100 + n_iters)
    a = probe._fill((8, probe.ROW_WORDS), 30 + n_iters)
    idx = g.integers(-9, probe.ROW_WORDS + 9, (8 * n_iters, probe.ROW_WORDS),
                     dtype=np.int32)
    if n_iters:
        assert (idx < 0).any() and (idx >= probe.ROW_WORDS).any()
    want = probe.probe_taa_plain(T(a), T(idx)).numpy()
    assert want.shape == (8, probe.ROW_WORDS)
    if not n_iters:
        assert not want.any()
    np.testing.assert_array_equal(split_model(row_lookup(a), idx, plan), want)
    np.testing.assert_array_equal(probe.probe_taa(T(a), T(idx)).numpy(), want)


def test_taa_plan_at_2048_iterations():
    """The script's 2048 iterations: 16 clusters of 8 blocks, 16 contiguous
    iterations a block, only the 1024 sums in shared memory."""
    plan = probe.gather_plan(2048, 0)
    assert plan == (128, 8, 0, 4 * 1024)
    assert 2048 // plan.grid == 16


def test_gather_plan_spreads_over_the_card():
    """About two iterations a block, clusters of 8, at most 128 blocks."""
    assert probe.gather_plan(1, 1024).grid == 8
    assert probe.gather_plan(37, 1024).grid == 24
    assert probe.gather_plan(256, 9216) == (128, 8, 0, 4 * (1024 + 9216))
    assert probe.gather_plan(10 ** 6, 1024).grid == 128
