"""Probe kernels: microbenchmarks of the primitives the decode executors
are built from, and of the executor's per-record step.

The counterparts of the five Pallas kernels in the JAX package's
``scripts/kernel_probe.py`` (``bench_scalar``, ``bench_gather``,
``bench_taa``), ``scripts/exec_probe.py`` (``bench_chain_body``) and
``scripts/ablate_exec.py`` (``run``).  Each is a function of its inputs and
returns its whole buffer (the JAX kernels of the two chain probes return
row 0 only):

* ``probe_scalar``: ``n_chains`` serial chains of steps
  ``buf[dst] = buf[src] + 1`` on rows of 128 int32;
* ``probe_gather``: ``out = sum_i tbl.flat[idx[i]]`` over [8, 128] index
  blocks, int32 wrap, the table in shared memory;
* ``probe_taa``: ``out[r, l] = sum_i a[r, idx[8 i + r, l]]``, the gather
  inside a row of 128, by warp shuffles;
* ``probe_chain_body``: per step, the 128-word window at a byte offset of
  two joined rows, masked to 64 bytes, stored to a third row;
* ``ablate_exec``: ``nchain`` synthetic LZ record chains over one arena, in
  five variants (``csrc/ablate.cu`` defines them).

The chain body, the ablation and ``probe_scalar`` run one thread block a
chain, each staging its chain's region of the buffer or arena in shared
memory; ``probe_scalar`` stages a region that does not fit one block across
a thread block cluster (``scalar_plan``).  ``probe_gather`` and
``probe_taa`` spread their iterations over clusters of blocks across the
card and sum their partial sums on the card in the same launch
(``gather_plan``), by one reduction and on one set of tickets.
``LAUNCHED`` keeps the plan of each of those three kernels' last launch.

Each wrapper launches its CUDA kernel (``csrc/probe.cu``,
``csrc/ablate.cu``) for CUDA tensors and runs its plain torch version, in
this module, for CPU tensors.  The ``*_inputs`` functions build, with numpy
and the JAX scripts' seeds and call order, the arrays those scripts build
for the same arguments; ``fill`` / ``wrap`` swap the scripts' all-zero (or
small) data for seeded non-zero (or full-range) data, on which a comparison
shows something.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build

_I32 = torch.int32
_I64 = torch.int64
ROW_WORDS = 128
ROW_B = 512
GATHER_ELEMS = 8 * ROW_WORDS
# Dynamic shared memory one thread block can use on Hopper.
SHARED_LIMIT = 232448
MAX_CHAINS = 32             # the chain probes walk 1..32 chains
MAX_CLUSTER = 16            # blocks a cluster; above 8 non-portable
GATHER_CLUSTER = 8          # probe_gather: blocks a cluster (csrc/probe.cu)
MAX_GATHER_CLUSTERS = 16    # 128 blocks: about one an SM of the card's 132
GATHER_ITERS = 2            # iterations a block that gather_plan aims at
CLUSTER_REFUSED = -1        # csrc/probe.cu: no cluster of that size fits
SPACES = ("shared", "global")
# The JAX probe's "taa" and "roll" realign the window in two ways and give
# the same words: both are "realign" here.
MODES = {"minimal": 0, "realign": 1, "taa": 1, "roll": 1}
VARIANTS = ("full", "onewin", "norealign", "nomask", "minimal")


def _wrap32(x):
    """int64 -> int32 with two's-complement wrap."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def _check_i32(name, t, dim, device=None):
    if t.dtype != _I32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D int32 tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _on_card(name, t) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")
    return True


# --------------------------------------------------------------------------
# Chains of dependent row moves: probe_scalar, probe_chain_body
# --------------------------------------------------------------------------

def _check_chain(name, steps, per_step, buf, n_chains, space):
    _check_i32("steps", steps, 1)
    _check_i32("buf", buf, 2, steps.device)
    if buf.shape[1] != ROW_WORDS or buf.shape[0] < 1:
        raise ValueError(f"buf must be [rows, {ROW_WORDS}]")
    if not 1 <= n_chains <= MAX_CHAINS:
        raise ValueError(f"{name} walks 1..{MAX_CHAINS} chains")
    if steps.numel() % (per_step * n_chains):
        raise ValueError(f"steps must hold n_chains * n_ops * {per_step} "
                         f"entries")
    if space not in SPACES:
        raise ValueError(f"space must be one of {SPACES}")
    return steps.numel() // (per_step * n_chains)


def stage_bytes(rows: int) -> int:
    """Dynamic shared memory of a block that stages ``rows`` rows with a
    flag byte a row, rounded up to 16 bytes (``csrc/probe.cu``)."""
    return rows * ROW_B + -(-rows // 16) * 16


# The most rows a block can stage with their flags: 453.
SHARE_ROWS = max(r for r in range(SHARED_LIMIT // ROW_B + 1)
                 if stage_bytes(r) <= SHARED_LIMIT)


def body_shared_bytes(n_rows: int, n_chains: int) -> int:
    """Shared memory of one ``probe_chain_body`` block in the shared space:
    its chain's region of ``n_rows // n_chains`` rows and a flag byte a
    row."""
    return stage_bytes(n_rows // n_chains)


class Plan(NamedTuple):
    """A launch of ``probe_scalar``, ``probe_gather`` or ``probe_taa``:
    blocks in the grid, blocks a cluster (1: a plain launch), rows a block
    stages (``probe_scalar``'s shared space) and dynamic shared bytes a
    block."""
    grid: int
    cluster: int
    share_rows: int
    shared_bytes: int


LAUNCHED: dict[str, Plan] = {}


def scalar_plan(n_rows: int, n_chains: int, space: str) -> Plan:
    """The launch of ``probe_scalar`` on a buffer of ``n_rows`` rows.  In
    device memory (``"global"``) a block of one warp a chain.  In the
    shared space chain c's region of r = n_rows // n_chains rows is staged
    by a cluster of k blocks, k the smallest power of two whose share of
    ceil(r / k) rows fits a block (``SHARE_ROWS``): 4096 rows take clusters
    of 16, 8, 4, 2 and 1 at 1, 2, 4, 8 and 16 chains.  Raises ValueError when
    a chain would need more than ``MAX_CLUSTER`` blocks."""
    if space == "global":
        return Plan(n_chains, 1, 0, 0)
    region = n_rows // n_chains
    cluster = 1
    while -(-region // cluster) > SHARE_ROWS:
        cluster *= 2
    if cluster > MAX_CLUSTER:
        raise ValueError(
            f"probe_scalar: a chain's region of {region} rows ({n_chains} "
            f"chains x {n_rows} rows) needs a cluster of {cluster} blocks of "
            f"at most {SHARE_ROWS} rows, more than {MAX_CLUSTER}")
    share = max(-(-region // cluster), 1)
    return Plan(n_chains * cluster, cluster, share, stage_bytes(share))


def _launched(lib, err: int, kernel: str, what: str, plan: Plan) -> None:
    """Raise ValueError naming the configuration unless the launch of
    ``kernel`` went through; record its plan and count it if it did."""
    if err:
        reason = ("no cluster of that size fits the card "
                  "(cudaOccupancyMaxActiveClusters: 0)"
                  if err == CLUSTER_REFUSED else
                  f"error {err} "
                  f"({lib.minlz_error_string(err).decode(errors='replace')})")
        raise ValueError(f"{kernel}: {what}, grid {plan.grid} in clusters "
                         f"of {plan.cluster}: the card refused the launch: "
                         f"{reason}")
    LAUNCHED[kernel] = plan
    _build.count_launch(kernel)


def probe_scalar(rows, buf, n_chains: int, space: str = "global"):
    """rows: [n_chains * n_ops * 2] int32, per chain and step (src, dst)
    row numbers; buf: [n_rows, 128] int32.  Chain after chain (they must own
    disjoint rows), step after step: ``buf[dst] = buf[src] + 1``.  Row
    numbers are clamped into buf.  The kernel walks each chain in a block
    (or a cluster) of its own.  ``space``: where it walks, ``"global"``
    (device memory) or ``"shared"``: chain c's region, rows [c * r, (c + 1)
    * r) with r = n_rows // n_chains, staged in shared memory as
    ``scalar_plan`` says (ValueError when it cannot be); a row outside its
    chain's region is walked in device memory, slower but as exact.
    Returns the walked buffer."""
    _check_chain("probe_scalar", rows, 2, buf, n_chains, space)
    plan = scalar_plan(buf.shape[0], n_chains, space)
    if not _on_card("probe_scalar", buf):
        return probe_scalar_plain(rows, buf, n_chains)
    out = buf.clone()
    launch_scalar(rows, out, n_chains, space, plan)
    return out


def launch_scalar(rows, buf, n_chains: int, space: str, plan: Plan):
    """The bare launch of ``probe_scalar``'s kernel on checked CUDA tensors:
    walks ``buf`` in place.  No check, no allocation; measurements time
    this."""
    n_ops = rows.numel() // (2 * n_chains)
    lib = _build.load()
    with torch.cuda.device(buf.device):
        err = lib.minlz_probe_scalar(
            rows.data_ptr(), n_ops, n_chains, buf.shape[0], buf.data_ptr(),
            int(space == "shared"), plan.grid, plan.cluster, plan.share_rows,
            plan.shared_bytes, _build.stream_of(buf))
    _launched(lib, err, "probe_scalar",
              f"{n_chains} chains x {buf.shape[0]} rows, {space}", plan)


def probe_scalar_plain(rows, buf, n_chains: int):
    """Plain torch version of ``probe_scalar`` (any device): a loop over the
    steps, the chains side by side."""
    n_ops = _check_chain("probe_scalar", rows, 2, buf, n_chains, "global")
    steps = rows.reshape(n_chains, n_ops, 2).to(_I64).clamp(
        0, buf.shape[0] - 1)
    out = buf.clone()
    for i in range(n_ops):
        out[steps[:, i, 1]] = _wrap32(out[steps[:, i, 0]].to(_I64) + 1)
    return out


def _mask_table(device):
    """[512, 128] int32: row ``off`` keeps bytes [off, min(off + 64, 512))
    of a 512-byte row."""
    p = np.arange(ROW_B)[None, :]
    off = np.arange(ROW_B)[:, None]
    keep = (p >= off) & (p < np.minimum(off + 64, ROW_B))
    table = np.ascontiguousarray(np.where(keep, 0xFF, 0).astype(np.uint8))
    return torch.from_numpy(table.view("<i4")).to(device)


def probe_chain_body(meta, buf, n_chains: int, mode: str = "realign",
                     space: str = "global"):
    """meta: [n_chains * n_ops * 3] int32, per chain and step (src row, dst
    row, byte offset, taken modulo 512); buf: [n_rows, 128] int32.  A step
    joins rows src and src + 1, takes the 128-word window that starts at
    word ``off >> 2`` (``mode="realign"``; the JAX probe's ``"taa"`` and
    ``"roll"`` are this) or the word-wise sum of the two rows
    (``"minimal"``), keeps bytes [off, min(off + 64, 512)), zeroes the rest
    and stores the row to dst.  Row numbers are clamped into buf, src + 1
    too.  The chains must own disjoint rows (then any order of the chains
    gives the result of the plain version's lockstep); the kernel walks
    each chain in a thread block of its own.  ``space``: where it walks,
    ``"global"`` (device memory) or ``"shared"``: chain c's region, rows
    [c * r, (c + 1) * r) with r = n_rows // n_chains, staged in its block's
    shared memory, where the scripts' inputs keep every row of chain c.
    Each region must fit (``body_shared_bytes``, else ValueError); a row
    outside its chain's region is walked in device memory, slower but as
    exact.  Returns the walked buffer."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}")
    n_ops = _check_chain("probe_chain_body", meta, 3, buf, n_chains, space)
    if space == "shared" and (body_shared_bytes(buf.shape[0], n_chains)
                              > SHARED_LIMIT):
        raise ValueError(
            f"a chain's region of {buf.shape[0] // n_chains} rows takes "
            f"{body_shared_bytes(buf.shape[0], n_chains)} bytes with its "
            f"flags, more than the {SHARED_LIMIT} bytes of shared memory a "
            f"block can use")
    if not _on_card("probe_chain_body", buf):
        return probe_chain_body_plain(meta, buf, n_chains, mode)
    out = buf.clone()
    lib = _build.load()
    with torch.cuda.device(buf.device):
        _build.check(lib, lib.minlz_probe_chain_body(
            meta.data_ptr(), n_ops, n_chains, buf.shape[0], out.data_ptr(),
            int(space == "shared"), MODES[mode], _build.stream_of(buf)))
    _build.count_launch("probe_chain_body")
    return out


def probe_chain_body_plain(meta, buf, n_chains: int, mode: str = "realign"):
    """Plain torch version of ``probe_chain_body`` (any device)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}")
    n_ops = _check_chain("probe_chain_body", meta, 3, buf, n_chains,
                         "global")
    dev = buf.device
    last = buf.shape[0] - 1
    steps = meta.reshape(n_chains, n_ops, 3).to(_I64)
    src = steps[..., 0].clamp(0, last)
    src1 = (src + 1).clamp(max=last)
    dst = steps[..., 1].clamp(0, last)
    off = steps[..., 2] & (ROW_B - 1)
    table = _mask_table(dev)
    word = torch.arange(ROW_WORDS, device=dev)[None, :]
    out = buf.clone()
    for i in range(n_ops):
        r0, r1 = out[src[:, i]], out[src1[:, i]]
        if MODES[mode]:
            w = torch.gather(torch.cat([r0, r1], 1), 1,
                             word + (off[:, i] >> 2)[:, None])
        else:
            w = _wrap32(r0.to(_I64) + r1.to(_I64))
        out[dst[:, i]] = w & table[off[:, i]]
    return out


# --------------------------------------------------------------------------
# Gathers: probe_gather (shared memory), probe_taa (registers)
# --------------------------------------------------------------------------

def _check_idx(idx, device):
    _check_i32("idx", idx, 2, device)
    if idx.shape[1] != ROW_WORDS or idx.shape[0] % 8:
        raise ValueError(f"idx must be [8 * n_iters, {ROW_WORDS}]")
    return idx.shape[0] // 8


def gather_plan(n_iters: int, tbl_words: int) -> Plan:
    """The launch of ``probe_gather`` (and, with ``tbl_words`` 0, of
    ``probe_taa``): clusters of ``GATHER_CLUSTER`` blocks, enough for about
    ``GATHER_ITERS`` iterations a block, at most ``MAX_GATHER_CLUSTERS``;
    each block takes a contiguous run of the iterations and stages the table
    behind its 1024 partial sums."""
    clusters = -(-n_iters // (GATHER_CLUSTER * GATHER_ITERS))
    clusters = min(max(clusters, 1), MAX_GATHER_CLUSTERS)
    return Plan(clusters * GATHER_CLUSTER, GATHER_CLUSTER, 0,
                4 * (GATHER_ELEMS + tbl_words))


_TICKETS: dict = {}


def gather_tickets(device, stream: int):
    """The ``GATHER_CLUSTER`` ticket counters of ``probe_gather`` and
    ``probe_taa`` on one stream of a device: zeroed once when first asked
    for, and left at zero by every launch (the block that draws a slice's
    last ticket resets it), so no launch needs a memset.  The two kernels
    share them because launches on one stream run one after another."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(GATHER_CLUSTER, dtype=_I32,
                                    device=device)
    return _TICKETS[key]


def gather_scratch(plan: Plan, device):
    """The [clusters, 1024] int32 scratch of a gather launch, any
    contents."""
    return torch.empty((plan.grid // plan.cluster, GATHER_ELEMS), dtype=_I32,
                       device=device)


def probe_gather(tbl, idx):
    """tbl: [rows, 128] int32, at most 36 KiB; idx: [8 * n_iters, 128]
    int32 flat indices into tbl, clamped into it.  Returns [8, 128] int32:
    ``sum_i tbl.flat[idx[8 i : 8 i + 8]]`` with int32 wrap.  The kernel
    spreads the iterations over ``gather_plan``'s blocks and sums their
    partial sums in the same launch."""
    _check_i32("tbl", tbl, 2)
    n_iters = _check_idx(idx, tbl.device)
    if tbl.shape[1] != ROW_WORDS or not 1 <= tbl.shape[0] <= 72:
        raise ValueError("tbl must be [1..72, 128]")
    plan = gather_plan(n_iters, tbl.numel())
    if not _on_card("probe_gather", tbl):
        return probe_gather_plain(tbl, idx)
    out = torch.empty((8, ROW_WORDS), dtype=_I32, device=tbl.device)
    launch_gather(tbl, idx, out, gather_scratch(plan, tbl.device), plan)
    return out


def launch_gather(tbl, idx, out, scratch, plan: Plan):
    """The bare launch of ``probe_gather``'s kernel on checked CUDA tensors:
    ``out`` [8, 128] written, ``scratch`` [clusters, 1024] int32 of any
    contents.  No check, no allocation; measurements time this."""
    lib = _build.load()
    stream = _build.stream_of(tbl)
    tickets = gather_tickets(tbl.device, stream)
    with torch.cuda.device(tbl.device):
        err = lib.minlz_probe_gather(
            tbl.data_ptr(), tbl.numel(), idx.data_ptr(), idx.shape[0] // 8,
            out.data_ptr(), plan.grid, plan.cluster, plan.shared_bytes,
            scratch.data_ptr(), tickets.data_ptr(), stream)
    _launched(lib, err, "probe_gather",
              f"{idx.shape[0] // 8} iterations over {tbl.numel()} words",
              plan)


def probe_gather_plain(tbl, idx):
    """Plain torch version of ``probe_gather`` (any device): an index and a
    sum."""
    picked = tbl.flatten()[idx.to(_I64).clamp(0, tbl.numel() - 1)]
    return _wrap32(picked.reshape(-1, 8, ROW_WORDS).sum(0, dtype=_I64))


def probe_taa(a, idx):
    """a: [8, 128] int32; idx: [8 * n_iters, 128] int32 positions in a row,
    clamped into 0..127.  Returns [8, 128] int32:
    ``out[r, l] = sum_i a[r, idx[8 i + r, l]]`` with int32 wrap.  The kernel
    spreads the iterations over ``gather_plan``'s blocks (no table), gathers
    inside each warp's registers by shuffles, and sums the partial sums in
    the same launch, as ``probe_gather`` does."""
    _check_i32("a", a, 2)
    n_iters = _check_idx(idx, a.device)
    if a.shape != (8, ROW_WORDS):
        raise ValueError("a must be [8, 128]")
    plan = gather_plan(n_iters, 0)
    if not _on_card("probe_taa", a):
        return probe_taa_plain(a, idx)
    out = torch.empty((8, ROW_WORDS), dtype=_I32, device=a.device)
    launch_taa(a, idx, out, gather_scratch(plan, a.device), plan)
    return out


def launch_taa(a, idx, out, scratch, plan: Plan):
    """The bare launch of ``probe_taa``'s kernel on checked CUDA tensors,
    as ``launch_gather``'s; it shares that kernel's tickets.  No check, no
    allocation; measurements time this."""
    lib = _build.load()
    stream = _build.stream_of(a)
    tickets = gather_tickets(a.device, stream)
    with torch.cuda.device(a.device):
        err = lib.minlz_probe_taa(
            a.data_ptr(), idx.data_ptr(), idx.shape[0] // 8, out.data_ptr(),
            plan.grid, plan.cluster, plan.shared_bytes, scratch.data_ptr(),
            tickets.data_ptr(), stream)
    _launched(lib, err, "probe_taa", f"{idx.shape[0] // 8} iterations", plan)


def probe_taa_plain(a, idx):
    """Plain torch version of ``probe_taa`` (any device): a gather and a
    sum."""
    ix = idx.to(_I64).clamp(0, ROW_WORDS - 1).reshape(-1, 8, ROW_WORDS)
    picked = torch.gather(a[None].expand(ix.shape[0], -1, -1), 2, ix)
    return _wrap32(picked.sum(0, dtype=_I64))


# --------------------------------------------------------------------------
# The executor's per-record step: ablate_exec
# --------------------------------------------------------------------------

def _check_ablate(counts, ops, arena, variant, out_base_row, chain_rows):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    _check_i32("ops", ops, 3)
    _check_i32("counts", counts, 1, ops.device)
    _check_i32("arena", arena, 2, ops.device)
    nchain, cap = ops.shape[0], ops.shape[1]
    if ops.shape[2] != 3 or counts.numel() != nchain:
        raise ValueError("ops must be [nchain, cap, 3], counts [nchain]")
    if not 1 <= nchain <= MAX_CHAINS:
        raise ValueError(f"ablate_exec walks 1..{MAX_CHAINS} chains")
    if chain_rows is None:
        chain_rows = (arena.shape[0] - out_base_row - 2) // nchain
    if (arena.shape[1] != ROW_WORDS or out_base_row < 0 or chain_rows < 1
            or arena.shape[0] < out_base_row + nchain * chain_rows):
        raise ValueError("arena must be [rows, 128] with out_base_row + "
                         "nchain * chain_rows rows or more")
    a = ops[..., 0].to(_I64)
    live = torch.arange(cap, device=ops.device)[None, :] < counts[:, None]
    need = torch.where(live, (a & 0x3FFF) + ((a >> 14) & 0x3FFF), 0).sum(1)
    if nchain and int(need.max()) > chain_rows * ROW_B:
        raise ValueError(
            f"a chain writes {int(need.max())} bytes, more than its region "
            f"of {chain_rows} rows ({chain_rows * ROW_B} bytes)")
    return nchain, cap, chain_rows


def ablate_exec(counts, ops, arena, variant: str = "full",
                out_base_row: int = 8, chain_rows: int | None = None):
    """counts: [nchain] int32 records per chain; ops: [nchain, cap, 3] int32
    records (llen | clen << 14, copy offset, literal byte address); arena:
    [rows, 128] int32, read as little-endian bytes: literal bytes in rows
    0..out_base_row-1, then ``chain_rows`` rows per chain (by default the
    rows left but the last two, shared out evenly).  Every chain appends its records to its
    region, in the given ``variant`` (``csrc/ablate.cu`` defines the five).
    A read of the chain's own region sees the chain's stores, every other
    read sees the input arena, so the chains are independent: the kernel
    walks each in a thread block of its own, its region staged in shared
    memory.  Raises when a chain's bytes exceed its region, and when a
    region exceeds ``SHARED_LIMIT``.  Returns the written arena."""
    nchain, cap, chain_rows = _check_ablate(counts, ops, arena, variant,
                                            out_base_row, chain_rows)
    if chain_rows * ROW_B > SHARED_LIMIT:
        raise ValueError(
            f"a chain's region of {chain_rows} rows ({chain_rows * ROW_B} "
            f"bytes) does not fit the {SHARED_LIMIT} bytes of shared memory "
            f"a block can use")
    if not _on_card("ablate_exec", arena):
        return ablate_exec_plain(counts, ops, arena, variant, out_base_row,
                                 chain_rows)
    out = arena.clone()
    lib = _build.load()
    with torch.cuda.device(arena.device):
        _build.check(lib, lib.minlz_ablate_exec(
            counts.data_ptr(), ops.data_ptr(), cap, nchain, arena.data_ptr(),
            out.data_ptr(), arena.shape[0], out_base_row, chain_rows,
            VARIANTS.index(variant), _build.stream_of(arena)))
    _build.count_launch("ablate_exec")
    return out


class _ChainBytes:
    """One chain's view of the arena, as bytes: reads of its own region
    [lo, hi) come from ``out``, every other read from ``inp``; a read outside
    the arena gives 0 and a store outside the region is dropped."""

    def __init__(self, inp, out, lo, hi):
        self.inp, self.out, self.lo, self.hi = inp, out, lo, hi
        self.n = inp.numel()

    def read(self, s: int, n: int):
        if n <= 0:
            return self.out[:0]
        if self.lo <= s and s + n <= self.hi:
            return self.out[s:s + n].clone()
        if 0 <= s and s + n <= self.n and (s + n <= self.lo or s >= self.hi):
            return self.inp[s:s + n]
        idx = torch.arange(s, s + n, device=self.inp.device)
        return self.read_at(idx)

    def read_at(self, idx):
        safe = idx.clamp(0, self.n - 1)
        own = (idx >= self.lo) & (idx < self.hi)
        val = torch.where(own, self.out[safe], self.inp[safe])
        return torch.where((idx >= 0) & (idx < self.n), val, 0)

    def write(self, d: int, val):
        a, b = max(d, self.lo), min(d + val.numel(), self.hi)
        if a < b:
            self.out[a:b] = val[a - d:b - d]

    def move(self, dst: int, src: int, n: int):
        self.write(dst, self.read(src, n))

    def move_row(self, dst: int, src: int):
        """512 bytes from src over the row at dst; a source byte before the
        arena is the one 512 bytes on (the TPU window's wrap in row 0)."""
        if src >= 0:
            val = self.read(src, ROW_B)
        else:
            idx = torch.arange(src, src + ROW_B, device=self.inp.device)
            val = self.read_at(torch.where(idx < 0, idx + ROW_B, idx))
        self.write(dst, val)


def ablate_exec_plain(counts, ops, arena, variant: str = "full",
                      out_base_row: int = 8, chain_rows: int | None = None):
    """Plain torch version of ``ablate_exec`` (any device): a Python loop
    over each chain's records and moves, on byte views of the arena."""
    nchain, _, chain_rows = _check_ablate(counts, ops, arena, variant,
                                          out_base_row, chain_rows)
    n_rows = arena.shape[0]
    out = arena.clone()
    inp_b = arena.view(torch.uint8).reshape(-1)
    out_b = out.view(torch.uint8).reshape(-1)
    recs = ops.cpu().tolist()
    for ch, count in enumerate(counts.cpu().tolist()):
        lo = (out_base_row + ch * chain_rows) * ROW_B
        hi = lo + chain_rows * ROW_B
        _walk_chain(_ChainBytes(inp_b, out_b, lo, hi),
                    recs[ch][:max(count, 0)], variant, n_rows)
    return out


def _window_row(byte_start: int, n_rows: int) -> int:
    """First byte of the aligned row the TPU body's window loads."""
    return min(max(byte_start >> 9, 0), n_rows - 2) * ROW_B


def _walk_chain(c: _ChainBytes, recs, variant: str, n_rows: int):
    cur = c.lo
    last_row = c.hi // ROW_B - 1
    if variant == "full":
        for a, b, cw in recs:
            llen, clen, eff = a & 0x3FFF, (a >> 14) & 0x3FFF, max(b, 1)
            c.move(cur, cw, llen)
            d = cur + llen
            if clen:
                period = c.read(d - eff, min(eff, clen))
                c.write(d, period.repeat(-(-clen // period.numel()))[:clen])
            cur = d + clen
        return
    if variant == "minimal":
        for a, b, _ in recs:
            src_row = min(max(b >> 9, 0), n_rows - 1)
            c.move_row(min(cur >> 9, last_row) * ROW_B, src_row * ROW_B)
            cur += (a & 0x3FFF) + ((a >> 14) & 0x3FFF)
        return
    # The TPU body's state machine (csrc/ablate.cu has the same loop).
    op, lr, cr, eff, ls = 0, 0, 0, 1, 0
    while True:
        if lr == 0 and cr == 0:
            if op >= len(recs):
                break
            a, b, ls = recs[op]
            lr, cr, eff = a & 0x3FFF, (a >> 14) & 0x3FFF, max(b, 1)
            op += 1
        if variant == "onewin":
            is_lit = lr > 0
            q = cur & (ROW_B - 1)
            ta = min(lr if is_lit else min(cr, eff), ROW_B - q)
            c.move(cur, ls if is_lit else cur - eff, ta)
            cur += ta
            if is_lit:
                ls += ta
                lr -= ta
            else:
                cr -= ta
                if ta == eff and cr > 0:
                    eff *= 2
            continue
        q = cur & (ROW_B - 1)
        ta = min(lr, ROW_B - q)
        if variant == "norealign":
            c.move(cur, _window_row(ls - q, n_rows) + q, ta)
        else:
            c.move_row(min(cur >> 9, last_row) * ROW_B, ls - q)
        cur += ta
        ls += ta
        lr -= ta
        q2 = cur & (ROW_B - 1)
        tb = min(cr, eff, ROW_B - q2) if lr == 0 else 0
        if variant == "norealign":
            c.move(cur, _window_row(cur - eff - q2, n_rows) + q2, tb)
        else:
            c.move_row(min(cur >> 9, last_row) * ROW_B, cur - eff - q2)
        cur += tb
        cr -= tb
        if tb == eff and cr > 0:
            eff *= 2


# --------------------------------------------------------------------------
# Inputs, as the JAX scripts build them
# --------------------------------------------------------------------------

def _fill(shape, seed: int):
    """Seeded int32 of the full range."""
    info = np.iinfo(np.int32)
    return np.random.default_rng(seed).integers(
        info.min, info.max, shape, dtype=np.int32, endpoint=True)


def scalar_inputs(n_ops: int = 8192, n_chains: int = 1, rows: int = 4096,
                  fill: bool = False):
    """(rows_arr [n_chains * n_ops * 2] int32, buf [rows, 128] int32) of
    ``kernel_probe.bench_scalar``: every chain draws its rows from its own
    share of the buffer.  ``fill``: a seeded non-zero buf in place of the
    script's zeros."""
    rng = np.random.default_rng(0)
    rr = rows // n_chains
    rows_arr = np.zeros(n_chains * n_ops * 2, np.int32)
    for c in range(n_chains):
        rows_arr[c * n_ops * 2:(c + 1) * n_ops * 2] = rng.integers(
            c * rr, (c + 1) * rr, n_ops * 2, dtype=np.int32)
    buf = _fill((rows, ROW_WORDS), 10) if fill else np.zeros(
        (rows, ROW_WORDS), np.int32)
    return rows_arr, buf


def gather_inputs(n_iters: int = 512, tbl_vregs: int = 1,
                  wrap: bool = False):
    """(tbl [8 * tbl_vregs, 128] int32, idx [8 * n_iters, 128] int32) of
    ``kernel_probe.bench_gather``.  ``wrap``: full-range table values, so
    that the int32 sum wraps."""
    rng = np.random.default_rng(1)
    n = tbl_vregs * GATHER_ELEMS
    tbl = rng.integers(0, 1 << 20, (tbl_vregs * 8, ROW_WORDS), dtype=np.int32)
    idx = rng.integers(0, n, (n_iters * 8, ROW_WORDS), dtype=np.int32)
    if wrap:
        tbl = _fill(tbl.shape, 11)
    return tbl, idx


def taa_inputs(n_iters: int = 2048, wrap: bool = False):
    """(a [8, 128] int32, idx [8 * n_iters, 128] int32) of
    ``kernel_probe.bench_taa``.  ``wrap`` as for ``gather_inputs``."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 100, (8, ROW_WORDS), dtype=np.int32)
    idx = rng.integers(0, ROW_WORDS, (n_iters * 8, ROW_WORDS), dtype=np.int32)
    if wrap:
        a = _fill(a.shape, 12)
    return a, idx


def chain_body_inputs(n_ops: int = 4096, n_chains: int = 16,
                      rows: int = 4096, fill: bool = False):
    """(meta [n_chains * n_ops * 3] int32, buf [rows, 128] int32) of
    ``exec_probe.bench_chain_body``.  ``fill`` as for ``scalar_inputs``."""
    rng = np.random.default_rng(0)
    rr = rows // n_chains
    if rr < 3:
        raise ValueError("every chain needs three rows of its own or more")
    meta = np.zeros(n_chains * n_ops * 3, np.int32)
    for c in range(n_chains):
        base = c * n_ops * 3
        meta[base:base + n_ops * 3:3] = rng.integers(
            c * rr, (c + 1) * rr - 2, n_ops, dtype=np.int32)
        meta[base + 1:base + n_ops * 3:3] = rng.integers(
            c * rr, (c + 1) * rr, n_ops, dtype=np.int32)
        meta[base + 2:base + n_ops * 3:3] = rng.integers(
            0, ROW_B, n_ops, dtype=np.int32)
    buf = _fill((rows, ROW_WORDS), 13) if fill else np.zeros(
        (rows, ROW_WORDS), np.int32)
    return meta, buf


def ablate_inputs(nchain: int = 8, ops_per_chain: int = 4096,
                  chain_rows: int = 128, out_base_row: int = 8,
                  fill: bool = False):
    """(counts [nchain] int32, ops [nchain, ops_per_chain, 3] int32, arena
    [out_base_row + nchain * chain_rows + 2, 128] int32) with the records of
    ``ablate_exec.run``: llen 0-4, clen 4-10, offset 8-1999, literals
    anywhere in the literal rows.  ``fill``: a seeded non-zero arena in
    place of the script's zeros."""
    rng = np.random.default_rng(0)
    ops = np.zeros((nchain, ops_per_chain, 3), np.int32)
    for c in range(nchain):
        ll = rng.integers(0, 5, ops_per_chain)
        cl = rng.integers(4, 11, ops_per_chain)
        ops[c, :, 0] = ll | (cl << 14)
        ops[c, :, 1] = rng.integers(8, 2000, ops_per_chain)
        ops[c, :, 2] = rng.integers(0, out_base_row * ROW_B, ops_per_chain)
    counts = np.full(nchain, ops_per_chain, np.int32)
    shape = (out_base_row + nchain * chain_rows + 2, ROW_WORDS)
    arena = _fill(shape, 14) if fill else np.zeros(shape, np.int32)
    return counts, ops, arena
