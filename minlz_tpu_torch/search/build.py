"""Per-block search table builder — vectorized.

The reference builds tables with unrolled per-matchLen byte loops and a SIMD
``packBits`` kernel (search_index.go:20-175, search_asm_*.s).  Here the whole
build is a handful of NumPy array passes (and the same math runs as torch ops
on a device, ``build_tables_device``): sliding-window values via shifts, the
spec hash family vectorized, presence bits via a scatter-OR — packBits
becomes np.bitwise_or.at.

Boundary rules per SPEC_SEARCH.md §3.3.1/B.1: windows may extend into the
next block's first bytes (overlap); prefix-filtered positions still require
the prefix inside this block.
"""

from __future__ import annotations

import numpy as np

from .table import (
    TYPE_BYTE_PREFIX,
    TYPE_LONG_PREFIX,
    TYPE_MASK_PREFIX,
    TYPE_NO_PREFIX,
    SearchTableConfig,
    hash_values_np,
)


def _window_values(data: np.ndarray, match_len: int) -> np.ndarray:
    """uint64 little-endian values of every match_len-byte window.

    data: uint8 array of block bytes + overlap.  Returns values for
    positions 0 .. len(data)-match_len.
    """
    n = len(data) - match_len + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    vals = np.zeros(n, np.uint64)
    for k in range(match_len):
        vals |= data[k : k + n].astype(np.uint64) << np.uint64(8 * k)
    return vals


def build_table(
    block: bytes,
    cfg: SearchTableConfig,
    overlap: bytes = b"",
    block_size_hint: int = 0,
):
    """Build the bitmap for one block.

    Returns (table_bytes, reductions) or None when the table is denser than
    the configured population limit (the encoder then omits the chunk).
    """
    cfg.validate()
    bits = cfg.auto_bits(block_size_hint or len(block))
    m = cfg.match_len
    s = len(block)
    if s == 0:
        return None

    data = np.frombuffer(bytes(block) + bytes(overlap), np.uint8)

    if cfg.table_type == TYPE_NO_PREFIX:
        # Index windows starting at 0..S-1 (overlap supplies the tail;
        # window at S belongs to the next block).
        end = min(s, len(data) - m + 1)
        vals = _window_values(data, m)[:end]
    elif cfg.table_type in (TYPE_BYTE_PREFIX, TYPE_MASK_PREFIX):
        # Positions 1..S following a prefix byte inside this block.
        if cfg.table_type == TYPE_BYTE_PREFIX:
            pset = np.zeros(256, bool)
            pset[list(set(cfg.prefixes))] = True
        else:
            pset = np.zeros(256, bool)
            pset[list(cfg.prefix_mask)] = True
        vals_all = _window_values(data, m)
        hi = min(s + 1, len(vals_all))
        pos = np.nonzero(pset[data[: hi - 1]])[0] + 1
        vals = vals_all[pos]
    else:  # TYPE_LONG_PREFIX
        p = np.frombuffer(cfg.prefixes, np.uint8)
        pl = len(p)
        e = cfg.extra_matches
        vals_all = _window_values(data, m)
        # Prefix occurrences starting in this block (start <= S-1).
        if len(data) < pl:
            return _finish(np.zeros(0, np.uint64), cfg, bits)
        win = np.lib.stride_tricks.sliding_window_view(data, pl)
        starts = np.nonzero((win == p).all(axis=1))[0]
        starts = starts[starts < s]
        pos = []
        for k in range(e + 1):
            pk = starts + pl + k
            pk = pk[pk < len(vals_all)]
            pos.append(pk)
        pos = np.concatenate(pos) if pos else np.zeros(0, np.int64)
        vals = vals_all[pos]

    return _finish(vals, cfg, bits)


_M32 = 0xFFFFFFFF


def _mullo32(a, p: int):
    """Low 32 bits of a * p for int64 tensors a < 2**32 and a constant
    p < 2**32.  p is split into 16-bit halves, so that no partial product
    reaches 2**48 and nothing relies on int64 overflow."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mulhi32(a, p: int):
    """High 32 bits of a * p for int64 tensors a < 2**32 and a constant
    p < 2**32, on 16-bit limbs (each partial product below 2**32)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    p0 = p & 0xFFFF
    p1 = p >> 16
    lo = a0 * p0
    mid1 = a1 * p0
    mid2 = a0 * p1
    carry = ((lo >> 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)) >> 16
    return a1 * p1 + (mid1 >> 16) + (mid2 >> 16) + carry


def build_tables_device(blocks_u8, match_len: int, bits: int,
                        device="cuda"):
    """Batched no-prefix table build on ``device`` (torch ops): hash every
    window of every block and scatter presence bits — the reference's
    unrolled byte loops + SIMD packBits (search_index.go:33-66,
    search_asm_*.s) as three vector passes.  blocks_u8: [nblocks,
    block_size] uint8 (tensor or numpy).  Returns [nblocks, 2^bits / 8]
    uint8 bitmaps, a tensor on ``device``.

    All spec match lengths 1..8 are supported: the 64-bit multiply-shift
    family (SPEC_SEARCH.md §3.1, reference search_table.go:289-333) is
    computed as hash = high32(v * prime mod 2^64) >> (32 - bits) on 32-bit
    halves carried in int64 and masked to 32 bits after every step, so the
    bitmaps are bit-identical to the NumPy builder's.

    Window values use this block only (no overlap tail); callers append
    the next block's first match_len-1 bytes to the row to get
    spec-complete boundary indexing, as the stream writer does.
    """
    import torch

    from .._device import resolve_device
    from .table import _PRIMES

    dev = resolve_device(device)
    if not isinstance(blocks_u8, torch.Tensor):
        blocks_u8 = torch.from_numpy(np.array(blocks_u8, np.uint8))
    blocks = blocks_u8.to(dev).to(torch.int64)
    nb, S = blocks.shape
    m = match_len
    npos = S - m + 1
    # Window k of position i is byte i + k; past the row's end it reads the
    # zero padding, and those positions are masked out below.
    padded = torch.nn.functional.pad(blocks, (0, m - 1))

    def byte_at(k):
        return padded[:, k:k + S]

    if m <= 4:
        vals = torch.zeros((nb, S), dtype=torch.int64, device=dev)
        for k in range(m):
            vals |= byte_at(k) << (8 * k)
        if m == 1:
            h = vals & 0xFF
        elif m == 2 and bits >= 16:
            h = vals & 0xFFFF
        else:
            shifted = (vals << (8 * (4 - m))) & _M32
            h = _mullo32(shifted, _PRIMES[m] & _M32) >> (32 - bits)
    else:
        # Two 32-bit halves of the left-justified 64-bit window value:
        # byte k of the window sits at bit 8k + (64 - 8m).
        s = 64 - 8 * m
        x0 = torch.zeros((nb, S), dtype=torch.int64, device=dev)
        x1 = torch.zeros((nb, S), dtype=torch.int64, device=dev)
        for k in range(m):
            bit = 8 * k + s
            if bit < 32:
                x0 |= byte_at(k) << bit
            else:
                x1 |= byte_at(k) << (bit - 32)
        p = _PRIMES[m]
        p0 = p & _M32
        p1 = p >> 32
        # high32(x * p mod 2^64) for x = x0 + x1*2^32:
        hi = (_mulhi32(x0, p0) + _mullo32(x0, p1) + _mullo32(x1, p0)) & _M32
        h = hi >> (32 - bits)
    pos = torch.arange(S, device=dev)[None, :]
    h = torch.where(pos < npos, h, 1 << bits)
    # Presence: one flag per bucket (the last bucket takes the masked
    # positions), then little-endian bit packing.
    flags = torch.zeros((nb, (1 << bits) + 1), dtype=torch.uint8, device=dev)
    flags.scatter_(1, h, 1)
    packed = flags[:, : 1 << bits].reshape(nb, (1 << bits) // 8, 8)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=dev)
    return (packed * weights).sum(dim=2, dtype=torch.uint8)


def build_table_auto(
    block: bytes,
    cfg: SearchTableConfig,
    overlap: bytes = b"",
    block_size_hint: int = 0,
    device="cuda",
):
    """build_table with the torch builder on the default no-prefix path —
    this is what the stream writer calls, with its own device, so the
    packBits-SIMD equivalent (reference search_index.go:20-66) runs on the
    card for the default config; prefix table types keep the NumPy path."""
    cfg.validate()
    if cfg.table_type != TYPE_NO_PREFIX or len(block) == 0:
        return build_table(block, cfg, overlap, block_size_hint)
    bits = cfg.auto_bits(block_size_hint or len(block))
    m = cfg.match_len
    # Windows must START inside this block (spec boundary rule); trimming
    # the row to block + (m-1) overlap bytes makes the device position mask
    # (npos = S - m + 1) coincide exactly with that rule.
    data = np.frombuffer(
        (bytes(block) + bytes(overlap))[: len(block) + m - 1], np.uint8
    )
    bitmap = build_tables_device(data[None, :], m, bits, device)[0]
    return _reduce_and_check(bitmap.cpu().numpy(), cfg)


def _reduce_and_check(table: np.ndarray, cfg: SearchTableConfig):
    reductions = 0
    pop = np.unpackbits(table).sum()
    # Reduce while sparse enough and above the 256-entry floor.
    while (
        len(table) > 32
        and pop <= cfg.max_reduced_population * (len(table) * 4)
    ):
        half = len(table) // 2
        table = table[:half] | table[half:]
        reductions += 1
        pop = np.unpackbits(table).sum()

    if pop > cfg.max_population * (len(table) * 8):
        return None
    return table.tobytes(), reductions


def _finish(vals: np.ndarray, cfg: SearchTableConfig, bits: int):
    h = hash_values_np(vals, bits, cfg.match_len)
    nbytes = 1 << (bits - 3)
    table = np.zeros(nbytes, np.uint8)
    np.bitwise_or.at(table, h >> np.uint32(3),
                     (np.uint8(1) << (h & np.uint32(7))).astype(np.uint8))
    return _reduce_and_check(table, cfg)
