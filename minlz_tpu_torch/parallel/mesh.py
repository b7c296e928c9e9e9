"""Data parallelism over independent blocks, one process per device.

The counterpart of ``minlz_tpu.parallel.mesh``.  The reference's concurrency
model is goroutines + an ordered channel of channels (writer.go:214-272);
here, as in the JAX package:

  * blocks are split data-parallel over the ranks of a process group, each
    rank holding a contiguous share in global block order;
  * every rank runs the match-find/parse pipeline on its own blocks;
  * per-block compressed sizes are exchanged with an all-gather;
  * stream assembly order = exclusive prefix sum of sizes (a deterministic
    scan replaces the reference's channel ordering);
  * dictionaries broadcast once from rank 0.

JAX drives every device from one program (``shard_map``); torch runs one
process per device.  So each ``sharded_*`` function takes this rank's local
share of the blocks and returns this rank's outputs, with the global
exclusive-scan offsets of its blocks.  Every rank of the group must call it
with shares of the same shape.  A failed collective raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops import emit, encode_kernel
from ..ops.greedy import greedy_parse
from ..ops.parse import parse_segments


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its process group, its rank in that
    group, the group's size, and the rank's torch device."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, device="cuda") -> Mesh:
    """The mesh of ``group`` (default: the whole world) on ``device``.

    ``torch.distributed`` must be initialised.  Asking for CUDA where torch
    sees no GPU raises; nothing moves to the CPU by itself.  NCCL needs a
    CUDA device."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group first (parallel.ranks.run "
                           "does it for local ranks)")
    if group is None:
        group = dist.group.WORLD
    dev = resolve_device(device)
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def _local(mesh: Mesh, x, dtype=None):
    """``x`` (tensor, numpy array or list) as a tensor on the mesh's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    x = x.to(mesh.device)
    return x if dtype is None else x.to(dtype)


def all_gather(mesh: Mesh, x):
    """All-gather of this rank's ``x`` (the same shape on every rank) into
    [size * len(x), ...] in rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def barrier(mesh: Mesh) -> None:
    """Wait for this rank's device work, then for every rank of the mesh."""
    import torch.distributed as dist

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)


def _scan_offsets(mesh: Mesh, sizes):
    """Exclusive prefix sum of every rank's per-block ``sizes`` in global
    block order; returns this rank's slice, int32."""
    all_sizes = all_gather(mesh, sizes.to(torch.int32))
    offsets = torch.cumsum(all_sizes, 0) - all_sizes
    local = sizes.shape[0]
    return offsets[mesh.rank * local:(mesh.rank + 1) * local].to(torch.int32)


def sharded_decode_parse(mesh: Mesh, comp_mat, comp_lens):
    """Data-parallel decode parse: each rank parses its own blocks'
    segments (the parse kernel K1, ``ops/parse.py``), then per-block op
    counts are all-gathered and scanned so every rank knows the global op
    offsets of its blocks (reader.go:612-668 equivalent).

    comp_mat:  [n_local, P, S] packed compressed bytes (column = segment),
               this rank's blocks.
    comp_lens: [n_local, S] per-segment compressed lengths (<= P).
    Returns (recs [7, n + lanes] int32, lane_start [lanes] int32,
    counts [n_local, S] int32, op offsets [n_local] int32).  Lane
    ``b * S + s`` is segment s of local block b; its records sit in slots
    ``lane_start + lane`` onward (the dense layout of ``parse_segments``),
    and they are the non-zero rows of the JAX transducer parse.
    """
    mat = _local(mesh, comp_mat)
    lens = _local(mesh, comp_lens, torch.int32)
    nb, P, S = mat.shape
    # Segment-major bytes, each lane's valid prefix back to back.
    cols = mat.permute(0, 2, 1).to(torch.uint8)
    keep = torch.arange(P, device=mesh.device)[None, None, :] < lens[..., None]
    comp = cols[keep]
    lane_len = lens.reshape(-1)
    lane_start = (torch.cumsum(lane_len, 0) - lane_len).to(torch.int32)
    recs, counts = parse_segments(comp, lane_start, lane_len)
    counts = counts.reshape(nb, S)
    ops = counts.sum(dim=1, dtype=torch.int32)
    return recs, lane_start, counts, _scan_offsets(mesh, ops)


def sharded_encode_blocks(mesh: Mesh, data_blocks, n_valid, seg: int = 4096,
                          rng: int = 0, level: int = 2,
                          collectives: bool = True):
    """End-to-end data-parallel block encode: real bytes out.

    data_blocks: [n_local, N] byte values (N window-padded), this rank's
    blocks; n_valid: [n_local] valid byte counts.

    Per rank: match find -> greedy parse (kernel 8 on the card) ->
    byte-exact verify -> token emission (ops/emit.py), all on the device.
    Per-block compressed sizes are all-gathered and exclusive-scanned into
    deterministic stream offsets — the reference's ordered
    channel-of-channels (writer.go:214-272) replaced by a collective prefix
    sum.  ``collectives=False`` skips the exchange (offsets come back zero)
    so harnesses can measure the collective's cost apart.

    Returns (seg_bytes [n_local, nseg, seg+PAD] uint8,
             seg_lens [n_local, nseg] int32,
             block_sizes [n_local] int32,
             stream_offsets [n_local] int32).
    """
    data = _local(mesh, data_blocks)
    n = _local(mesh, n_valid, torch.int32)
    out, lens = emit.encode_block_emit(data, n, seg, rng, level)
    sizes = lens.sum(dim=1, dtype=torch.int32)
    if not collectives:
        return out, lens, sizes, torch.zeros_like(sizes)
    return out, lens, sizes, _scan_offsets(mesh, sizes)


def sharded_encode_blocks_dict(mesh: Mesh, dict_arr, data_blocks, n_valid,
                               seg: int = 4096):
    """Dict-aware data-parallel encode: ONE dictionary, broadcast from rank
    0 so every rank holds the same bytes, blocks split over the ranks.

    dict_arr: [D] dictionary bytes (the same length on every rank), D a
    multiple of ``seg`` (pad at the FRONT and hand the padded bytes to the
    decoder as its dict — match verification is byte-exact, so pad bytes
    are never falsely referenced).  data_blocks: [n_local, N]; n_valid:
    [n_local].

    Every block is encoded against the shared dictionary context: the
    match finder sees [dict || block], emission covers only the block's
    segments, and copies may reach back into the dictionary (decode with
    ``native.codec.decode_block_dict`` / oracle dict decode).  The range
    clamp is off in dict mode — dictionary references cross ranges by
    design, so these blocks take the whole-block decode road.

    Reference analog: dict-candidate encode (encode_l2.go:607,
    encode_l3.go:278-296) under writer concurrency (writer.go:214-272),
    with the broadcast replacing per-goroutine dict pointer sharing.

    Returns (seg_bytes [n_local, nseg, seg+PAD] uint8,
             seg_lens [n_local, nseg] int32,
             block_sizes [n_local] int32,
             stream_offsets [n_local] int32).
    """
    import torch.distributed as dist

    d = _local(mesh, dict_arr, torch.uint8).contiguous()
    D = d.shape[0]
    if D % seg:
        raise ValueError("dictionary length must be a multiple of seg "
                         "(front-pad and use the padded dict to decode)")
    dist.broadcast(d, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    data = _local(mesh, data_blocks, torch.uint8)
    n = _local(mesh, n_valid, torch.int32)
    combined = torch.cat([d[None, :].expand(data.shape[0], D), data], dim=1)
    # ctx=D // seg: the dict segments feed match finding/verification but
    # are never serialized — no wasted emission work.
    out, lens = emit.encode_block_emit(combined, n + D, seg, 0,
                                       ctx=D // seg)
    sizes = lens.sum(dim=1, dtype=torch.int32)
    return out, lens, sizes, _scan_offsets(mesh, sizes)


def assemble_blocks(seg_bytes, seg_lens, n_valid, seg: int = 4096):
    """Host assembly: per-block spec-valid MinLZ blocks from sharded
    emission output (None entry = incompressible, caller stores raw)."""
    from ..minlz import put_uvarint

    seg_bytes, seg_lens, n_valid = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (seg_bytes, seg_lens, n_valid))
    blocks = []
    for bi in range(seg_bytes.shape[0]):
        n = int(n_valid[bi])
        nseg = -(-n // seg)
        body = b"".join(
            seg_bytes[bi, i, : seg_lens[bi, i]].tobytes()
            for i in range(nseg)
        )
        if len(body) >= n:
            blocks.append(None)
        else:
            blocks.append(b"\x00" + put_uvarint(n) + body)
    return blocks


def sharded_pipeline_step(mesh: Mesh, data_blocks, n_valid, seg: int = 4096):
    """One data-parallel encode pipeline step.

    data_blocks: [n_local, block_size] byte values, this rank's blocks;
    n_valid: [n_local] valid byte counts.

    Per rank: full match finding + greedy parse (kernel 8 on the card) for
    its blocks; then an all-gather of per-block compressed-size estimates
    and an exclusive scan to produce deterministic stream output offsets.

    Returns (take, tok_off, tok_len [n_local, nseg, seg] int32,
             est_sizes [n_local] int32, out_offsets [n_local] int32).
    """
    data = _local(mesh, data_blocks)
    n = _local(mesh, n_valid, torch.int32)
    nb, N = data.shape
    nsegs = N // seg
    dist_, length = encode_kernel.find_matches_dyn(data, n, seg)
    take, tok_off, tok_len, _ = greedy_parse(
        dist_.to(torch.int32).reshape(nb * nsegs, seg),
        length.to(torch.int32).reshape(nb * nsegs, seg), seg)
    take, tok_off, tok_len = (
        x.reshape(nb, nsegs, seg) for x in (take, tok_off, tok_len))
    # Estimated compressed size: 3 bytes per token + literals.
    covered = tok_len.sum(dim=(1, 2), dtype=torch.int32)
    toks = take.sum(dim=(1, 2), dtype=torch.int32)
    est = toks * 3 + (n - covered)
    return take, tok_off, tok_len, est, _scan_offsets(mesh, est)
