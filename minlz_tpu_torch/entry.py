"""Entry points for a quick check: one forward step, and a mesh dry run.

The counterparts of the JAX package's ``__graft_entry__.py``: ``entry()``
sends the same 64 KiB of seeded input through the full-block match finder
and the greedy parse; ``dryrun_multichip(n)`` runs the same five phases on
a mesh of ``n`` ranks (``parallel.ranks``).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.encode_kernel import find_matches_dyn
from .ops.greedy import greedy_parse


def entry(device="cuda"):
    """Returns (fn, args): ``fn(*args)`` runs match finding and the greedy
    parse on ``device`` and returns (take.sum(), tok_len.sum())."""
    n = 64 * 1024
    seg = 4096
    dev = resolve_device(device)

    def step(data_flat):
        dist, length = find_matches_dyn(data_flat, [n], seg)
        nseg = n // seg
        take, _, tok_len, _ = greedy_parse(
            dist.to(torch.int32).reshape(nseg, seg),
            length.to(torch.int32).reshape(nseg, seg), seg)
        return take.sum(), tok_len.sum()

    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 64, (1, n)).astype(np.int32)).to(dev)
    return step, (data,)


def _twain() -> bytes:
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "testdata", "Mark.Twain-Tom.Sawyer.txt"),
              "rb") as f:
        return f.read()


def _timed(mesh, fn):
    """Seconds of one call of fn() after a warm-up call, every rank of
    ``mesh`` starting together."""
    import time

    from .parallel.mesh import barrier

    fn()
    barrier(mesh)
    t0 = time.perf_counter()
    fn()
    barrier(mesh)
    return time.perf_counter() - t0


def _dryrun_rank(mesh, compute_kb: int, per_rank: int):
    """The five phases of ``dryrun_multichip`` on one rank; returns the
    lines to print (rank 0's are printed)."""
    import io

    import torch.distributed as dist

    from .minlz import put_uvarint
    from .oracle import decode as odec
    from .oracle import encode as oenc
    from .oracle.decode import parse_header
    from .parallel import (assemble_blocks, sharded_decode_parse,
                           sharded_encode_blocks, sharded_pipeline_step)
    from .parallel.mesh import all_gather, make_mesh
    from .stream import Reader, Writer

    n, r = mesh.size, mesh.rank
    lines = []

    def mine(x):
        local = x.shape[0] // n
        return x[r * local:(r + 1) * local]

    def gathered(x):
        return all_gather(mesh, x).cpu().numpy()

    # --- the pipeline step's offset scan ------------------------------------
    rng = np.random.default_rng(0)
    bs = 16384  # tiny blocks for the dry run
    nb = n * 2
    blocks = rng.integers(0, 64, (nb, bs)).astype(np.int32)
    valid = np.full((nb,), bs, np.int32)
    _, _, _, est, offs = sharded_pipeline_step(mesh, mine(blocks),
                                               mine(valid))
    offs, est = gathered(offs), gathered(est)
    assert offs.shape == (nb,)
    assert (np.diff(offs) == est[:-1]).all(), "offset scan mismatch"

    # --- end-to-end sharded encode: real bytes, decoded bit-exact -----------
    twain = _twain()
    seg = 4096
    N = 32768  # level-0 sort window padding (encode_kernel.WINDOW * 2)
    nb2 = n * 2
    raw = []
    mat = np.zeros((nb2, N), np.int32)
    for b in range(nb2):
        d = (twain[b * 977:] + twain * 3)[:N]
        raw.append(d)
        mat[b] = np.frombuffer(d, np.uint8)
    valid2 = np.full((nb2,), N, np.int32)
    seg_bytes, seg_lens, sizes, soffs = sharded_encode_blocks(
        mesh, mine(mat), mine(valid2), seg)
    sizes, soffs = gathered(sizes), gathered(soffs)
    assert (np.diff(soffs) == sizes[:-1]).all(), "stream offset scan"
    enc_blocks = assemble_blocks(seg_bytes, seg_lens, mine(valid2), seg)
    hdr = 1 + len(put_uvarint(N))
    local = nb2 // n
    for k, blk in enumerate(enc_blocks):
        b = r * local + k
        assert blk is not None and len(blk) - hdr == sizes[b]
        assert odec.decode_block(blk) == raw[b], f"block {b} not bit-exact"

    # --- scaling measurement: compute-sized workload ------------------------
    # The same total work at world n and at world 1 (rank 0 alone, in a
    # group of its own), timed after a warm-up call.  Ranks that share a
    # card or the host's cores cannot run faster than one rank on the same
    # work; equal times mean the split and the collective add nothing.
    bs3 = compute_kb * 1024
    nb3 = n * per_rank
    raw3 = np.zeros((nb3, bs3), np.uint8)
    for b in range(nb3):
        d = (twain[b * 977:] + twain * ((bs3 // len(twain)) + 2))[:bs3]
        raw3[b] = np.frombuffer(d, np.uint8)
    data3 = torch.from_numpy(raw3).to(mesh.device)
    valid3 = np.full((nb3,), bs3, np.int32)
    t_n = _timed(mesh, lambda: sharded_encode_blocks(
        mesh, mine(data3), mine(valid3), seg, level=-1))
    solo = dist.new_group([dist.get_global_rank(mesh.group, 0)])
    t_1 = None
    if r == 0:
        one = make_mesh(solo, mesh.device)
        t_1 = _timed(one, lambda: sharded_encode_blocks(
            one, data3, valid3, seg, level=-1))
    dist.barrier(group=mesh.group)
    dist.destroy_process_group(solo)
    if r == 0:
        overhead = 100.0 * (t_n - t_1) / max(t_1, 1e-9)
        mb = nb3 * bs3 / (1 << 20)
        lines.append(
            f"sharded encode: {nb2} blocks bit-exact; workload {mb:g} MiB "
            f"({per_rank} x {bs3 >> 10} KiB blocks/rank); same total work: "
            f"{n}-rank mesh {t_n * 1000:.0f}ms vs 1 rank {t_1 * 1000:.0f}ms "
            f"-> mesh+collective overhead {overhead:+.1f}% on "
            f"{mesh.device.type} ranks (per-block exchange is a 4-byte "
            f"all-gather)")

    # --- decode direction: sharded parse + collective op scan ---------------
    data = bytes(rng.integers(65, 91, 4096, dtype=np.uint8)) * 2
    enc = oenc.encode_block(data)
    _, _, pos = parse_header(enc)
    segb = np.frombuffer(enc[pos:], np.uint8)
    P = 1 << int(len(segb)).bit_length()
    mat4 = np.zeros((nb, P, 2), np.int32)
    lens4 = np.zeros((nb, 2), np.int32)
    mat4[:, : len(segb), 0] = segb
    lens4[:, 0] = len(segb)
    _, _, counts, doffs = sharded_decode_parse(mesh, mine(mat4), mine(lens4))
    ops = gathered(counts.sum(dim=1, dtype=torch.int32))
    doffs = gathered(doffs)
    assert (np.diff(doffs) == ops[:-1]).all(), "decode op scan mismatch"

    # --- public API over the mesh: Writer(mesh=...) -> Reader ---------------
    payload = b"".join(
        (twain[i * 1303:] + twain * 6)[: 48 * 1024] for i in range(n))
    buf = io.BytesIO()
    with Writer(buf, device=mesh.device, mesh=mesh, block_size=16 * 1024,
                add_index=False, concurrency=1) as w:
        w.write(payload)
    stream_bytes = buf.getvalue()
    got = Reader(io.BytesIO(stream_bytes), device=mesh.device).readall()
    assert got == payload, "mesh Writer/Reader stream round-trip"
    lines.append(
        f"mesh stream: {len(payload) >> 10} KiB through "
        f"Writer(mesh={n} ranks) -> Reader bit-exact "
        f"({len(stream_bytes)} compressed bytes)")
    return lines


def dryrun_multichip(n_devices: int, backend: str = "nccl", device="cuda",
                     compute_kb: int = 512, per_rank: int = 4,
                     timeout: float = 600.0) -> None:
    """Run one sharded pipeline step, a sharded encode decoded bit-exact, a
    compute-sized encode at world n against world 1, the sharded decode
    parse's op scan and a Writer(mesh=) -> Reader round trip on a mesh of
    ``n_devices`` local ranks.  ``backend`` and ``device`` are those of
    ``parallel.ranks.run`` ("nccl" on "cuda", one rank a card, or "gloo"
    on "cpu"); ``compute_kb`` and ``per_rank`` size the timed workload.
    Raises if a phase fails."""
    from functools import partial

    from .parallel import ranks

    fn = partial(_dryrun_rank, compute_kb=compute_kb, per_rank=per_rank)
    lines = ranks.run([(fn, [()] * n_devices)], n_devices, backend=backend,
                      devices=device, timeout=timeout)[0][0]
    for line in lines:
        print(line, flush=True)
