"""Local ranks: spawn ``n`` processes that form one mesh, and run calls on it.

``run(calls, n, backend=..., devices=...)`` starts ``n`` processes with
``torch.multiprocessing`` (start method "spawn"), each of which joins a
``torch.distributed`` process group of world size ``n`` through a
rendezvous file (no TCP port, so concurrent runs never collide), opens its
``mesh.make_mesh`` on its own device, and calls every ``fn(mesh, *args)``
of ``calls`` in order.  Tensors in the results come back as numpy arrays.
Every run has a timeout: a rank that hangs, fails or outlives it ends the
whole run with an exception.

The functions a rank calls must be importable by a fresh interpreter, so
they live in the package: the ``sharded_*`` functions of ``mesh.py``,
``write_stream`` below, ``entry._dryrun_rank``.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta

import torch

FOREIGN = ("jax", "jaxlib", "minlz_tpu")


def device_map(devices, n: int) -> list[str]:
    """One device name per rank.  ``devices``: "cpu" (every rank on the
    CPU), "cuda" (rank r on card r % device_count, so ranks share cards
    when there are fewer cards than ranks), or a list of n names."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        return [str(d) for d in devices]
    if devices == "cpu":
        return ["cpu"] * n
    if devices == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("devices='cuda' but torch sees no CUDA GPU")
        return [f"cuda:{r % count}" for r in range(n)]
    raise ValueError(f"unsupported devices {devices!r}")


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, n, backend, devices, rdzv, out_dir, calls, timeout):
    import sys

    import torch.distributed as dist

    from .mesh import make_mesh

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # One thread a CPU rank: ranks share the host's cores, and torch's
        # thread pools in several processes oversubscribe them.
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{rdzv}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        mesh = make_mesh(device=dev)
        results = [_to_host(fn(mesh, *args[rank])) for fn, args in calls]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    if foreign:
        raise AssertionError(f"rank {rank} imported {foreign}")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run(calls, n: int, *, backend: str, devices, timeout: float = 300.0):
    """Run ``calls`` on ``n`` fresh ranks and return ``results[i][r]``, the
    result of call i on rank r.

    calls:   a list of (fn, per_rank_args); rank r calls
             ``fn(mesh, *per_rank_args[r])``.  Bind keyword arguments with
             ``functools.partial``.
    backend: "nccl" or "gloo", as ``init_process_group`` takes it.
    devices: see ``device_map``.
    timeout: seconds for the whole run and for each collective.
    """
    import torch.multiprocessing as mp

    devs = device_map(devices, n)
    for fn, args in calls:
        if len(args) != n:
            raise ValueError(f"{getattr(fn, '__name__', fn)}: "
                             f"{len(args)} argument tuples for {n} ranks")
    work = tempfile.mkdtemp(prefix="minlz_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main,
            args=(n, backend, devs, os.path.join(work, "rdzv"), work, calls,
                  timeout),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n} ranks ({backend}, {devs}) did not "
                                   f"finish within {timeout} s")
        per_rank = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                per_rank.append(pickle.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [[per_rank[r][i] for r in range(n)] for i in range(len(calls))]


def write_stream(mesh, data: bytes, writer_opts: dict, repeats: int = 1):
    """Write ``data`` through ``Writer(mesh=mesh)`` on the mesh's device
    ``repeats`` times.  Returns (stream bytes, seconds of the last write):
    every rank gets the same bytes; each write starts when every rank is
    ready and ends when every rank is done."""
    import io

    from ..stream import Writer
    from .mesh import barrier

    for _ in range(repeats):
        barrier(mesh)
        t0 = time.perf_counter()
        buf = io.BytesIO()
        with Writer(buf, device=mesh.device, mesh=mesh, **writer_opts) as w:
            w.write(data)
        barrier(mesh)
        secs = time.perf_counter() - t0
    return buf.getvalue(), secs
