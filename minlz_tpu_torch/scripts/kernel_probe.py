"""Microbenchmarks of executor primitives on the card.

A) a serial chain of dependent row moves (one 512-byte row loaded and stored
   per step), 1 to 16 chains, a thread block (or a cluster of blocks) a
   chain, in shared memory and in device memory (L2) -> ns per step: the
   latency a record walk pays per move.  The shared walk stages each
   chain's region of the --rows buffer (4096 rows, as in the JAX script)
   in its block's shared memory, or across a cluster's blocks, whose rows
   the walker reaches through distributed shared memory; a configuration
   the card refuses is reported and not walked.
B) a gather of 1024 arbitrary int32 from a table of 4 to 36 KiB in shared
   memory, the iterations spread over clusters of blocks across the card
   -> elements/s under random bank conflicts.
C) a gather inside rows of 128 int32 held in a warp's registers, by warp
   shuffles, the iterations spread over clusters of blocks across the card
   -> elements/s.

    python -m minlz_tpu_torch.scripts.kernel_probe [--device cuda|cpu]
        [--steps 8192] [--rows 4096] [--gather-iters 512]
        [--taa-iters 2048] [--iters 3]
"""

from __future__ import annotations

import argparse

import torch

from ..bench import add_common_args, card, timed_device
from ..ops import probe

CHAINS = (1, 2, 4, 8, 16)


def _to(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _plan(name, plan, device) -> str:
    if torch.device(device).type != "cuda":
        return (f"plan grid={plan.grid} cluster={plan.cluster} (plain "
                f"version on the CPU)")
    launched = probe.LAUNCHED[name]
    return f"grid={launched.grid} cluster={launched.cluster}"


def bench_scalar(n_ops=8192, n_chains=1, rows=4096, space="global",
                 device="cuda", iters=3):
    """ns per step of ``probe_scalar``."""
    rows_t, buf = _to(device, *probe.scalar_inputs(n_ops, n_chains, rows,
                                                   fill=True))
    head = f"A chains={n_chains} space={space} rows={rows}"
    try:
        plan = probe.scalar_plan(rows, n_chains, space)
        t, _ = timed_device(probe.probe_scalar,
                            (rows_t, buf, n_chains, space), iters)
    except ValueError as e:
        print(f"{head}: not walked: {e}  [{card(device)}]", flush=True)
        return
    total = n_ops * n_chains
    print(f"{head} {_plan('probe_scalar', plan, device)}: "
          f"{t * 1e9 / n_ops:.1f} ns/step of a chain, "
          f"{t * 1e9 / total:.1f} ns/op ({total / t / 1e6:.1f} M ops/s)  "
          f"[{card(device)}]", flush=True)


def bench_gather(n_iters=512, tbl_vregs=1, device="cuda", iters=3):
    """Elements/s of ``probe_gather``."""
    tbl, idx = _to(device, *probe.gather_inputs(n_iters, tbl_vregs,
                                                wrap=True))
    plan = probe.gather_plan(n_iters, tbl.numel())
    t, _ = timed_device(probe.probe_gather, (tbl, idx), iters)
    total = n_iters * probe.GATHER_ELEMS
    print(f"B tbl={tbl_vregs * probe.GATHER_ELEMS} words "
          f"({tbl_vregs * 4}KiB) iters={n_iters} "
          f"{_plan('probe_gather', plan, device)}: "
          f"{t * 1e9 / total:.3f} ns/elem "
          f"({total / t / 1e9:.2f} G elem/s)  [{card(device)}]", flush=True)


def bench_taa(n_iters=2048, device="cuda", iters=3):
    """Elements/s of ``probe_taa``."""
    a, idx = _to(device, *probe.taa_inputs(n_iters, wrap=True))
    plan = probe.gather_plan(n_iters, 0)
    t, _ = timed_device(probe.probe_taa, (a, idx), iters)
    total = n_iters * probe.GATHER_ELEMS
    print(f"C in-row gather by shuffles iters={n_iters} "
          f"{_plan('probe_taa', plan, device)}: "
          f"{t * 1e9 / total:.3f} ns/elem "
          f"({total / t / 1e9:.2f} G elem/s)  [{card(device)}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.kernel_probe",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--steps", type=int, default=8192)
    ap.add_argument("--rows", type=int, default=4096,
                    help="buffer rows of both walks (2 MiB)")
    ap.add_argument("--gather-iters", type=int, default=512)
    ap.add_argument("--taa-iters", type=int, default=2048)
    opt = ap.parse_args(argv)
    dev, it = opt.device, opt.iters
    bench_taa(opt.taa_iters, dev, it)
    for vregs in (1, 2, 4):
        bench_gather(opt.gather_iters, vregs, dev, it)
    bench_gather(max(opt.gather_iters // 2, 1), 9, dev, it)
    for space in ("shared", "global"):
        for n_chains in CHAINS:
            bench_scalar(opt.steps, n_chains, opt.rows, space, dev, it)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
