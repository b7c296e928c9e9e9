"""Phase breakdown and primitive probes for the decode executors.

  phases   the port's parse alone against the whole batched decode on corpus
           blocks: records per MiB, bytes per record, ns per record.
  body     ``ops.probe.probe_chain_body``: per step two dependent row loads,
           a window realigned at a byte offset, a 64-byte mask, one row
           store; 1 and 8 to 32 chains, a thread block each, in shared
           memory on a buffer of --shared-rows rows (the JAX script's 4096:
           each block stages its chain's region of rows // chains rows; a
           chain count whose region does not fit a block is reported and
           not walked) and in device memory on a buffer of --rows rows.
  gather   rounds of torch indexing over 1 Mi elements: what a round of
           pointer jumping costs.
  scatter  a batched per-lane scatter (the sort-free compaction candidate).

    python -m minlz_tpu_torch.scripts.exec_probe [all|phases|body|gather|
        scatter] [--device cuda|cpu] [--blocks 4] [--block-kb 1024]
        [--executor fast|scheduled] [--steps 4096] [--rows 4096]
        [--shared-rows 4096] [--n 1048576] [--iters 3]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..bench import MB, add_common_args, card, corpus_segments, timed_device
from ..ops import exec_chain as ec
from ..ops import parse as ps
from ..ops import probe
from ..ops.device_codec import RANGE

BODY_CHAINS = (1, 8, 16, 32)   # 1: the bare latency of a step
BODY_MODES = ("minimal", "realign")


def phase_breakdown(n_blocks=4, device="cuda", iters=3, block_size=MB,
                    executor="fast"):
    """Parse against the whole batched decode (``decode_planned``) on
    corpus blocks."""
    _, segs, seg = corpus_segments(n_blocks, device, RANGE, block_size)
    plan = ec.plan_batch(segs, seg, RANGE)
    t = plan.tensors(device)
    t_parse, (_, counts) = timed_device(
        ps.parse_segments, (t["comp"], t["lane_start"], t["lane_len"]), iters)
    t_full, _ = timed_device(
        lambda: ec.decode_planned(plan, device, executor, t), (), iters,
        device=device)
    total = int(counts.sum())
    mb = n_blocks * block_size / MB
    where = card(device)
    print(f"batch {n_blocks} x {block_size >> 10} KiB, executor {executor}, "
          f"{len(plan.range_span)} ranges, {len(plan.lane_len)} lanes")
    print(f"records total {total} ({total / mb:.0f}/MiB, "
          f"{plan.total_out / max(total, 1):.1f} B/record, "
          f"{total / max(len(plan.range_span), 1):.0f} per range)")
    print(f"parse          {t_parse * 1e3:8.3f} ms "
          f"({t_parse * 1e3 / mb:.3f}/MB)  [{where}]")
    print(f"full pipeline  {t_full * 1e3:8.3f} ms "
          f"({t_full * 1e3 / mb:.3f}/MB)  [{where}]")
    print(f"compact+exec   {(t_full - t_parse) * 1e3:8.3f} ms "
          f"({(t_full - t_parse) * 1e9 / max(total, 1):.1f} ns/record)  "
          f"[{where}]", flush=True)


def bench_chain_body(n_ops=4096, n_chains=16, rows=4096, mode="realign",
                     space="global", device="cuda", iters=3):
    """ns per step of ``probe_chain_body`` on a buffer of ``rows`` rows."""
    meta, buf = (torch.from_numpy(a).to(device)
                 for a in probe.chain_body_inputs(n_ops, n_chains, rows,
                                                  fill=True))
    t, _ = timed_device(probe.probe_chain_body,
                        (meta, buf, n_chains, mode, space), iters)
    total = n_ops * n_chains
    # A block a chain (csrc/probe.cu, launch_body).
    print(f"chainbody mode={mode} chains={n_chains} space={space} "
          f"rows={rows} grid={n_chains} blocks: {t * 1e3:.4f} ms, "
          f"{t * 1e9 / n_ops:.1f} ns/step of a "
          f"chain, {t * 1e9 / total:.1f} ns/op  [{card(device)}]",
          flush=True)


def bench_gather_rounds(n=1 << 20, rounds=4, device="cuda", iters=3):
    """``rounds`` dependent rounds of ``x = tbl[x]`` over n elements (a
    library call, as in the JAX script): the cost of one round of pointer
    jumping."""
    rng = np.random.default_rng(3)
    tbl = torch.from_numpy(rng.integers(0, n, n, dtype=np.int32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n, n, dtype=np.int32)).to(device)

    def f(t_, x):
        for _ in range(rounds):
            x = t_[x.long()]
        return x

    t, _ = timed_device(f, (tbl, idx), iters, chain=4)
    per = t / rounds
    print(f"gather rounds, {n} elems: {per * 1e3:.4f} ms/round "
          f"({n / per / 1e9:.2f} G elem/s)  [{card(device)}]", flush=True)


def bench_scatter(L=256, P=2816, cap=8192, device="cuda", iters=3):
    """Per-lane scatter ``dense[l, rank] = value`` (a library call, as in
    the JAX script)."""
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(
        rng.integers(0, 1 << 20, (L, P), dtype=np.int32)).to(device)
    # ascending ranks with gaps (like records within a lane)
    idx = torch.from_numpy(
        np.sort(rng.integers(0, cap, (L, P)), axis=1)).to(device)

    def f(v, ix):
        return torch.zeros((L, cap), dtype=torch.int32,
                           device=v.device).scatter_(1, ix, v)

    t, _ = timed_device(f, (vals, idx), iters, chain=8)
    total = L * P
    print(f"scatter [{L},{P}]->[{L},{cap}]: {t * 1e3:.4f} ms "
          f"({total / t / 1e9:.2f} G elem/s)  [{card(device)}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.exec_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "phases", "body", "gather", "scatter"))
    add_common_args(ap)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--block-kb", type=int, default=1024)
    ap.add_argument("--executor", choices=ec.EXECUTORS, default="fast")
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--shared-rows", type=int, default=4096,
                    help="rows of the buffer in the shared space (each "
                         "chain's region of rows // chains must fit a "
                         "block's shared memory)")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="elements of the gather rounds")
    opt = ap.parse_args(argv)
    dev, it = opt.device, opt.iters
    if opt.which in ("all", "phases"):
        phase_breakdown(opt.blocks, dev, it, opt.block_kb << 10,
                        opt.executor)
    if opt.which in ("all", "body"):
        for mode in BODY_MODES:
            for space, rows in (("shared", opt.shared_rows),
                                ("global", opt.rows)):
                for chains in BODY_CHAINS:
                    need = probe.body_shared_bytes(rows, chains)
                    if space == "shared" and need > probe.SHARED_LIMIT:
                        print(f"chainbody mode={mode} chains={chains} "
                              f"space=shared rows={rows}: not walked, a "
                              f"region of {rows // chains} rows takes "
                              f"{need} bytes, more than a block's "
                              f"{probe.SHARED_LIMIT}", flush=True)
                        continue
                    bench_chain_body(opt.steps, chains, rows, mode, space,
                                     dev, it)
    if opt.which in ("all", "gather"):
        bench_gather_rounds(opt.n, 4, dev, it)
    if opt.which in ("all", "scatter"):
        bench_scatter(device=dev, iters=it)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
