"""Profile the decode stages separately on the card.

Times parse, parse + compact and parse + compact + execute through the
wrappers, as a caller pays them, on one decode road: ``whole`` (blocks
without a range clamp: ``exec_block.execute_blocks``) or ``range``
(``exec_chain.execute_ranges``).  Beside each stage stands the time of its
CUDA kernel alone: CUDA events around the bare launch on preallocated
outputs, with no allocation, zero fill, argument check or device-to-host
read in the window.  Then times torch primitives a parallel resolution
would be built from (index, chained index rounds, searchsorted, cumsum,
sort).

``--profile DIR`` also runs eight decodes under ``torch.profiler``, writes a
Chrome trace, and prints the device's busy and idle share of the traced
window and the five longest kernels.

    python -m minlz_tpu_torch.scripts.profile_decode [--device cuda|cpu]
        [--road whole|range] [--blocks 1] [--block-kb 1024] [--n 1048576]
        [--iters 3] [--profile DIR]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..bench import (MB, add_common_args, card, corpus_segments,
                     device_share, profiled, timed_device)
from ..ops import exec_block as eb
from ..ops import exec_chain as ec
from ..ops import parse as ps
from ..ops.device_codec import RANGE


def stage_times(road="whole", n_blocks=1, device="cuda", iters=3,
                block_size=MB, profile_dir=None):
    """Wrapper and kernel-alone times of the three decode stages.  Returns
    {"parse" | "compact" | "execute": (wrapper seconds, kernel seconds or
    None on the CPU)}; the wrapper times of compact and execute are
    differences of the cumulative runs."""
    rng = RANGE if road == "range" else 0
    blocks, segs, seg = corpus_segments(n_blocks, device, rng, block_size)
    plan = ec.plan_batch(segs, seg, rng)
    t = plan.tensors(device)
    lanes = (t["comp"], t["lane_start"], t["lane_len"])
    spans = (t["lane_start"], t["lane_len"], t["lane_lo"], t["lane_hi"])
    where = card(device)
    on_card = torch.device(device).type == "cuda"

    def parse_compact():
        recs, counts = ps.parse_planned(*lanes)
        return ec.compact_records(recs, counts, *spans)

    def full():
        crec, lane_out, total = parse_compact()
        first = ec.range_firsts(lane_out, total, t["range_lane"])
        args = (crec, first, t["range_out"], t["range_span"], t["comp"],
                plan.total_out)
        if rng:
            return ec.execute_ranges(*args, plan.max_span)
        return eb.execute_blocks(*args)

    t_parse, (recs, counts) = timed_device(ps.parse_planned, lanes, iters)
    t_pc, (crec, lane_out, total) = timed_device(parse_compact, (), iters,
                                                 device=device)
    t_full, out = timed_device(full, (), iters, device=device)
    got = out.cpu().numpy()
    for (o, _), b in zip(plan.block_out, blocks):
        if got[o:o + len(b)].tobytes() != b:
            raise AssertionError("the decode differs from the input")

    alone = dict.fromkeys(("parse", "compact", "execute"))
    if on_card:
        first = ec.range_firsts(lane_out, total, t["range_lane"])
        c_args = [x.contiguous() for x in (
            recs, t["lane_start"], t["lane_len"], counts, lane_out,
            t["lane_lo"], t["lane_hi"])]
        x_args = ec.range_args("execute", crec, 5, first, t["range_out"],
                               t["range_span"], t["comp"], plan.total_out)
        crec_out, bytes_out = torch.empty_like(crec), torch.empty_like(out)
        scratch = None if rng else eb.blocks_scratch(x_args, bytes_out)
        launches = {
            "parse": lambda: ps.launch_parse(*lanes, recs, counts),
            "compact": lambda: ec.launch_compact(ec.COMPACT, c_args,
                                                 crec_out),
            "execute": (lambda: ec.launch_execute(
                ec.EXEC, x_args, plan.max_span, bytes_out)) if rng else (
                lambda: eb.launch_blocks(x_args, bytes_out, scratch)),
        }
        for name, fn in launches.items():
            alone[name], _ = timed_device(fn, (), iters, device=device)
        n = int(total)
        if not torch.equal(crec_out[:, :n], crec[:, :n]) \
                or not torch.equal(bytes_out, out):
            raise AssertionError("a bare launch differs from its wrapper")

    def ms(x):
        return "not measured" if x is None else f"{x * 1e3:.4f} ms"

    n_recs = int(total)
    per_walk = max(n_recs / max(len(plan.range_span), 1), 1)
    print(f"road {road}: {n_blocks} x {block_size >> 10} KiB, "
          f"{t['comp'].numel()} compressed bytes, {len(plan.lane_len)} "
          f"lanes, {n_recs} records, {len(plan.range_span)} ranges")
    print(f"parse: wrapper {ms(t_parse)}, kernel alone "
          f"{ms(alone['parse'])}  [{where}]")
    print(f"parse+compact: wrapper {ms(t_pc)} (compact ~{ms(t_pc - t_parse)})"
          f", compact kernel alone {ms(alone['compact'])}  [{where}]")
    print(f"full: wrapper {ms(t_full)} (execute ~{ms(t_full - t_pc)}), "
          f"execute kernel alone {ms(alone['execute'])}"
          + (f" = {alone['execute'] * 1e9 / per_walk:.1f} ns/record of a "
             f"range or block ({per_walk:.0f} records each on average)"
             if on_card else "") + f"  [{where}]", flush=True)

    if profile_dir:
        with profiled(profile_dir, f"profile_decode_{road}", device) as prof:
            for _ in range(8):
                full()
            if on_card:
                torch.cuda.synchronize()
        if on_card:
            share = device_share(prof)
            print(f"traced window of 8 decodes: {share['window_us']:.0f} us, "
                  f"device busy {1 - share['idle_share']:.1%}, idle "
                  f"{share['idle_share']:.1%}  [{where}]")
            for name, us, calls in share["kernels"]:
                print(f"  {us:10.0f} us in {calls:3d} calls  {name}")
        else:
            print("traced on the CPU: no device share")
    return {"parse": (t_parse, alone["parse"]),
            "compact": (t_pc - t_parse, alone["compact"]),
            "execute": (t_full - t_pc, alone["execute"])}


def primitive_times(n=1 << 20, device="cuda", iters=3):
    """Torch primitives at n elements (library calls, as in the JAX
    script)."""
    rng = np.random.default_rng(0)
    where = card(device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    tbl = dev(rng.integers(0, n, n, dtype=np.int64))
    idx = dev(rng.integers(0, n, n, dtype=np.int64))
    tbl32 = tbl.to(torch.int32)
    t_take, _ = timed_device(lambda a, i: a[i], (tbl32, idx), iters)
    print(f"index {n}<-{n} int32: {t_take * 1e3:.4f} ms  [{where}]")

    def take_chain(a, i):
        for _ in range(8):
            i = a[i]
        return i

    t_chain, _ = timed_device(take_chain, (tbl, idx), iters)
    print(f"8x chained index: {t_chain * 1e3:.4f} ms "
          f"({t_chain / 8 * 1e3:.4f}/round)  [{where}]")
    tbl8 = dev(rng.integers(0, 127, n, dtype=np.int8))
    t_take8, _ = timed_device(lambda a, i: a[i], (tbl8, idx), iters)
    print(f"index {n}<-{n} int8: {t_take8 * 1e3:.4f} ms  [{where}]")
    m = max(n >> 4, 1)
    bnd = dev(np.sort(rng.integers(0, n, m).astype(np.int32)))
    q = dev(rng.integers(0, n, n, dtype=np.int32))
    t_ss, _ = timed_device(torch.searchsorted, (bnd, q), iters)
    print(f"searchsorted {n} q / {m} bnd: {t_ss * 1e3:.4f} ms  [{where}]")
    t_cs, _ = timed_device(lambda x: torch.cumsum(x, 0), (q,), iters)
    print(f"cumsum {n} int32: {t_cs * 1e3:.4f} ms  [{where}]")
    t_srt, _ = timed_device(lambda x: torch.sort(x).values, (q,), iters)
    print(f"sort {n} int32: {t_srt * 1e3:.4f} ms  [{where}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="minlz_tpu_torch.scripts.profile_decode",
        description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--road", choices=("whole", "range"), default="whole")
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--block-kb", type=int, default=1024)
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="elements of the primitive timings")
    ap.add_argument("--profile", metavar="DIR", default=None)
    opt = ap.parse_args(argv)
    stage_times(opt.road, opt.blocks, opt.device, opt.iters,
                opt.block_kb << 10, opt.profile)
    primitive_times(opt.n, opt.device, opt.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
