"""Fine phase split of the two decode roads on the same blocks: parse,
parse + compact, and the full decode, for the range road (positioned
records, one thread block per 128 KiB range; ``--executor scheduled`` takes
the append-only form) and for the whole-block road (one thread block per
128 KiB tile of every block, then a fix-up pass), in ms/MB.

    python -m minlz_tpu_torch.scripts.probe_v2 [--device cuda|cpu]
        [--blocks 4] [--block-kb 1024] [--executor fast|scheduled]
        [--iters 3]
"""

from __future__ import annotations

import argparse

from ..bench import MB, add_common_args, card, corpus_segments, timed_device
from ..ops import exec_block as eb
from ..ops import exec_chain as ec
from ..ops import parse as ps
from ..ops.device_codec import RANGE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.probe_v2",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--block-kb", type=int, default=1024)
    ap.add_argument("--executor", choices=ec.EXECUTORS, default="fast")
    opt = ap.parse_args(argv)
    dev, it = opt.device, opt.iters
    block_size = opt.block_kb << 10
    _, segs, seg = corpus_segments(opt.blocks, dev, RANGE, block_size)
    mb = opt.blocks * block_size / MB
    where = card(dev)
    t_parse = None
    for tag, rng in (("range", RANGE), ("whole", 0)):
        plan = ec.plan_batch(segs, seg, rng)
        t = plan.tensors(dev)
        lanes = (t["comp"], t["lane_start"], t["lane_len"])
        dense = bool(rng) and opt.executor == "scheduled"

        def parse_compact():
            recs, counts = ps.parse_segments(*lanes)
            if dense:
                return ec.compact_records_dense(recs, counts, *lanes[1:])
            return ec.compact_records(recs, counts, *lanes[1:],
                                      t["lane_lo"], t["lane_hi"])

        def full():
            if rng:
                return ec.decode_planned(plan, dev, opt.executor, t)
            return eb.decode_planned_whole(plan, dev, t)

        if t_parse is None:
            t_parse, _ = timed_device(ps.parse_segments, lanes, it)
            print(f"parse          {t_parse * 1e3 / mb:8.4f} ms/MB  [{where}]")
        tc, _ = timed_device(parse_compact, (), it, device=dev)
        tf, _ = timed_device(full, (), it, device=dev)
        name = f"{tag}/{opt.executor}" if rng else tag
        print(f"{name}: +compact    {tc * 1e3 / mb:8.4f} ms/MB   "
              f"(compact {max(tc - t_parse, 0) * 1e3 / mb:.4f})  [{where}]")
        print(f"{name}: full        {tf * 1e3 / mb:8.4f} ms/MB   "
              f"(execute {max(tf - tc, 0) * 1e3 / mb:.4f})  [{where}]",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
