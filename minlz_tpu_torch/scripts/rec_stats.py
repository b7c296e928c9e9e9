"""Record statistics of the decode parse on the corpus.

Keeps the JAX script's classification, whose 512-byte row is a notion of the
TPU arena: a record is "fast" when its literal part fits one 512-byte row,
its copy part fits one row, and the copy does not overlap its own output
(csrc >= clen); everything else took the TPU's multi-pass state machine.
Adds two figures that matter on the card: records per 128 KiB range (what
the append-only executor walks and the parallel executors expand), and the
share of copies whose source overlaps their destination.

    python -m minlz_tpu_torch.scripts.rec_stats [--device cuda|cpu]
        [--mb 4] [--block-kb 1024]
"""

from __future__ import annotations

import argparse

import torch

from ..bench import MB, add_common_args, corpus_segments
from ..ops import exec_chain as ec
from ..ops import parse as ps
from ..ops.device_codec import RANGE

ROW_B = 512


def record_stats(recs, lane_out, n_recs, range_lane) -> dict:
    """Counts over the parse output ``recs`` [7, n_slots] (kind, dst, clen,
    csrc, lsrc, llen, lacc); the range figures need the lane offsets and
    the record total (``exec_chain.lane_offsets``)."""
    kind, dst, clen, csrc, _, llen, _ = recs.to(torch.int64)
    real = kind > 0
    q = dst & (ROW_B - 1)
    lit_ok = (llen == 0) | (q + llen <= ROW_B)
    q2 = (q + llen) & (ROW_B - 1)
    no_dbl = csrc >= clen
    cpy_ok = (clen == 0) | ((q2 + clen <= ROW_B) & no_dbl)
    fast = real & lit_ok & cpy_ok

    # Pass estimate for the slow records: literal rows, doubling rounds and
    # copy row crossings.
    lit_passes = torch.where(llen > 0, (q + llen + ROW_B - 1) // ROW_B, 0)
    eff0 = csrc.clamp(min=1)
    growth = (clen.float() / eff0.float()).clamp(min=1.0)
    dbl_rounds = torch.where((clen > 0) & (csrc < clen),
                             torch.ceil(torch.log2(growth)).long() + 1, 0)
    cpy_passes = torch.where(
        clen > 0,
        torch.maximum((q2 + clen + ROW_B - 1) // ROW_B, dbl_rounds), 0)
    passes = lit_passes.clamp(min=1) + cpy_passes - 1
    passes = torch.where(real, passes.clamp(min=1), 0)

    per_range = ec.range_firsts(lane_out, n_recs, range_lane).diff()
    r = {
        "n_real": real.sum(),
        "n_fast": fast.sum(),
        "n_dbl": (real & (clen > 0) & ~no_dbl).sum(),
        "n_litcross": (real & ~lit_ok).sum(),
        "n_cpycross": (real & (clen > 0) & no_dbl & (q2 + clen > ROW_B)).sum(),
        "tot_passes": passes.sum(),
        "slow_passes": torch.where(fast, 0, passes).sum(),
        "litonly": (real & (clen == 0)).sum(),
        "cpyonly": (real & (llen == 0)).sum(),
        "llen_sum": torch.where(real, llen, 0).sum(),
        "clen_sum": torch.where(real, clen, 0).sum(),
        "n_copies": (real & (clen > 0)).sum(),
        "range_max": per_range.max(),
        "n_ranges": per_range.numel(),
    }
    return {k: int(v) for k, v in r.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.rec_stats",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--mb", type=float, default=4)
    ap.add_argument("--block-kb", type=int, default=1024)
    opt = ap.parse_args(argv)
    block_size = opt.block_kb << 10
    n_blocks = max(int(opt.mb * MB) // block_size, 1)
    _, segs, seg = corpus_segments(n_blocks, opt.device, RANGE, block_size)
    plan = ec.plan_batch(segs, seg, RANGE)
    t = plan.tensors(opt.device)
    recs, counts = ps.parse_segments(t["comp"], t["lane_start"],
                                     t["lane_len"])
    lane_out, total = ec.lane_offsets(counts)
    r = record_stats(recs, lane_out, total, t["range_lane"])
    n = max(r["n_real"], 1)
    mb = n_blocks * block_size / MB
    print(f"MB={mb:g} records={r['n_real']} ({r['n_real'] / mb / 1024:.0f}"
          f"/KiB)")
    print(f"fast: {r['n_fast']} ({r['n_fast'] / n:.1%})")
    print(f"  doubling (csrc<clen): {r['n_dbl']} ({r['n_dbl'] / n:.2%})")
    print(f"  lit row-cross: {r['n_litcross']} ({r['n_litcross'] / n:.2%})")
    print(f"  copy row-cross: {r['n_cpycross']} ({r['n_cpycross'] / n:.2%})")
    print(f"lit-only: {r['litonly'] / n:.1%}  "
          f"copy-only: {r['cpyonly'] / n:.1%}")
    print(f"avg llen {r['llen_sum'] / n:.2f} avg clen {r['clen_sum'] / n:.2f}")
    print(f"est passes/record: {r['tot_passes'] / n:.3f} (slow records avg "
          f"{r['slow_passes'] / max(n - r['n_fast'], 1):.2f})")
    print(f"records per {RANGE >> 10} KiB range: "
          f"{r['n_real'] / max(r['n_ranges'], 1):.0f} on average over "
          f"{r['n_ranges']} ranges, {r['range_max']} at most")
    print(f"copies whose source overlaps their destination: {r['n_dbl']} of "
          f"{r['n_copies']} ({r['n_dbl'] / max(r['n_copies'], 1):.2%})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
