"""Ablation of the executor's per-record step on the card.

Runs ``ops.probe.ablate_exec`` on synthetic record chains (llen 0-4, clen
4-10, about 9.5 bytes a record, copies from 8 to 1999 bytes back) in its
five variants:
  full       literal move, then copy by out[d + i] = out[d - eff + i % eff]
  onewin     one literal-or-copy move per iteration of a state machine
  norealign  moves take their bytes from an aligned row (no byte shift)
  nomask     every slot stores a whole 512-byte window (no byte mask)
  minimal    one whole-row load and store per record
A thread block walks each chain, its region of --chain-rows rows staged in
shared memory; the grid has a block a chain.

    python -m minlz_tpu_torch.scripts.ablate_exec [--device cuda|cpu]
        [--ops 4096] [--chains 8 16] [--chain-rows 128] [--iters 3]
"""

from __future__ import annotations

import argparse

import torch

from ..bench import add_common_args, card, timed_device
from ..ops import probe


def run(variant, nchain=8, ops_per_chain=4096, chain_rows=128, device="cuda",
        iters=3):
    """ns per record of one variant."""
    counts, ops, arena = (torch.from_numpy(a).to(device)
                          for a in probe.ablate_inputs(
                              nchain, ops_per_chain, chain_rows, fill=True))
    t, _ = timed_device(
        probe.ablate_exec, (counts, ops, arena, variant, 8, chain_rows),
        iters)
    total = nchain * ops_per_chain
    # A block a chain (csrc/ablate.cu, launch).
    print(f"{variant:10s} nchain={nchain:2d} grid={nchain} blocks: "
          f"{t * 1e3:.4f} ms, {t * 1e9 / ops_per_chain:7.1f} ns/record of a "
          f"chain, "
          f"{t * 1e9 / total:6.1f} ns/op  [{card(device)}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.ablate_exec",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--ops", type=int, default=4096,
                    help="records per chain")
    ap.add_argument("--chains", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--chain-rows", type=int, default=128,
                    help="512-byte rows of each chain's region (at most "
                         "454: it is staged in shared memory)")
    opt = ap.parse_args(argv)
    for variant in probe.VARIANTS:
        for nchain in opt.chains:
            run(variant, nchain, opt.ops, opt.chain_rows, opt.device,
                opt.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
