"""Encode match-finder phase split on one corpus block.

Times ``find_matches_dyn`` at each level, then isolated tier passes at the
block's real geometry (the windowed sorts of the short and the stride-8
tier, and the run-length doubling), to rank where the match finder's time
goes.

    python -m minlz_tpu_torch.scripts.enc_probe [--device cuda|cpu]
        [--block-kb 1024] [--iters 3]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..bench import MB, add_common_args, card, make_corpus, timed_device
from ..ops import encode_kernel as ek
from ..ops.device_codec import RANGE, SEG, WINDOW


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.enc_probe",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--block-kb", type=int, default=1024,
                    help="block size, KiB (a multiple of 32)")
    opt = ap.parse_args(argv)
    dev, it = opt.device, opt.iters
    N = opt.block_kb << 10
    if N % (2 * WINDOW):
        raise ValueError("the block must be a multiple of 32 KiB")
    where = card(dev)
    flat = torch.from_numpy(
        np.frombuffer(make_corpus(N), np.uint8).reshape(1, N).copy()).to(dev)
    per_mb = N / MB

    for level in (-1, 1, 2, 3):
        t, _ = timed_device(
            lambda x: ek.find_matches_dyn(x, [N], SEG, RANGE, level)[0],
            (flat,), it)
        print(f"find_matches level {level:2d}: {t * 1e3 / per_mb:8.4f} "
              f"ms/MB  [{where}]")

    # Isolated passes at the real geometry.
    d = flat.to(torch.int64)
    v0 = (d | torch.roll(d, -1, 1) << 8 | torch.roll(d, -2, 1) << 16
          | torch.roll(d, -3, 1) << 24)
    W = 2 * WINDOW
    pos_bits0 = 15
    key = (((v0 * ek._PRIME4) & ek._M32) >> 16) << pos_bits0
    for nback, shift, tag in ((2, 0, "short aligned nb2"),
                              (1, W // 2, "short shifted nb1"),
                              (1, 0, "short aligned nb1")):
        t, _ = timed_device(
            lambda k: ek._window_pass(k, [], N, W, shift, nback=nback,
                                      pos_bits=pos_bits0)[0], (key,), it)
        print(f"{tag}: {t * 1e3:8.4f} ms  [{where}]")

    # Mid tier (stride 8): two value payloads.
    M = N // 8
    words = d.reshape(1, M, 8)
    w0 = (words[:, :, 0] | words[:, :, 1] << 8 | words[:, :, 2] << 16
          | words[:, :, 3] << 24)
    w1 = (words[:, :, 4] | words[:, :, 5] << 8 | words[:, :, 6] << 16
          | words[:, :, 7] << 24)
    keym = ((w0 * 31 + w1) & ek._M32) << ek._POS_BITS
    Wm = min(WINDOW, M)
    for shift, tag in ((0, "mid aligned"), (Wm // 2, "mid shifted")):
        t, _ = timed_device(
            lambda k, a, b: ek._window_pass(k, [a, b], M, Wm, shift,
                                            nback=1)[0], (keym, w0, w1), it)
        print(f"{tag}: {t * 1e3:8.4f} ms  [{where}]")

    t, _ = timed_device(lambda e: ek._run_doubling(e, 256), (flat > 0,), it)
    print(f"run_doubling cap256 on [1,{N}]: {t * 1e3:8.4f} ms  [{where}]",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
