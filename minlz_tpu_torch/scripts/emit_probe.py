"""Measure the all-device encode (``emit.encode_block_emit``: match find,
greedy parse, verify, token emission) on one corpus block: device time per
MB and ratio, against the host serializer on the same match proposals.  The
emitted block is decoded by the spec oracle.

    python -m minlz_tpu_torch.scripts.emit_probe [--device cuda|cpu]
        [--block-kb 1024] [--iters 3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..bench import MB, add_common_args, card, make_corpus, timed_device
from ..minlz import put_uvarint
from ..native.build import build_error
from ..native.codec import get_codec
from ..ops import encode_kernel as ek
from ..ops.device_codec import RANGE, SEG, WINDOW
from ..ops.emit import encode_block_emit
from ..oracle import decode as odec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.emit_probe",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--block-kb", type=int, default=1024,
                    help="block size, KiB (a multiple of 32)")
    opt = ap.parse_args(argv)
    dev = opt.device
    n = opt.block_kb << 10
    if n % (2 * WINDOW):
        raise ValueError("the block must be a multiple of 32 KiB")
    where = card(dev)
    corpus = make_corpus(n)
    per_mb = n / MB
    flat = torch.from_numpy(
        np.frombuffer(corpus, np.uint8).reshape(1, n).copy()).to(dev)

    t_emit, (out, out_lens) = timed_device(
        lambda f: encode_block_emit(f, [n], SEG, RANGE), (flat,), opt.iters,
        chain=8 if torch.device(dev).type == "cuda" else 1)
    out = out.cpu().numpy()[0]
    out_lens = out_lens.cpu().numpy()[0]
    body = b"".join(out[s, :out_lens[s]].tobytes()
                    for s in range(out.shape[0]))
    print(f"device emit: {t_emit * 1e3 / per_mb:.4f} ms/MB, "
          f"ratio {len(body) / n:.4f}  [{where}]")
    if odec.decode_block(b"\x00" + put_uvarint(n) + body) != corpus:
        raise AssertionError("the emitted block does not decode to its "
                             "input")
    print("emit stream decodes bit-exact")

    # The host path on the same match proposals: the serializer's cost.
    codec = get_codec()
    if codec is None:
        raise RuntimeError(f"the native codec did not build: {build_error()}")
    dist = ek._find_matches_batch(flat, [n], SEG, RANGE).cpu().numpy()[0]
    t0 = time.perf_counter()
    host_body, _ = codec.parse_serialize(corpus, dist, SEG, RANGE)
    t_host = time.perf_counter() - t0
    print(f"host parse+serialize: {t_host * 1e3 / per_mb:.4f} ms/MB, "
          f"ratio {len(host_body) / n:.4f}  [host clock; {where}]",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
