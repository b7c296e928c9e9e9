"""Measure the all-device encode (``emit.encode_block_emit``: match find,
greedy parse, verify, token emission) on one corpus block: device time per
MB and ratio, then the time of each stage (the greedy parse and the token
emission also as their kernels alone, the bare launches into preallocated
outputs), against the host
serializer on the same match proposals.  The emitted block is decoded by the
spec oracle.

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
from ..ops import greedy as tg
from ..ops.device_codec import RANGE, SEG, WINDOW
from ..ops.emit import (OUT_PAD, emit_segments, encode_block_emit,
                       launch_emit, verify_extend)
from ..oracle import decode as odec


def stage_split(flat, n: int, iters: int, where: str) -> dict:
    """Seconds of each stage of ``encode_block_emit`` on ``flat`` [1, n],
    as it runs them, and of the greedy and emit kernels alone on the card
    (None on the CPU, where there is no kernel)."""
    dev = flat.device
    on_card = dev.type == "cuda"
    ns = [n]
    t_find, (dist, length) = timed_device(
        lambda f: ek.find_matches_dyn(f, ns, SEG, RANGE), (flat,), iters)
    off = dist.to(torch.int32).reshape(-1, SEG)
    lens = length.to(torch.int32).reshape(-1, SEG)
    t_greedy, (take, tok_off, _, _) = timed_device(
        lambda: tg.greedy_parse(dist.to(torch.int32).reshape(-1, SEG),
                                length.to(torch.int32).reshape(-1, SEG),
                                SEG), (), iters, device=dev)
    alone = None
    if on_card:
        out = torch.empty((4, *off.shape), dtype=torch.int32, device=dev)
        alone, _ = timed_device(lambda: tg.launch_greedy(off, lens, SEG, out),
                                (), iters, device=dev)
        if not torch.equal(out[0], take) or not torch.equal(out[1], tok_off):
            raise AssertionError("the bare greedy launch differs from "
                                 "greedy_parse")
    take, tok_off = take.reshape(1, n), tok_off.reshape(1, n)
    t_verify, (surv, vlen) = timed_device(
        lambda: verify_extend(flat, take, tok_off, ns, SEG), (), iters,
        device=dev)
    t_emit, (e_out, e_lens) = timed_device(
        lambda: emit_segments(flat, surv, tok_off, vlen, ns, SEG), (), iters,
        device=dev)
    e_alone = None
    if on_card:
        data = flat.to(torch.uint8)
        n_t = torch.tensor(ns, dtype=torch.int32, device=dev)
        out = torch.empty_like(e_out)
        lens_out = torch.empty_like(e_lens)
        assert out.shape[-1] == SEG + OUT_PAD
        e_alone, _ = timed_device(
            lambda: launch_emit(data, surv, tok_off, vlen, n_t, SEG, out,
                                lens_out), (), iters, device=dev)
        if not torch.equal(out, e_out) or not torch.equal(lens_out, e_lens):
            raise AssertionError("the bare emit launch differs from "
                                 "emit_segments")
    per_mb = n / MB
    res = {"match_find": t_find, "greedy": t_greedy, "greedy_alone": alone,
           "verify_extend": t_verify, "emit_segments": t_emit,
           "emit_alone": e_alone}
    print("stages, ms/MB: " + ", ".join(
        f"{k} " + ("not measured" if v is None else f"{v * 1e3 / per_mb:.4f}")
        for k, v in res.items()) + f"  [{where}]", flush=True)
    return res


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
    stage_split(flat, n, opt.iters, where)

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
