"""Benchmark of the port: encode and decode throughput of one device, measured
on the deterministic mixed corpus, with a bit-exact round trip, as ONE JSON
line.  The counterpart of the JAX package's ``bench.py``; the probe scripts
under ``minlz_tpu_torch/scripts/`` take ``timed_device`` and ``make_corpus``
from here.

Each pipeline phase is timed on device-resident inputs and the sum is
reported:

  encode = device match-find + host parse and serialization (threaded)
  decode = device parse + compaction + execution of a batch of blocks

On a CUDA device the device phases are timed with CUDA events around a run
of calls made back to back, on the CPU (``--device cpu``, the plain torch
versions) with the host clock; a CPU run gives no device metric.  Every
encoded block is decoded by the spec oracle, the timed decode batch is
compared with its input, and 1 MiB goes through the stream Writer and
Reader.

    python -m minlz_tpu_torch.bench [--device cuda] [--mb 8] [--iters 4]
        [--enc-batch 4] [--dec-batch N] [--executor fast|scheduled]
        [--profile DIR]

``--profile DIR`` runs the device phases under ``torch.profiler`` and writes
a Chrome trace there.  Exits 1 when the round trip is not exact.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ._device import resolve_device
from .corpus import make_corpus  # noqa: F401  (the scripts import it here)

MB = 1 << 20
LEVEL = 2  # the stream Writer's default on a device


def card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them; every
    measured line carries it.  ``"cpu"`` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return lines[min(dev.index or 0, len(lines) - 1)]


def add_common_args(parser, iters: int = 3):
    """The options every measurement script takes."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--iters", type=int, default=iters,
                        help="timed repeats; the median is reported")
    return parser


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def timed_device(fn, args, iters, chain=None, device=None):
    """Median seconds per call of ``fn(*args)`` and the last result.

    On a CUDA device (``device``, or by default wherever a tensor of the
    arguments lies) one measurement is ``chain`` calls made back to back
    between two CUDA events, with one synchronisation at the end, so that
    launch gaps are amortised as in a pipeline that keeps the device fed;
    one call before the first measurement builds and warms what the call
    needs.  On the CPU it is the host clock around the calls, with no call
    before them: the plain versions build nothing at first use.  ``chain``
    defaults to 32 on the card and 1 on the CPU."""
    if device is not None:
        cuda = torch.device(device).type == "cuda"
    else:
        cuda = any(t.is_cuda for t in _tensors(args))
    if chain is None:
        chain = 32 if cuda else 1
    times, r = [], None
    if cuda:
        fn(*args)
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                r = fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / chain)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(chain):
                r = fn(*args)
            times.append((time.perf_counter() - t0) / chain)
    times.sort()
    return times[len(times) // 2], r


@contextlib.contextmanager
def profiled(profile_dir, name: str, device):
    """Run the body under ``torch.profiler`` and write
    ``<profile_dir>/<name>_trace.json`` (a Chrome trace); yields the
    profiler.  Without a directory it does nothing and yields None."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}_trace.json"))


def device_share(prof, top: int | None = 5) -> dict:
    """What a finished profile says of the device: the traced window (first
    device activity to the last), the time some kernel or copy ran in it,
    the idle share, and the ``top`` longest kernels by name (all of them
    for None).  Raises when the profile holds no device activity."""
    from torch.autograd import DeviceType

    return _share([(e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)], top)


# The Chrome trace's categories of device activity: what
# ``prof.events()`` lists on the CUDA device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_share(path: str, top: int | None = 5) -> dict:
    """``device_share`` of a Chrome trace that ``profiled`` wrote, from its
    GPU kernel, copy and memset events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return _share([(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATEGORIES], top)


def _share(spans, top):
    """spans: (name, start us, end us) of each device activity."""
    if not spans:
        raise RuntimeError("the profile holds no device activity: the "
                           "profiler cannot trace this device here")
    by_name = {}
    for name, a, b in spans:
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (b - a), calls + 1)
    spans = sorted((a, b) for _, a, b in spans)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    longest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_us": window, "busy_us": busy,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels": [(n, t, c) for n, (t, c) in longest]}


def corpus_segments(n_blocks: int, device, rng: int | None = None,
                    block_size: int = MB):
    """The first ``n_blocks`` blocks of the corpus, encoded on ``device``
    with the range clamp ``rng`` (default: the stream's 128 KiB; 0: none).
    Returns (blocks, per block the list of its segments' compressed bytes,
    segment size): what ``exec_chain.plan_batch`` takes."""
    from .ops import encode_kernel as ek
    from .ops.device_codec import RANGE, DeviceCodec, split_body
    from .oracle.decode import parse_header

    rng = RANGE if rng is None else rng
    corpus = make_corpus(n_blocks * block_size)
    blocks = [corpus[i * block_size:(i + 1) * block_size]
              for i in range(n_blocks)]
    seg = DeviceCodec._seg_for(block_size)
    segs = []
    for i, (blk, hints) in enumerate(
            ek.encode_blocks_device(blocks, seg, rng, LEVEL, device)):
        if blk is None:
            raise ValueError(f"block {i} of the corpus does not compress; "
                             f"use larger blocks")
        _, _, pos = parse_header(blk)
        segs.append(split_body(blk[pos:], [h[0] for h in hints]))
    return blocks, segs, seg


def encode_blocks_timed(blocks, dists, seg, rng, level, repeats: int = 3):
    """The host half of the encode, threaded over the host's cores (the
    native codec releases the GIL): median seconds of one pass over all
    blocks, and the (body, hints) results."""
    from concurrent.futures import ThreadPoolExecutor

    from .native.build import build_error
    from .native.codec import get_codec

    codec = get_codec()
    if codec is None:
        raise RuntimeError("the native codec did not build: "
                           f"{build_error()}")
    times, results = [], None
    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as pool:
        for _ in range(repeats):
            t0 = time.perf_counter()
            futs = [pool.submit(codec.parse_serialize, b, d, seg, rng, level)
                    for b, d in zip(blocks, dists)]
            results = [f.result() for f in futs]
            times.append(time.perf_counter() - t0)
    times.sort()
    for i, res in enumerate(results):
        if res is None:
            raise ValueError(f"block {i} of the corpus does not compress; "
                             f"use larger blocks")
    return times[len(times) // 2], results


def main(argv=None) -> int:
    from .minlz import put_uvarint
    from .ops import encode_kernel as ek
    from .ops import exec_chain as ec
    from .ops.device_codec import RANGE, DeviceCodec, split_body
    from .oracle import decode as odec
    from .stream import Reader, Writer

    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    add_common_args(ap, iters=4)
    ap.add_argument("--mb", type=float, default=8, help="corpus size, MiB")
    ap.add_argument("--block-kb", type=int, default=1024,
                    help="block size, KiB (a power of two; default 1 MiB)")
    ap.add_argument("--enc-batch", type=int, default=4,
                    help="blocks per match-find dispatch")
    ap.add_argument("--dec-batch", type=int, default=None,
                    help="blocks per decode dispatch (default 4; 1 with "
                         "--executor scheduled)")
    ap.add_argument("--executor", choices=ec.EXECUTORS, default="fast")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace the device phases with torch.profiler")
    opt = ap.parse_args(argv)

    t_start = time.time()
    dev = resolve_device(opt.device)
    block_size = opt.block_kb << 10
    corpus = make_corpus(int(opt.mb * MB))
    n_blocks = len(corpus) // block_size
    if n_blocks < 1:
        raise ValueError("the corpus is smaller than one block")
    corpus = corpus[:n_blocks * block_size]
    blocks = [corpus[i * block_size:(i + 1) * block_size]
              for i in range(n_blocks)]
    seg = DeviceCodec._seg_for(block_size)

    def batch_tensor(chunk):
        arr = np.stack([np.frombuffer(b, np.uint8) for b in chunk])
        return torch.from_numpy(arr).to(dev)

    # ---- encode, device phase: batched match finding -----------------------
    enc_batch = min(opt.enc_batch, n_blocks)
    ns = [block_size] * enc_batch

    def enc_step(a):
        # The range clamp keeps match sources inside 128 KiB ranges (parse
        # hints v2), so that decode can run range by range.
        return ek._find_matches_batch(a, ns, seg, RANGE, LEVEL)

    with profiled(opt.profile, "bench_encode", dev):
        t_enc_batch, _ = timed_device(
            enc_step, (batch_tensor(blocks[:enc_batch]),), opt.iters)
    t_enc_dev = t_enc_batch / enc_batch

    # ---- encode, host phase: parse + serialization -------------------------
    dists = []
    for i in range(0, n_blocks, enc_batch):
        chunk = blocks[i:i + enc_batch]
        d = ek._find_matches_batch(batch_tensor(chunk),
                                   [block_size] * len(chunk), seg, RANGE,
                                   LEVEL).cpu().numpy()
        dists.extend(d[j] for j in range(len(chunk)))
    t_enc_host, results = encode_blocks_timed(blocks, dists, seg, RANGE,
                                              LEVEL)
    bodies = [r[0] for r in results]
    all_hints = [r[1] for r in results]
    ratio = sum(len(b) for b in bodies) / len(corpus)

    # Every encoded block must decode bit-exact by the spec oracle.
    ok = all(odec.decode_block(b"\x00" + put_uvarint(len(b)) + body) == b
             for b, body in zip(blocks, bodies))

    # ---- decode, device phase: parse -> compact -> execute -----------------
    dec_batch = opt.dec_batch or (1 if opt.executor == "scheduled" else 4)
    dec_batch = min(dec_batch, n_blocks)
    plan = ec.plan_batch(
        [split_body(body, [h[0] for h in hints])
         for body, hints in zip(bodies[:dec_batch], all_hints[:dec_batch])],
        seg, RANGE)
    tensors = plan.tensors(dev)  # shipped once

    def dec_step():
        return ec.decode_planned(plan, dev, opt.executor, tensors)

    with profiled(opt.profile, "bench_decode", dev):
        t_dec_batch, out = timed_device(dec_step, (), opt.iters, device=dev)
    got = out.cpu().numpy()
    for (o, _), b in zip(plan.block_out, blocks):
        ok = ok and got[o:o + len(b)].tobytes() == b

    # ---- stream layer round trip (small, end to end) -----------------------
    small = corpus[:MB]
    buf = io.BytesIO()
    with Writer(buf, device=dev, block_size=min(256 << 10, block_size),
                add_index=False, concurrency=1) as w:
        w.encode_buffer(small)
    ok = ok and Reader(io.BytesIO(buf.getvalue()),
                       device=dev).readall() == small

    # ---- report ------------------------------------------------------------
    n = len(corpus)
    t_enc = t_enc_dev * n_blocks + t_enc_host
    t_dec = t_dec_batch / dec_batch * n_blocks
    per_mb = block_size / MB
    print(json.dumps({
        "metric": "encode+decode GB/s per device (mixed corpus, device "
                  "phases)",
        "value": round(n / (t_enc + t_dec) / 1e9, 4),
        "unit": "GB/s",
        "encode_gbps": round(n / t_enc / 1e9, 4),
        "decode_gbps": round(n / t_dec / 1e9, 4),
        "enc_device_ms_per_mb": round(t_enc_dev * 1000 / per_mb, 2),
        "enc_host_ms_per_mb": round(t_enc_host / n_blocks * 1000 / per_mb, 2),
        "dec_device_ms_per_mb": round(
            t_dec_batch / dec_batch * 1000 / per_mb, 2),
        "dec_batch": dec_batch,
        "executor": opt.executor,
        "ratio": round(ratio, 4),
        "roundtrip_exact": bool(ok),
        "corpus_mb": n / MB,
        "device": card(dev),
        "total_s": round(time.time() - t_start, 1),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
