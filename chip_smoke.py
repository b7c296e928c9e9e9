"""Smoke run of minlz_tpu_torch on one CUDA GPU.

Builds the port's native host library and its CUDA kernels from the sources
in the checkout, holds each kernel against its plain torch version (on real
batches and on mutated or hostile input), checks the match finder on the
card against the CPU, and drives the port's two main paths at full width,
each a 32 MiB stream through minlz_tpu_torch.stream.Writer and Reader: the
serializer path (match finder on the card, native host serializer) and the
all-device path (Writer(device_emit=True): match find, greedy parse, verify
and token emission on the card).  Then it times each phase.  It imports
nothing of jax or of the JAX package.  Prints a JSON line of kernel results,
then, as its last line, {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero.

    python3 chip_smoke.py
"""

import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MB = 1 << 20
LEVEL = 2
SEG = 4096
BATCH_BLOCKS = 8        # the Reader's decode batch
ENCODE_BATCH = 16       # the Writer's encode batch
STREAM_MB = 32
MUTATED_PAIRS = 16
MUTATED_BLOCK = 32 << 10
REPEATS = 5

HOSTILE_LANES = 4096    # random int32 proposals for the greedy kernel
FOREIGN = ("jax", "jaxlib", "bench", "minlz_tpu")

# Published peaks of one H100 SXM: device memory rate, and the float32 rate
# outside the tensor cores, taken as the rate of scalar int32 arithmetic.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "parse": ("minlz_tpu_torch/csrc/parse.cu",
              "minlz_tpu/ops/pallas_decode.py:56"),
    "compact": ("minlz_tpu_torch/csrc/compact.cu",
                "minlz_tpu/ops/exec_chain.py:394"),
    "exec_range": ("minlz_tpu_torch/csrc/exec_range.cu",
                   "minlz_tpu/ops/exec_chain.py:774"),
    "greedy": ("minlz_tpu_torch/csrc/greedy.cu",
               "minlz_tpu/ops/pallas_encode.py:29"),
}
# The path whose run gives each kernel's "launches".
CLAIMED_ON = {"parse": "serializer", "compact": "serializer",
              "exec_range": "serializer", "greedy": "device_emit"}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=REPEATS):
    """Median milliseconds of fn() by CUDA events, after a warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def once_ms(fn):
    """(result, milliseconds) of one call of fn(), by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return res, a.elapsed_time(b)


def host_ms(fn, repeats=3):
    """Median milliseconds of fn() on the host clock, ending in a sync."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def require_equal(label, x, y) -> int:
    """Max absolute difference of two integer tensors; raises unless 0."""
    if x.shape != y.shape:
        raise AssertionError(f"{label}: shape {tuple(x.shape)} != "
                             f"{tuple(y.shape)}")
    err = 0
    if x.numel():
        err = int((x.to(torch.int64) - y.to(x.device, torch.int64))
                  .abs().max())
    if err:
        raise AssertionError(f"{label}: kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes and do n_ops, the larger of the two times."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def foreign_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def hostile_proposals(lanes: int, seg: int, dev):
    """Random int32 off/len with negative and huge lengths, equal offsets
    in runs, and a huge length at the first and last position."""
    g = torch.Generator(device="cpu").manual_seed(0xD15EA5E)
    lo, hi = -(1 << 31), (1 << 31) - 1
    off = torch.randint(lo, hi, (lanes, seg), generator=g, dtype=torch.int64)
    ln = torch.randint(lo, hi, (lanes, seg), generator=g, dtype=torch.int64)
    small = torch.rand((lanes, seg), generator=g) < 0.97
    ln = torch.where(small, torch.randint(-3, 40, (lanes, seg), generator=g),
                     ln)
    near = torch.rand((lanes, seg), generator=g) < 0.5
    off = torch.where(near, torch.randint(-1, 3, (lanes, seg), generator=g),
                      off)
    ln[:, -1] = hi
    ln[0, 0] = hi
    ln[1, 0] = lo
    return (off.to(torch.int32).to(dev).contiguous(),
            ln.to(torch.int32).to(dev).contiguous())


def run_stages(t, plan, plain: bool):
    """parse -> compact -> execute on plan tensors ``t``, with the kernels
    or with the plain versions.  Returns every stage's output."""
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import parse as ps

    parse = ps.parse_segments_plain if plain else ps.parse_segments
    compact = ec.compact_records_plain if plain else ec.compact_records
    execute = ec.execute_ranges_plain if plain else ec.execute_ranges
    recs, counts = parse(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out = compact(recs, counts, t["lane_start"], t["lane_len"],
                             t["lane_lo"], t["lane_hi"])
    first = ec.range_firsts(lane_out, crec.shape[1], plan.spr)
    out = execute(crec, first, t["range_out"], t["range_span"], t["comp"],
                  plan.total_out, plan.rng)
    return recs, counts, crec, lane_out, first, out


STAGE_LABELS = ("parse records", "parse counts", "compacted records",
                "lane offsets", "range offsets", "decoded bytes")


def round_trip(label, corpus, dev, **writer_opts):
    """One main path: corpus -> Writer(**writer_opts) -> Reader on the
    card and Reader on the host.  The launch counts are set to 0 just
    before and read just after.  Returns the launch counts."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.stream import Reader, Writer

    n = len(corpus) // MB
    _build.reset_launches()
    buf = io.BytesIO()
    w = Writer(buf, device=dev, level=LEVEL, block_size=MB, **writer_opts)
    with w:
        w.write(corpus)
    stream = buf.getvalue()
    r = Reader(io.BytesIO(stream), device=dev)
    back = r.readall()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if back != corpus:
        raise AssertionError(f"{label}: the device Reader did not round-trip")
    if Reader(io.BytesIO(stream), device=None).readall() != corpus:
        raise AssertionError(f"{label}: the host Reader cannot read the "
                             f"port's stream")
    if w.codec.blocks_encoded != n or r.codec.blocks_decoded != n:
        raise AssertionError(
            f"{label}: device blocks: {w.codec.blocks_encoded} encoded, "
            f"{r.codec.blocks_decoded} decoded, want {n} of {n}")
    log(f"main path ({label}): {n} MiB -> {len(stream)} bytes (ratio "
        f"{len(stream) / len(corpus):.4f}); {n} of {n} blocks encoded and "
        f"{n} of {n} decoded on the device; launches {launches}")
    return launches


def main():
    # ---- 1. card and versions -------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA GPU")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # Importing the package builds the native host library (the CRC of
    # minlz.py loads it), so the import is timed as that build.
    t0 = time.perf_counter()
    from minlz_tpu_torch import _build, minlz
    from minlz_tpu_torch.corpus import make_corpus
    from minlz_tpu_torch.minlz import CorruptError
    from minlz_tpu_torch.native import build as native_build
    from minlz_tpu_torch.native.codec import get_codec
    from minlz_tpu_torch.ops import emit
    from minlz_tpu_torch.ops import encode_kernel as ek
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import greedy as tg
    from minlz_tpu_torch.ops import parse as ps
    from minlz_tpu_torch.ops.device_codec import (
        RANGE, DeviceCodec, parse_hints, split_body)
    from minlz_tpu_torch.oracle.decode import decode_block, parse_header
    from minlz_tpu_torch.testing import mutate

    if foreign_modules():
        raise AssertionError(f"the port pulled in {foreign_modules()}")
    dev = torch.device("cuda", 0)

    # ---- 2. build ----------------------------------------------------------
    native = get_codec()
    if native is None or minlz._crc32c_impl is None:
        raise AssertionError("the port's native library did not build: "
                             f"{native_build.build_error()}")
    log(f"build: g++ native host library and the package import, "
        f"{time.perf_counter() - t0:.2f} s")
    secs, _ = _build.build()
    _build.load()
    log(f"build: nvcc sm_90a, {len(KERNELS)} kernels in parallel, "
        f"{secs:.2f} s")

    # ---- 3. decode kernels against their plain versions ------------------
    corpus = make_corpus(STREAM_MB * MB)
    codec = DeviceCodec(dev)

    def segments(block, payload):
        _, _, pos = parse_header(block)
        return split_body(block[pos:], parse_hints(payload)[1])

    blocks = [corpus[i * MB:(i + 1) * MB] for i in range(BATCH_BLOCKS)]
    enc = codec.encode_batch(blocks, LEVEL)
    if any(e is None for e in enc):
        raise AssertionError("a corpus block did not compress")
    plan = ec.plan_batch([segments(*e) for e in enc], SEG, RANGE)
    t = plan.tensors(dev)
    recs, counts, crec, lane_out, first, out = run_stages(t, plan, False)
    torch.cuda.synchronize()
    args_parse = (t["comp"], t["lane_start"], t["lane_len"])
    args_compact = (recs, counts, t["lane_start"], t["lane_len"],
                    t["lane_lo"], t["lane_hi"])
    args_exec = (crec, first, t["range_out"], t["range_span"], t["comp"],
                 plan.total_out, plan.rng)
    err, plain_ms = {}, {}
    (recs_p, counts_p), plain_ms["parse"] = once_ms(
        lambda: ps.parse_segments_plain(*args_parse))
    err["parse"] = max(require_equal("parse counts", counts, counts_p),
                       require_equal("parse records", recs, recs_p))
    (crec_p, lane_out_p), plain_ms["compact"] = once_ms(
        lambda: ec.compact_records_plain(*args_compact))
    require_equal("lane offsets", lane_out, lane_out_p)
    err["compact"] = require_equal("compacted records", crec, crec_p)
    out_p, plain_ms["exec_range"] = once_ms(
        lambda: ec.execute_ranges_plain(*args_exec))
    err["exec_range"] = require_equal("decoded bytes", out, out_p)
    host = out.cpu().numpy()
    for (o, _), b in zip(plan.block_out, blocks):
        if host[o:o + len(b)].tobytes() != b:
            raise AssertionError("the kernels' decode differs from the input")
    n_comp, lanes = t["comp"].numel(), len(plan.lane_len)
    n_recs, n_ranges = crec.shape[1], len(plan.range_span)
    log(f"decode kernels == plain versions (tolerance 0: integers and "
        f"bytes) on {BATCH_BLOCKS} x 1 MiB: {n_comp} compressed bytes, "
        f"{lanes} lanes, {n_recs} records, {n_ranges} ranges")
    k_ms = {
        "parse": cuda_ms(lambda: ps.parse_segments(*args_parse)),
        "compact": cuda_ms(lambda: ec.compact_records(*args_compact)),
        "exec_range": cuda_ms(lambda: ec.execute_ranges(*args_exec)),
    }
    # Bytes each function must move (inputs once, outputs once) and its
    # integer operations, counted from this batch.  parse: the compressed
    # bytes and two lane arrays in, seven int32 record fields per slot and
    # the counts out; about 40 operations per compressed byte.  compact:
    # five fields of each record and seven lane arrays in, five fields and
    # the lane offsets out; about 30 operations per record.  exec_range:
    # five fields per record, three range arrays and the literal source
    # bytes in, the decoded bytes out; about 2 operations per byte out.
    bounds = {
        "parse": bound(n_comp + 8 * lanes + 28 * (n_comp + lanes)
                       + 4 * lanes, 40 * n_comp),
        "compact": bound(20 * n_recs + 28 * lanes + 20 * n_recs + 8 * lanes,
                         30 * n_recs),
        "exec_range": bound(20 * n_recs + 16 * n_ranges + n_comp
                            + plan.total_out, 2 * plan.total_out),
    }

    # Mutated block/hint pairs: CorruptError or bytes, no CUDA fault, and
    # kernel == plain version (run on the CPU) wherever the pipeline runs.
    # Each pair is tried with both parts mutated and with the body alone.
    def mutated_case(label, body, payload, want):
        try:
            got = codec.decode(body, payload, want)
        except CorruptError:
            torch.cuda.synchronize()
            return False
        except NotImplementedError:
            if parse_hints(payload)[2] != 0:
                raise
            return False  # well-formed hints without a range clamp
        seg, rng_b, segs = codec._prepare(body, payload, want)
        mplan = ec.plan_batch([segs], seg, rng_b)
        kern = run_stages(mplan.tensors(dev), mplan, False)
        plain = run_stages(mplan.tensors("cpu"), mplan, True)
        torch.cuda.synchronize()
        for stage, k, p in zip(STAGE_LABELS, kern, plain):
            require_equal(f"{label}: {stage}", k, p)
        if got != plain[-1].numpy()[:want].tobytes():
            raise AssertionError(f"{label}: codec bytes differ")
        return True

    rng = np.random.default_rng(0xBEEF)
    decoded = tried = 0
    for i in range(STREAM_MB * MB // MUTATED_BLOCK):
        if tried == MUTATED_PAIRS:
            break
        res = codec.encode(corpus[i * MUTATED_BLOCK:(i + 1) * MUTATED_BLOCK],
                           LEVEL)
        if res is None:
            continue  # stored uncompressed by the stream layer
        block, hints = res
        _, want, pos = parse_header(block)
        badh, badb = mutate(rng, hints), mutate(rng, block[pos:])
        decoded += mutated_case(f"pair {i}", badb, badh, want)
        decoded += mutated_case(f"pair {i}, body only", badb, hints, want)
        tried += 1
    log(f"mutated pairs: {tried} pairs x (both parts, body only): {decoded} "
        f"decoded with kernels == plain versions, {2 * tried - decoded} "
        f"rejected as corrupt, no CUDA fault")

    # ---- 4. encode parity: the match finder on the card and the CPU ------
    arr = np.frombuffer(corpus[8 * MB:9 * MB], np.uint8).reshape(1, MB)
    gd, gl = ek.find_matches_dyn(torch.from_numpy(arr.copy()).to(dev), [MB],
                                 SEG, RANGE, LEVEL)
    cd, cl = ek.find_matches_dyn(torch.from_numpy(arr.copy()), [MB], SEG,
                                 RANGE, LEVEL)
    require_equal("match distances, cuda vs cpu", gd, cd)
    require_equal("match lengths, cuda vs cpu", gl, cl)
    log(f"find_matches_dyn: cuda == cpu on a 1 MiB block, "
        f"{int((gd > 0).sum())} proposals")

    # ---- 5. the greedy kernel against its plain version ------------------
    nb = ENCODE_BATCH
    enc_in = torch.from_numpy(np.frombuffer(corpus[: nb * MB], np.uint8)
                              .reshape(nb, MB).copy()).to(dev)
    ns = [MB] * nb
    dist, length = ek.find_matches_dyn(enc_in, ns, SEG, RANGE, LEVEL)
    g_off = dist.to(torch.int32).reshape(-1, SEG)
    g_len = length.to(torch.int32).reshape(-1, SEG)
    del dist, length
    g_names = ("take", "tok_off", "tok_len", "is_rep")
    g_kern = tg.greedy_parse(g_off, g_len, SEG)
    torch.cuda.synchronize()
    g_plain, plain_ms["greedy"] = once_ms(
        lambda: tg.greedy_parse_plain(g_off, g_len, SEG))
    err["greedy"] = max(require_equal(f"greedy {nm}", k, p)
                        for nm, k, p in zip(g_names, g_kern, g_plain))
    n_tokens = int(g_kern[0].sum())
    h_off, h_len = hostile_proposals(HOSTILE_LANES, SEG, dev)
    h_kern = tg.greedy_parse(h_off, h_len, SEG)
    torch.cuda.synchronize()
    h_plain = tg.greedy_parse_plain(h_off, h_len, SEG)
    err["greedy"] = max(err["greedy"], *(
        require_equal(f"greedy, hostile input, {nm}", k, p)
        for nm, k, p in zip(g_names, h_kern, h_plain)))
    torch.cuda.synchronize()
    log(f"greedy kernel == plain version (tolerance 0: integers) on "
        f"{g_off.shape[0]} lanes x {SEG} positions of real proposals "
        f"({n_tokens} tokens) and on {HOSTILE_LANES} lanes of hostile "
        f"int32 ({int(h_kern[0].sum())} tokens), no CUDA fault")
    k_ms["greedy"] = cuda_ms(lambda: tg.greedy_parse(g_off, g_len, SEG))
    # off and len in (8 bytes per position), four int32 outputs out (16);
    # a ballot, a find-first-set, two shuffles and some arithmetic per
    # token: about 16 operations per token and 4 per position loaded.
    bounds["greedy"] = bound(24 * g_off.numel(),
                             16 * n_tokens + 4 * g_off.numel())
    del g_kern, g_plain, h_kern, h_plain, h_off, h_len

    # ---- 6. main paths: Writer -> Reader on the card ---------------------
    path_launches = {}
    path_launches["serializer"] = round_trip("serializer", corpus, dev)
    path_launches["device_emit"] = round_trip("device_emit", corpus, dev,
                                              device_emit=True)
    for name in ("parse", "compact", "exec_range"):
        for path, counts_ in path_launches.items():
            if counts_[name] <= 0:
                raise AssertionError(
                    f"kernel {name} never ran on the {path} path")
    if path_launches["device_emit"]["greedy"] <= 0:
        raise AssertionError("the greedy kernel never ran on the "
                             "device_emit path")
    if path_launches["serializer"]["greedy"] != 0:
        raise AssertionError("the serializer path launched the greedy "
                             "kernel")

    # ---- 7. the greedy serializer: one block, no native codec ------------
    _build.reset_launches()
    one = corpus[3 * MB:4 * MB]
    gblock, ghints = ek.encode_block_device(one, SEG, RANGE, LEVEL, dev,
                                            serializer="greedy")
    if gblock is None or decode_block(gblock) != one:
        raise AssertionError("the greedy-serializer block does not decode")
    if _build.launch_counts()["greedy"] != 1:
        raise AssertionError("serializer=\"greedy\" did not launch the "
                             "greedy kernel once")
    nblock, _ = ek.encode_block_device(one, SEG, RANGE, LEVEL, dev)
    log(f"encode_block_device(serializer=\"greedy\"): 1 MiB -> "
        f"{len(gblock)} bytes, {len(ghints)} segments, decoded by the "
        f"oracle (serializer=\"native\": {len(nblock)} bytes)")

    # ---- 8. times, for information ---------------------------------------
    enc_ms = cuda_ms(lambda: ek._find_matches_batch(
        enc_in, ns, SEG, RANGE, LEVEL), repeats=3)
    dists = ek._find_matches_batch(enc_in, ns, SEG, RANGE,
                                   LEVEL).cpu().numpy()
    ser_ms = host_ms(lambda: [
        native.parse_serialize(corpus[i * MB:(i + 1) * MB], dists[i], SEG,
                               RANGE, LEVEL) for i in range(nb)])
    dev_ms = cuda_ms(lambda: run_stages(t, plan, False))
    items = []
    for block, payload in enc:
        _, want, pos = parse_header(block)
        items.append((block[pos:], payload, want))
    e2e_ms = host_ms(lambda: codec.decode_batch(items))

    # The all-device encode, stage by stage, as encode_block_emit runs it.
    def emit_stages():
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        marks[0].record()
        d, ln = ek.find_matches_dyn(enc_in, ns, SEG, RANGE, LEVEL)
        marks[1].record()
        take, tok_off, _, _ = tg.greedy_parse(
            d.to(torch.int32).reshape(-1, SEG),
            ln.to(torch.int32).reshape(-1, SEG), SEG)
        del d, ln
        take, tok_off = take.reshape(nb, MB), tok_off.reshape(nb, MB)
        marks[2].record()
        surv, vlen = emit.verify_extend(enc_in, take, tok_off, ns, SEG)
        marks[3].record()
        res = emit.emit_segments(enc_in, surv, tok_off, vlen, ns, SEG)
        marks[4].record()
        marks[4].synchronize()
        return res, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    emit_stages()
    staged, _ = emit_stages()
    whole = emit.encode_block_emit(enc_in, ns, SEG, RANGE, LEVEL)
    require_equal("emit stages vs encode_block_emit, bytes", staged[0],
                  whole[0])
    require_equal("emit stages vs encode_block_emit, lengths", staged[1],
                  whole[1])
    del staged, whole
    splits = [emit_stages()[1] for _ in range(3)]
    split_ms = [statistics.median(s[k] for s in splits) for k in range(4)]
    torch.cuda.reset_peak_memory_stats()
    emit_ms = cuda_ms(lambda: emit.encode_block_emit(
        enc_in, ns, SEG, RANGE, LEVEL), repeats=3)
    emit_peak = torch.cuda.max_memory_allocated()
    batch = [corpus[i * MB:(i + 1) * MB] for i in range(nb)]
    emit_e2e_ms = host_ms(lambda: codec.encode_batch_emit(batch, LEVEL))
    ser_e2e_ms = host_ms(lambda: codec.encode_batch(batch, LEVEL))

    for label, val in (
            ("encode match-find, device, 16 x 1 MiB", enc_ms / nb),
            ("encode parse_serialize, host", ser_ms / nb),
            ("encode_batch (serializer path) host bytes in/out, 16 x 1 MiB",
             ser_e2e_ms / nb),
            ("encode_block_emit, device-resident, 16 x 1 MiB", emit_ms / nb),
            ("  of which match-find", split_ms[0] / nb),
            ("  of which greedy (casts + kernel)", split_ms[1] / nb),
            ("  of which verify_extend", split_ms[2] / nb),
            ("  of which emit_segments", split_ms[3] / nb),
            ("encode_batch_emit host bytes in/out, 16 x 1 MiB",
             emit_e2e_ms / nb),
            ("decode 3 kernels, device-resident, 8 x 1 MiB",
             dev_ms / BATCH_BLOCKS),
            ("decode_batch host bytes in/out, 8 x 1 MiB",
             e2e_ms / BATCH_BLOCKS)):
        log(f"time {label}: {val:.4f} ms/MB  [{card}]")
    log(f"peak device memory, encode_block_emit on 16 x 1 MiB: "
        f"{emit_peak / (1 << 20):.0f} MiB  [{card}]")
    shapes = {"greedy": "16 x 1 MiB batch"}
    for name in KERNELS:
        log(f"time kernel {name}: {k_ms[name]:.4f} ms, plain version "
            f"{plain_ms[name]:.4f} ms, bound {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]} ({shapes.get(name, '8 x 1 MiB batch')})  "
            f"[{card}]")

    if foreign_modules():
        raise AssertionError(f"the run pulled in {foreign_modules()}")
    log(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[CLAIMED_ON[name]][name],
         "launches_by_path": {p: c[name] for p, c in path_launches.items()},
         "max_abs_err": err[name], "ms": k_ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
