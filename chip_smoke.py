"""Smoke run of minlz_tpu_torch on one CUDA GPU.

Builds the port's native host library and its CUDA kernels from the sources
in the checkout, holds each kernel against its plain torch version (on real
batches and on mutated or hostile input), checks the match finder on the
card against the CPU, and drives the port's main paths at full width.
Three are a 32 MiB stream through minlz_tpu_torch.stream.Writer and Reader:
the serializer path (match finder on the card, native host serializer), the
all-device path (Writer(device_emit=True): match find, greedy parse, verify
and token emission on the card) and the unclamped path (the serializer path
without the encoder's range clamp, so that the Reader decodes every block on
the whole-block road).  The seek path reads the serializer path's stream
(written with an index) at random: ReadSeeker(device=...) reads 64 spans at
offsets from a seeded numpy generator through seek + read and read_at,
Reader.skip crosses three blocks, two streams written on the card are read
concatenated and a stream with padding and a user chunk is read whole and
through its loaded index, every read held to the corpus and every block it
touches decoded on the card (K1, the lane offset scan, K2 and K3; "time
seek" line).  The next path sends the clamped stream's blocks through
decode_blocks_chained(executor="scheduled"), the append-only road.  One
8 MiB block (16 KiB segments) goes through Writer and Reader and through
decode_block_whole.  The five probe kernels (ops/probe.py) are held against
their plain versions at their scripts' default sizes (the chain body also in
the shared space at the JAX script's 4096 rows, 16 and 32 chains; it and the
ablation launch a thread block a chain; probe_scalar walks 4096 rows in
both spaces at 1 to 16 chains, a block or a cluster of blocks a chain, and
with strayed rows at 16; probe_gather and probe_taa run on clusters of
blocks across the card, also at ragged counts, probe_taa at none; the three
are timed alone, bare launches queued, beside their wrappers: "time
probe_scalar", "time probe_gather" and "time probe_taa" lines, each with
the grid and cluster launched) and then driven through
the port's measurement scripts (kernel_probe, exec_probe body, ablate_exec),
whose lines are printed as "time probe ..."; minlz_tpu_torch.bench.main runs
at 8 MiB and profile_decode prints each decode kernel's time alone beside its
wrapper's.  The three executors on the resolution core (exec_range,
exec_sched, exec_block) are also held against their plain versions on
records made for their parallel resolution (deep chains, 4 KiB literal and
RLE records, 2-4 byte records, copies across every tile boundary, odd spans,
hostile fields, ranges that go backwards) and timed at four record densities
with the rounds their deepest sub-tile takes; the whole-block executor's
tile phase and fix-up are timed apart, with the share of residual bytes.
The parse kernel (K1) is held against its plain version on random bytes,
literal runs, RLE tokens, lanes of copy tokens across its windows and 16 KiB
segments, against its token model (ops/parse_model.py) on whole batches, and
timed ("time parse" lines: alone, and through both wrappers) on the corpus
and three made-up batches.  The greedy kernel is held against its plain
version, through its wrapper and as a bare launch into an output filled
with 0x7f7f7f7f, and timed ("time greedy" lines: alone and through
greedy_parse, tokens a lane, registers and shared memory a block) on the
encode batch's proposals, hostile int32, no candidate, every length 4 and
one lane-long match.  The emit kernel (csrc/emit.cu, token emission, which
the JAX package wrote in jnp) is held against emit_segments_plain on the
encode batch's verified parse, through emit_segments and as a bare launch
into outputs filled with 0x7f, and timed ("time emit" line: alone and
through emit_segments).  The compactions (kernels 2, 5 and 6, and the lane
offset scan in front of them) are held against their plain versions (lane
offsets, record total and the first total columns) on the corpus batch at
range spans, at whole-block spans and dense, on the three made-up K1 batches
and on the mutated pairs, and timed ("time compact" lines: through the
wrapper, the kernel alone, the scan alone, and decode_planned
device-resident on each road, beside the earlier design's figures).  A
no-sync phase runs decode_planned (fast, scheduled) and decode_planned_whole
from plan tensors on the card under torch.cuda.set_sync_debug_mode("error").
The mesh path writes the corpus through Writer(mesh=...) on one NCCL rank
(this process) and reads it back on the card: its bytes are the device_emit
stream's; the mesh encode is timed with its all-gathers' share, the same
Writer runs on one and on two gloo ranks sharing the card ("time mesh"
lines), and dryrun_multichip runs its five phases on every card over NCCL.
The api path calls the port's functions under the JAX package's names on
the card, each held to its plain version: parse_segments_scan (K1, then
its records laid out at the scan's rows) on the decode batch,
decode_segments_jnp on 256 one-segment blocks,
encode_kernel.greedy_parse (K8) on the encode batch and
find_matches_dyn(exact=True) on the encode batch, held to the CPU's
proposals ("time api" lines).
The search path writes the corpus, with patterns planted, through
Writer(search_table=SearchTableConfig()) (tables built on the card by
build_tables_device), reads it back, holds every block's table and a
match_len/bits sweep of bitmaps against the NumPy builder, and searches it
with BlockSearcher ("time search" line).  The unhinted path writes the
corpus as the format's other writers do (Writer(device=None), 2 MiB blocks,
no parse hints) and reads it on the card through Reader.readall and
Reader.read, every block's lanes derived on the card (csrc/derive.cu); the
derivation is held against derive_plan_plain, every lane, range and verdict
tensor exactly, and K1 against its plain version on derived lanes that
enter with their repeat offsets ("time derive" line: alone, through
derive_plan, the plain version).  Then it times each phase.  It
imports nothing of jax or of the JAX package.  Prints a JSON line of kernel
results, then, as its last line, {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero.

The cli path runs last, after every other time: the mz command line
(minlz_tpu_torch.cli.main) in this process on the card, its default route.
`c -2` (with -device and without) writes the Writer's stream byte for byte,
`d` decodes it exactly with every block on the card, `d -offset` decodes
its range on the card, `bench -device` prints its line ("time cli" lines:
the CLI's own rate and the main call's, file to file), `c -device -search`
and `s -c` find each planted pattern, `c` and `d` on the host route
(main(argv, device=None)) build no DeviceCodec, `d` on the card decodes the
host route's stream, which has no parse hints, with every block's lanes
derived on the card (csrc/derive.cu), and `--traceprof D d
-device` decodes with K1, the lane offset scan, K2 and K3 in its trace and
prints the device's idle share.  The device-resident decode lines are then
timed again ("time after the cli path").

    python3 chip_smoke.py
"""

import contextlib
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
BENCH_MB = 8            # minlz_tpu_torch.bench.main's corpus
# The probe scripts' default sweeps (scripts/kernel_probe.py, exec_probe.py
# and ablate_exec.py of the port): (rows of the buffer, where it is walked).
PARSE_LANES = 2048       # lanes of the "time parse" inputs: the corpus batch's
PLAIN_LANES = 64         # lanes of them held against the plain version
API_PIECES = 256         # 4 KiB one-segment blocks for decode_segments_jnp
SEEK_SPANS = 64          # spans the seek path reads, half by seek + read and
SEEK_SPAN = 4096         # half by read_at, each this long, at offsets from
SEEK_SEED = 18           # numpy's default_rng(SEEK_SEED)
SEEK_SIDE_MB = 4         # the concatenated and the padded streams
SEEK_PADDING = 64 << 10
PROBE_SPACES = (("shared", 256), ("global", 4096))
SCALAR_STEPS, SCALAR_CHAINS = 8192, (1, 2, 4, 8, 16)
# probe_scalar walks the JAX script's 4096 rows in both spaces: in the
# shared space a block a chain at 16 chains and a cluster of 2 to 16 blocks
# a chain below.  Its floor is a chain of one-chain steps in one block's
# shared memory (256 rows: the range executors' stage) or in device memory,
# timed in the same run.
SCALAR_SPACES = (("shared", 4096), ("global", 4096))
SCALAR_FLOOR_ROWS = {"shared": 256, "global": 4096}
BODY_STEPS, BODY_CHAINS = 4096, (1, 8, 16, 32)
# exec_probe body's shared sweep: the JAX script's 4096 rows at each of
# BODY_CHAINS whose region fits a block (16 and 32 chains: 256 and 128
# rows a block, which the one-block design refused; 1 and 8 do not fit).
BODY_SHARED_ROWS = 4096
GATHER_TABLES = ((512, 1), (512, 2), (512, 4), (256, 9))  # (iters, 4 KiB)
GATHER_RAGGED = (257, 9)    # a count that is no multiple of the grid
TAA_ITERS = 2048
# probe_taa is held at none, one, a ragged count and the script's (last:
# its inputs and plan are the ones timed through the wrapper).
TAA_SPLITS = (0, 1, 37, TAA_ITERS)
ABLATE_RECORDS, ABLATE_CHAINS, ABLATE_ROWS = 4096, (8, 16), 128

# Published peaks of one H100 SXM: device memory rate, and the float32 rate
# outside the tensor cores, taken as the rate of scalar int32 arithmetic.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {
    # name: (source, the TPU kernel it replaces, its launch count's name in
    # _build.launch_counts(), the path whose run gives its "launches")
    "parse": ("minlz_tpu_torch/csrc/parse.cu",
              "minlz_tpu/ops/pallas_decode.py:56", "parse", "serializer"),
    "compact": ("minlz_tpu_torch/csrc/compact.cu",
                "minlz_tpu/ops/exec_chain.py:394", "compact", "serializer"),
    # The scan of the lane counts in front of both compactions, where the
    # TPU package took a jnp.cumsum: no Pallas kernel of its own.
    "lane_offsets": ("minlz_tpu_torch/csrc/compact.cu",
                     "minlz_tpu/ops/exec_chain.py:1220", "lane_offsets",
                     "serializer"),
    "exec_range": ("minlz_tpu_torch/csrc/exec_range.cu",
                   "minlz_tpu/ops/exec_chain.py:774", "exec_range",
                   "serializer"),
    "greedy": ("minlz_tpu_torch/csrc/greedy.cu",
               "minlz_tpu/ops/pallas_encode.py:29", "greedy", "device_emit"),
    # Token emission, where the TPU package took jnp ops: no Pallas kernel
    # of its own.
    "emit": ("minlz_tpu_torch/csrc/emit.cu", "minlz_tpu/ops/emit.py:196",
             "emit", "device_emit"),
    "exec_block": ("minlz_tpu_torch/csrc/exec_block.cu",
                   "minlz_tpu/ops/pallas_decode.py:137", "exec_block",
                   "unclamped"),
    # The v1 compaction is compact.cu's kernel launched with whole-block
    # lane spans: the same count, read on the unclamped path.
    "compact_whole": ("minlz_tpu_torch/csrc/compact.cu",
                      "minlz_tpu/ops/pallas_decode.py:326", "compact",
                      "unclamped"),
    "compact_dense": ("minlz_tpu_torch/csrc/compact.cu",
                      "minlz_tpu/ops/exec_chain.py:94", "compact_dense",
                      "scheduled"),
    "exec_sched": ("minlz_tpu_torch/csrc/exec_range.cu",
                   "minlz_tpu/ops/exec_chain.py:438", "exec_sched",
                   "scheduled"),
    # The lane plan of blocks without parse hints, which the TPU package
    # decoded on the host: no Pallas kernel of its own.
    "derive": ("minlz_tpu_torch/csrc/derive.cu",
               "minlz_tpu/stream/reader.py:345", "derive", "unhinted"),
    # The probe kernels run on the "probes" path: the port's measurement
    # scripts at their default sizes.
    "probe_scalar": ("minlz_tpu_torch/csrc/probe.cu",
                     "scripts/kernel_probe.py:29", "probe_scalar", "probes"),
    "probe_gather": ("minlz_tpu_torch/csrc/probe.cu",
                     "scripts/kernel_probe.py:77", "probe_gather", "probes"),
    "probe_taa": ("minlz_tpu_torch/csrc/probe.cu",
                  "scripts/kernel_probe.py:124", "probe_taa", "probes"),
    "probe_chain_body": ("minlz_tpu_torch/csrc/probe.cu",
                         "scripts/exec_probe.py:85", "probe_chain_body",
                         "probes"),
    "ablate_exec": ("minlz_tpu_torch/csrc/ablate.cu",
                    "scripts/ablate_exec.py:38", "ablate_exec", "probes"),
}
BIG_BLOCK = 8 * MB      # the format's largest block: 16 KiB segments


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
    or with the plain versions; a plan without a range (``plan.rng == 0``)
    takes the whole-block executor.  Returns every stage's output."""
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import parse as ps

    parse = ps.parse_segments_plain if plain else ps.parse_planned
    compact = ec.compact_records_plain if plain else ec.compact_records
    recs, counts = parse(t["comp"], t["lane_start"], t["lane_len"])
    crec, lane_out, total = compact(recs, counts, t["lane_start"],
                                    t["lane_len"], t["lane_lo"],
                                    t["lane_hi"])
    first = ec.range_firsts(lane_out, total, t["range_lane"])
    args = (crec, first, t["range_out"], t["range_span"], t["comp"],
            plan.total_out)
    if plan.rng:
        execute = ec.execute_ranges_plain if plain else ec.execute_ranges
        out = execute(*args, plan.max_span)
    else:
        execute = eb.execute_blocks_plain if plain else eb.execute_blocks
        out = execute(*args)
    return recs, counts, crec, lane_out, total, first, out


STAGE_LABELS = ("parse records", "parse counts", "compacted records",
                "lane offsets", "record total", "range offsets",
                "decoded bytes")


def require_records(label, kernel, plain) -> int:
    """A compaction's (out, lane_out, total) against its plain version's:
    the same capacity, lane offsets and total, and the same first total
    columns (the kernel leaves those past the total unwritten).  Returns
    the max abs err (0) and raises on any other."""
    out, lane_out, total = kernel
    out_p, lane_out_p, total_p = plain
    if out.shape != out_p.shape:
        raise AssertionError(f"{label}: capacity {tuple(out.shape)} != "
                             f"{tuple(out_p.shape)}")
    require_equal(f"{label}: lane offsets", lane_out, lane_out_p)
    require_equal(f"{label}: record total", total, total_p)
    n = int(total)
    return require_equal(label, out[:, :n], out_p[:, :n])


def require_stages(label, kern, plain):
    """run_stages' outputs, kernels against plain versions."""
    for i, (stage, k, p) in enumerate(zip(STAGE_LABELS, kern, plain)):
        if i == 2:
            require_records(f"{label}: {stage}", kern[2:5], plain[2:5])
        elif i not in (3, 4):
            require_equal(f"{label}: {stage}", k, p)


def round_trip(label, corpus, dev, clamp=True, block_size=MB,
               **writer_opts):
    """One main path: corpus -> Writer(**writer_opts) -> Reader on the
    card and Reader on the host.  ``clamp=False`` switches the encoder's
    range clamp off around the Writer, so that its hints carry range 0.
    The launch counts are set to 0 just before and read just after.
    Returns (launch counts, stream bytes)."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import device_codec
    from minlz_tpu_torch.stream import Reader, Writer

    n = -(-len(corpus) // block_size)
    # The Writer and the Reader share the process's codec on the card.
    codec = device_codec.get_device_codec(dev)
    enc0, dec0 = codec.blocks_encoded, codec.blocks_decoded
    _build.reset_launches()
    buf = io.BytesIO()
    clamp_range = device_codec.RANGE
    try:
        if not clamp:
            device_codec.RANGE = 0
        w = Writer(buf, device=dev, level=LEVEL, block_size=block_size,
                   **writer_opts)
        with w:
            w.write(corpus)
    finally:
        device_codec.RANGE = clamp_range
    stream = buf.getvalue()
    r = Reader(io.BytesIO(stream), device=dev)
    back = r.readall()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if back != corpus:
        raise AssertionError(f"{label}: the device Reader did not round-trip")
    if r.hint_fallbacks:
        raise AssertionError(f"{label}: {r.hint_fallbacks} blocks' hints "
                             f"sent them to the host")
    if Reader(io.BytesIO(stream), device=None).readall() != corpus:
        raise AssertionError(f"{label}: the host Reader cannot read the "
                             f"port's stream")
    encoded = codec.blocks_encoded - enc0
    decoded = codec.blocks_decoded - dec0
    if w.codec is not codec or r.codec is not codec or encoded != n \
            or decoded != n:
        raise AssertionError(
            f"{label}: device blocks: {encoded} encoded, {decoded} "
            f"decoded, want {n} of {n}")
    log(f"main path ({label}): {len(corpus) // MB} MiB -> {len(stream)} "
        f"bytes (ratio {len(stream) / len(corpus):.4f}); {n} of {n} blocks "
        f"encoded and {n} of {n} decoded on the device; launches {launches}")
    return launches, stream


def run_script(main_fn, argv, prefix):
    """Run a measurement script's main(argv) and print its lines behind
    ``prefix``.  Any failure raises."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    for line in buf.getvalue().splitlines():
        log(f"{prefix}{line}")
    if rc != 0:
        raise AssertionError(f"{prefix.strip()} {argv} returned {rc}")


def strayed_steps(steps, rows: int, n_chains: int):
    """probe_scalar's (src, dst) step list with every row number moved on
    by half a region, modulo rows: the chains still own disjoint rows, but
    half of each chain's rows lie in the next chain's region."""
    out = steps.reshape(n_chains, -1, 2).astype(np.int64)
    out = (out + rows // n_chains // 2) % rows
    return out.astype(np.int32).reshape(-1)


def compare_probes(dev, card):
    """Each probe kernel against its plain version on the card, the whole
    buffer, at its script's default size, on seeded non-zero data.  Returns
    (max abs err, kernel ms, plain ms, bound) per kernel; the times and the
    bound are of the largest configuration of each.  probe_scalar, the
    chain body and the ablation run a thread block (or a cluster) a chain
    across the card, probe_gather and probe_taa about a block an SM: every
    bound is the card's (``bound``).  probe_scalar, probe_gather and
    probe_taa are also timed alone (bare launches queued, ``queued_ms``)
    beside their wrappers."""
    from minlz_tpu_torch.ops import probe

    def to_dev(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    err, k_ms, plain_ms, bounds = {}, {}, {}, {}

    def held(name, label, kernel_fn, plain_fn, timed, n_bytes, n_ops):
        got = kernel_fn()
        torch.cuda.synchronize()
        want, p_ms = once_ms(plain_fn)
        err[name] = max(err.get(name, 0),
                        require_equal(f"{name} ({label})", got, want))
        if timed:
            k_ms[name] = cuda_ms(kernel_fn)
            plain_ms[name] = p_ms
            bounds[name] = bound(n_bytes, n_ops)

    def held_body(rows, c, space, timed_as):
        meta, buf = to_dev(probe.chain_body_inputs(BODY_STEPS, c, rows,
                                                   fill=True))
        for mode in ("minimal", "realign"):
            # About 6 operations a word: select, four mask tests, and.
            held("probe_chain_body", f"{c} chains, {mode}, {space}, "
                 f"{rows} rows",
                 lambda: probe.probe_chain_body(meta, buf, c, mode, space),
                 lambda: probe.probe_chain_body_plain(meta, buf, c, mode),
                 (space, c, mode) == timed_as,
                 4 * meta.numel() + 8 * buf.numel(),
                 6 * 128 * BODY_STEPS * c)

    floor_ns = {}
    for space, rows in SCALAR_FLOOR_ROWS.items():
        steps, buf = to_dev(probe.scalar_inputs(SCALAR_STEPS, 1, rows,
                                                fill=True))
        plan = probe.scalar_plan(rows, 1, space)
        floor_ns[space] = queued_ms(lambda: probe.launch_scalar(
            steps, buf, 1, space, plan)) * 1e6 / SCALAR_STEPS
    for space, rows in SCALAR_SPACES:
        for c in SCALAR_CHAINS:
            stray = (False, True) if c == SCALAR_CHAINS[-1] else (False,)
            for strays in stray:
                steps, buf = probe.scalar_inputs(SCALAR_STEPS, c, rows,
                                                 fill=True)
                if strays:
                    steps = strayed_steps(steps, rows, c)
                steps, buf = to_dev((steps, buf))
                label = (f"{c} chains x {rows} rows, {space}"
                         f"{', strayed' if strays else ''}")
                wrapper = lambda: probe.probe_scalar(steps, buf, c, space)
                # Step list and buffer in, buffer out; one add per word
                # moved.
                n_bytes = 4 * steps.numel() + 8 * buf.numel()
                held("probe_scalar", label, wrapper,
                     lambda: probe.probe_scalar_plain(steps, buf, c),
                     (space, c, strays) == ("shared", SCALAR_CHAINS[-1],
                                            False),
                     n_bytes, 128 * SCALAR_STEPS * c)
                plan = probe.LAUNCHED["probe_scalar"]
                work = buf.clone()
                alone = queued_ms(lambda: probe.launch_scalar(
                    steps, work, c, space, plan))
                log(f"time probe_scalar {SCALAR_STEPS} steps x {label}: "
                    f"grid {plan.grid} cluster {plan.cluster} (share "
                    f"{plan.share_rows} rows): {cuda_ms(wrapper):.4f} ms "
                    f"through the wrapper ({host_us(wrapper):.1f} us of "
                    f"host time a call), {alone:.4f} ms alone "
                    f"({alone * 1e6 / SCALAR_STEPS:.1f} ns a step); floor "
                    f"{SCALAR_STEPS} x {floor_ns[space]:.1f} ns = "
                    f"{SCALAR_STEPS * floor_ns[space] * 1e-6:.4f} ms (one "
                    f"chain, {SCALAR_FLOOR_ROWS[space]} rows, {space}); "
                    f"bound {bound(n_bytes, 0)[0]:.4f} ms  [{card}]")
    for space, rows in PROBE_SPACES:
        for c in BODY_CHAINS:
            held_body(rows, c, space, ("global", BODY_CHAINS[-1], "realign"))
    shared_chains = [c for c in BODY_CHAINS
                     if probe.body_shared_bytes(BODY_SHARED_ROWS, c)
                     <= probe.SHARED_LIMIT]
    for c in shared_chains:
        held_body(BODY_SHARED_ROWS, c, "shared", None)
    log(f"probe_scalar == plain version (tolerance 0, whole buffer) at "
        f"{SCALAR_STEPS} steps x {SCALAR_CHAINS} chains, each on "
        f"{SCALAR_SPACES}, with strayed rows at {SCALAR_CHAINS[-1]} "
        f"(grid: a block or a cluster a chain), and probe_chain_body at "
        f"{BODY_STEPS} steps x {BODY_CHAINS} chains x (minimal, realign), "
        f"each on {PROBE_SPACES}, and in the shared space at "
        f"{BODY_SHARED_ROWS} rows x {shared_chains} chains (grid: a block "
        f"a chain): compared and timed at the same, full size")
    for iters, vregs in GATHER_TABLES + (GATHER_RAGGED,):
        tbl, idx = to_dev(probe.gather_inputs(iters, vregs, wrap=True))
        wrapper = lambda: probe.probe_gather(tbl, idx)
        # Table, indices and sums through L2; two operations a gather.
        n_bytes = 4 * (tbl.numel() + idx.numel() + 1024)
        held("probe_gather", f"{iters} x 1024 from {vregs * 1024} words",
             wrapper, lambda: probe.probe_gather_plain(tbl, idx),
             (iters, vregs) == GATHER_TABLES[-1], n_bytes, 2 * idx.numel())
        plan = probe.LAUNCHED["probe_gather"]
        out = torch.empty((8, 128), dtype=torch.int32, device=dev)
        scratch = probe.gather_scratch(plan, dev)
        bare = lambda: probe.launch_gather(tbl, idx, out, scratch, plan)
        alone = queued_ms(bare)
        log(f"time probe_gather {iters} x 1024 gathers from {vregs * 1024} "
            f"words: grid {plan.grid} cluster {plan.cluster}: "
            f"{cuda_ms(wrapper):.4f} ms through the wrapper "
            f"({host_us(wrapper):.1f} us of host time a call), "
            f"{queued_ms(wrapper):.4f} ms through it queued, {alone:.4f} ms "
            f"alone ({host_us(bare):.1f} us of host time a bare launch); "
            f"bound {bound(n_bytes, 2 * idx.numel())[0]:.4f} ms  "
            f"[{card}]")
    taa_alone = {}
    for iters in TAA_SPLITS:
        a, idx = to_dev(probe.taa_inputs(iters, wrap=True))
        wrapper = lambda: probe.probe_taa(a, idx)
        # Row, indices and sums through L2; four shuffles, three selects and
        # an add per element.
        n_bytes = 4 * (a.numel() + idx.numel() + 1024)
        held("probe_taa", f"{iters} iterations", wrapper,
             lambda: probe.probe_taa_plain(a, idx), iters == TAA_ITERS,
             n_bytes, 8 * idx.numel())
        plan = probe.LAUNCHED["probe_taa"]
        if iters in (1, TAA_ITERS):
            out = torch.empty((8, 128), dtype=torch.int32, device=dev)
            scratch = probe.gather_scratch(plan, dev)
            taa_alone[iters] = queued_ms(lambda: probe.launch_taa(
                a, idx, out, scratch, plan))
    log(f"time probe_taa {TAA_ITERS} x 1024 in-row gathers: grid "
        f"{plan.grid} cluster {plan.cluster}: {cuda_ms(wrapper):.4f} ms "
        f"through the wrapper ({host_us(wrapper):.1f} us of host time a "
        f"call), {queued_ms(wrapper):.4f} ms through it queued, "
        f"{taa_alone[TAA_ITERS]:.4f} ms alone, {taa_alone[1]:.4f} ms alone "
        f"at 1 iteration (grid {probe.gather_plan(1, 0).grid}); bound "
        f"{bound(n_bytes, 8 * idx.numel())[0]:.4f} ms  [{card}]")
    log(f"probe_gather == plain version (tolerance 0) on tables of "
        f"{[v * 1024 for _, v in GATHER_TABLES]} words and at "
        f"{GATHER_RAGGED[0]} iterations, and probe_taa at {TAA_SPLITS} x "
        f"1024 in-row gathers, int32 sums that wrap (grid: clusters of "
        f"blocks across the card)")
    for variant in probe.VARIANTS:
        for c in ABLATE_CHAINS:
            counts, ops, arena = to_dev(probe.ablate_inputs(
                c, ABLATE_RECORDS, ABLATE_ROWS, fill=True))
            moved = int(((ops[..., 0] & 0x3FFF)
                         + ((ops[..., 0] >> 14) & 0x3FFF)).sum())
            # Records and arena in, arena out; two operations a byte moved.
            held("ablate_exec", f"{variant}, {c} chains",
                 lambda: probe.ablate_exec(counts, ops, arena, variant,
                                           chain_rows=ABLATE_ROWS),
                 lambda: probe.ablate_exec_plain(counts, ops, arena, variant,
                                                 chain_rows=ABLATE_ROWS),
                 (variant, c) == ("full", ABLATE_CHAINS[0]),
                 4 * (counts.numel() + ops.numel() + 2 * arena.numel()),
                 2 * moved)
    log(f"ablate_exec == plain version (tolerance 0, whole arena) in "
        f"{probe.VARIANTS} at {ABLATE_RECORDS} records x {ABLATE_CHAINS} "
        f"chains (grid: a block a chain): compared and timed at the same, "
        f"full size  [{card}]")
    return err, k_ms, plain_ms, bounds


def on_card(batch, dev):
    return tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                 else a for a in batch)


def block_phase_times(args):
    """The whole-block executor's bare launch on execute_blocks' arguments:
    (ms of all three kernels, ms of the index and tile kernels, ms of the
    fix-up kernel, residual bytes after the tile phase)."""
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import exec_chain as ec

    x_args = ec.range_args("execute_blocks", args[0], 5, *args[1:5], args[5])
    out = torch.empty(args[5], dtype=torch.uint8, device=args[0].device)
    scratch = eb.blocks_scratch(x_args, out)
    both = cuda_ms(lambda: eb.launch_blocks(x_args, out, scratch))
    tiles = cuda_ms(lambda: eb.launch_blocks(x_args, out, scratch, eb.TILES))
    residual = int((scratch[:args[5]] >= 0).sum())
    fix = cuda_ms(lambda: eb.launch_blocks(x_args, out, scratch, eb.FIXUP))
    return both, tiles, fix, residual


def log_block_phases(label, args, card):
    """A "time" line of the whole-block executor's phases on ``args``, with
    the tiled model's counts; the kernel's residual count must equal the
    model's and the model's bytes the kernel's."""
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import resolve_model as rm

    both, tiles, fix, residual = block_phase_times(args)
    model, info = rm.execute_blocks_tiled(*args)
    require_equal(f"exec_block vs the tiled model, {label}",
                  eb.execute_blocks(*args), model)
    if residual != info["residual"]:
        raise AssertionError(f"{label}: the tile phase left {residual} "
                             f"residual bytes, the model {info['residual']}")
    log(f"time exec_block phases, {label}: {int(args[1][-1])} records, "
        f"{both:.4f} ms = index + tile phase {tiles:.4f} + fix-up "
        f"{fix:.4f}; {residual} of {args[5]} bytes residual "
        f"({residual / max(args[5], 1):.2%}), longest walk {info['hops']} "
        f"hops, {info['rounds']} rounds in the deepest sub-tile  [{card}]")
    return both


def log_range_rounds(label, args, card):
    """A "time" line of K3's bare launch on execute_ranges' arguments
    (without max_span: 128 KiB), with the tiled model's rounds."""
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import resolve_model as rm
    from minlz_tpu_torch.ops.device_codec import RANGE

    x_args = ec.range_args("execute_ranges", args[0], 5, *args[1:5], args[5])
    out = torch.empty(args[5], dtype=torch.uint8, device=args[0].device)
    ms = cuda_ms(lambda: ec.launch_execute(ec.EXEC, x_args, RANGE, out))
    model, info = rm.execute_ranges_tiled(*args, RANGE)
    require_equal(f"exec_range vs the tiled model, {label}", out, model)
    # The same records without their positions through the append-only
    # executor: its cursor scan, then the same K3.
    s_args = ec.range_args("execute_scheduled", args[0][1:].contiguous(), 4,
                           *args[1:5], args[5])
    out_s = torch.empty_like(out)
    scratch = ec.sched_scratch(s_args)
    ms_s = cuda_ms(lambda: ec.launch_execute(ec.EXEC_SCHED, s_args, RANGE,
                                             out_s, scratch))
    require_equal(f"exec_sched vs exec_range, {label}", out_s, out)
    log(f"time K3 exec_range alone, {label}: {int(args[1][-1])} records, "
        f"{ms:.4f} ms, {info['rounds']} rounds in the deepest sub-tile "
        f"({info['round_sum']} over the 4 steps); exec_sched alone (cursor "
        f"scan + K3) {ms_s:.4f} ms  [{card}]")
    return ms, ms_s


def lanes_on(segs, dev):
    """Segment byte strings -> (comp, lane_start, lane_len) on ``dev``."""
    lens = np.array([len(x) for x in segs], np.int32)
    start = (np.cumsum(lens) - lens).astype(np.int32)
    comp = np.frombuffer(b"".join(segs) or b"\x00", np.uint8).copy()
    return tuple(torch.from_numpy(a).to(dev) for a in (comp, start, lens))


def parse_inputs():
    """The three made-up inputs of the "time parse" lines, PARSE_LANES
    lanes of one 4 KiB segment's worth each, from a seed: one literal run
    of incompressible bytes a lane; short tokens (one literal, then 2-byte
    Copy1 tokens of offset 1, RLE); random bytes."""
    from minlz_tpu_torch.oracle import encode as oenc

    g = np.random.default_rng(0x5EED)
    lit = []
    for _ in range(PARSE_LANES):
        dst = bytearray()
        oenc.emit_literals(dst, g.integers(0, 256, SEG, np.uint8).tobytes())
        lit.append(bytes(dst))
    rle = [b"\x00a" + b"\x01\x00" * (SEG // 2 - 1)] * PARSE_LANES
    rnd = [g.integers(0, 256, SEG, np.uint8).tobytes()
           for _ in range(PARSE_LANES)]
    return {"literals only (incompressible)": lit, "short tokens (RLE)": rle,
            "random bytes": rnd}


def copy_token_lanes(n_lanes, n_bytes, seed):
    """Random bytes with no literal-run tag: copy tokens back to back, so
    every lane's chain runs its whole length across several windows."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n_lanes):
        b = g.integers(0, 256, n_bytes, dtype=np.uint8)
        b |= (b & 3 == 0) * g.integers(1, 4, n_bytes, dtype=np.uint8)
        out.append(b.tobytes())
    return out


def parse_vs_plain(label, segs, dev):
    """K1 on ``segs`` against its plain version (run on the CPU: a row loop
    is cheaper there for few lanes), every slot.  Returns 0."""
    from minlz_tpu_torch.ops import parse as ps

    recs, counts = ps.parse_segments(*lanes_on(segs, dev))
    torch.cuda.synchronize()
    recs_p, counts_p = ps.parse_segments_plain(*lanes_on(segs, "cpu"))
    return max(require_equal(f"parse counts, {label}", counts, counts_p),
               require_equal(f"parse records, {label}", recs, recs_p))


def time_parse(label, args, card):
    """A "time parse" line: K1 alone (the bare launch), through
    parse_planned (no read back, as decode_planned calls it) and through
    parse_segments (three checks read back), with the token model's counts;
    the kernel must equal the model in every slot."""
    from minlz_tpu_torch.ops import parse as ps
    from minlz_tpu_torch.ops import parse_model as pm

    recs, counts = ps.parse_planned(*args)
    recs_m, counts_m, info = pm.parse_segments_model(*args)
    torch.cuda.synchronize()
    require_equal(f"parse vs the token model, {label}", recs, recs_m)
    require_equal(f"parse counts vs the token model, {label}", counts,
                  counts_m)
    del recs_m, counts_m
    r2, c2 = torch.empty_like(recs), torch.empty_like(counts)
    alone = cuda_ms(lambda: ps.launch_parse(*args, r2, c2))
    require_equal(f"parse, bare launch, {label}", r2, recs)
    planned = cuda_ms(lambda: ps.parse_planned(*args))
    wrapper = cuda_ms(lambda: ps.parse_segments(*args))
    log(f"time parse {label}: {args[2].numel()} lanes, {args[0].numel()} "
        f"bytes, {info['tokens']} tokens = chain hops ({info['max_tokens']} "
        f"in the fullest window), {info['windows']} windows, "
        f"{int(counts.sum())} records; alone {alone:.4f} ms, parse_planned "
        f"{planned:.4f} ms, parse_segments {wrapper:.4f} ms  [{card}]")
    return alone, planned, wrapper


GREEDY_CORPUS = f"the corpus, {ENCODE_BATCH} x 1 MiB"
SENTINEL = 0x7F7F7F7F
# The compactions of the earlier design (one thread block a lane, a shared
# memory scan, the record total read back to the host before the launch):
# ms a call through the wrapper and alone on the 8 x 1 MiB batch, and the
# decode lines' ms/MB device-resident, on an H100 80GB HBM3 at 700 W
# (PERF.md §5, §6).
BEFORE = {"compact": (0.1435, 0.0259), "compact_whole": (0.2397, 0.0259),
          "compact_dense": (0.1220, 0.0158), "fast": 0.0837,
          "scheduled": 0.0876, "whole": 0.0913}


def compact_args(kernel, recs, counts, t):
    """(wrapper, its arguments) of a compaction kernel on plan tensors
    ``t``: COMPACT takes the lane spans, COMPACT_DENSE does not."""
    from minlz_tpu_torch.ops import exec_chain as ec

    if kernel == ec.COMPACT:
        return ec.compact_records, (recs, counts, t["lane_start"],
                                    t["lane_len"], t["lane_lo"],
                                    t["lane_hi"])
    return ec.compact_records_dense, (recs, counts, t["lane_start"],
                                      t["lane_len"])


def time_compact(label, kernel, recs, counts, t, card, before=None):
    """A "time compact" line: the compaction through its wrapper (the lane
    offset scan, then the kernel, nothing read back), the bare kernel alone
    and the bare offset scan alone, both queued behind a spin kernel, and
    the wrapper's host time a call (host_us).  The
    bare launch into an output filled with 0x7f7f7f7f must equal the
    wrapper in the first total columns and leave every later column as it
    was.  Returns (wrapper ms, kernel alone ms, scan alone ms)."""
    from minlz_tpu_torch.ops import exec_chain as ec

    wrap, args = compact_args(kernel, recs, counts, t)
    out, lane_out, total = wrap(*args)
    wrapper = cuda_ms(lambda: wrap(*args))
    bare_args = [x.contiguous() for x in (args[0], *args[2:4], counts,
                                          lane_out, *args[4:])]
    bare = torch.full_like(out, SENTINEL)
    alone = queued_ms(lambda: ec.launch_compact(kernel, bare_args, bare))
    n = int(total)
    require_equal(f"{label}, bare launch", bare[:, :n], out[:, :n])
    if bool((bare[:, n:] != SENTINEL).any()):
        raise AssertionError(f"{label}: the kernel wrote past the total")
    off = torch.empty(counts.numel() + 1, dtype=torch.int64,
                      device=counts.device)
    scan = queued_ms(lambda: ec.launch_offsets(counts, off))
    host = host_us(lambda: wrap(*args))
    was = ("" if before is None else
           f"; the earlier design {before[0]:.4f} through the wrapper, "
           f"{before[1]:.4f} alone")
    log(f"time compact {label}: {counts.numel()} lanes, {n} records in "
        f"{out.shape[1]} slots; {wrap.__name__} {wrapper:.4f} ms, kernel "
        f"alone {alone:.4f} ms, offset scan alone {scan:.4f} ms; the "
        f"wrapper's host time {host:.1f} us a call{was}  [{card}]")
    return wrapper, alone, scan


def compare_compaction(label, segs, dev, card, err):
    """Kernels 2, 5 and 6 against their plain versions (run on the card)
    on K1's output for ``segs``, planned as blocks of 32 segments (one
    128 KiB range each) at range spans, at whole-block spans and dense;
    then their "time compact" lines."""
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import parse as ps
    from minlz_tpu_torch.ops.device_codec import RANGE

    blocks = [segs[i:i + 32] for i in range(0, len(segs), 32)]
    for name, kernel, rng in (("compact", ec.COMPACT, RANGE),
                              ("compact_whole", ec.COMPACT, 0),
                              ("compact_dense", ec.COMPACT_DENSE, RANGE)):
        plan = ec.plan_batch(blocks, SEG, rng)
        t = plan.tensors(dev)
        recs, counts = ps.parse_planned(t["comp"], t["lane_start"],
                                        t["lane_len"])
        wrap, args = compact_args(kernel, recs, counts, t)
        plain = (ec.compact_records_plain if wrap is ec.compact_records
                 else ec.compact_records_dense_plain)
        err[name] = max(err.get(name, 0), require_records(
            f"{name}, {label}", wrap(*args), plain(*args)))
        time_compact(f"{name}, {label}", kernel, recs, counts, t, card)


def no_sync_phase(plan, t, plan_w, tw, blocks, dev):
    """The three decode roads, from plan tensors already on the card to
    the decoded tensor, under torch.cuda.set_sync_debug_mode("error"):
    any synchronising call (a read back, a blocking copy) raises.  The
    bytes must be the blocks'."""
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import exec_chain as ec

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {"fast": ec.decode_planned(plan, dev, "fast", t),
                "scheduled": ec.decode_planned(plan, dev, "scheduled", t),
                "whole": eb.decode_planned_whole(plan_w, dev, tw)}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [len(b) for b in blocks]
    for road, out in outs.items():
        p = plan_w if road == "whole" else plan
        if ec.trim_blocks(p, out, want) != blocks:
            raise AssertionError(f"no-sync phase: the {road} road's bytes "
                                 f"differ from the input")
    log(f"no-sync phase: decode_planned (fast, scheduled) and "
        f"decode_planned_whole on {len(blocks)} x 1 MiB ran from plan "
        f"tensors on the card to the decoded tensor under "
        f"set_sync_debug_mode(\"error\") with no synchronising call; bytes "
        f"== input")


def queued_ms(fn, n=20, repeats=REPEATS):
    """Median device milliseconds per call of fn(), n calls queued behind a
    spin kernel, so that the host's launch cost is hidden: the calls run
    back to back on the card, as in a pipeline that keeps it fed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host enqueues meanwhile
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def host_us(fn, n=20, repeats=REPEATS):
    """Median host microseconds per call of fn(), n calls issued while the
    card spins, so that no call waits for it: what a wrapper costs the
    host (checks, allocations, ctypes, the launches themselves)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def greedy_inputs(g_off, g_len, dev):
    """The five inputs of the "time greedy" lines, each [4096, SEG] int32:
    the corpus's proposals, hostile int32, and three made from a seed: no
    candidate (every length below 4), every length exactly 4 (the longest
    chain, a token every 4 positions), and one match as long as the lane at
    its first position."""
    lanes = g_off.shape[0]
    g = torch.Generator(device="cpu").manual_seed(0x6EED)

    def rand(lo, hi):
        return torch.randint(lo, hi, (lanes, SEG), generator=g,
                             dtype=torch.int32).to(dev)

    one = rand(0, 12)
    one[:, 0] = SEG
    return {
        GREEDY_CORPUS: (g_off, g_len),
        "hostile int32": hostile_proposals(HOSTILE_LANES, SEG, dev),
        "no candidates": (rand(-1, 3), rand(-3, 4)),
        "every length 4": (rand(-1, 3), torch.full((lanes, SEG), 4,
                                                   dtype=torch.int32,
                                                   device=dev)),
        "one lane-long match at position 0": (rand(-1, 3), one),
    }


def time_greedy(label, off, length, card):
    """A "time greedy" line: the kernel alone (the bare launch into an
    output filled with SENTINEL, which must come out equal to the plain
    version's, as must greedy_parse's), greedy_parse queued and as one
    call, tokens per lane, and what the card made of the kernel."""
    from minlz_tpu_torch.ops import greedy as tg

    lanes, seg = off.shape
    out = torch.full((4, lanes, seg), SENTINEL, dtype=torch.int32,
                     device=off.device)
    tg.launch_greedy(off, length, seg, out)
    wrapped = tg.greedy_parse(off, length, seg)
    torch.cuda.synchronize()
    plain, p_ms = once_ms(lambda: tg.greedy_parse_plain(off, length, seg))
    err = 0
    for k, nm in enumerate(("take", "tok_off", "tok_len", "is_rep")):
        err = max(err,
                  require_equal(f"greedy {nm}, {label}", out[k], plain[k]),
                  require_equal(f"greedy_parse {nm}, {label}", wrapped[k],
                                plain[k]))
    tokens = int(out[0].sum())
    del plain, wrapped
    alone = queued_ms(lambda: tg.launch_greedy(off, length, seg, out))
    wrapper = queued_ms(lambda: tg.greedy_parse(off, length, seg))
    once = cuda_ms(lambda: tg.greedy_parse(off, length, seg))
    a = tg.kernel_attrs()
    log(f"time greedy {label}: {lanes} lanes x {seg} positions, {tokens} "
        f"tokens = {tokens / lanes:.1f} a lane; alone {alone:.4f} ms, "
        f"greedy_parse {wrapper:.4f} ms queued, {once:.4f} ms as one call; "
        f"{a['registers']} registers a thread, {a['shared_bytes']} bytes of "
        f"shared memory and {a['threads']} threads a block, "
        f"{a['blocks_per_sm']} blocks resident a SM  [{card}]")
    return {"err": err, "tokens": tokens, "wrapper_once": once,
            "plain_ms": p_ms}


def time_emit(enc_in, ns, card):
    """The "time emit" line: the encode batch's verified parse emitted by
    the kernel alone (the bare launch into outputs filled with 0x7f, which
    must come out equal to the plain version's, as must emit_segments'),
    through emit_segments queued and as one call, and what the card made
    of the kernel."""
    from minlz_tpu_torch.ops import emit
    from minlz_tpu_torch.ops import encode_kernel as ek
    from minlz_tpu_torch.ops import greedy as tg
    from minlz_tpu_torch.ops.device_codec import RANGE

    nb, N = enc_in.shape
    d, ln = ek.find_matches_dyn(enc_in, ns, SEG, RANGE, LEVEL)
    take, tok_off, _, _ = tg.greedy_parse(
        d.to(torch.int32).reshape(-1, SEG),
        ln.to(torch.int32).reshape(-1, SEG), SEG)
    del d, ln
    take, tok_off = take.reshape(nb, N), tok_off.reshape(nb, N)
    surv, vlen = emit.verify_extend(enc_in, take, tok_off, ns, SEG)
    del take
    n = torch.tensor(ns, dtype=torch.int32, device=enc_in.device)
    args = (enc_in, surv, tok_off, vlen, n)
    out = torch.full((nb, N // SEG, SEG + emit.OUT_PAD), 0x7F,
                     dtype=torch.uint8, device=enc_in.device)
    lens = torch.full((nb, N // SEG), SENTINEL, dtype=torch.int32,
                      device=enc_in.device)
    emit.launch_emit(*args, SEG, out, lens)
    wrapped = emit.emit_segments(*args, SEG)
    torch.cuda.synchronize()
    plain, p_ms = once_ms(lambda: emit.emit_segments_plain(*args, SEG))
    err = max(require_equal("emit bytes, bare launch", out, plain[0]),
              require_equal("emit lengths, bare launch", lens, plain[1]),
              require_equal("emit_segments bytes", wrapped[0], plain[0]),
              require_equal("emit_segments lengths", wrapped[1], plain[1]))
    tokens = int(surv.sum())
    kept = int(plain[1].sum())
    del plain, wrapped
    alone = queued_ms(lambda: emit.launch_emit(*args, SEG, out, lens))
    wrapper = queued_ms(lambda: emit.emit_segments(*args, SEG))
    once = cuda_ms(lambda: emit.emit_segments(*args, SEG))
    a = emit.kernel_attrs(SEG)
    # The block bytes and three int32 arrays in, the padded rows and their
    # lengths out.
    moved = 13 * enc_in.numel() + out.numel() + 4 * lens.numel()
    log(f"time emit: {nb} x {N >> 20} MiB, {lens.numel()} segments, "
        f"{tokens} tokens, {kept} bytes emitted; alone {alone:.4f} ms, "
        f"emit_segments {wrapper:.4f} ms queued, {once:.4f} ms as one call, "
        f"plain version {p_ms:.4f} ms; {moved / 1e6:.1f} MB to move; "
        f"{a['registers']} registers a thread, {a['shared_bytes']} bytes of "
        f"shared memory and {a['threads']} threads a block, "
        f"{a['blocks_per_sm']} blocks resident a SM  [{card}]")
    return {"err": err, "wrapper_once": once, "plain_ms": p_ms,
            "bytes": moved, "tokens": tokens}


def compare_synthetic(dev, card, err):
    """exec_range and exec_block against their plain versions on records
    made for the parallel resolution, then their times at three synthetic
    record densities and on the deep chains."""
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import resolve_model as rm
    from minlz_tpu_torch.ops.device_codec import RANGE
    from minlz_tpu_torch.testing import (HOSTILE_RECORDS, HOSTILE_SPAN,
                                         RECORD_KINDS, record_batch)

    range_spans = [RANGE, 0, 37, rm.SUB + 13, RANGE - 1, 100_000]
    block_spans = [MB + 1000, 0, 37, 3 * rm.TILE - 5, 200_000]
    for kind in RECORD_KINDS:
        args = on_card(record_batch(kind, range_spans, seed=3), dev)
        got = ec.execute_ranges(*args, RANGE)
        torch.cuda.synchronize()
        err["exec_range"] = max(err["exec_range"], require_equal(
            f"exec_range, {kind} records", got,
            ec.execute_ranges_plain(*args, RANGE)))
        drec = args[0][1:].contiguous()
        got = ec.execute_scheduled(drec, *args[1:], RANGE)
        torch.cuda.synchronize()
        err["exec_sched"] = max(err["exec_sched"], require_equal(
            f"exec_sched, {kind} records", got,
            ec.execute_scheduled_plain(drec, *args[1:], RANGE)))
        args = on_card(record_batch(kind, block_spans, seed=4), dev)
        got = eb.execute_blocks(*args)
        torch.cuda.synchronize()
        err["exec_block"] = max(err["exec_block"], require_equal(
            f"exec_block, {kind} records", got,
            eb.execute_blocks_plain(*args)))
    n = len(HOSTILE_RECORDS)
    crec = torch.tensor(HOSTILE_RECORDS * 2, dtype=torch.int32).T.contiguous()
    g = np.random.default_rng(9)
    for comp in (g.integers(0, 256, 2048, dtype=np.uint8),
                 np.zeros(0, np.uint8)):
        args = (crec.to(dev), torch.tensor([0, n, 2 * n], device=dev),
                torch.tensor([0, HOSTILE_SPAN], device=dev),
                torch.tensor([HOSTILE_SPAN, HOSTILE_SPAN - 3],
                             dtype=torch.int32, device=dev),
                torch.from_numpy(comp).to(dev), 2 * HOSTILE_SPAN - 3)
        want = ec.execute_ranges_plain(*args, HOSTILE_SPAN)
        got_r = ec.execute_ranges(*args, HOSTILE_SPAN)
        got_b = eb.execute_blocks(*args)
        torch.cuda.synchronize()
        err["exec_range"] = max(err["exec_range"], require_equal(
            "exec_range, hostile records", got_r, want))
        err["exec_block"] = max(err["exec_block"], require_equal(
            "exec_block, hostile records", got_b, want))
    # The append-only executor on hostile fields and ranges that go
    # backwards, past the records, or hold none.
    g = np.random.default_rng(8)
    n = 3000
    drec = np.where(g.random((4, n)) < 0.95, g.integers(-2, 40, (4, n)),
                    g.integers(-(1 << 31), (1 << 31) - 1, (4, n),
                               dtype=np.int64)).astype(np.int32)
    first = torch.tensor([0, 900, 900, 400, 2000, 1500, n, n + 7])
    span = torch.tensor([4096, 100, 2000, 8192, 64, 3000, 17],
                        dtype=torch.int32)
    span64 = span.to(torch.int64)
    s_args = (torch.from_numpy(drec), first, torch.cumsum(span64, 0) - span64,
              span, torch.from_numpy(g.integers(0, 256, 5000, np.uint8)),
              int(span.sum()), 8192)
    got = ec.execute_scheduled(*(a.to(dev) if torch.is_tensor(a) else a
                                 for a in s_args))
    torch.cuda.synchronize()
    err["exec_sched"] = max(err["exec_sched"], require_equal(
        "exec_sched, hostile records, backward ranges", got,
        ec.execute_scheduled_plain(*s_args)))
    log(f"exec_range, exec_sched and exec_block == plain versions "
        f"(tolerance 0) on synthetic records {RECORD_KINDS} at range spans "
        f"{range_spans} and block spans {block_spans}, and on hostile fields "
        f"with and without comp (exec_sched: with ranges that go backwards), "
        f"no CUDA fault")

    for kind in ("literals", "dense", "deep_1", "deep_3", "far"):
        if kind != "far":
            args = on_card(record_batch(kind, [RANGE] * 64, seed=5), dev)
            log_range_rounds(f"{kind} records, 64 x 128 KiB", args, card)
        args = on_card(record_batch(kind, [MB] * BATCH_BLOCKS, seed=5), dev)
        log_block_phases(f"{kind} records, {BATCH_BLOCKS} x 1 MiB", args,
                         card)

def mesh_path(corpus, dev, card, emit_stream):
    """The mesh path: the corpus through Writer(mesh=...) on one NCCL rank
    (this process, the card the run was given) and back through
    Reader(device=...); its bytes are the device_emit stream's.  Then the
    mesh encode's time and its all-gathers' share, the same Writer on one
    and on two gloo ranks sharing the card, and dryrun_multichip on every
    card over NCCL.  Returns the launch counts of the one-rank run."""
    import tempfile
    from functools import partial

    import torch.distributed as dist

    from minlz_tpu_torch.entry import dryrun_multichip
    from minlz_tpu_torch.ops.device_codec import RANGE, DeviceCodec
    from minlz_tpu_torch.parallel import make_mesh, ranks
    from minlz_tpu_torch.parallel.mesh import all_gather, sharded_encode_blocks

    rdzv = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_mesh(device=dev)
        launches, stream = round_trip("mesh", corpus, dev, mesh=mesh)
        if stream != emit_stream:
            raise AssertionError("the mesh stream differs from the "
                                 "device_emit stream")
        codec = DeviceCodec(dev)
        batch = [corpus[i * MB:(i + 1) * MB] for i in range(ENCODE_BATCH)]
        enc_ms = host_ms(lambda: codec.encode_batch_mesh(mesh, batch, LEVEL))
        # The all-gathers of encode_batch_mesh at its shapes: the sizes
        # (the offset scan), the segment lengths, the segment bytes.
        arr = torch.from_numpy(np.frombuffer(
            corpus[:ENCODE_BATCH * MB], np.uint8).reshape(ENCODE_BATCH, MB)
            .copy()).to(dev)
        out, lens, sizes, _ = sharded_encode_blocks(
            mesh, arr, [MB] * ENCODE_BATCH, SEG, RANGE, LEVEL)
        longest = int(lens.max())
        gather_ms = cuda_ms(lambda: (
            all_gather(mesh, sizes), all_gather(mesh, lens),
            all_gather(mesh, out[:, :, :longest])))
        coll_ms = cuda_ms(lambda: sharded_encode_blocks(
            mesh, arr, [MB] * ENCODE_BATCH, SEG, RANGE, LEVEL), repeats=3)
        alone_ms = cuda_ms(lambda: sharded_encode_blocks(
            mesh, arr, [MB] * ENCODE_BATCH, SEG, RANGE, LEVEL,
            collectives=False), repeats=3)
        del arr, out, lens, sizes
        opts = dict(level=LEVEL, block_size=MB)
        _, nccl_1 = ranks.write_stream(mesh, corpus, opts, repeats=2)
    finally:
        dist.destroy_process_group()
    log(f"time mesh encode_batch_mesh, 1 NCCL rank, {ENCODE_BATCH} x 1 MiB "
        f"host bytes in/out: {enc_ms / ENCODE_BATCH:.4f} ms/MB, of which "
        f"the three all-gathers {gather_ms:.4f} ms "
        f"({100 * gather_ms / enc_ms:.2f} %); sharded_encode_blocks "
        f"device-resident {coll_ms / ENCODE_BATCH:.4f} ms/MB with its size "
        f"scan, {alone_ms / ENCODE_BATCH:.4f} ms/MB without  [{card}]")

    # One and two gloo ranks sharing this card: gloo takes CUDA tensors
    # (NCCL refuses two ranks on one device).
    secs = {}
    for world in (1, 2):
        res = ranks.run([(ranks.write_stream, [(corpus, opts, 2)] * world)],
                        world, backend="gloo", devices=[str(dev)] * world,
                        timeout=600)[0]
        if any(got != emit_stream for got, _ in res):
            raise AssertionError(f"the {world}-rank gloo mesh stream differs "
                                 f"from the device_emit stream")
        secs[world] = res[0][1]
    mb = len(corpus) / MB
    log(f"time mesh Writer(mesh=), {len(corpus) // MB} MiB, 1 MiB blocks: "
        f"1 NCCL rank {nccl_1 * 1e3 / mb:.4f} ms/MB; gloo on one card: "
        f"1 rank {secs[1] * 1e3 / mb:.4f} ms/MB, 2 ranks "
        f"{secs[2] * 1e3 / mb:.4f} ms/MB (world 2 / world 1 = "
        f"{secs[2] / secs[1]:.3f}); every rank's stream == device_emit  "
        f"[{card}]")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(torch.cuda.device_count(), backend="nccl",
                         device="cuda")
    for line in buf.getvalue().splitlines():
        log(f"dryrun_multichip({torch.cuda.device_count()}): {line}")
    return launches


PLANTED = (b"MINLZ-PLANTED-PATTERN-ONE", b"straddle-the-block-boundary!",
           b"MINLZ-PLANTED-PATTERN-TWO")
ABSENT = b"\x01\x02never-in-the-corpus\xfe\xfd"
SWEEP_BITS = (8, 16, 23)


def planted(corpus):
    """The corpus with PLANTED written in, one across a block boundary."""
    data = bytearray(corpus)
    n = len(data) // MB
    for at, pat in zip((MB + 1000, (n // 2) * MB - 11, len(data) - 5000),
                       PLANTED):
        data[at:at + len(pat)] = pat
    return bytes(data)


def search_path(corpus, dev, card):
    """The search path: the corpus, with patterns planted (one across a
    block boundary), through Writer(device=..., search_table=
    SearchTableConfig()) (match_len 6, compressed tables, built on the
    card) and back through Reader(device=...).  Every block's table equals
    the NumPy builder's; on one block every match length at bits 8, 16 and
    23 does; BlockSearcher finds every planted pattern and skips blocks for
    an absent one.  Returns the launch counts of the Writer/Reader run."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.search import BlockSearcher, SearchTableConfig
    from minlz_tpu_torch.search.build import (build_table, build_table_auto,
                                              build_tables_device)
    from minlz_tpu_torch.stream import Reader, Writer

    data = planted(corpus)
    n = len(data) // MB
    cfg = SearchTableConfig()

    def write(search):
        buf = io.BytesIO()
        with Writer(buf, device=dev, level=LEVEL, block_size=MB,
                    search_table=cfg if search else None) as w:
            w.write(data)
        torch.cuda.synchronize()
        return buf.getvalue()

    _build.reset_launches()
    stream = write(True)
    r = Reader(io.BytesIO(stream), device=dev)
    before = r.codec.blocks_decoded
    back = r.readall()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if back != data or r.codec.blocks_decoded - before != n \
            or r.hint_fallbacks:
        raise AssertionError("the search stream did not round-trip on the "
                             "device")
    types = [ctype for _, ctype, _ in chunks(stream)]
    tables = {kind: types.count(kind) for kind in (0x45, 0x46)}
    if sum(tables.values()) != n:
        raise AssertionError(f"{tables} table chunks for {n} blocks")

    # Every block's table, built on the card as the Writer builds it (the
    # next block's first bytes as overlap), against the NumPy builder.
    m = cfg.match_len
    for i in range(n):
        block = data[i * MB:(i + 1) * MB]
        overlap = data[(i + 1) * MB:(i + 1) * MB + m - 1]
        if build_table_auto(block, cfg, overlap, MB, dev) != build_table(
                block, cfg, overlap, MB):
            raise AssertionError(f"block {i}: the card's table differs")
    block = np.frombuffer(data[:MB], np.uint8)
    for ml in range(1, 9):
        for bits in SWEEP_BITS:
            plain = SearchTableConfig(match_len=ml, table_bits=bits)
            plain.max_population = 1.0
            plain.max_reduced_population = 0.0
            want, _ = build_table(data[:MB], plain, b"", MB)
            got = build_tables_device(block[None, :], ml, bits, dev)
            if got[0].cpu().numpy().tobytes() != want:
                raise AssertionError(f"bitmap differs at match_len {ml}, "
                                     f"bits {bits}")
    for pat in PLANTED:
        want = _find_all(data, pat)
        got = [x.offset for x in BlockSearcher(io.BytesIO(stream),
                                               pat).search()]
        if got != want or not got:
            raise AssertionError(f"{pat!r}: found at {got}, want {want}")
    s = BlockSearcher(io.BytesIO(stream), ABSENT)
    if s.search() or s.stats.blocks_skipped == 0 \
            or s.stats.blocks_decoded >= s.stats.blocks_total:
        raise AssertionError(f"absent pattern: {vars(s.stats)}")
    log(f"main path (search): {n} MiB -> {len(stream)} bytes, {n} tables "
        f"({tables[0x46]} compressed 0x46, {tables[0x45]} plain 0x45) built "
        f"on the card == NumPy builder for every block; bitmaps == NumPy "
        f"for match_len 1-8 at bits {SWEEP_BITS} on a 1 MiB block; "
        f"{len(PLANTED)} planted patterns found; an absent pattern skipped "
        f"{s.stats.blocks_skipped} of {s.stats.blocks_total} blocks "
        f"undecoded; launches {launches}")

    row = torch.from_numpy(block[None, :].copy()).to(dev)
    bits = cfg.auto_bits(MB)
    build_ms = cuda_ms(lambda: build_tables_device(row, m, bits, dev))
    with_ms = host_ms(lambda: write(True), repeats=2)
    without_ms = host_ms(lambda: write(False), repeats=2)
    log(f"time search table build_tables_device on the card, 1 MiB block, "
        f"match_len {m}, bits {bits}: {build_ms:.4f} ms/MB; "
        f"Writer(device=\"cuda\") {n} MiB with search tables "
        f"{with_ms / n:.4f} ms/MB, without {without_ms / n:.4f} ms/MB  "
        f"[{card}]")
    return launches


# The decode kernels of `mz d -device` (their launch counts' names) and the
# functions' own names in a trace.
CLI_KERNELS = {"parse": "parse_kernel",
               "lane_offsets": "lane_offsets_kernel",
               "compact": "compact_kernel",
               "exec_range": "exec_range_kernel"}


def kernel_base(name):
    """The function's own name in a trace's kernel name, e.g. "parse_kernel"
    in "(anonymous namespace)::parse_kernel(unsigned char const*, ...)"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].rsplit("::", 1)[-1]


def cli_path(corpus, dev, card):
    """The cli path: the mz command line (minlz_tpu_torch.cli.main) run in
    this process on the card over the corpus in a file.  `c -2` and
    `c -2 -device` write the stream of Writer(device=...) with the CLI's
    defaults; `d` and `d -device` decode it exactly, every block on the card;
    `d -offset` decodes the blocks it touches on the card; `bench -device -n
    3` prints its line; `c -device -search` then `s -c` finds each planted
    pattern as often as bytes.count does; `c` and `d` on the host route
    (main(argv, device=None)) build no DeviceCodec, and `d` on the card
    decodes the host route's stream (no parse hints) with a derive and an
    exec_block launch a batch.  Last, because the
    profiler stays in the process, `--traceprof D d -device`: its trace holds
    K1, the lane offset scan, K2 and K3, a launch each for every batch of 8
    blocks, and gives the
    device's busy time and idle share.  Each rate is printed twice: the
    CLI's own (the codec alone, without reading the input and writing the
    output) and the whole main call, file to file.  Returns the launch
    counts of the run."""
    import re
    import tempfile

    from minlz_tpu_torch import _build, cli
    from minlz_tpu_torch._device import resolve_device
    from minlz_tpu_torch.minlz import DEFAULT_BLOCK_SIZE
    from minlz_tpu_torch.bench import trace_share
    from minlz_tpu_torch.ops.device_codec import DeviceCodec
    from minlz_tpu_torch.stream import Writer

    def mz(argv, device=dev):
        """mz argv: its stdout, its stderr and the seconds of the call."""
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv, device=device)
        if device is not None:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"mz {argv} returned {rc}: {err.getvalue()}")
        return out.getvalue(), err.getvalue(), dt

    def rate(line):
        return float(re.search(r"([\d.]+) MB/s", line).group(1))

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    t_path = time.perf_counter()
    n = len(corpus) // MB
    batches = -(-n // BATCH_BLOCKS)
    buf = io.BytesIO()
    with Writer(buf, device=dev, level=LEVEL, add_index=True,
                padding=0) as w:
        w.encode_buffer(corpus)
    want = buf.getvalue()
    rates = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        src, mzf = os.path.join(d, "corpus"), os.path.join(d, "corpus.mz")
        out_f = src + ".out"
        with open(src, "wb") as fh:
            fh.write(corpus)
        _build.reset_launches()
        for flag in (["-device"], []):
            out, _, dt = mz(["c", "-2"] + flag + [src, "-o", mzf])
            if read(mzf) != want:
                raise AssertionError(f"mz c {flag} differs from the Writer's "
                                     f"stream")
            rates["c" + " -device" * bool(flag)] = (rate(out), n / dt)
        for flag in (["-device"], []):
            _, err, dt = mz(["d"] + flag + [mzf, "-o", out_f])
            if read(out_f) != corpus:
                raise AssertionError(f"mz d {flag} did not decode the corpus")
            if f", {n} blocks on {resolve_device(dev)})" not in err:
                raise AssertionError(f"mz d {flag}: not every block on the "
                                     f"card: {err.strip()}")
            rates["d" + " -device" * bool(flag)] = (rate(err), n / dt)
        start = n // 2 * MB + 12345
        before = _build.launch_counts()["exec_range"]
        mz(["d", "-offset", str(start), "-limit", str(2 * MB), mzf, "-o",
            out_f])
        if read(out_f) != corpus[start:start + 2 * MB]:
            raise AssertionError("mz d -offset did not decode its range")
        seek_launches = _build.launch_counts()["exec_range"] - before
        if seek_launches != 3:
            raise AssertionError(f"mz d -offset: {seek_launches} blocks on "
                                 f"the card, want 3")
        bench_out, _, _ = mz(["bench", "-device", "-n", "3", src])

        data = planted(corpus)
        src_s, mz_s = os.path.join(d, "planted"), os.path.join(d, "planted.mz")
        with open(src_s, "wb") as fh:
            fh.write(data)
        mz(["c", "-device", "-search", src_s, "-o", mz_s])
        for pat in PLANTED:
            out, _, _ = mz(["s", "-c", pat.decode(), mz_s])
            got = int(out.strip().rsplit(" ", 1)[-1])
            if got != data.count(pat) or got == 0:
                raise AssertionError(f"mz s -c {pat!r}: {got}, want "
                                     f"{data.count(pat)}")

        # The Reader and Writer take the process's codec on their device
        # (get_device_codec): the host route asks for none and builds none,
        # the card route's d asks for one.
        from minlz_tpu_torch.ops import device_codec as dcm

        built, real_init = [], DeviceCodec.__init__
        asked, real_get = [], dcm.get_device_codec

        def counted(self, *args, **kwargs):
            built.append(args)
            real_init(self, *args, **kwargs)

        def counted_get(*args, **kwargs):
            asked.append(args)
            return real_get(*args, **kwargs)

        DeviceCodec.__init__ = counted
        dcm.get_device_codec = counted_get
        try:
            mz(["c", "-2", src, "-o", mzf + ".host"], device=None)
            mz(["d", mzf + ".host", "-o", src + ".host"], device=None)
            host_built, host_asked = len(built), len(asked)
            if read(src + ".host") != corpus:
                raise AssertionError("mz c / mz d on the host did not "
                                     "round-trip")
            # The host route's stream has no parse hints; the card route's
            # d derives every block's lanes (derive, then the whole-block
            # road), a launch of each a batch.
            before = _build.launch_counts()
            _, err, _ = mz(["d", mzf + ".host", "-o", src + ".host"])
            after = _build.launch_counts()
        finally:
            DeviceCodec.__init__ = real_init
            dcm.get_device_codec = real_get
        if host_built or host_asked or len(asked) != 1:
            raise AssertionError(
                f"mz c and mz d on the host route built {host_built} "
                f"DeviceCodec and asked for {host_asked}; the card route's d "
                f"after them asked for {len(asked) - host_asked}, want 1")
        # The host route's Writer keeps the format's 2 MiB default blocks.
        n_host = -(-len(corpus) // DEFAULT_BLOCK_SIZE)
        host_batches = -(-n_host // BATCH_BLOCKS)
        unhinted = {k: after[k] - before[k] for k in after}
        if read(src + ".host") != corpus \
                or f", {n_host} blocks on {resolve_device(dev)})" not in err \
                or unhinted["derive"] != host_batches \
                or unhinted["exec_block"] != host_batches \
                or unhinted["exec_range"]:
            raise AssertionError(
                f"mz d of the host route's stream on the card: "
                f"{err.strip()}; launches {unhinted}; want derive and "
                f"exec_block {host_batches} times, exec_range none")

        prof = os.path.join(d, "prof")
        before = _build.launch_counts()
        _, err, dt = mz(["--traceprof", prof, "d", "-device", mzf, "-o",
                         out_f])
        after = _build.launch_counts()
        if read(out_f) != corpus:
            raise AssertionError("mz d -device did not decode the corpus")
        rates["d -device under --traceprof (file to file includes the "
              "trace's export)"] = (rate(err), n / dt)
        share = trace_share(os.path.join(prof, "mz_trace.json"), top=None)
        in_trace = {}
        for name, _, calls in share["kernels"]:
            base = kernel_base(name)
            in_trace[base] = in_trace.get(base, 0) + calls
        for count, kname in CLI_KERNELS.items():
            if after[count] - before[count] != batches \
                    or in_trace.get(kname, 0) != batches:
                raise AssertionError(
                    f"mz d -device: {kname} launched "
                    f"{after[count] - before[count]} times, "
                    f"{in_trace.get(kname, 0)} in the trace; want {batches}")
        launches = _build.launch_counts()
    log(f"main path (cli): mz c -2 and mz c -2 -device == Writer(device=...) "
        f"stream ({len(want)} bytes); mz d and mz d -device == corpus, {n} "
        f"blocks on the card; mz d -offset: 3 blocks on the card; in the "
        f"trace " + ", ".join(f"{k} x{in_trace[k]}"
                               for k in CLI_KERNELS.values())
        + f" ({batches} batches of {BATCH_BLOCKS} blocks)")
    for label, (own, whole) in rates.items():
        log(f"time cli mz {label}, {n} MiB: {own} MB/s as the CLI prints it "
            f"(the codec alone), {whole * MB / 1e6:.1f} MB/s file to file "
            f"(the main call)  [{card}]")
    top = ", ".join(f"{kernel_base(k)} {t:.1f} us x{c}"
                    for k, t, c in share["kernels"][:5])
    log(f"time cli mz --traceprof d -device, {n} MiB: device busy "
        f"{share['busy_us']:.1f} us of a {share['window_us']:.1f} us "
        f"window, idle share {share['idle_share']:.4f}; longest: {top}  "
        f"[{card}]")
    log(f"time cli mz bench -device -n 3: "
        f"{bench_out.strip().replace(src, 'corpus')}  [{card}]")
    log(f"main path (cli): mz c -device -search, then mz s -c finds each of "
        f"{len(PLANTED)} planted patterns as often as bytes.count; mz c and "
        f"mz d on the host route built no DeviceCodec; its stream, without "
        f"hints, decoded on the card by mz d: derive x{unhinted['derive']}, "
        f"exec_block x{unhinted['exec_block']}; launches {launches}; "
        f"the path took {time.perf_counter() - t_path:.1f} s")
    return launches


def api_path(batch_segs, g_off, g_len, enc_in, ns, corpus, dev, card):
    """The JAX package's names on the card, each held to its plain version
    (tolerance 0): parse_segments_scan on the decode batch's segments (all
    seven [P, lanes] arrays), decode_segments_jnp on 1 MiB of the corpus as
    4 KiB blocks of one segment each (== the CPU's bytes == the input),
    encode_kernel.greedy_parse on the encode batch's proposals, and
    find_matches_dyn(exact=True) on the encode batch (== the CPU's
    proposals).  The launch counts are set to 0 just before and read just
    after.  Returns them."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import decode_kernel as dk
    from minlz_tpu_torch.ops import encode_kernel as ek
    from minlz_tpu_torch.ops import greedy as tg
    from minlz_tpu_torch.ops.device_codec import RANGE
    from minlz_tpu_torch.oracle.decode import parse_header

    mat, lens = dk.pack_segments(batch_segs)
    m, ln = torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)
    pieces = [corpus[i * SEG:(i + 1) * SEG] for i in range(API_PIECES)]
    encoded = ek.encode_blocks_device(pieces, SEG, 0, LEVEL, dev)
    kept = [(p, b) for p, (b, _) in zip(pieces, encoded) if b is not None]
    one_segs = [b[parse_header(b)[2]:] for _, b in kept]
    torch.cuda.synchronize()

    _build.reset_launches()
    scan, scan_ms = once_ms(lambda: dk.parse_segments_scan(m, ln))
    dec, dec_ms = once_ms(lambda: dk.decode_segments_jnp(
        one_segs, [SEG] * len(one_segs), dev))
    greedy, greedy_ms = once_ms(lambda: ek.greedy_parse(g_off, g_len, SEG))
    exact, exact_ms = once_ms(lambda: ek.find_matches_dyn(
        enc_in, ns, SEG, RANGE, LEVEL, exact=True))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for count in ("parse", "greedy"):
        if launches[count] <= 0:
            raise AssertionError(f"kernel {count} never ran on the api path")

    scan_p, scan_p_ms = once_ms(lambda: dk.parse_segments_scan_plain(m, ln))
    for name, got, want in zip(("kind", "dst", "clen", "csrc", "lsrc",
                                "llen", "lacc"), scan, scan_p):
        require_equal(f"parse_segments_scan {name}", got, want)
    t0 = time.perf_counter()
    dec_p = dk.decode_segments_jnp(one_segs, [SEG] * len(one_segs), "cpu")
    dec_p_ms = (time.perf_counter() - t0) * 1e3
    if dec != dec_p or dec != [p for p, _ in kept]:
        raise AssertionError("decode_segments_jnp on the card differs from "
                             "the CPU's or from the input")
    greedy_p, greedy_p_ms = once_ms(
        lambda: tg.greedy_parse_plain(g_off, g_len, SEG))
    for name, got, want in zip(("take", "tok_off", "tok_len", "is_rep"),
                               greedy, greedy_p):
        require_equal(f"encode_kernel.greedy_parse {name}", got, want)
    t0 = time.perf_counter()
    exact_p = ek.find_matches_dyn(enc_in.cpu(), ns, SEG, RANGE, LEVEL,
                                  exact=True)
    exact_p_ms = (time.perf_counter() - t0) * 1e3
    for name, got, want in zip(("dist", "length"), exact, exact_p):
        require_equal(f"find_matches_dyn(exact=True) {name}, cuda vs cpu",
                      got, want)
    # exact=False and exact=True again, each once, on the same batch: the
    # two modes' times side by side in this run.
    hashed, hashed_ms = once_ms(lambda: ek.find_matches_dyn(
        enc_in, ns, SEG, RANGE, LEVEL))
    hashed = int((hashed[0] > 0).sum())
    _, exact2_ms = once_ms(lambda: ek.find_matches_dyn(
        enc_in, ns, SEG, RANGE, LEVEL, exact=True))
    records = int((scan[0] > 0).sum())
    log(f"main path (api): parse_segments_scan on {mat.shape[1]} lanes x "
        f"{mat.shape[0]} rows ({records} records at their rows), "
        f"decode_segments_jnp on {len(one_segs)} one-segment blocks, "
        f"encode_kernel.greedy_parse on {g_off.shape[0]} lanes == their "
        f"plain versions, find_matches_dyn(exact=True) on {len(ns)} x 1 MiB "
        f"== the CPU's ({int((exact[0] > 0).sum())} proposals, {hashed} "
        f"with exact=False) (tolerance 0: integers and bytes); launches "
        f"{launches}")
    for label, ms, plain in (
            ("parse_segments_scan (K1, then the layout)", scan_ms,
             scan_p_ms),
            ("decode_segments_jnp (host bytes in/out)", dec_ms, dec_p_ms),
            ("encode_kernel.greedy_parse (K8)", greedy_ms, greedy_p_ms),
            (f"find_matches_dyn(exact=True), {len(ns)} x 1 MiB (torch ops; "
             f"the plain version is the CPU's)", exact_ms, exact_p_ms)):
        log(f"time api {label}: {ms:.4f} ms once, plain version "
            f"{plain:.4f} ms  [{card}]")
    log(f"time api find_matches_dyn, {len(ns)} x 1 MiB, one call each in "
        f"this order: exact=True {exact_ms:.4f} ms, exact=False "
        f"{hashed_ms:.4f} ms, exact=True {exact2_ms:.4f} ms  [{card}]")
    return launches


def derived_lanes(plan, first: int, n: int):
    """Lanes [first, first + n) of a derived plan as a batch of their own:
    (comp, lane_start, lane_len, lane_rep), the bytes they tile and their
    starts counted from the first."""
    start = plan["lane_start"][first:first + n]
    lens = plan["lane_len"][first:first + n]
    a = int(start[0])
    b = int(start[-1] + lens[-1])
    return (plan["comp"][a:b].contiguous(), (start - a).contiguous(),
            lens.contiguous(), plan["lane_rep"][first:first + n].contiguous())


def unhinted_path(corpus, dev, card):
    """The unhinted path: the corpus written as the format's other writers
    write it (Writer(device=None) at 2 MiB blocks, as mz c does: no chunk
    0x88), then read by Reader(device=...) through readall (batches of
    BATCH_BLOCKS) and read (a block a dispatch): every block derives its
    lanes on the card (csrc/derive.cu), then K1 with each lane's incoming
    repeat offset, the lane offset scan, K2 and the whole-block executor.
    The launch counts are set to 0 just before readall and read just after
    it.  Then the derivation is held against derive_plan_plain on the
    stream's blocks (every lane, range and verdict tensor exactly), K1 with
    the derived lane_rep against parse_segments_plain on PLAIN_LANES lanes,
    and both are timed ("time derive" line).  Returns (launches, the
    kernel's max abs err, its time through derive_plan as one call, the
    plain version's time, its bound)."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.minlz import read_uvarint
    from minlz_tpu_torch.ops import derive
    from minlz_tpu_torch.ops import parse as ps
    from minlz_tpu_torch.ops.device_codec import get_device_codec
    from minlz_tpu_torch.stream import Reader, Writer
    from mzbench.derive_reference import plan_bytes

    block = 2 * MB
    n = -(-len(corpus) // block)
    buf = io.BytesIO()
    with Writer(buf, device=None, level=LEVEL, block_size=block) as w:
        w.write(corpus)
    stream = buf.getvalue()
    if hinted_blocks(stream):
        raise AssertionError("unhinted: Writer(device=None) wrote parse "
                             "hints")
    codec = get_device_codec(dev)
    launches = None
    for route in ("readall", "read"):
        dec0 = codec.blocks_decoded
        _build.reset_launches()
        r = Reader(io.BytesIO(stream), device=dev)
        back = r.readall() if route == "readall" else r.read()
        torch.cuda.synchronize()
        launches = launches or _build.launch_counts()
        decoded = codec.blocks_decoded - dec0
        if back != corpus or r.host_unhinted_blocks or r.hint_fallbacks \
                or decoded != n:
            raise AssertionError(
                f"unhinted ({route}): exact {back == corpus}, "
                f"{r.host_unhinted_blocks} blocks without hints and "
                f"{r.hint_fallbacks} with hints on the host, {decoded} of "
                f"{n} on the card")
    log(f"main path (unhinted): {len(corpus) // MB} MiB -> {len(stream)} "
        f"bytes by Writer(device=None), {n} x 2 MiB blocks without hints; "
        f"Reader.readall (batches of {BATCH_BLOCKS}) and Reader.read (a block "
        f"a dispatch) on the card == corpus, "
        f"{n} of {n} blocks on the card, host_unhinted_blocks 0; launches "
        f"{launches}")

    bodies, wants = [], []
    for pos, ctype, clen in chunks(stream):
        if ctype in (0x02, 0x03):   # compressed data: CRC, uvarint, body
            want, hdr = read_uvarint(stream, pos + 8)
            bodies.append(stream[hdr:pos + 4 + clen])
            wants.append(want)
    if len(bodies) != n:
        raise AssertionError(f"unhinted: {len(bodies)} compressed blocks, "
                             f"want {n}")
    lens = np.array([len(b) for b in bodies], np.int64)
    comp = torch.from_numpy(np.frombuffer(b"".join(bodies), np.uint8)
                            .copy()).to(dev)
    body_off = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                                .astype(np.int64)).to(dev)
    out_len = torch.tensor(wants, dtype=torch.int32, device=dev)
    total = sum(wants)
    plan = derive.derive_plan(comp, body_off, out_len, total, SEG)
    plain, p_ms = once_ms(lambda: derive.derive_plan_plain(
        comp, body_off, out_len, total, SEG))
    err = 0
    for k in derive.LANES + derive.RANGES + ("bad",):
        err = max(err, require_equal(f"derive {k}", plan[k], plain[k]))
    if int(plan["bad"]):
        raise AssertionError("derive: a sound stream judged unsound")
    reps = int((plan["lane_rep"] != 1).sum())
    first = int(plan["range_lane"][1]) - PLAIN_LANES // 2
    sub = derived_lanes(plan, first, PLAIN_LANES)
    recs, counts = ps.parse_planned(*sub)
    torch.cuda.synchronize()
    recs_p, counts_p = ps.parse_segments_plain(*(x.cpu() for x in sub))
    err = max(err, require_equal("parse with lane_rep, counts", counts,
                                 counts_p),
              require_equal("parse with lane_rep, records", recs, recs_p))
    sub_reps = int((sub[3] != 1).sum())
    if not sub_reps:
        raise AssertionError("parse with lane_rep: no lane of the held "
                             "batch enters with an offset other than 1")
    del plain, recs, counts, recs_p, counts_p

    scratch = derive.derive_scratch(comp, n)
    bare = derive.empty_plan(comp, n, SEG)
    alone = queued_ms(lambda: derive.launch_derive(
        bare, body_off, out_len, total, SEG, scratch))
    for k in derive.LANES + derive.RANGES + ("bad",):
        require_equal(f"derive {k}, bare launch", bare[k], plan[k])
    queued = queued_ms(lambda: derive.derive_plan(comp, body_off, out_len,
                                                  total, SEG))
    once = cuda_ms(lambda: derive.derive_plan(comp, body_off, out_len,
                                              total, SEG))
    moved = plan_bytes(lens.tolist(), SEG)
    log(f"time derive: {n} x 2 MiB blocks without hints, {comp.numel()} "
        f"compressed bytes, {plan['lane_len'].numel()} lanes ({reps} enter "
        f"with an offset other than 1; the {PLAIN_LANES} across the first "
        f"block's end held through K1: {sub_reps}); alone {alone:.4f} ms, "
        f"derive_plan {queued:.4f} ms queued, {once:.4f} ms as one call, "
        f"plain version {p_ms:.4f} ms; {moved / 1e6:.2f} MB to move (the "
        f"bodies read once, the walk's lanes written once)  [{card}]")
    return launches, err, once, p_ms, bound(moved, 0)


def blocks_touched(off: int, n: int, block: int = MB) -> int:
    """Blocks that a read of n bytes at off decodes."""
    return (off + n - 1) // block - off // block + 1


def chunks(stream: bytes):
    """(offset, type, payload length) of every chunk of a stream, by
    walking its chunk headers."""
    out, pos = [], 0
    while pos < len(stream):
        clen = int.from_bytes(stream[pos + 1:pos + 4], "little")
        out.append((pos, stream[pos], clen))
        pos += 4 + clen
    return out


def hinted_blocks(stream: bytes) -> int:
    """Data chunks of a stream that parse hints come before."""
    from minlz_tpu_torch.minlz import CHUNK_TYPE_PARSE_HINT

    types = [ctype for _, ctype, _ in chunks(stream)]
    return sum(ctype in (0x02, 0x03) and prev == CHUNK_TYPE_PARSE_HINT
               for prev, ctype in zip(types, types[1:]))


def seek_path(stream, corpus, dev, card):
    """Random access on the card, on the serializer path's stream (32 MiB,
    1 MiB blocks, written with an index): ReadSeeker(device=dev) reads
    SEEK_SPANS spans of SEEK_SPAN bytes at offsets from a seeded numpy
    generator, half through seek + read and half through read_at; Reader.skip
    crosses three blocks; two streams written on the card are read
    concatenated, and a stream written with padding and a user chunk is read
    whole and through its loaded index.  Every read is held to the corpus,
    the codec's blocks_decoded must rise by the blocks each read touches and
    no block may fall back to the host.  The launch counts are set to 0 just
    before and read just after.  Returns them."""
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops import device_codec
    from minlz_tpu_torch.stream import Index, Reader, ReadSeeker, Writer

    codec = device_codec.get_device_codec(dev)
    offs = [int(o) for o in np.random.default_rng(SEEK_SEED).integers(
        0, len(corpus) - SEEK_SPAN, SEEK_SPANS)]
    half = SEEK_SPANS // 2
    side = corpus[:SEEK_SIDE_MB * MB], corpus[-SEEK_SIDE_MB * MB:]
    torch.cuda.synchronize()

    _build.reset_launches()
    dec0 = codec.blocks_decoded
    rs = ReadSeeker(io.BytesIO(stream), device=dev)
    seek_ms, at_ms, want = [], [], 0
    for k, off in enumerate(offs):
        t0 = time.perf_counter()
        if k < half:
            rs.seek(off)
            got = rs.read(SEEK_SPAN)
        else:
            got = rs.read_at(off, SEEK_SPAN)
        (seek_ms if k < half else at_ms).append(
            (time.perf_counter() - t0) * 1e3)
        if got != corpus[off:off + SEEK_SPAN]:
            raise AssertionError(f"seek path: the span at {off} differs")
        want += blocks_touched(off, SEEK_SPAN)
    spans_decoded = codec.blocks_decoded - dec0
    if spans_decoded != want or rs.hint_fallbacks:
        raise AssertionError(
            f"seek path: {spans_decoded} blocks decoded on the card for the "
            f"spans, want {want}; {rs.hint_fallbacks} on the host")

    r = Reader(io.BytesIO(stream), device=dev)
    before = codec.blocks_decoded
    skip_to = 3 * MB + 12345
    r.skip(skip_to)
    got = r.read(SEEK_SPAN)
    if got != corpus[skip_to:skip_to + SEEK_SPAN] \
            or codec.blocks_decoded - before != 1 or r.hint_fallbacks:
        raise AssertionError("seek path: Reader.skip over three blocks did "
                             "not decode the fourth alone on the card")

    def write(data):
        buf = io.BytesIO()
        with Writer(buf, device=dev, level=LEVEL, block_size=MB) as w:
            w.write(data)
        return buf.getvalue()

    one = write(side[0]) + write(side[1])
    before = codec.blocks_decoded
    r = Reader(io.BytesIO(one), device=dev)
    if r.readall() != side[0] + side[1] or r.hint_fallbacks \
            or codec.blocks_decoded - before != hinted_blocks(one):
        raise AssertionError("seek path: the concatenated streams did not "
                             "decode on the card")

    buf = io.BytesIO()
    with Writer(buf, device=dev, level=LEVEL, block_size=MB,
                padding=SEEK_PADDING, add_index=True) as w:
        w.write(side[0][:MB + MB // 2])
        w.add_user_chunk(0x90, b"seek path user chunk")
        w.write(side[0][MB + MB // 2:])
    padded = buf.getvalue()
    idx = Index.load_stream(io.BytesIO(padded))
    seen = []
    before = codec.blocks_decoded
    r = Reader(io.BytesIO(padded), device=dev, user_chunk_cb={0x90:
                                                              seen.append})
    if len(padded) % SEEK_PADDING or idx.total_uncompressed != len(side[0]) \
            or r.readall() != side[0] or seen != [b"seek path user chunk"] \
            or codec.blocks_decoded - before != hinted_blocks(padded):
        raise AssertionError("seek path: the padded stream with a user "
                             "chunk did not read back on the card")
    rs = ReadSeeker(io.BytesIO(padded), index=idx, device=dev)
    before = codec.blocks_decoded
    for off in (MB - 7, len(side[0]) - SEEK_SPAN):
        if rs.read_at(off, SEEK_SPAN) != side[0][off:off + SEEK_SPAN]:
            raise AssertionError(f"seek path: the padded stream's span at "
                                 f"{off} differs")
    if codec.blocks_decoded - before != 3 or rs.hint_fallbacks:
        raise AssertionError("seek path: the padded stream's spans did not "
                             "decode on the card")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for count in ("parse", "lane_offsets", "compact", "exec_range"):
        if launches[count] <= 0:
            raise AssertionError(f"kernel {count} never ran on the seek "
                                 f"path")
    for count in ("greedy", "exec_block", "exec_sched", "compact_dense"):
        if launches[count] != 0:
            raise AssertionError(f"the seek path launched {count}")
    log(f"main path (seek): ReadSeeker(device) read {SEEK_SPANS} spans of "
        f"{SEEK_SPAN} bytes of the {len(corpus) // MB} MiB stream ({half} "
        f"by seek + read, {SEEK_SPANS - half} by read_at, offsets from "
        f"default_rng({SEEK_SEED})) == corpus, {spans_decoded} blocks "
        f"decoded on the card for them, none on the host; Reader.skip over "
        f"3 blocks; two {SEEK_SIDE_MB} MiB streams concatenated and a "
        f"{SEEK_SIDE_MB} MiB stream with padding {SEEK_PADDING} and a user "
        f"chunk read back on the card; launches {launches}")
    total_ms = sum(seek_ms) + sum(at_ms)
    log(f"time seek: {statistics.median(seek_ms):.3f} ms a seek + read of "
        f"{SEEK_SPAN} bytes (median of {half}, host clock, one 1 MiB block "
        f"a dispatch), read_at {SEEK_SPAN * len(at_ms) / sum(at_ms) / 1e3:.3f}"
        f" MB/s of span bytes ({statistics.median(at_ms):.3f} ms a call), "
        f"{spans_decoded * MB / total_ms / 1e3:.1f} MB/s of blocks decoded "
        f"for all {SEEK_SPANS} spans  [{card}]")
    return launches


def _find_all(data, pattern):
    out, start = [], 0
    while (j := data.find(pattern, start)) >= 0:
        out.append(j)
        start = j + 1
    return out



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
    from minlz_tpu_torch.ops import exec_block as eb
    from minlz_tpu_torch.ops import exec_chain as ec
    from minlz_tpu_torch.ops import greedy as tg
    from minlz_tpu_torch.ops import parse as ps
    from minlz_tpu_torch.ops.device_codec import (
        RANGE, DeviceCodec, marshal_hints, parse_hints, split_body)
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
    n_src = sum(f.endswith(".cu") for f in _build.sources())
    log(f"build: nvcc sm_90a, {n_src} sources in parallel, {secs:.2f} s")

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
    recs, counts, crec, lane_out, total, first, out = run_stages(
        t, plan, False)
    torch.cuda.synchronize()
    args_parse = (t["comp"], t["lane_start"], t["lane_len"])
    args_compact = (recs, counts, t["lane_start"], t["lane_len"],
                    t["lane_lo"], t["lane_hi"])
    args_exec = (crec, first, t["range_out"], t["range_span"], t["comp"],
                 plan.total_out, plan.max_span)
    err, plain_ms = {}, {}
    (recs_p, counts_p), plain_ms["parse"] = once_ms(
        lambda: ps.parse_segments_plain(*args_parse))
    err["parse"] = max(require_equal("parse counts", counts, counts_p),
                       require_equal("parse records", recs, recs_p))
    compact_p, plain_ms["compact"] = once_ms(
        lambda: ec.compact_records_plain(*args_compact))
    err["compact"] = require_records("compacted records",
                                     (crec, lane_out, total), compact_p)
    (lane_out_p, total_p), plain_ms["lane_offsets"] = once_ms(
        lambda: ec.lane_offsets_plain(counts))
    err["lane_offsets"] = max(
        require_equal("lane offsets", lane_out, lane_out_p),
        require_equal("record total", total, total_p))
    crec_p = compact_p[0]
    out_p, plain_ms["exec_range"] = once_ms(
        lambda: ec.execute_ranges_plain(*args_exec))
    err["exec_range"] = require_equal("decoded bytes", out, out_p)
    host = out.cpu().numpy()
    for (o, _), b in zip(plan.block_out, blocks):
        if host[o:o + len(b)].tobytes() != b:
            raise AssertionError("the kernels' decode differs from the input")
    n_comp, lanes = t["comp"].numel(), len(plan.lane_len)
    n_recs, n_ranges = int(total), len(plan.range_span)
    log(f"decode kernels == plain versions (tolerance 0: integers and "
        f"bytes) on {BATCH_BLOCKS} x 1 MiB: {n_comp} compressed bytes, "
        f"{lanes} lanes, {n_recs} records, {n_ranges} ranges")
    # ---- 3a. K1 on inputs made to stress it, and its time ------------------
    # "ms" of parse is the wrapper the decode roads call (parse_planned).
    k_ms = {}
    _, k_ms["parse"], _ = time_parse(f"the corpus, {BATCH_BLOCKS} x 1 MiB",
                                     args_parse, card)
    made_up = parse_inputs()
    for label, segs in made_up.items():
        err["parse"] = max(err["parse"], parse_vs_plain(
            f"{label}, first {PLAIN_LANES} lanes", segs[:PLAIN_LANES], dev))
        time_parse(label, lanes_on(segs, dev), card)
    err["parse"] = max(err["parse"], parse_vs_plain(
        "copy tokens, 16 lanes of 6000 bytes", copy_token_lanes(16, 6000, 21),
        dev))
    log(f"parse == plain version (tolerance 0, every slot) on the first "
        f"{PLAIN_LANES} lanes of each made-up input and on 16 lanes of "
        f"copy tokens across 3 windows each; == the token model on all "
        f"{PARSE_LANES} lanes of each")
    k_ms.update({
        "compact": cuda_ms(lambda: ec.compact_records(*args_compact)),
        "lane_offsets": cuda_ms(lambda: ec.lane_offsets(counts)),
        "exec_range": cuda_ms(lambda: ec.execute_ranges(*args_exec)),
    })
    # Bytes each function must move (inputs once, outputs once) and its
    # integer operations, counted from this batch.  parse: the compressed
    # bytes and two lane arrays in, seven int32 record fields per slot and
    # the counts out; about 40 operations per compressed byte.  compact:
    # five fields of each record and seven lane arrays in, five fields and
    # the lane offsets out; about 30 operations per record.  lane_offsets:
    # the int32 counts in, the int64 offsets and total out; about 4
    # operations per lane.  exec_range:
    # five fields per record, three range arrays and the literal source
    # bytes in, the decoded bytes out; about 2 operations per byte out.
    bounds = {
        "parse": bound(n_comp + 8 * lanes + 28 * (n_comp + lanes)
                       + 4 * lanes, 40 * n_comp),
        "compact": bound(20 * n_recs + 28 * lanes + 20 * n_recs + 8 * lanes,
                         30 * n_recs),
        "lane_offsets": bound(4 * lanes + 8 * (lanes + 1), 4 * lanes),
        "exec_range": bound(20 * n_recs + 16 * n_ranges + n_comp
                            + plan.total_out, 2 * plan.total_out),
    }

    # ---- 3a'. kernels 2, 5 and 6 on the made-up batches, and their time --
    corpus_label = f"the corpus, {BATCH_BLOCKS} x 1 MiB"
    time_compact(
        f"compact, {corpus_label}", ec.COMPACT, recs, counts, t, card,
        BEFORE["compact"])
    for label, segs in made_up.items():
        compare_compaction(label, segs, dev, card, err)
    log(f"compact, compact_whole and compact_dense == plain versions "
        f"(tolerance 0: lane offsets, total and the first total columns) "
        f"on the {len(made_up)} made-up batches, at range spans, "
        f"whole-block spans and dense")
    del made_up

    # ---- 3b. the append-only road on the same batch ------------------------
    args_dense = (recs, counts, t["lane_start"], t["lane_len"])
    dense = ec.compact_records_dense(*args_dense)
    drec = dense[0]
    torch.cuda.synchronize()
    dense_p, plain_ms["compact_dense"] = once_ms(
        lambda: ec.compact_records_dense_plain(*args_dense))
    err["compact_dense"] = require_records("dense records", dense, dense_p)
    require_equal("dense records vs positioned records", drec[:, :n_recs],
                  crec[1:, :n_recs])
    drec_p = dense_p[0]
    args_sched = (drec, first) + args_exec[2:]
    out_s = ec.execute_scheduled(*args_sched)
    torch.cuda.synchronize()
    out_sp, plain_ms["exec_sched"] = once_ms(
        lambda: ec.execute_scheduled_plain(*args_sched))
    err["exec_sched"] = require_equal("append-only decoded bytes", out_s,
                                      out_sp)
    require_equal("append-only executor vs exec_range", out_s, out)
    log(f"compact_dense and exec_sched == plain versions (tolerance 0) on "
        f"the same batch; exec_sched bytes == exec_range bytes")
    k_ms["compact_dense"] = cuda_ms(
        lambda: ec.compact_records_dense(*args_dense))
    k_ms["exec_sched"] = cuda_ms(lambda: ec.execute_scheduled(*args_sched))
    # compact_dense: four fields of each record and four lane arrays in,
    # four fields and the lane offsets out; about 10 operations per record.
    # exec_sched: four fields per record, else as exec_range.
    bounds["compact_dense"] = bound(
        16 * n_recs + 20 * lanes + 16 * n_recs + 8 * lanes, 10 * n_recs)
    bounds["exec_sched"] = bound(16 * n_recs + 16 * n_ranges + n_comp
                                 + plan.total_out, 2 * plan.total_out)
    del drec_p, out_s, out_sp, recs_p, crec_p, out_p, compact_p, dense_p

    time_compact(
        f"compact_dense, {corpus_label}", ec.COMPACT_DENSE, recs, counts, t,
        card, BEFORE["compact_dense"])

    # ---- 3c. the whole-block road: the same blocks without the clamp -----
    enc_w = ek.encode_blocks_device(blocks, SEG, 0, LEVEL, dev)
    if any(b is None for b, _ in enc_w):
        raise AssertionError("a corpus block did not compress")
    items_w = []
    for block, hints in enc_w:
        _, want, pos = parse_header(block)
        items_w.append((block[pos:], marshal_hints(SEG, hints, 0), want))
    plan_w = ec.plan_batch(
        [split_body(body, parse_hints(payload)[1])
         for body, payload, _ in items_w], SEG, 0)
    tw = plan_w.tensors(dev)
    recs_w, counts_w, crec_w, lane_out_w, total_w, first_w, out_w = \
        run_stages(tw, plan_w, False)
    torch.cuda.synchronize()
    args_compact_w = (recs_w, counts_w, tw["lane_start"], tw["lane_len"],
                      tw["lane_lo"], tw["lane_hi"])
    args_block = (crec_w, first_w, tw["range_out"], tw["range_span"],
                  tw["comp"], plan_w.total_out)
    compact_wp, plain_ms["compact_whole"] = once_ms(
        lambda: ec.compact_records_plain(*args_compact_w))
    err["compact_whole"] = require_records(
        "whole-block compacted records", (crec_w, lane_out_w, total_w),
        compact_wp)
    n_recs_w = int(total_w)
    out_wp, plain_ms["exec_block"] = once_ms(
        lambda: eb.execute_blocks_plain(*args_block))
    err["exec_block"] = require_equal("whole-block decoded bytes", out_w,
                                      out_wp)
    host_w = out_w.cpu().numpy()
    for (o, _), b in zip(plan_w.block_out, blocks):
        if host_w[o:o + len(b)].tobytes() != b:
            raise AssertionError("the whole-block decode differs from the "
                                 "input")
    pos_w, llen_w, clen_w, csrc_w, _ = crec_w[:, :n_recs_w].to(torch.int64)
    d_w = pos_w + llen_w
    far = int(((clen_w > 0) & ((d_w - csrc_w) // RANGE < d_w // RANGE)).sum())
    n_comp_w, lanes_w = tw["comp"].numel(), len(plan_w.lane_len)
    log(f"whole-block kernels == plain versions (tolerance 0) on "
        f"{BATCH_BLOCKS} x 1 MiB without the range clamp: {n_comp_w} "
        f"compressed bytes, {lanes_w} lanes, {n_recs_w} records, "
        f"{BATCH_BLOCKS} blocks, {far} copies from an earlier 128 KiB range")
    if far == 0:
        raise AssertionError("the unclamped batch holds no far copy")
    k_ms["compact_whole"] = cuda_ms(
        lambda: ec.compact_records(*args_compact_w))
    time_compact(
        f"compact_whole, {corpus_label} without the clamp", ec.COMPACT,
        recs_w, counts_w, tw, card, BEFORE["compact_whole"])
    no_sync_phase(plan, t, plan_w, tw, blocks, dev)
    k_ms["exec_block"] = cuda_ms(lambda: eb.execute_blocks(*args_block),
                                 repeats=3)
    bounds["compact_whole"] = bound(
        20 * n_recs_w + 28 * lanes_w + 20 * n_recs_w + 8 * lanes_w,
        30 * n_recs_w)
    bounds["exec_block"] = bound(
        20 * n_recs_w + 16 * BATCH_BLOCKS + n_comp_w + plan_w.total_out,
        2 * plan_w.total_out)
    del compact_wp, out_wp, pos_w, llen_w, clen_w, csrc_w, d_w

    # Mutated block/hint pairs: CorruptError or bytes, no CUDA fault, and
    # kernel == plain version (run on the CPU) wherever the pipeline runs.
    # Each pair is tried with both parts mutated, with the body alone, and
    # with the body alone under hints without a range clamp, which take the
    # whole-block road (as do mutated hints whose range is unusable).
    def mutated_case(label, body, payload, want):
        try:
            got = codec.decode(body, payload, want)
        except CorruptError:
            torch.cuda.synchronize()
            return False
        seg, rng_b, segs = codec._prepare(body, payload, want)
        mplan = ec.plan_batch([segs], seg, rng_b)
        mt = mplan.tensors(dev)
        kern = run_stages(mt, mplan, False)
        plain = run_stages(mplan.tensors("cpu"), mplan, True)
        torch.cuda.synchronize()
        require_stages(label, kern, plain)
        dense_args = (kern[0], kern[1], mt["lane_start"], mt["lane_len"])
        err["compact_dense"] = max(err["compact_dense"], require_records(
            f"{label}: dense records",
            ec.compact_records_dense(*dense_args),
            ec.compact_records_dense_plain(*dense_args)))
        if got != plain[-1].numpy()[:want].tobytes():
            raise AssertionError(f"{label}: codec bytes differ")
        return True

    rng = np.random.default_rng(0xBEEF)
    decoded = tried = 0
    whole_before = _build.launch_counts()["exec_block"]
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
        seg_h, offs_h, _ = parse_hints(hints)
        unclamped = marshal_hints(seg_h, [(o, 0) for o in offs_h], 0)
        decoded += mutated_case(f"pair {i}, body only, no clamp", badb,
                                unclamped, want)
        tried += 1
    whole_runs = _build.launch_counts()["exec_block"] - whole_before
    if whole_runs < 2 * tried:
        raise AssertionError("the mutated pairs did not reach the "
                             "whole-block road")
    log(f"mutated pairs: {tried} pairs x (both parts, body only, body only "
        f"without a clamp): {decoded} decoded with kernels == plain "
        f"versions, {3 * tried - decoded} rejected as corrupt, "
        f"{whole_runs} launches of the whole-block executor, no CUDA fault")

    # ---- 3d. the parallel resolution on records made for it -----------------
    compare_synthetic(dev, card, err)
    log_range_rounds(f"the corpus, {n_ranges} x 128 KiB", args_exec[:6], card)
    log_block_phases(f"the corpus without the clamp, {BATCH_BLOCKS} x 1 MiB",
                     args_block, card)

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

    # ---- 5. the greedy kernel against its plain version, and its time -----
    nb = ENCODE_BATCH
    enc_in = torch.from_numpy(np.frombuffer(corpus[: nb * MB], np.uint8)
                              .reshape(nb, MB).copy()).to(dev)
    ns = [MB] * nb
    dist, length = ek.find_matches_dyn(enc_in, ns, SEG, RANGE, LEVEL)
    g_off = dist.to(torch.int32).reshape(-1, SEG)
    g_len = length.to(torch.int32).reshape(-1, SEG)
    del dist, length
    err["greedy"] = 0
    g_lines = {}
    for label, (o, ln) in greedy_inputs(g_off, g_len, dev).items():
        g_lines[label] = time_greedy(label, o, ln, card)
        err["greedy"] = max(err["greedy"], g_lines[label]["err"])
    corpus_g = g_lines[GREEDY_CORPUS]
    n_tokens = corpus_g["tokens"]
    plain_ms["greedy"] = corpus_g["plain_ms"]
    k_ms["greedy"] = corpus_g["wrapper_once"]
    log(f"greedy kernel == plain version (tolerance 0: integers), through "
        f"greedy_parse and through launch_greedy into an output filled with "
        f"0x7f7f7f7f, on {len(g_lines)} inputs of {g_off.shape[0]} lanes x "
        f"{SEG} positions ({n_tokens} tokens on the corpus), no CUDA fault")
    # off and len in (8 bytes per position), four int32 outputs out (16);
    # about 8 operations per position (candidate test, suffix minimum, hop)
    # and 8 per token (a chain step and its mark).
    bounds["greedy"] = bound(24 * g_off.numel(),
                             8 * g_off.numel() + 8 * n_tokens)
    e_line = time_emit(enc_in, ns, card)
    err["emit"] = e_line["err"]
    k_ms["emit"] = e_line["wrapper_once"]
    plain_ms["emit"] = e_line["plain_ms"]
    # About 8 operations a position (scans, cover, byte copy) and 40 a
    # token (its choice and its bytes).
    bounds["emit"] = bound(e_line["bytes"], 8 * enc_in.numel()
                           + 40 * e_line["tokens"])

    # ---- 6. main paths: Writer -> Reader on the card ---------------------
    path_launches, streams = {}, {}
    path_launches["serializer"], streams["serializer"] = round_trip(
        "serializer", corpus, dev)
    path_launches["seek"] = seek_path(streams["serializer"], corpus, dev,
                                      card)
    path_launches["device_emit"], streams["device_emit"] = round_trip(
        "device_emit", corpus, dev, device_emit=True)
    path_launches["unclamped"], streams["unclamped"] = round_trip(
        "unclamped", corpus, dev, clamp=False)
    log(f"ratio without the range clamp "
        f"{len(streams['unclamped']) / len(corpus):.4f}, with it "
        f"{len(streams['serializer']) / len(corpus):.4f}")

    # The clamped stream's blocks (encode_batch is what the Writer calls)
    # through the append-only road.
    sched_items = []
    for i in range(0, STREAM_MB, ENCODE_BATCH):
        part = [corpus[j * MB:(j + 1) * MB]
                for j in range(i, i + ENCODE_BATCH)]
        for block, payload in codec.encode_batch(part, LEVEL):
            _, want, pos = parse_header(block)
            sched_items.append(
                (split_body(block[pos:], parse_hints(payload)[1]), want))
    _build.reset_launches()
    back = []
    for i in range(0, STREAM_MB, BATCH_BLOCKS):
        part = sched_items[i:i + BATCH_BLOCKS]
        back += ec.decode_blocks_chained(
            [p[0] for p in part], [p[1] for p in part], SEG, RANGE, dev,
            executor="scheduled")
    torch.cuda.synchronize()
    path_launches["scheduled"] = _build.launch_counts()
    if b"".join(back) != corpus:
        raise AssertionError("the scheduled executor did not decode the "
                             "clamped stream's blocks")
    log(f"main path (scheduled): {STREAM_MB} blocks of the clamped stream "
        f"through decode_blocks_chained(executor=\"scheduled\") == corpus; "
        f"launches {path_launches['scheduled']}")
    del back, sched_items

    # ---- 6a. the mesh and search paths -------------------------------------
    path_launches["mesh"] = mesh_path(corpus, dev, card,
                                      streams["device_emit"])
    path_launches["search"] = search_path(corpus, dev, card)
    del streams
    (path_launches["unhinted"], err["derive"], k_ms["derive"],
     plain_ms["derive"], bounds["derive"]) = unhinted_path(corpus, dev, card)

    for name, (_, _, count, path) in KERNELS.items():
        if path != "probes" and path_launches[path][count] <= 0:
            raise AssertionError(f"kernel {name} never ran on the {path} "
                                 f"path")
    for path, counts in (("mesh", ("greedy", "emit", "parse")),
                         ("search", ("parse", "compact", "exec_range")),
                         ("unhinted", ("parse", "lane_offsets", "compact",
                                       "exec_block"))):
        for count in counts:
            if path_launches[path][count] <= 0:
                raise AssertionError(
                    f"kernel {count} never ran on the {path} path")
    for path in ("serializer", "device_emit"):
        for count in ("parse", "compact", "exec_range"):
            if path_launches[path][count] <= 0:
                raise AssertionError(
                    f"kernel {count} never ran on the {path} path")
    for path, idle in (("serializer", ("greedy", "emit", "exec_block",
                                       "exec_sched", "compact_dense",
                                       "derive")),
                       ("unclamped", ("greedy", "emit", "exec_range",
                                      "exec_sched", "compact_dense",
                                      "derive")),
                       ("scheduled", ("greedy", "exec_range", "exec_block",
                                      "compact", "derive")),
                       ("unhinted", ("greedy", "emit", "exec_range",
                                     "exec_sched", "compact_dense"))):
        for count in idle:
            if path_launches[path][count] != 0:
                raise AssertionError(f"the {path} path launched {count}")

    # ---- 6b. one block of the format's largest size ------------------------
    big = corpus[:BIG_BLOCK]
    big_launches, _ = round_trip("8 MiB block", big, dev,
                                 block_size=BIG_BLOCK)
    if big_launches["exec_range"] != 1:
        raise AssertionError("the 8 MiB block did not take the range road "
                             "in one dispatch")
    big_seg = DeviceCodec._seg_for(BIG_BLOCK)
    big_block, big_hints = ek.encode_block_device(big, big_seg, 0, LEVEL,
                                                  dev)
    _, _, pos = parse_header(big_block)
    big_segs = split_body(big_block[pos:], [h[0] for h in big_hints])
    err["parse"] = max(err["parse"], parse_vs_plain(
        "8 MiB block, 16 KiB segments, first 8 lanes", big_segs[:8], dev))
    _build.reset_launches()
    (got_big, big_ms) = once_ms(lambda: eb.decode_block_whole(
        big_segs, BIG_BLOCK, big_seg, dev))
    if got_big != big or _build.launch_counts()["exec_block"] != 1:
        raise AssertionError("the 8 MiB block did not decode on the "
                             "whole-block road")
    log(f"8 MiB block, {big_seg}-byte segments, {len(big_segs)} lanes: "
        f"Writer -> Reader on the range road, and decode_block_whole "
        f"({len(big_block)} bytes without the clamp) in {big_ms:.1f} ms "
        f"host bytes in/out  [{card}]")
    plan_big = ec.plan_batch([big_segs], big_seg, 0)
    big_stages = run_stages(plan_big.tensors(dev), plan_big, False)
    tb = plan_big.tensors(dev)
    big_both = log_block_phases(
        "one 8 MiB block without the clamp",
        (big_stages[2], big_stages[5], tb["range_out"], tb["range_span"],
         tb["comp"], plan_big.total_out), card)
    log(f"time exec_block per MB: one 8 MiB block {big_both / 8:.4f} ms/MB, "
        f"eight 1 MiB blocks {k_ms['exec_block'] / BATCH_BLOCKS:.4f} ms/MB "
        f"(wrapper)  [{card}]")
    del got_big, big_block, big_segs, big_stages, tb

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

    # ---- 7a. the JAX package's names: scan parse, reference decoder ------
    path_launches["api"] = api_path(
        [s for e in enc for s in segments(*e)], g_off, g_len, enc_in, ns,
        corpus, dev, card)

    # ---- 7b. the probe kernels against their plain versions --------------
    p_err, p_ms, p_plain, p_bounds = compare_probes(dev, card)
    err.update(p_err)
    k_ms.update(p_ms)
    plain_ms.update(p_plain)
    bounds.update(p_bounds)

    # ---- 7c. the probes path: the port's measurement scripts --------------
    from minlz_tpu_torch import bench as tbench
    from minlz_tpu_torch.scripts import (ablate_exec, exec_probe,
                                         kernel_probe, profile_decode)

    _build.reset_launches()
    run_script(kernel_probe.main, [], "time probe ")
    run_script(exec_probe.main, ["body"], "time probe ")
    run_script(ablate_exec.main, [], "time probe ")
    torch.cuda.synchronize()
    path_launches["probes"] = _build.launch_counts()
    for name, (_, _, count, path) in KERNELS.items():
        if path == "probes" and path_launches["probes"][count] <= 0:
            raise AssertionError(f"kernel {name} never ran on the probes "
                                 f"path")
    for count in ("parse", "compact", "exec_range", "exec_block", "greedy",
                  "emit", "derive"):
        if path_launches["probes"][count] != 0:
            raise AssertionError(f"the probes path launched {count}")
    log(f"main path (probes): kernel_probe, exec_probe body and ablate_exec "
        f"at their default sizes; launches {path_launches['probes']}")
    per_range, per_block = n_recs / n_ranges, n_recs_w / BATCH_BLOCKS
    log(f"time probe executors, for the distance to the bare chains: K3 "
        f"exec_range {k_ms['exec_range'] * 1e6 / per_range:.1f} ns/record "
        f"of a range ({per_range:.0f} records a range, resolved in shared "
        f"memory), exec_block {k_ms['exec_block'] * 1e6 / per_block:.1f} "
        f"ns/record of a block ({per_block:.0f} records a block, resolved "
        f"tile by tile), exec_sched {k_ms['exec_sched'] * 1e6 / per_range:.1f} "
        f"ns/record of a range  [{card}]")

    # ---- 7d. the port's bench and the kernel-alone times --------------------
    _build.reset_launches()
    run_script(tbench.main, ["--mb", str(BENCH_MB)], "time bench: ")
    path_launches["bench"] = _build.launch_counts()
    for count in ("parse", "compact", "exec_range"):
        if path_launches["bench"][count] <= 0:
            raise AssertionError(f"bench.main never launched {count}")
    run_script(profile_decode.main,
               ["--road", "whole", "--blocks", str(BATCH_BLOCKS)],
               "time alone: ")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        profile_decode.stage_times("range", BATCH_BLOCKS, dev)
    for line in buf.getvalue().splitlines():
        log(f"time alone: {line}")

    # ---- 8. times, for information ---------------------------------------
    enc_ms = cuda_ms(lambda: ek._find_matches_batch(
        enc_in, ns, SEG, RANGE, LEVEL), repeats=3)
    dists = ek._find_matches_batch(enc_in, ns, SEG, RANGE,
                                   LEVEL).cpu().numpy()
    ser_ms = host_ms(lambda: [
        native.parse_serialize(corpus[i * MB:(i + 1) * MB], dists[i], SEG,
                               RANGE, LEVEL) for i in range(nb)])
    dev_ms = cuda_ms(lambda: ec.decode_planned(plan, dev, "fast", t))
    items = []
    for block, payload in enc:
        _, want, pos = parse_header(block)
        items.append((block[pos:], payload, want))
    e2e_ms = host_ms(lambda: codec.decode_batch(items))
    dev_w_ms = cuda_ms(lambda: eb.decode_planned_whole(plan_w, dev, tw),
                       repeats=3)
    e2e_w_ms = host_ms(lambda: codec.decode_batch(items_w))
    dev_s_ms = cuda_ms(lambda: ec.decode_planned(plan, dev, "scheduled"))
    dev_s2_ms = cuda_ms(lambda: ec.decode_planned(plan, dev, "scheduled",
                                                  tensors=t))

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
            ("decode_planned (fast), device-resident, 8 x 1 MiB",
             dev_ms / BATCH_BLOCKS),
            ("decode_batch host bytes in/out, 8 x 1 MiB",
             e2e_ms / BATCH_BLOCKS),
            ("decode, append-only road (plan copy + 3 kernels), 8 x 1 MiB",
             dev_s_ms / BATCH_BLOCKS),
            ("decode_planned (scheduled), append-only road, "
             "device-resident, 8 x 1 MiB", dev_s2_ms / BATCH_BLOCKS),
            ("decode_planned_whole, whole-block road, device-resident, "
             "8 x 1 MiB", dev_w_ms / BATCH_BLOCKS),
            ("decode_batch host bytes in/out, whole-block road, 8 x 1 MiB",
             e2e_w_ms / BATCH_BLOCKS)):
        log(f"time {label}: {val:.4f} ms/MB  [{card}]")
    for road, val in (("fast", dev_ms), ("scheduled", dev_s2_ms),
                      ("whole", dev_w_ms)):
        name = "decode_planned_whole" if road == "whole" else \
            "decode_planned"
        log(f"time compact {name} ({road}), device-resident from plan "
            f"tensors on the card, {BATCH_BLOCKS} x 1 MiB: "
            f"{val / BATCH_BLOCKS:.4f} ms/MB; the earlier design "
            f"{BEFORE[road]:.4f} ms/MB  [{card}]")
    log(f"peak device memory, encode_block_emit on 16 x 1 MiB: "
        f"{emit_peak / (1 << 20):.0f} MiB  [{card}]")

    # ---- 9. the cli path, after every other time ---------------------------
    # Its --traceprof leaves torch.profiler's state in this process, so the
    # device-resident decode lines are timed once more after it.
    path_launches["cli"] = cli_path(corpus, dev, card)
    for count in ("parse", "compact", "exec_range"):
        if path_launches["cli"][count] <= 0:
            raise AssertionError(f"kernel {count} never ran on the cli path")
    # exec_block and derive run for the host route's stream, which has no
    # hints (cli_path checks their counts).
    for count in ("greedy", "emit", "exec_sched", "compact_dense"):
        if path_launches["cli"][count] != 0:
            raise AssertionError(f"the cli path launched {count}")
    for label, fn, reps, before in (
            ("decode_planned (fast), device-resident, 8 x 1 MiB",
             lambda: ec.decode_planned(plan, dev, "fast", t), REPEATS,
             dev_ms),
            ("decode_planned (scheduled), append-only road, "
             "device-resident, 8 x 1 MiB",
             lambda: ec.decode_planned(plan, dev, "scheduled", t), REPEATS,
             dev_s2_ms),
            ("decode_planned_whole, whole-block road, device-resident, "
             "8 x 1 MiB", lambda: eb.decode_planned_whole(plan_w, dev, tw),
             3, dev_w_ms)):
        after = cuda_ms(fn, repeats=reps)
        log(f"time after the cli path (torch.profiler has run) {label}: "
            f"{after / BATCH_BLOCKS:.4f} ms/MB, before it "
            f"{before / BATCH_BLOCKS:.4f} ms/MB  [{card}]")
    from minlz_tpu_torch.ops.probe import gather_plan
    gather_grid = gather_plan(GATHER_TABLES[-1][0],
                              GATHER_TABLES[-1][1] * 1024).grid
    shapes = {"parse": "8 x 1 MiB batch, through parse_planned",
              "greedy": "16 x 1 MiB batch, greedy_parse as one call",
              "emit": "16 x 1 MiB batch, emit_segments as one call",
              "exec_block": "8 x 1 MiB batch without the clamp",
              "derive": f"{STREAM_MB // 2} x 2 MiB blocks without hints, "
                        f"lanes of {SEG} bytes, through derive_plan",
              "compact_whole": "8 x 1 MiB batch without the clamp",
              "lane_offsets": "8 x 1 MiB batch, the lane counts",
              "probe_scalar": f"{SCALAR_STEPS} steps x "
                              f"{SCALAR_CHAINS[-1]} chains x "
                              f"{SCALAR_SPACES[0][1]} rows, shared memory, "
                              f"grid {SCALAR_CHAINS[-1]} blocks",
              "probe_gather": f"{GATHER_TABLES[-1][0]} x 1024 gathers from "
                              f"{GATHER_TABLES[-1][1] * 1024} words, grid "
                              f"{gather_grid} blocks",
              "probe_taa": f"{TAA_ITERS} x 1024 in-row gathers, grid "
                           f"{gather_plan(TAA_ITERS, 0).grid} blocks",
              "probe_chain_body": f"{BODY_STEPS} steps x {BODY_CHAINS[-1]} "
                                  f"chains, realign, device memory, grid "
                                  f"{BODY_CHAINS[-1]} blocks",
              "ablate_exec": f"full, {ABLATE_RECORDS} records x "
                             f"{ABLATE_CHAINS[0]} chains, grid "
                             f"{ABLATE_CHAINS[0]} blocks"}
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
         "launches": path_launches[path][count],
         "launches_by_path": {p: c[count] for p, c in path_launches.items()},
         "max_abs_err": err[name], "ms": k_ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep, count, path) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
