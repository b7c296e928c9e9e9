"""Run the port's main-path CUDA kernels under compute-sanitizer.

Each tool (memcheck, racecheck, synccheck by default) checks one run of the
workload in a child process started under ``compute-sanitizer --tool T``,
with PyTorch's caching allocator off, so that every tensor is an allocation
of its own and memcheck sees its bounds.  The workload is a small corpus
batch (``--blocks`` blocks of ``--block-kb`` KiB, with the range clamp and
without it) and ``--mutated`` copies of it whose segment bytes are mutated,
each through K1 (parse), the lane offset scan, the positioned compaction
(K2 at range spans, kernel 5 at whole-block spans), the dense compaction
(kernel 6), K3, the append-only executor (its cursor scan, then K3), the
whole-block executor (index, tile and fix-up kernels); then greedy on the
batch's match proposals and on hostile proposals.  A valid batch must
decode to its input.  The kernels are built before the child starts, so
nvcc does not run under the sanitizer.

Prints one line per tool with the sanitizer's summary and the child's
launch counts, and exits 0 only if every tool ran and reported no error,
1 if a tool reported one.  Exits 2 without running anything if
compute-sanitizer is not found (on PATH, under $CUDA_HOME/bin or
/usr/local/cuda/bin), 3 if it refuses the device ("Device not
supported"): then nothing was checked.

    python -m minlz_tpu_torch.scripts.sanitize_kernels [--tool memcheck
        racecheck synccheck] [--blocks 2] [--block-kb 256] [--mutated 8]
        [--log-dir DIR] [--timeout 900]
    python -m minlz_tpu_torch.scripts.sanitize_kernels --workload
        [--device cuda|cpu] ...    (the child's run, no sanitizer)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..bench import add_common_args, card, corpus_segments
from ..ops import encode_kernel as ek
from ..ops import exec_block as eb
from ..ops import exec_chain as ec
from ..ops import greedy as tg
from ..ops.device_codec import RANGE
from ..ops.parse import parse_planned
from ..testing import mutate

TOOLS = ("memcheck", "racecheck", "synccheck")
# The kernels the workload must launch (their launch counts' names).
MAIN_PATH = ("parse", "lane_offsets", "compact", "compact_dense",
             "exec_range", "exec_sched", "exec_block", "greedy")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_sanitizer() -> str | None:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "compute-sanitizer")
            if os.path.exists(cand):
                return cand
    return None


def decode_plan(plan, dev):
    """Every decode kernel of the plan's road on ``dev``: (bytes of the
    positioned road, bytes of the append-only road or None)."""
    t = plan.tensors(dev)
    recs, counts = parse_planned(t["comp"], t["lane_start"], t["lane_len"])
    lanes = (t["lane_start"], t["lane_len"])
    crec, lane_out, total = ec.compact_records(recs, counts, *lanes,
                                               t["lane_lo"], t["lane_hi"])
    first = ec.range_firsts(lane_out, total, t["range_lane"])
    common = (first, t["range_out"], t["range_span"], t["comp"],
              plan.total_out)
    if not plan.rng:
        return eb.execute_blocks(crec, *common), None
    drec, _, _ = ec.compact_records_dense(recs, counts, *lanes)
    return (ec.execute_ranges(crec, *common, plan.max_span),
            ec.execute_scheduled(drec, *common, plan.max_span))


def workload(dev, n_blocks: int, block_size: int, n_mutated: int,
             seed: int = 7) -> dict:
    """The kernels on the corpus batch and on mutated copies; returns the
    launch counts."""
    from .. import _build

    _build.reset_launches()
    blocks, segs, seg = corpus_segments(n_blocks, dev, RANGE, block_size)
    _, segs_w, _ = corpus_segments(n_blocks, dev, 0, block_size)
    for rng, s in ((RANGE, segs), (0, segs_w)):
        plan = ec.plan_batch(s, seg, rng)
        for out in decode_plan(plan, dev):
            if out is not None and ec.trim_blocks(
                    plan, out, [len(b) for b in blocks]) != blocks:
                raise AssertionError(f"the decode of range {rng} differs "
                                     f"from the input")
    g = np.random.default_rng(seed)
    for _ in range(n_mutated):
        bad = [[mutate(g, x) if g.random() < 0.25 else x for x in b]
               for b in segs]
        for rng in (RANGE, 0):
            decode_plan(ec.plan_batch(bad, seg, rng), dev)

    data = np.frombuffer(b"".join(blocks), np.uint8).reshape(n_blocks, -1)
    d, ln = ek.find_matches_dyn(torch.from_numpy(data.copy()).to(dev),
                                [block_size] * n_blocks, seg, RANGE)
    tg.greedy_parse(d.to(torch.int32).reshape(-1, seg),
                    ln.to(torch.int32).reshape(-1, seg), seg)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    off = g.integers(lo, hi, (64, seg), dtype=np.int64)
    length = np.where(g.random((64, seg)) < 0.97,
                      g.integers(-3, 40, (64, seg)),
                      g.integers(lo, hi, (64, seg), dtype=np.int64))
    length[:, -1] = hi
    tg.greedy_parse(torch.from_numpy(off.astype(np.int32)).to(dev),
                    torch.from_numpy(length.astype(np.int32)).to(dev), seg)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return _build.launch_counts()


def summary(text: str) -> str:
    """The sanitizer's summary lines, joined."""
    lines = [ln.strip("= ").strip() for ln in text.splitlines()
             if "SUMMARY" in ln]
    return "; ".join(lines) or "no summary"


REFUSED = "Device not supported"


def run_tool(sanitizer, tool, opt, log_dir):
    """One tool over the workload in a child process.  Returns (status, the
    summary, the child's launch counts or None); status is "clean",
    "FAILED" or "refused" (the sanitizer did not support the device)."""
    cmd = [sanitizer, "--tool", tool, "--error-exitcode", "97",
           "--print-limit", "50", sys.executable, "-m",
           "minlz_tpu_torch.scripts.sanitize_kernels", "--workload",
           "--blocks", str(opt.blocks), "--block-kb", str(opt.block_kb),
           "--mutated", str(opt.mutated)]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    try:
        res = subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                             text=True, timeout=opt.timeout)
    except subprocess.TimeoutExpired:
        return "FAILED", f"timed out after {opt.timeout} s", None
    text = res.stdout + res.stderr
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"sanitize_{tool}.log"), "w") as fh:
            fh.write(text)
    counts = None
    m = re.search(r"^launches (\{.*\})$", res.stdout, re.M)
    if m:
        counts = json.loads(m.group(1))
    if REFUSED in text:
        return "refused", f"rc {res.returncode}; {REFUSED}", counts
    errors = re.search(r"ERROR SUMMARY: (\d+) error", text)
    ok = (res.returncode == 0 and counts is not None
          and (errors is None or int(errors.group(1)) == 0)
          and all(counts.get(k, 0) > 0 for k in MAIN_PATH))
    return ("clean" if ok else "FAILED"), \
        f"rc {res.returncode}; {summary(text)}", counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="minlz_tpu_torch.scripts.sanitize_kernels",
        description=__doc__.split("\n\n")[0])
    add_common_args(ap, iters=1)
    ap.add_argument("--tool", nargs="+", default=list(TOOLS), choices=TOOLS)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--block-kb", type=int, default=256)
    ap.add_argument("--mutated", type=int, default=8)
    ap.add_argument("--log-dir", default=None,
                    help="write each tool's whole output there")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds each tool may take")
    ap.add_argument("--workload", action="store_true",
                    help="run the workload itself (the child's part)")
    opt = ap.parse_args(argv)
    if opt.workload:
        counts = workload(opt.device, opt.blocks, opt.block_kb << 10,
                          opt.mutated)
        print(f"launches {json.dumps(counts)}", flush=True)
        return 0
    sanitizer = find_sanitizer()
    if sanitizer is None:
        print("compute-sanitizer not found (PATH, $CUDA_HOME/bin, "
              "/usr/local/cuda/bin): nothing was checked")
        return 2
    from .. import _build

    _build.load()
    where = card(opt.device)
    version = subprocess.run([sanitizer, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"{sanitizer}: {version.splitlines()[-1] if version else '?'}")
    statuses = set()
    for tool in opt.tool:
        status, text, counts = run_tool(sanitizer, tool, opt, opt.log_dir)
        statuses.add(status)
        ran = {k: counts.get(k, 0) for k in MAIN_PATH} if counts else None
        print(f"sanitize {tool}: {status}; {text}; {opt.blocks} x "
              f"{opt.block_kb} KiB + {opt.mutated} mutated; launches {ran}  "
              f"[{where}]", flush=True)
    if "FAILED" in statuses:
        return 1
    return 3 if "refused" in statuses else 0


if __name__ == "__main__":
    raise SystemExit(main())
