"""probe_scalar, probe_gather and probe_taa of several checkouts, timed in
turn on the card: to compare two versions of the kernels in one run, on one
card.

Each TREE is the root of a checkout of this repository.  Its own
``minlz_tpu_torch`` is imported in a child process (which builds that
tree's kernels into the tree's ``build/``) and its three kernels are timed
on the probe scripts' inputs: through the wrapper (``bench.timed_device``:
32 calls back to back) and alone (the kernel's device time, read from
``torch.profiler`` over 20 wrapper calls).  A configuration that a tree's
wrapper refuses is reported as not walked.  Give the trees in the order
to run them, e.g. ``OLD NEW NEW OLD``.

    python -m minlz_tpu_torch.scripts.probe_trees TREE [TREE ...]
        [--steps 8192] [--iters 3]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (space, rows, chains) of probe_scalar, (iterations, 4 KiB tables) of
# probe_gather and iterations of probe_taa.  Shared memory at 256 rows is
# the one configuration of the shared space that a one-block kernel takes.
SCALAR = ([("shared", 4096, c) for c in (1, 2, 4, 8, 16)]
          + [("shared", 256, c) for c in (1, 16)]
          + [("global", 4096, c) for c in (1, 16)])
GATHER = ((256, 9), (512, 1))
TAA = (2048, 1)

CHILD = r'''
import subprocess, sys
import torch
from torch.profiler import ProfilerActivity, profile
from minlz_tpu_torch.bench import timed_device
from minlz_tpu_torch.ops import probe

label, steps, iters, scalar, gather, taa = sys.argv[1:7]
steps, iters = int(steps), int(iters)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip().splitlines()[0]


def alone_ms(fn, kernel, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += getattr(evt, "device_time_total", None) or \
                evt.cuda_time_total
            count += evt.count
    return total / count / 1e3 if count else float("nan")


def plan(name):
    got = getattr(probe, "LAUNCHED", {}).get(name)
    return f"grid {got.grid} cluster {got.cluster}" if got else "grid 1"


def cuda(*arrays):
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


for item in scalar.split(";"):
    space, rows, c = item.split(",")
    rows, c = int(rows), int(c)
    args = (*cuda(*probe.scalar_inputs(steps, c, rows, fill=True)), c,
            space)
    head = (f"{label} probe_scalar {steps} steps x {c} chains x {rows} "
            f"rows, {space}")
    try:
        wrapper = timed_device(probe.probe_scalar, args, iters)[0] * 1e3
    except ValueError as e:
        print(f"{head}: not walked: {e}  [{card}]", flush=True)
        continue
    alone = alone_ms(lambda: probe.probe_scalar(*args), "probe_scalar_kernel")
    print(f"{head}: {plan('probe_scalar')}: wrapper {wrapper:.4f} ms "
          f"(chained), alone {alone:.4f} ms ({alone * 1e6 / steps:.1f} ns "
          f"a step)  [{card}]", flush=True)
for item in gather.split(";"):
    n_iters, vregs = (int(v) for v in item.split(","))
    args = cuda(*probe.gather_inputs(n_iters, vregs, wrap=True))
    wrapper = timed_device(probe.probe_gather, args, iters)[0] * 1e3
    alone = alone_ms(lambda: probe.probe_gather(*args), "probe_gather_kernel")
    print(f"{label} probe_gather {n_iters} x 1024 from {vregs * 1024} words: "
          f"{plan('probe_gather')}: wrapper {wrapper:.4f} ms (chained), "
          f"alone {alone:.4f} ms  [{card}]", flush=True)
for item in taa.split(";"):
    n_iters = int(item)
    args = cuda(*probe.taa_inputs(n_iters, wrap=True))
    wrapper = timed_device(probe.probe_taa, args, iters)[0] * 1e3
    alone = alone_ms(lambda: probe.probe_taa(*args), "probe_taa_kernel")
    print(f"{label} probe_taa {n_iters} x 1024 in-row gathers: "
          f"{plan('probe_taa')}: wrapper {wrapper:.4f} ms (chained), "
          f"alone {alone:.4f} ms  [{card}]", flush=True)
'''


def run_tree(tree: str, label: str, steps: int, iters: int) -> int:
    """Times one tree's kernels in a child process; returns its exit
    code."""
    scalar = ";".join(f"{s},{r},{c}" for s, r, c in SCALAR)
    gather = ";".join(f"{n},{v}" for n, v in GATHER)
    taa = ";".join(str(n) for n in TAA)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    return subprocess.run(
        [sys.executable, "-c", CHILD, label, str(steps), str(iters), scalar,
         gather, taa], cwd=tree, env=env).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minlz_tpu_torch.scripts.probe_trees",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in run order")
    ap.add_argument("--steps", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    opt = ap.parse_args(argv)
    rc = 0
    for i, tree in enumerate(opt.trees):
        label = f"run {i + 1} ({os.path.basename(os.path.abspath(tree))})"
        code = run_tree(tree, label, opt.steps, opt.iters)
        rc = rc or code
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
