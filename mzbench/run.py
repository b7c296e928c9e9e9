"""Run one cell of the benchmark once and print its result line.

    python3 mzbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m mzbench.run`` is the same.)  The run loads and warms up,
measures for ``--seconds``, compares a sample of what the timed path
produced with the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the window),
``device``, ``breakdown`` (traced runs) and, last, ``checks``: each number
compared beside its limit, also printed as the last lines of standard
error.  ``--control 1`` runs the cell's control instead of the program (a
run that must come out not correct); the benchmark's own runs never do.

It exits with a code other than 0, and prints no result, where torch sees
no CUDA device or fewer than the cell asks for, and where ``jax``,
``jaxlib``, ``flax`` or ``minlz_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "minlz_tpu")


def caches():
    """Every kernel cache at a fixed path inside the checkout: the
    program's own nvcc and g++ builds already go to ``build/`` there, and
    a Triton or torch extension build would go there too."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


def forbidden(names) -> list:
    """The top-level names among module ``names`` that the benchmark must
    not load, compared whole: ``minlz_tpu_torch`` is not ``minlz_tpu``."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    opt = ap.parse_args(argv)
    caches()

    import torch

    from mzbench import harness

    bench = harness.benchmark()
    cell = harness.cell(bench, opt.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"mzbench: {opt.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(bench, opt.workload, opt.seed, opt.seconds,
                         bool(opt.trace), "cuda", bool(opt.control))
    found = forbidden(list(sys.modules))
    if found:
        print(f"mzbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"checked: {result.pop('checked')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
