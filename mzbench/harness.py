"""One run of one cell: find the cell's configuration, traffic mix, data
generator, traffic loop and metric readers by name, set up, measure,
check, and build the result line.

Everything is found by name from the cell's entry in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (codec settings, data scale,
  the generator's name, ``reduced`` and ``assumed``);
* ``traffic/<traffic>.json``: the mix's parameters and the loop that
  plays it (``loops/<loop>.py``);
* ``data/<generator>.py``: ``generate(seed, n_bytes, device)``;
* ``metrics/<metric>.py``: ``read(rec, trace)``, for every end-to-end and
  per-layer metric, returning None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import time

import torch

from . import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    return importlib.import_module(f"mzbench.{kind}.{name}")


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mzbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def _update(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _update(out[k], v) if isinstance(v, dict) else v
    return out


def run(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
        device="cuda", control: bool = False, overrides=None) -> dict:
    """Set up, measure for ``seconds``, check; the result as a dict."""
    w = cell(bench, workload)
    overrides = overrides or {}
    t0 = time.perf_counter()
    cfg = _update(load_json("configs", w["config"]),
                  overrides.get("config", {}))
    mix = _update(load_json("traffic", w["traffic"]),
                  overrides.get("traffic", {}))
    loop = load_module("loops", mix["loop"])
    gen = load_module("data", cfg["generator"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = loop.setup(cfg, mix, gen, seed, dev, control)
    # What set-up made lives on: no collection in the window rescans it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    prof = tracing.profiler(dev) if traced else contextlib.nullcontext()
    with prof:
        rec = loop.window(state, seconds)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = tracing.reduce(prof) if traced else None
    rec["setup_s"] = setup_s
    loop.release(state)
    checks = loop.check_outputs(state, rec)
    metrics = {}
    for m in metrics_for(bench, workload, traced):
        value = load_metric(m["name"]).read(rec, found)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["ok"] for c in checks)
    result = {
        "correct": correct,
        "attempted": rec["attempted"],
        "failed": rec["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": w["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"]["busy_s"] = found["busy_s"]
        result["device"]["window_s"] = found["window_s"]
        result["breakdown"] = {"device_ops": found["device_ops"],
                               "idle_gaps": found["idle_gaps"]}
    result["checked"] = rec["checked"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result
