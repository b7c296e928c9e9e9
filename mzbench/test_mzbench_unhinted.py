"""The cell of blocks without parse hints (``gharchive-json-mz.
decode-unhinted``): its reference's walk, its readers' arithmetic, and
``correct`` coming out false where it must: the plain reference in the
program's place, every lane's incoming repeat offset forced to 1, and the
timed path broken underneath a whole run (on the port's CPU path at a small
size).  The card tests run both controls at the cell's own size."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mzbench import derive_reference as D
from mzbench import harness, reference as R

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "gharchive-json-mz.decode-unhinted"
SEED = (1 << 31) + 2424
SMALL = {"config": {"codec": {"block_size": 64 << 10},
                    "scale": {"store_extents": 2}},
         "traffic": {"extent_blocks": 2, "warm_seconds": 0.2,
                     "check_sample": 8, "check_blocks": 2}}
# Lanes of 64 compressed bytes: many start at a Repeat.
NARROW = {"config": {"codec": {"block_size": 64 << 10, "segment": 64},
                     "scale": {"store_extents": 2}},
          "traffic": SMALL["traffic"]}


def run(control=False, overrides=SMALL, seconds=0.5, device="cpu"):
    return harness.run(harness.benchmark(), CELL, SEED, seconds, False,
                       device, control, overrides)


def lit(b: bytes) -> bytes:
    return bytes([(len(b) - 1) << 3]) + b


def test_the_walk_of_a_made_up_body():
    """Three literals, a Copy1 that sets 3, a Repeat, a literal; cut at 2
    bytes: the lanes start at tokens and enter with the offset set before
    them."""
    body = lit(b"abc") + bytes([((3 - 1) << 4 | (4 - 4)) << 2 | 1, 0]) \
        + bytes([(2 - 1) << 3 | 4]) + lit(b"z")
    assert [t[4] for t in D.walk(body)] == ["lit", "copy", "repeat", "lit"]
    assert D.lane_table(body, 10, 2) == [
        (0, 4, 0, 3, 1), (4, 0, 3, 3, 1), (4, 2, 3, 7, 1),
        (6, 3, 7, 10, 3), (9, 0, 10, 10, 3)]
    for bad_len in (9, 11, 0, 9 << 20):
        with pytest.raises(R.Corrupt):
            D.lane_table(body, bad_len, 2)
    with pytest.raises(R.Corrupt):
        D.walk(body[:-1])
    assert D.plan_bytes([9, 4096, 4097], 4096) == \
        9 + 4096 + 4097 + 20 * (1 + 1 + 2) + 20 * 3


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"bad_bytes", "bad_plans", "bad_lanes"}
    assert set(r["metrics"]) == {"decode_gbps", "decode_p95_ms", "setup_s"}


def test_the_control_is_not_correct():
    r = run(control=True)
    assert r["correct"] is False, r["checks"]


def rep_of_one(monkeypatch):
    """Every lane enters with the repeat offset 1."""
    from minlz_tpu_torch.ops import derive

    real = derive.derive_plan

    def broken(*args, **kw):
        plan = real(*args, **kw)
        plan["lane_rep"].fill_(1)
        return plan

    monkeypatch.setattr(derive, "derive_plan", broken)


def test_lane_rep_of_one_is_not_correct(monkeypatch):
    assert run(overrides=NARROW)["correct"] is True
    rep_of_one(monkeypatch)
    r = run(overrides=NARROW)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["bad_bytes"]["value"] > 0


def fault(kind):
    from minlz_tpu_torch.ops import derive, exec_block

    if kind == "lane_moved":  # each block's second lane a byte later
        real = derive.derive_plan

        def moved(*args, **kw):
            plan = real(*args, **kw)
            second = plan["range_lane"][:-1] + 1
            second = second[second < plan["range_lane"][1:]]
            plan["lane_len"][second - 1] += 1
            plan["lane_start"][second] += 1
            plan["lane_len"][second] -= 1
            return plan

        return derive, "derive_plan", moved
    real = exec_block.decode_unhinted

    def broken(comp, body_off, out_len, total_out, seg=4096):
        out, bad = real(comp, body_off, out_len, total_out, seg)
        if kind == "verdict":  # a sound extent said to be unsound
            return out, bad + 1
        out = out.clone()
        out[total_out // 3] ^= 1  # one byte altered where it is produced
        return out, bad

    return exec_block, "decode_unhinted", broken


@pytest.mark.parametrize("kind,check", [("altered", "bad_bytes"),
                                        ("verdict", "bad_plans"),
                                        ("lane_moved", "bad_lanes")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind, check):
    monkeypatch.setattr(*fault(kind))
    r = run()
    assert r["correct"] is False, r["checks"]
    assert r["checks"][check]["value"] > 0


def test_readers(monkeypatch):
    from mzbench import spans

    rec = {"kind": "decode", "window_s": 2.0, "setup_s": 20.0,
           "bytes_out": [64 << 20] * 10, "bytes_in": [10 << 20] * 10,
           "plan_bytes": [11 << 20] * 10,
           "latency_s": [0.001 * (i + 1) for i in range(10)],
           "enqueue_s": [0.0002] * 10}
    tr = {"busy_s": 1.5, "window_s": 2.0}
    snap = {"spans": {
        "decode.derive": {"count": 20, "device_s": 0.01, "host_median_s": 0,
                          "host_s": 0, "self_s": 0, "parent": None},
        "decode.unhinted": {"count": 20, "device_s": None,
                            "host_median_s": 0.0004, "host_s": 0,
                            "self_s": 0, "parent": None}},
        "counters": {}}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    read = lambda name, t=tr: harness.load_metric(name).read(rec, t)  # noqa
    assert read("idle_share.unhinted") == pytest.approx(25.0)
    assert read("derive_ms.unhinted") == pytest.approx(0.5)
    assert read("derive_roofline.unhinted") == pytest.approx(
        100 * 20 * (11 << 20) / 3.35e12 / 0.01)
    assert read("host_ms.unhinted") == pytest.approx(0.4)
    for name in ("idle_share.unhinted", "derive_ms.unhinted",
                 "derive_roofline.unhinted", "host_ms.unhinted"):
        assert read(name, None) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)  # no tracer
    for name in ("derive_ms.unhinted", "derive_roofline.unhinted",
                 "host_ms.unhinted"):
        assert read(name) is None
    names = {m["name"] for m in harness.metrics_for(
        harness.benchmark(), CELL, True)}
    assert names == {"idle_share.unhinted", "derive_ms.unhinted",
                     "derive_roofline.unhinted", "host_ms.unhinted"}


@pytest.mark.cuda
def test_the_controls_at_the_cells_size_on_the_card(card, monkeypatch):
    seeds = [(1 << 31) + 7101 + i for i in range(2)]
    for seed in seeds:
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             CELL, "--seed", str(seed), "--seconds", "1", "--trace", "0",
             "--control", "1"], capture_output=True, text=True, check=True)
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is False, result["checks"]
    rep_of_one(monkeypatch)
    r = harness.run(harness.benchmark(), CELL, seeds[0], 1.0, False,
                    "cuda", False, {})
    assert r["correct"] is False, r["checks"]
    torch.cuda.empty_cache()
