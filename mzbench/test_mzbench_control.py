"""``correct`` comes out false where it must: the control in the program's
place, and the timed path broken underneath a whole run (the harness's look
for a card skipped, the port's CPU path at a small size).  One test runs
each cell's control at its own size on the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mzbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = (1 << 31) + 4321
SMALL = {"config": {"codec": {"block_size": 64 << 10},
                    "scale": {"store_extents": 2}},
         "traffic": {"extent_blocks": 2, "warm_seconds": 0.2,
                     "check_sample": 16, "pass_bytes": 4 * (64 << 10),
                     "batch_blocks": 2, "warm_batches": 1}}
DECODE = "nyc-taxi-csv.decode-resident"
ENCODE = "gharchive-json.compress-emit"


def run(workload, control=False, overrides=SMALL):
    return harness.run(harness.benchmark(), workload, SEED, 0.5, False, "cpu",
                       control, overrides)


@pytest.mark.parametrize("workload", [DECODE, ENCODE])
def test_a_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", [DECODE, ENCODE])
def test_the_control_is_not_correct(workload):
    r = run(workload, control=True)
    assert r["correct"] is False, r["checks"]


def decode_fault(kind):
    from minlz_tpu_torch.ops import exec_chain

    real = exec_chain.decode_planned

    def broken(plan, device="cuda", executor="fast", tensors=None):
        if kind == "unchanged":  # the output buffer as it was
            return torch.zeros(plan.total_out, dtype=torch.uint8)
        out = real(plan, device, executor, tensors)
        if kind == "half":  # half of the extent's blocks left out
            out[plan.total_out // 2:] = 0
        else:  # one byte altered where it is produced
            out[plan.total_out // 3] ^= 1
        return out

    return exec_chain, "decode_planned", broken


def encode_fault(kind):
    from minlz_tpu_torch.ops.device_codec import DeviceCodec

    real = DeviceCodec.encode_batch_emit
    first = []

    def broken(self, blocks, level=2):
        res = real(self, blocks, level)
        if kind == "unchanged":  # every batch gets the first one's blocks
            first.append(res) if not first else None
            return first[0]
        if kind == "half":  # the second half of the batch left out
            half = len(res) // 2
            return res[:len(res) - half] + res[:half]
        altered = []  # one byte of every block altered
        for block, hints in res:
            b = bytearray(block)
            b[len(b) * 2 // 3] ^= 0x5A
            altered.append((bytes(b), hints))
        return altered

    return DeviceCodec, "encode_batch_emit", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload,fault", [(DECODE, decode_fault),
                                            (ENCODE, encode_fault)],
                         ids=["decode", "encode"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault,
                                            kind):
    monkeypatch.setattr(*fault(kind))
    r = run(workload)
    assert r["correct"] is False, r["checks"]


def hint_fault(kind):
    if kind == "clamp_removed":  # copies may read across a range's start
        from minlz_tpu_torch.ops import emit

        real = emit.encode_block_emit

        def broken(data, n, seg, rng=0, level=2, ctx=0):
            return real(data, n, seg, 0, level, ctx)

        return emit, "encode_block_emit", broken
    from minlz_tpu_torch.ops import device_codec as dc

    real = dc.DeviceCodec.encode_batch_emit

    def broken(self, blocks, level=2):  # one hint a block a byte later
        moved = []
        for res in real(self, blocks, level):
            if res is not None:
                seg, offs, rng = dc.parse_hints(res[1])
                offs[len(offs) // 2] += 1
                res = (res[0], dc.marshal_hints(
                    seg, [(o, i * seg) for i, o in enumerate(offs)], rng))
            moved.append(res)
        return moved

    return dc.DeviceCodec, "encode_batch_emit", broken


@pytest.mark.parametrize("kind", ["hint_moved", "clamp_removed"])
def test_broken_parse_hints_are_not_correct(monkeypatch, kind):
    """Blocks of two 128 KiB ranges, so that a copy can reach across."""
    big = {"config": {"codec": {"block_size": 256 << 10}},
           "traffic": {"pass_bytes": 4 * (256 << 10), "batch_blocks": 2,
                       "warm_batches": 1, "check_sample": 2}}
    assert run(ENCODE, overrides=big)["correct"] is True
    monkeypatch.setattr(*hint_fault(kind))
    r = run(ENCODE, overrides=big)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.benchmark()["workloads"]])
def test_the_control_at_the_cells_size_on_the_card(card, workload):
    seeds = [(1 << 31) + 7001 + i for i in range(3)]
    for seed in seeds:
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             workload, "--seed", str(seed), "--seconds", "1", "--trace", "0",
             "--control", "1"], capture_output=True, text=True, check=True)
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is False, result["checks"]
