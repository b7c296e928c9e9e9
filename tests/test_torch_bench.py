"""minlz_tpu_torch.bench.main and the port's measurement scripts, on the CPU
at small sizes: each runs to its end through the plain versions, and the
bench line carries the JAX benchmark's keys.  The bench ``ratio`` is held to
the port's ``encode_blocks_device`` on the same blocks, which
tests/test_torch_encode.py holds to the JAX package byte for byte."""

import json

import pytest

from minlz_tpu_torch import bench as tbench
from minlz_tpu_torch.oracle.decode import parse_header

KEYS = {"metric", "value", "unit", "encode_gbps", "decode_gbps",
        "enc_device_ms_per_mb", "enc_host_ms_per_mb", "dec_device_ms_per_mb",
        "dec_batch", "ratio", "roundtrip_exact", "corpus_mb", "total_s",
        "device"}


@pytest.mark.parametrize("executor", ["fast", "scheduled"])
def test_bench_main_prints_the_benchmark_line(executor, capsys):
    from minlz_tpu_torch.ops.device_codec import RANGE
    from minlz_tpu_torch.ops.encode_kernel import encode_blocks_device

    rc = tbench.main(["--device", "cpu", "--mb", "0.125", "--block-kb", "32",
                      "--iters", "1", "--enc-batch", "2", "--dec-batch", "1",
                      "--executor", executor])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert KEYS <= set(res) and "vs_baseline" not in res
    assert res["roundtrip_exact"] is True
    assert res["device"] == "cpu" and res["executor"] == executor
    assert res["dec_batch"] == 1 and res["corpus_mb"] == 0.125
    assert res["unit"] == "GB/s" and res["dec_device_ms_per_mb"] > 0

    corpus = tbench.make_corpus(128 << 10)
    blocks = [corpus[i << 15:(i + 1) << 15] for i in range(4)]
    comp = 0
    for blk, _ in encode_blocks_device(blocks, 4096, RANGE, 2, "cpu"):
        comp += len(blk) - parse_header(blk)[2]
    assert res["ratio"] == round(comp / len(corpus), 4)


def test_bench_main_takes_no_corpus_below_a_block():
    with pytest.raises(ValueError):
        tbench.main(["--device", "cpu", "--mb", "0.01", "--iters", "1"])


SCRIPTS = {
    "kernel_probe": ["--steps", "32", "--rows", "64", "--gather-iters", "4",
                     "--taa-iters", "4"],
    "ablate_exec": ["--ops", "64", "--chains", "1", "2", "--chain-rows",
                    "8"],
    "exec_probe": ["all", "--blocks", "1", "--block-kb", "32", "--steps",
                   "16", "--rows", "128", "--shared-rows", "128", "--n",
                   "4096"],
    "profile_decode": ["--road", "whole", "--blocks", "1", "--block-kb",
                       "32", "--n", "4096"],
    "probe_v2": ["--blocks", "1", "--block-kb", "32"],
    "rec_stats": ["--mb", "0.03125", "--block-kb", "32"],
    "enc_probe": ["--block-kb", "32"],
    "emit_probe": ["--block-kb", "32"],
}
EXPECT = {
    "kernel_probe": ["C in-row gather", "B tbl=9216 words",
                     "A chains=1 space=shared rows=64 plan grid=1 cluster=1",
                     "A chains=16 space=global"],
    "ablate_exec": ["full       nchain= 1", "minimal    nchain= 2"],
    "exec_probe": ["compact+exec", "chainbody mode=realign chains=32",
                   "gather rounds", "scatter ["],
    "profile_decode": ["road whole", "kernel alone not measured",
                       "sort 4096 int32"],
    "probe_v2": ["range/fast: full", "whole: full"],
    "rec_stats": ["fast:", "records per 128 KiB range",
                  "source overlaps their destination"],
    "enc_probe": ["find_matches level  3", "run_doubling"],
    "emit_probe": ["emit stream decodes bit-exact", "host parse+serialize",
                   "greedy_alone not measured"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_runs_to_its_end_on_the_cpu(name, capsys):
    import importlib

    mod = importlib.import_module(f"minlz_tpu_torch.scripts.{name}")
    rc = mod.main(["--device", "cpu", "--iters", "1", *SCRIPTS[name]])
    out = capsys.readouterr().out
    assert rc == 0
    for want in EXPECT[name]:
        assert want in out, (want, out)
    assert "[cpu]" in out or name == "rec_stats"


def test_profile_decode_range_road(capsys):
    from minlz_tpu_torch.scripts import profile_decode

    res = profile_decode.stage_times("range", 1, "cpu", 1, 32 << 10)
    assert "road range" in capsys.readouterr().out
    assert set(res) == {"parse", "compact", "execute"}
    assert all(alone is None for _, alone in res.values())


def test_profiled_writes_a_trace_and_finds_no_device_on_the_cpu(tmp_path):
    import torch

    with tbench.profiled(str(tmp_path), "tiny", "cpu") as prof:
        torch.arange(100).sum()
    assert (tmp_path / "tiny_trace.json").stat().st_size > 0
    with pytest.raises(RuntimeError):
        tbench.device_share(prof)
    with tbench.profiled(None, "none", "cpu") as prof:
        assert prof is None


def test_device_share_leaves_out_user_annotations():
    """A span's mirror on the device's timeline (a user annotation, such as
    ``minlz.decode.parse``) is no device time."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def event(name, start, end, annotation=False):
        return NS(name=name, device_type=DeviceType.CUDA,
                  time_range=NS(start=start, end=end),
                  is_user_annotation=annotation)

    prof = NS(events=lambda: [event("k1", 0, 10), event("k2", 30, 40),
                              event("minlz.decode.parse", 0, 40, True)])
    share = tbench.device_share(prof, top=None)
    assert share["busy_us"] == 20 and share["window_us"] == 40
    assert [k for k, _, _ in share["kernels"]] == ["k1", "k2"]


def test_trace_share_reads_a_chrome_trace(tmp_path):
    """trace_share: the device's window, busy time and idle share from the
    kernel and copy events of a Chrome trace; host events are not device
    time; a trace without device events raises."""
    import json

    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 90},
    ]
    path = tmp_path / "t_trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    share = tbench.trace_share(str(path), top=None)
    assert share["window_us"] == 40 and share["busy_us"] == 25
    assert share["idle_share"] == pytest.approx(0.375, abs=1e-12)
    assert share["kernels"] == [("k1", 20, 2), ("Memcpy HtoD", 10, 1)]
    assert tbench.trace_share(str(path), top=1)["kernels"] == [("k1", 20, 2)]
    path.write_text(json.dumps({"traceEvents": events[3:]}))
    with pytest.raises(RuntimeError):
        tbench.trace_share(str(path))


def test_scripts_refuse_a_missing_gpu():
    import torch

    from minlz_tpu_torch.scripts import rec_stats

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        rec_stats.main(["--mb", "0.03125", "--block-kb", "32"])


def test_sanitize_workload_runs_on_the_cpu(capsys):
    """The workload the sanitizer checks runs to its end through the plain
    versions (the corpus batch decodes to its input, mutated copies
    decode without a fault)."""
    from minlz_tpu_torch.scripts import sanitize_kernels

    rc = sanitize_kernels.main(["--workload", "--device", "cpu", "--blocks",
                                "1", "--block-kb", "32", "--mutated", "1"])
    assert rc == 0
    assert capsys.readouterr().out.startswith("launches {")


def test_sanitize_reports_what_it_could_not_check(tmp_path, monkeypatch,
                                                  capsys):
    """No compute-sanitizer: exit 2, nothing run.  A sanitizer that refuses
    the device ("Device not supported"): the tool's status is "refused",
    not clean; one that reports errors: "FAILED"."""
    import argparse

    from minlz_tpu_torch.scripts import sanitize_kernels as sk

    monkeypatch.setattr(sk, "find_sanitizer", lambda: None)
    assert sk.main([]) == 2
    assert "not found" in capsys.readouterr().out
    opt = argparse.Namespace(blocks=1, block_kb=32, mutated=0, timeout=60)
    for said, status in (("Error: Device not supported.", "refused"),
                         ("ERROR SUMMARY: 3 errors", "FAILED")):
        fake = tmp_path / "fake-sanitizer"
        fake.write_text(f"#!/bin/sh\necho '========= {said}'\nexit 97\n")
        fake.chmod(0o755)
        got, text, counts = sk.run_tool(str(fake), "memcheck", opt,
                                        str(tmp_path / "logs"))
        assert got == status and counts is None and "rc 97" in text
        assert (tmp_path / "logs" / "sanitize_memcheck.log").exists()


def test_exec_probe_body_walks_the_chain_counts_whose_region_fits(capsys):
    """exec_probe body's shared sweep at its default buffer, the JAX
    script's 4096 rows: 16 and 32 chains (256 and 128 rows a block) are
    walked with a block a chain; 1 and 8 do not fit a block and are
    reported, not walked."""
    from minlz_tpu_torch.scripts import exec_probe

    rc = exec_probe.main(["body", "--device", "cpu", "--iters", "1",
                          "--steps", "4", "--rows", "128"])
    out = capsys.readouterr().out
    assert rc == 0
    for mode in exec_probe.BODY_MODES:
        for c in (1, 8):
            assert (f"chainbody mode={mode} chains={c} space=shared "
                    f"rows=4096: not walked, a region of {4096 // c} rows"
                    in out)
        for c in (16, 32):
            assert (f"chainbody mode={mode} chains={c} space=shared "
                    f"rows=4096 grid={c} blocks:" in out)
        for c in exec_probe.BODY_CHAINS:
            assert (f"chainbody mode={mode} chains={c} space=global "
                    f"rows=128 grid={c} blocks:" in out)
