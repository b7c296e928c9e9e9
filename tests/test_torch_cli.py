"""The port's command line (minlz_tpu_torch.cli) on the CPU: the cases of
test_cli.py recast on the port's main on the host route (device=None, as the
JAX CLI runs without -device), the .mz files of the card route (with and
without -device) byte-equal to the JAX CLI's `c -device` and those of the
host route to its `c`, every `d` equal to its input (tolerance 0: bytes), no
DeviceCodec built on the host route, no host fallback on the card route,
the seek routes on the card, the host-only routes refused there, and
--traceprof through torch.profiler."""

import json
import os
import re

import pytest

from minlz_tpu.cli import main as jax_main
from minlz_tpu_torch.cli import main
from minlz_tpu_torch.ops.device_codec import DeviceCodec


@pytest.fixture
def workdir(tmp_path, twain, monkeypatch):
    p = tmp_path / "t.txt"
    p.write_bytes(twain * 4)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run(argv, capsys):
    rc = main(argv, device=None)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---- the cases of test_cli.py, on the port --------------------------------

def test_compress_decompress_roundtrip(workdir, capsys):
    rc, _, _ = run(["c", "t.txt"], capsys)
    assert rc == 0
    assert (workdir / "t.txt.mz").exists()
    rc, out, _ = run(["cat", "t.txt.mz"], capsys)
    assert rc == 0
    rc, _, _ = run(["d", "-o", "out.bin", "t.txt.mz"], capsys)
    assert rc == 0
    assert (workdir / "out.bin").read_bytes() == (workdir / "t.txt").read_bytes()


def test_block_mode_and_levels(workdir, capsys):
    for lvl in ("-xfast", "-2", "-3"):
        rc, _, _ = run(["c", lvl, "-block", "-o", "b.mzb", "t.txt"], capsys)
        assert rc == 0
        rc, _, _ = run(["d", "-o", "b.out", "b.mzb"], capsys)
        assert rc == 0
        assert (workdir / "b.out").read_bytes() == (
            workdir / "t.txt"
        ).read_bytes()


def test_offset_tail_limit(workdir, capsys):
    data = (workdir / "t.txt").read_bytes()
    run(["c", "-bs", "16384", "t.txt"], capsys)
    rc, _, _ = run(
        ["d", "-offset", "20000", "-limit", "100", "-o", "part.bin",
         "t.txt.mz"], capsys)
    assert rc == 0
    assert (workdir / "part.bin").read_bytes() == data[20000:20100]


def test_stats_blocks(workdir, capsys):
    run(["c", "t.txt"], capsys)
    rc, out, _ = run(["stats", "-blocks", "t.txt.mz"], capsys)
    assert rc == 0
    st = json.loads(out)
    assert st["blocks"] >= 1
    assert st["uncompressed"] == os.path.getsize(workdir / "t.txt")
    assert sum(st["op_bytes"].values()) == st["uncompressed"]


def test_search_and_sidecar_cli(workdir, capsys):
    run(["c", "-bs", "16384", "t.txt"], capsys)
    rc, out, _ = run(["s", "Tom Sawyer", "t.txt.mz"], capsys)
    assert rc == 0 and out.count("\n") > 1
    rc, _, _ = run(["sidecar", "build", "t.txt.mz"], capsys)
    assert rc == 0
    rc, out, _ = run(
        ["s", "--sidecar", "t.txt.mz.mzs", "-c", "Tom Sawyer", "t.txt.mz"],
        capsys)
    assert rc == 0
    assert int(out.strip().rsplit(" ", 1)[-1]) > 1


def test_vis_and_block_debug(workdir, capsys):
    run(["c", "-block", "-o", "b.mzb", "t.txt"], capsys)
    rc, _, _ = run(["vis", "b.mzb"], capsys)
    assert rc == 0
    html = (workdir / "b.mzb.html").read_text()
    assert "minlz block" in html
    rc, out, _ = run(["d", "-block-debug", "b.mzb"], capsys)
    assert rc == 0
    assert "lit" in out


def test_glob_expansion(workdir, capsys):
    (workdir / "sub").mkdir()
    (workdir / "sub" / "a.txt").write_bytes(b"hello glob " * 100)
    rc, _, _ = run(["c", "**/*.txt"], capsys)
    assert rc == 0
    assert (workdir / "sub" / "a.txt.mz").exists()


def test_compress_with_search_tables(workdir, capsys):
    rc, _, _ = run(["c", "-search", "-bs", "16384", "t.txt"], capsys)
    assert rc == 0
    raw = (workdir / "t.txt.mz").read_bytes()
    # Search info chunk (0x44) plus at least one table chunk present.
    assert bytes([0x44]) == raw[10:11] or b"\x44" in raw[:64]
    rc, out, _ = run(["s", "-q", "Tom Sawyer", "t.txt.mz"], capsys)
    assert rc == 0


def test_cli_compress_bench_verify(tmp_path, twain, capsys):
    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    rc = main(["c", "-bench", "2", "-verify", str(src)], device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert "best of 2" in out and "verified" in out


def test_cli_offset_nl_snapping(tmp_path, twain, capsys):
    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    mz = tmp_path / "in.mz"
    assert main(["c", str(src), "-o", str(mz)], device="cpu") == 0
    out_plain = tmp_path / "o1"
    out_nl = tmp_path / "o2"
    assert main(["d", "-offset", "6000", str(mz), "-o", str(out_plain)],
                device="cpu") == 0
    assert main(["d", "-offset", "6000+nl", str(mz), "-o", str(out_nl)],
                device="cpu") == 0
    plain = out_plain.read_bytes()
    snapped = out_nl.read_bytes()
    # Snapped output starts exactly after the first newline at/after 6000.
    j = plain.find(b"\n")
    assert snapped == plain[j + 1 :]
    assert twain.endswith(snapped)


def test_cli_compress_cpu_flag(tmp_path, twain):
    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    mz = tmp_path / "in.mz"
    assert main(["c", "-cpu", "2", str(src), "-o", str(mz)], device="cpu") == 0
    out = tmp_path / "out.txt"
    assert main(["d", str(mz), "-o", str(out)], device="cpu") == 0
    assert out.read_bytes() == twain


def test_stats_dispositions_and_hist(workdir, capsys):
    """mz stats reports block-size histograms always, and per-disposition
    sub-block accounting when 0x46 compressed search tables are present
    (reference mz stats disposition stats, cmd/mz/stats.go)."""
    run(["c", "-search", "-bs", "16384", "t.txt"], capsys)
    rc, out, _ = run(["stats", "t.txt.mz"], capsys)
    assert rc == 0
    st = json.loads(out)
    assert st["block_size_hist"]
    if "search-table-compressed" in st["chunks"]:
        d = st["dispositions"]
        total = sum(
            v["count"] for k, v in d.items() if isinstance(v, dict)
        )
        assert total > 0 and d["bitmap_bytes"] > 0


# ---- the same subcommands and flags as the JAX CLI -----------------------

def _help(fn, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        fn(argv)
    assert exc.value.code == 0
    return capsys.readouterr().out


def _flags(text):
    return sorted(set(re.findall(r"(?<![\w-])--?[a-z0-9][\w.-]*", text)))


@pytest.mark.parametrize("cmd", [None, "c", "d", "cat", "tail", "stats", "s",
                                 "search", "find", "sidecar", "vis", "bench"])
def test_subcommands_and_flags_match_jax(cmd, capsys):
    argv = ["--help"] if cmd is None else [cmd, "--help"]
    port = _help(main, argv, capsys)
    jax = _help(jax_main, argv, capsys)
    if cmd is None:
        subs = re.search(r"\{([\w,]+)\}", port).group(1)
        assert subs == re.search(r"\{([\w,]+)\}", jax).group(1)
        assert subs.split(",") == ["c", "d", "cat", "tail", "stats", "s",
                                   "search", "find", "sidecar", "vis", "bench"]
    usage = port.split("\n\n", 1)[0]
    assert _flags(usage) == _flags(jax.split("\n\n", 1)[0])


# ---- byte parity with the JAX CLI ----------------------------------------

CASES = [("twain", "-1"), ("twain", "-3"), ("corpus", "-2")]


@pytest.fixture(scope="module")
def inputs(twain):
    from minlz_tpu_torch.corpus import make_corpus

    return {"twain": twain, "corpus": make_corpus(1 << 20)}


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory, inputs):
    """The JAX CLI's .mz files, with and without -device, for every case
    (written once, so that JAX compiles once a level)."""
    d = tmp_path_factory.mktemp("jax_cli")
    out = {}
    for name, level in CASES:
        src = d / f"{name}.txt"
        src.write_bytes(inputs[name])
        for dev in (False, True):
            dst = d / f"{name}{level}{'-device' if dev else ''}.mz"
            argv = ["c", level] + (["-device"] if dev else [])
            assert jax_main(argv + ["-o", str(dst), str(src)]) == 0
            out[name, level, dev] = dst.read_bytes()
    return out


# (the port's device, its flags, the JAX CLI's file: with -device or not)
ROUTES = {"host": (None, [], False), "device": ("cpu", ["-device"], True),
          "plain": ("cpu", [], True)}


@pytest.mark.parametrize("dev", list(ROUTES))
@pytest.mark.parametrize("name,level", CASES)
def test_compress_matches_jax_cli(tmp_path, inputs, jax_files, name, level,
                                  dev):
    """The card route, with -device or without, writes the JAX CLI's
    `c -device` file; the host route (device=None) writes its `c` file."""
    data = inputs[name]
    src, mz = tmp_path / "in.txt", tmp_path / "in.mz"
    src.write_bytes(data)
    device, flag, jax_dev = ROUTES[dev]
    assert main(["c", level] + flag + ["-o", str(mz), str(src)],
                device=device) == 0
    assert mz.read_bytes() == jax_files[name, level, jax_dev]
    for i, (argv, on) in enumerate(((["d"], None), (["d"], "cpu"),
                                    (["d", "-device"], "cpu"))):
        out = tmp_path / f"out{i}"
        assert main(argv + ["-o", str(out), str(mz)], device=on) == 0
        assert out.read_bytes() == data
    out = tmp_path / "out_jax"
    assert jax_main(["d", "-o", str(out), str(mz)]) == 0
    assert out.read_bytes() == data


def test_device_decode_runs_on_the_device_codec(tmp_path, twain, monkeypatch):
    """`d -device` sends every hinted block through DeviceCodec.decode_batch
    on the device it was given."""
    seen = []
    real = DeviceCodec.decode_batch

    def spy(self, items):
        seen.append((str(self.device), len(items)))
        return real(self, items)

    monkeypatch.setattr(DeviceCodec, "decode_batch", spy)
    src, mz, out = tmp_path / "in.txt", tmp_path / "in.mz", tmp_path / "out"
    src.write_bytes(twain * 5)
    assert main(["c", "-device", "-bs", "16384", "-o", str(mz), str(src)],
                device="cpu") == 0
    assert main(["d", "-device", "-o", str(out), str(mz)], device="cpu") == 0
    assert out.read_bytes() == twain * 5
    assert seen and {d for d, _ in seen} == {"cpu"}
    assert sum(n for _, n in seen) == -(-len(twain * 5) // 16384)


# ---- the route is chosen by main's device ---------------------------------

def test_no_device_codec_without_the_flag(workdir, capsys, monkeypatch):
    """Every subcommand on the host route (main(argv, device=None), no
    -device) builds no DeviceCodec."""
    def refuse(self, *a, **k):
        raise AssertionError("a DeviceCodec was built without -device")

    monkeypatch.setattr(DeviceCodec, "__init__", refuse)
    data = (workdir / "t.txt").read_bytes()
    for argv in (["c", "-bs", "16384", "-search", "t.txt"],
                 ["c", "-recomp", "-o", "re.mz", "t.txt.mz"],
                 ["c", "-bench", "1", "-verify", "t.txt"],
                 ["d", "-o", "out.bin", "t.txt.mz"],
                 ["d", "-offset", "1000", "-o", "part.bin", "t.txt.mz"],
                 ["tail", "-n", "100", "t.txt.mz"],
                 ["stats", "-verify", "t.txt.mz"],
                 ["s", "-c", "Tom Sawyer", "t.txt.mz"],
                 ["sidecar", "build", "t.txt.mz"]):
        assert main(argv, device=None) == 0, argv
    assert (workdir / "out.bin").read_bytes() == data
    assert (workdir / "part.bin").read_bytes() == data[1000:]
    assert main(["d", "-o", "re.out", "re.mz"], device=None) == 0
    assert (workdir / "re.out").read_bytes() == data
    out = capsys.readouterr().out
    assert "best of 1" in out
    assert int(re.search(r"^t\.txt\.mz: (\d+)$", out, re.M).group(1)) > 1


def test_device_failure_raises(tmp_path, twain, monkeypatch):
    """On the card route (with -device or without) a failing device decode
    raises: no host fallback."""
    src, mz = tmp_path / "in.txt", tmp_path / "in.mz"
    src.write_bytes(twain)
    assert main(["c", "-device", "-o", str(mz), str(src)], device="cpu") == 0

    def fail(self, items):
        raise RuntimeError("device decode failed")

    monkeypatch.setattr(DeviceCodec, "decode_batch", fail)
    for flag in (["-device"], []):
        with pytest.raises(RuntimeError, match="device decode failed"):
            main(["d"] + flag + ["-o", str(tmp_path / "out"), str(mz)],
                 device="cpu")
    assert main(["d", "-o", str(tmp_path / "out"), str(mz)],
                device=None) == 0


def test_device_flag_without_gpu_raises(tmp_path, twain, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    for argv in (["c", "-device", str(src)], ["c", str(src)],
                 ["d", str(src)]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(argv)
    assert not (tmp_path / "in.txt.mz").exists()


def test_traceprof_writes_a_trace(tmp_path, twain):
    src, prof = tmp_path / "in.txt", tmp_path / "prof"
    src.write_bytes(twain)
    assert main(["--traceprof", str(prof), "c", "-device", str(src)],
                device="cpu") == 0
    assert sorted(os.listdir(prof)) == ["mz_trace.json", "spans.json"]
    with open(prof / "mz_trace.json") as f:
        trace = json.load(f)
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])


def test_traceprof_writes_the_spans(tmp_path, twain):
    """`--traceprof DIR` writes the run's spans and counters beside the
    trace: here the serializer Writer's stages, each batch's stages under
    it, and the spans' names in the trace under ``minlz.``."""
    src, prof = tmp_path / "in.txt", tmp_path / "prof"
    src.write_bytes(twain)
    assert main(["--traceprof", str(prof), "c", "-device", str(src)],
                device="cpu") == 0
    with open(prof / "spans.json") as f:
        snap = json.load(f)
    spans = snap["spans"]
    batches = spans["writer.flush_batch"]["count"]
    assert batches >= 1
    for name, parent in (("codec.encode_batch", "writer.flush_batch"),
                         ("encode.match", "codec.encode_batch"),
                         ("encode.serialize", "codec.encode_batch"),
                         ("writer.frame", "writer.flush_batch")):
        assert spans[name]["parent"] == parent
        assert spans[name]["count"] == batches
        assert 0 <= spans[name]["self_s"] <= spans[name]["host_s"]
    assert snap["counters"]["writer.blocks_stored_raw"] == 0
    with open(prof / "mz_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"minlz." + n for n in spans} <= names


def test_seek_routes_run_on_the_card(tmp_path, twain, monkeypatch,
                                     capfdbinary):
    """`d -offset`, `d -tail` and `tail` on the card route decode the blocks
    they touch through DeviceCodec.decode, and `d` says how many."""
    seen = []
    real = DeviceCodec.decode

    def spy(self, *args):
        seen.append(str(self.device))
        return real(self, *args)

    monkeypatch.setattr(DeviceCodec, "decode", spy)
    data = twain * 4
    src, mz, out = tmp_path / "in.txt", tmp_path / "in.mz", tmp_path / "out"
    src.write_bytes(data)
    assert main(["c", "-bs", "16384", "-o", str(mz), str(src)],
                device="cpu") == 0
    capfdbinary.readouterr()
    for argv, want in ((["-offset", "20000", "-limit", "100"],
                        data[20000:20100]),
                       (["-tail", "5000"], data[-5000:])):
        seen.clear()
        assert main(["d"] + argv + ["-o", str(out), str(mz)],
                    device="cpu") == 0
        assert out.read_bytes() == want
        assert seen and set(seen) == {"cpu"}
        err = capfdbinary.readouterr().err.decode()
        assert f", {len(seen)} blocks on cpu)" in err
    seen.clear()
    assert main(["tail", "-n", "300", str(mz)], device="cpu") == 0
    assert capfdbinary.readouterr().out == data[-300:]
    assert seen == ["cpu"]


@pytest.mark.parametrize("argv", [["d", "-cpu", "2", "{mz}"],
                                  ["d", "-o", "{out}", "{mzb}"],
                                  ["c", "-block", "-o", "{out}", "{src}"],
                                  ["c", "-recomp", "-o", "{out}", "{mzb}"]],
                         ids=["d-cpu", "d-mzb", "c-block", "c-recomp-mzb"])
def test_host_only_routes_refused_on_the_card(tmp_path, twain, capsys, argv):
    """The routes only the host codec takes (raw blocks, host decode
    threads) exit 2 on the card route and write nothing; on the host route
    they run."""
    paths = {k: str(tmp_path / n) for k, n in
             (("src", "in.txt"), ("mz", "in.mz"), ("mzb", "in.mzb"),
              ("out", "out"))}
    (tmp_path / "in.txt").write_bytes(twain)
    assert main(["c", "-o", paths["mz"], paths["src"]], device=None) == 0
    assert main(["c", "-block", "-o", paths["mzb"], paths["src"]],
                device=None) == 0
    argv = [a.format(**paths) for a in argv]
    capsys.readouterr()
    assert main(argv, device="cpu") == 2
    assert "main(argv, device=None)" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
    assert main(argv, device=None) == 0


def test_device_flag_on_the_host_route_is_an_error(tmp_path, twain):
    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    with pytest.raises(SystemExit) as exc:
        main(["c", "-device", str(src)], device=None)
    assert exc.value.code == 2
    assert not (tmp_path / "in.txt.mz").exists()
