"""The port stands on its own: no module of minlz_tpu_torch, and not
chip_smoke.py, imports jax, bench, tests/ or anything of minlz_tpu, and the
port's copies of the host modules agree with the originals on seeded input
(tolerance 0: bytes and integers).  chip_smoke.py refuses to run without a
GPU or outside the repository."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "minlz_tpu_torch")

_WALK_AND_CHECK = r"""
import importlib, pkgutil, sys
import minlz_tpu_torch
names = ["minlz_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(minlz_tpu_torch.__path__,
                                          "minlz_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
foreign = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "bench", "minlz_tpu",
                           "kernel_probe", "exec_probe", "ablate_exec",
                           "profile_decode", "probe_v2", "rec_stats",
                           "enc_probe", "emit_probe"))
assert not foreign, foreign
for wanted in ("minlz_tpu_torch.stream.writer", "minlz_tpu_torch.ops.emit",
               "minlz_tpu_torch.ops.greedy", "minlz_tpu_torch.native.codec",
               "minlz_tpu_torch.oracle.encode", "minlz_tpu_torch.corpus",
               "minlz_tpu_torch.entry", "minlz_tpu_torch.testing",
               "minlz_tpu_torch.ops.exec_block",
               "minlz_tpu_torch.ops.decode_kernel",
               "minlz_tpu_torch.ops.probe", "minlz_tpu_torch.bench",
               "minlz_tpu_torch.scripts.kernel_probe",
               "minlz_tpu_torch.scripts.exec_probe",
               "minlz_tpu_torch.scripts.ablate_exec",
               "minlz_tpu_torch.scripts.profile_decode",
               "minlz_tpu_torch.scripts.probe_v2",
               "minlz_tpu_torch.scripts.rec_stats",
               "minlz_tpu_torch.scripts.enc_probe",
               "minlz_tpu_torch.scripts.emit_probe",
               "minlz_tpu_torch.scripts.sanitize_kernels",
               "minlz_tpu_torch.parallel", "minlz_tpu_torch.parallel.mesh",
               "minlz_tpu_torch.parallel.ranks", "minlz_tpu_torch.search",
               "minlz_tpu_torch.search.build",
               "minlz_tpu_torch.search.searcher",
               "minlz_tpu_torch.search.sidecar", "minlz_tpu_torch.dict",
               "minlz_tpu_torch.utils.huff0", "minlz_tpu_torch.cli",
               "minlz_tpu_torch.lz4", "minlz_tpu_torch.utils.readahead",
               "minlz_tpu_torch.utils.shttp"):
    assert wanted in names, wanted
print("clean", len(names))
"""


def _run(args, cwd, env_extra=None, timeout=180):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = ROOT if cwd != ROOT else env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    """Every module of the port (the package is walked) and chip_smoke,
    imported in a fresh interpreter, leave no jax, jaxlib, bench or
    minlz_tpu module behind."""
    res = _run(["-c", _WALK_AND_CHECK], ROOT)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


_TRACED_CLI = r"""
import os, sys
from minlz_tpu_torch.cli import main
d = sys.argv[1]
src = os.path.join(d, "in.txt")
with open(src, "wb") as f:
    f.write(b"the cli under torch.profiler " * 2000)
assert main(["--traceprof", os.path.join(d, "prof"), "c", src],
            device="cpu") == 0
assert os.listdir(os.path.join(d, "prof"))
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "minlz_tpu"))
assert not foreign, foreign
print("clean")
"""


def test_traced_cli_imports_no_jax(tmp_path):
    """`mz --traceprof DIR c FILE` traces with torch.profiler and leaves no
    jax, jaxlib or minlz_tpu module behind."""
    res = _run(["-c", _TRACED_CLI, str(tmp_path)], ROOT)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_sources_name_no_foreign_package():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(minlz_tpu|jax|jaxlib|bench|tests|test_\w+"
        r"|conftest)\b(?!_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PORT):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path, encoding="utf-8") as f:
            found = pattern.findall(f.read())
        assert not found, (path, found)


def test_native_library_builds_outside_the_sources():
    from minlz_tpu_torch import minlz
    from minlz_tpu_torch.native import build
    from minlz_tpu_torch.native.codec import get_codec

    assert build.build_error() is None
    assert get_codec() is not None and minlz._crc32c_impl is not None
    assert build.LIB_PATH.startswith(
        os.path.join(ROOT, "build", "minlz_tpu_torch") + os.sep)
    assert os.path.exists(build.LIB_PATH)
    for base, _, names in os.walk(PORT):
        assert not [n for n in names if n.endswith(".so")], base


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    res = _run(["chip_smoke.py"], str(tmp_path), env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


# ---- the copies against the originals -----------------------------------

def test_make_corpus_matches_bench():
    import bench
    from minlz_tpu_torch.corpus import make_corpus

    assert make_corpus(1 << 20) == bench.make_corpus(1 << 20)
    assert len(make_corpus(12345)) == 12345


def test_mutate_matches_fuzz_helper():
    from test_fuzz import _mutate

    from minlz_tpu_torch.testing import mutate

    data = bytes(range(256)) * 4
    for seed in range(40):
        assert mutate(np.random.default_rng(seed), data) \
            == _mutate(np.random.default_rng(seed), data)
    assert mutate(np.random.default_rng(0), b"") == b""


def test_minlz_constants_and_errors_match():
    from minlz_tpu import minlz as jm
    from minlz_tpu_torch import minlz as tm

    names = [n for n in dir(jm) if n.isupper()]
    assert len(names) > 30
    for name in names:
        assert getattr(tm, name) == getattr(jm, name), name
    for name in ("CorruptError", "TooLargeError", "UnsupportedError"):
        assert issubclass(getattr(tm, name), Exception)
        assert [c.__name__ for c in getattr(tm, name).__mro__] \
            == [c.__name__ for c in getattr(jm, name).__mro__]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc_and_uvarint_match(seed):
    from minlz_tpu import minlz as jm
    from minlz_tpu_torch import minlz as tm

    rng = np.random.default_rng(seed)
    for size in (0, 1, 7, 64, 4097, 100_000):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert tm.crc32c(data) == jm.crc32c(data)
        assert tm.crc(data) == jm.crc(data)
    buf = bytearray()
    values = [0, 1, 127, 128, 300, (1 << 32) - 1, (1 << 63) + 5] + [
        int(v) for v in rng.integers(0, 1 << 62, 20)]
    for v in values:
        enc = tm.put_uvarint(v)
        assert enc == jm.put_uvarint(v)
        buf += enc
    pos = 0
    for v in values:
        got, nxt = tm.read_uvarint(bytes(buf), pos)
        assert (got, nxt) == jm.read_uvarint(bytes(buf), pos)
        assert got == v
        pos = nxt
    with pytest.raises(ValueError):
        tm.read_uvarint(b"\xff\xff", 0)


@pytest.mark.parametrize("level", [-1, 1, 2, 3])
def test_block_encode_decode_match(twain, level):
    from minlz_tpu import block as jb
    from minlz_tpu_torch import block as tb

    rng = np.random.default_rng(level + 10)
    inputs = [
        twain[:50_000],
        rng.integers(0, 4, 30_000, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes(),
        b"",
        b"abc",
    ]
    for data in inputs:
        enc = tb.encode(data, level)
        assert enc == jb.encode(data, level)
        assert tb.decode(enc) == data
        assert jb.decode(enc) == data
        assert tb.decoded_len(enc) == len(data)
        assert tb.is_minlz(enc) == jb.is_minlz(enc)


def test_oracle_and_snappy_copies_match(twain, twain_mzb):
    from minlz_tpu import snappy as js
    from minlz_tpu.oracle import decode as jod
    from minlz_tpu.oracle import encode as joe
    from minlz_tpu_torch import snappy as ts
    from minlz_tpu_torch.minlz import CorruptError
    from minlz_tpu_torch.oracle import decode as tod
    from minlz_tpu_torch.oracle import encode as toe

    assert tod.decode_block(twain_mzb) == jod.decode_block(twain_mzb) == twain
    data = twain[:20_000]
    assert toe.encode_block(data) == joe.encode_block(data)
    with pytest.raises(CorruptError):
        tod.decode_block(twain_mzb[: len(twain_mzb) // 2])
    for use_repeats in (False, True):
        enc = ts.snappy_encode_block(data, use_repeats=use_repeats)
        assert enc == js.snappy_encode_block(data, use_repeats=use_repeats)
        assert ts.s2_decode_block(enc) == js.s2_decode_block(enc) == data


def test_stream_index_copy_matches():
    from minlz_tpu.stream import Index as JIndex
    from minlz_tpu_torch.stream import Index as TIndex

    ji, ti = JIndex(), TIndex()
    for idx in (ji, ti):
        for k in range(50):
            idx.add(k * 70_000 + 10, k * (1 << 20))
        idx.total_uncompressed = 50 << 20
        idx.total_compressed = 50 * 70_000 + 10
        idx.est_block_uncomp = 1 << 20
    assert ti.marshal() == ji.marshal()
    back = TIndex.load(ji.marshal())
    assert back.find(3 << 20) == ji.find(3 << 20) == ti.find(3 << 20)
    assert back.to_json() == JIndex.load(ti.marshal()).to_json()


def test_top_level_block_api_matches(twain):
    """The package's top exports minlz_tpu's block API, constants, errors and
    version, from the port's own modules, beside the four names of the
    device codec."""
    import minlz_tpu as jm
    import minlz_tpu_torch as tm

    assert set(jm.__all__) <= set(tm.__all__)
    assert set(tm.__all__) - set(jm.__all__) == {
        "DeviceCodec", "Reader", "Writer", "resolve_device"}
    assert tm.__version__ == jm.__version__
    for name in tm.__all__:
        obj = getattr(tm, name)
        if callable(obj):
            assert obj.__module__.startswith("minlz_tpu_torch."), name
        else:
            assert obj == getattr(jm, name), name
    data = twain[:30_000]
    for level in (tm.LEVEL_SUPER_FAST, tm.LEVEL_FASTEST, tm.LEVEL_BALANCED,
                  tm.LEVEL_SMALLEST):
        enc = tm.encode(data, level)
        assert enc == jm.encode(data, level)
        assert tm.decode(enc) == data and tm.decoded_len(enc) == len(data)
        assert tm.is_minlz(enc) and tm.append_decoded(b"x", enc) == b"x" + data
        assert tm.append_encoded(b"y", data, level) == b"y" + enc
        assert len(enc) <= tm.max_encoded_len(len(data))
        assert tm.try_encode(data, level) == jm.try_encode(data, level)
    with pytest.raises(tm.CorruptError):
        tm.decode(enc[: len(enc) // 2])
    assert issubclass(tm.TooLargeError, Exception)
    assert issubclass(tm.UnsupportedError, Exception)
