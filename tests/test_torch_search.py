"""Search parity: minlz_tpu_torch.search against minlz_tpu.search, recast
from tests/test_search.py and tests/test_search_fixture.py.  The torch
builder ``build_tables_device`` runs on the CPU here and is held to the JAX
builder and to the NumPy builder bit for bit; Writer(search_table=...)
streams, table chunks, sidecars and searcher results equal the JAX
package's exactly (tolerance 0: bytes, integers, and statistics computed
from them)."""

import io
from dataclasses import asdict

import numpy as np
import pytest

from minlz_tpu import search as js
from minlz_tpu.search import build as jbuild
from minlz_tpu.search import compressed as jcomp
from minlz_tpu.search import sidecar as jside
from minlz_tpu.search import table as jtable
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch import block as blockapi
from minlz_tpu_torch import search as ts
from minlz_tpu_torch.minlz import MAGIC_CHUNK, crc, put_uvarint
from minlz_tpu_torch.search import build as tbuild
from minlz_tpu_torch.search import compressed as tcomp
from minlz_tpu_torch.search import sidecar as tside
from minlz_tpu_torch.search import table as ttable
from minlz_tpu_torch.stream import Reader, Writer

BS = 16 << 10


def _cfgs(make):
    """(port config, JAX config) built by the same ``make(module)``."""
    return make(ttable), make(jtable)


def _streams(data, make, block_size=BS, device=None, **kw):
    """The same bytes through both Writers with the same search config.
    ``device``: None for the host path of both packages, "cpu" for the
    device path (the JAX Writer's device=True)."""
    tcfg, jcfg = _cfgs(make)
    tbuf, jbuf = io.BytesIO(), io.BytesIO()
    with Writer(tbuf, block_size=block_size, add_index=False,
                search_table=tcfg, concurrency=1, device=device, **kw) as w:
        w.write(data)
    with JaxWriter(jbuf, block_size=block_size, add_index=False,
                   search_table=jcfg, concurrency=1,
                   device=device is not None, **kw) as w:
        w.write(data)
    return tbuf.getvalue(), jbuf.getvalue()


def _search(mod, stream, pattern, **kw):
    s = mod.BlockSearcher(io.BytesIO(stream), pattern, **kw)
    res = s.search()
    return [asdict(r) for r in res], asdict(s.stats)


def _both_search(tstream, jstream, pattern):
    got = _search(ts, tstream, pattern)
    want = _search(js, jstream, pattern)
    assert got == want
    return got


def _find_all(data, pattern):
    out, start = [], 0
    while (j := data.find(pattern, start)) >= 0:
        out.append(j)
        start = j + 1
    return out


# --- the hash family and the builders ---------------------------------------


def test_hash_family_matches_jax():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 63, 1000).astype(np.uint64)
    for ml in range(1, 9):
        for bits in (8, 14, 16, 20, 23):
            np.testing.assert_array_equal(
                ttable.hash_values_np(vals, bits, ml),
                jtable.hash_values_np(vals, bits, ml))
            mask = (1 << (8 * ml)) - 1
            for i in range(0, 1000, 97):
                v = int(vals[i]) & mask
                assert ttable.hash_value(v, bits, ml) == \
                    jtable.hash_value(v, bits, ml)


@pytest.mark.parametrize("match_len", range(1, 9))
def test_build_tables_device_matches_jax(twain, match_len):
    """Every match length at bits 8 to 23, on text, random bytes, all-0xff
    rows (the largest window values) and rows shorter than a window."""
    rng = np.random.default_rng(match_len)
    text = np.frombuffer((twain * 2)[: 3 * 4096], np.uint8).reshape(3, 4096)
    noise = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    ones = np.full((1, 4096), 255, np.uint8)
    for blocks in (np.concatenate([text, noise, ones]), noise[:, :5]):
        for bits in (8, 11, 16, 19, 23):
            got = tbuild.build_tables_device(blocks, match_len, bits, "cpu")
            want = np.asarray(jbuild.build_tables_device(blocks, match_len,
                                                         bits))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"bits {bits}")


@pytest.mark.parametrize("match_len", range(1, 9))
def test_build_table_auto_matches_numpy_and_jax(twain, match_len):
    block = twain[:8192]
    overlap = twain[8192 : 8192 + match_len]
    a = tbuild.build_table(block, ttable.SearchTableConfig(
        match_len=match_len), overlap, 8192)
    b = tbuild.build_table_auto(block, ttable.SearchTableConfig(
        match_len=match_len), overlap, 8192, "cpu")
    c = jbuild.build_table_auto(block, jtable.SearchTableConfig(
        match_len=match_len), overlap, 8192)
    assert a == b == c


def test_device_builder_matches_numpy_unreduced(twain):
    """build_tables_device against the NumPy builder with reduction and
    the population limit off (tests/test_search.py)."""
    bs = 8 << 10
    data = (twain * 3)[: 4 * bs]
    blocks = np.frombuffer(data, np.uint8).reshape(4, bs)
    for m, bits in ((3, 12), (4, 13), (6, 20)):
        dev = tbuild.build_tables_device(blocks, m, bits, "cpu").numpy()
        for i in range(4):
            cfg = ttable.SearchTableConfig(match_len=m, table_bits=bits)
            cfg.max_population = 1.0
            cfg.max_reduced_population = 0.0
            table, red = tbuild.build_table(blocks[i].tobytes(), cfg, b"", bs)
            assert red == 0
            assert dev[i].tobytes() == table, (m, bits, i)


@pytest.mark.parametrize("kind", ["byte", "mask", "long"])
def test_prefix_builders_match_jax(twain, kind):
    data = (b'{"key":"val1"} id=12345;' * 300 + twain[:6000])[: 12 << 10]

    def make(mod):
        cfg = mod.SearchTableConfig(match_len=4)
        if kind == "byte":
            return cfg.with_byte_prefix(b':"')
        if kind == "mask":
            return cfg.with_mask_prefix(b":=")
        return cfg.with_long_prefix(b"id=", extras=2)

    tcfg, jcfg = _cfgs(make)
    for overlap in (b"", data[:16]):
        got = tbuild.build_table_auto(data, tcfg, overlap, BS, "cpu")
        assert got == jbuild.build_table_auto(data, jcfg, overlap, BS)
        assert got == tbuild.build_table(data, tcfg, overlap, BS)


def test_table_chunks_match_jax(twain):
    for comp in (False, True):
        def make(mod):
            return mod.SearchTableConfig(match_len=6, compression=comp)

        tcfg, jcfg = _cfgs(make)
        table, red = tbuild.build_table(twain, tcfg, b"")
        chunk = tcfg.marshal_table(len(twain), table, red)
        assert chunk == jcfg.marshal_table(len(twain), table, red)
        assert tcfg.marshal_info(len(twain)) == jcfg.marshal_info(len(twain))
        if chunk[0] == 0x45:
            assert ttable.parse_table_chunk(chunk[4:])[1:] == \
                jtable.parse_table_chunk(chunk[4:])[1:]


# --- compressed tables (0x46) and huff0 --------------------------------------


def test_sparse_bit_table_matches_jax():
    rng = np.random.default_rng(11)
    for density in (0.001, 0.01, 0.05, 0.2):
        bits = (rng.random(8192 * 8) < density).astype(np.uint8)
        bitmap = np.packbits(bits, bitorder="little").tobytes()
        enc = tcomp.sparse_encode(bitmap)
        assert enc == jcomp.sparse_encode(bitmap)
        assert tcomp.sparse_decode(enc, len(bitmap)) == bitmap
    assert tcomp.sparse_encode(bytes(64)) == b""
    assert tcomp.sparse_decode(b"", 64) == bytes(64)


@pytest.mark.parametrize("shape", ["twain", "two_densities"])
def test_compressed_table_chunk_matches_jax(twain, shape):
    if shape == "twain":
        cfg = ttable.SearchTableConfig(match_len=6, table_bits=17)
        cfg.compression = False
        cfg.max_reduced_population = 0.0  # keep the table large and sparse
        table, red = tbuild.build_table(twain, cfg, b"", BS)
        block_size = BS
    else:
        cfg = ttable.SearchTableConfig(match_len=6)
        block_size = 1 << 20
        nbits = 1 << cfg.auto_bits(block_size)
        rng = np.random.default_rng(1)
        half = nbits // 2
        table = np.packbits(np.concatenate([
            (rng.random(half) < 0.04).astype(np.uint8),
            (rng.random(half) < 0.35).astype(np.uint8)]),
            bitorder="little").tobytes()
        red = 0
    jcfg = jtable.SearchTableConfig(match_len=6, table_bits=cfg.table_bits)
    chunk = tcomp.marshal_compressed_table(cfg, block_size, table, red)
    assert chunk is not None and chunk[0] == 0x46
    assert chunk == jcomp.marshal_compressed_table(jcfg, block_size, table,
                                                   red)
    got = tcomp.parse_compressed_table_chunk(chunk[4:])
    want = jcomp.parse_compressed_table_chunk(chunk[4:])
    assert got[1:] == want[1:] and got[3] == table
    assert tcomp.disposition_stats(chunk[4:]) == \
        jcomp.disposition_stats(chunk[4:])


# --- Writer(search_table=...) streams and the searcher -----------------------


def _no_prefix(comp):
    return lambda mod: mod.SearchTableConfig(match_len=6, compression=comp)


def _byte_prefix(comp):
    return lambda mod: mod.SearchTableConfig(
        match_len=4, compression=comp).with_byte_prefix(b":")


@pytest.mark.parametrize("make,comp,device", [
    (_no_prefix, False, None), (_no_prefix, True, None),
    (_byte_prefix, False, None), (_byte_prefix, True, None),
    (_no_prefix, True, "cpu"), (_byte_prefix, False, "cpu"),
], ids=["no_prefix-0x45-host", "no_prefix-0x46-host",
        "byte_prefix-0x45-host", "byte_prefix-0x46-host",
        "no_prefix-0x46-device", "byte_prefix-0x45-device"])
def test_writer_stream_matches_jax(twain, make, comp, device):
    """Host streams of both packages, and device streams (the JAX Writer's
    device=True against the port's device="cpu"); the device streams are
    kept to 2.5 blocks, since each block is its own device dispatch."""
    data = (b'{"key":"val1"}' * 400 + twain[:12000]) * 4
    if device is not None:
        data = data[: BS * 5 // 2]
    tstream, jstream = _streams(data, make(comp), device=device)
    assert tstream == jstream
    assert bytes([0x44]) in tstream
    if device is not None:
        r = Reader(io.BytesIO(tstream), device=device)
        assert r.readall() == data and r.codec.blocks_decoded > 0
    pattern = b':"val1"' if make is _byte_prefix else b"Tom Sawyer"
    got, _ = _both_search(tstream, jstream, pattern)
    assert got and [r["offset"] for r in got] == _find_all(data, pattern)


def test_writer_compressed_tables_are_used(twain):
    def make(mod):
        cfg = mod.SearchTableConfig(match_len=6, table_bits=17)
        cfg.max_reduced_population = 0.0  # sparse tables so 0x46 wins
        return cfg

    data = twain * 8
    tstream, jstream = _streams(data, make)
    assert tstream == jstream and bytes([0x46]) in tstream
    got, stats = _both_search(tstream, jstream, b"Tom Sawyer")
    assert [r["offset"] for r in got] == _find_all(data, b"Tom Sawyer")
    assert stats["tables_compressed"] > 0


def test_search_skips_absent_pattern():
    rng = np.random.default_rng(5)
    blocks = [rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
              for _ in range(6)]
    needle = b"NEEDLE-IN-HAYSTACK-XYZZY"
    blocks[3] = blocks[3][:5000] + needle + blocks[3][5000 + len(needle):]
    data = b"".join(blocks)
    tstream, jstream = _streams(data, _no_prefix(True))
    assert tstream == jstream
    got, stats = _both_search(tstream, jstream, needle)
    assert [r["offset"] for r in got] == [data.find(needle)]
    assert stats["blocks_skipped"] >= 2
    assert stats["blocks_decoded"] < stats["blocks_total"]


@pytest.mark.parametrize("case", ["straddle", "deferred_straddle",
                                  "deferred_absent"])
def test_boundary_cases_match_jax(twain, case):
    if case == "deferred_absent":
        rng = np.random.default_rng(13)
        words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo",
                 b"foxtrot"]
        blocks = [b" ".join(words[int(k)] for k in rng.integers(0, 6, 3000))
                  [:BS] for _ in range(8)]
        pattern = b"zulu-yankee-xray"
        data = b"".join(blocks)[: 7 * BS] + pattern
        pos = len(data) - len(pattern)
    else:
        pattern = (b"SPLIT-ACROSS-BOUNDARY" if case == "straddle"
                   else b"QqWwEeRrTtYy-straddle-AaSsDdFf")
        data = bytearray((twain * 12)[: BS * 6])
        pos = BS * 2 - len(pattern) // 2 if case == "straddle" else BS * 3 - 7
        data[pos : pos + len(pattern)] = pattern
        data = bytes(data)
    tstream, jstream = _streams(data, _no_prefix(True))
    assert tstream == jstream
    got, _ = _both_search(tstream, jstream, pattern)
    assert pos in [r["offset"] for r in got]


def test_no_false_negatives_fuzz(twain):
    rng = np.random.default_rng(7)
    base = bytearray(twain * 2)
    patterns = [b"alpha0", b"bravo-bravo", b"x" * 9, b"zq9!kk"]
    for p in patterns:
        for _ in range(5):
            pos = int(rng.integers(0, len(base) - len(p)))
            base[pos : pos + len(p)] = p
    data = bytes(base)
    for ml in (4, 6):
        tstream, jstream = _streams(
            data, lambda mod: mod.SearchTableConfig(match_len=ml),
            block_size=8 << 10)
        assert tstream == jstream
        for p in patterns:
            got, _ = _both_search(tstream, jstream, p)
            assert [r["offset"] for r in got] == _find_all(data, p)


def test_long_prefix_stream(twain):
    data = (b"id=12345;" * 300 + twain[:6000]) * 2
    tstream, jstream = _streams(
        data, lambda mod: mod.SearchTableConfig(match_len=4)
        .with_long_prefix(b"id=", extras=2), block_size=8 << 10)
    assert tstream == jstream
    got, _ = _both_search(tstream, jstream, b"id=12345")
    assert [r["offset"] for r in got] == _find_all(data, b"id=12345")


def test_search_stream_without_tables(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=BS, add_index=False, device=None) as w:
        w.write(twain * 4)
    s = ts.BlockSearcher(io.BytesIO(buf.getvalue()), b"Tom")
    assert len(s.search()) == (twain * 4).count(b"Tom")
    assert s.stats.blocks_no_table == s.stats.blocks_total


def test_forward_context_and_stats(twain):
    """SEARCH_FORWARD re-delivers the match with more context; the extended
    statistics print as the JAX package's do."""
    tstream, jstream = _streams(twain * 2, _no_prefix(True), block_size=4096)
    assert tstream == jstream
    calls = []

    def cb(r):
        calls.append((r.offset, len(r.context)))
        return ts.SEARCH_FORWARD if len(calls) == 1 else False

    ts.BlockSearcher(io.BytesIO(tstream), b"Tom Sawyer").search(cb)
    assert len(calls) >= 2 and calls[1][0] == calls[0][0]
    assert calls[1][1] > calls[0][1]
    outs = []
    for mod, stream in ((ts, tstream), (js, jstream)):
        s = mod.BlockSearcher(io.BytesIO(stream), b"nonexistent-zzz-string")
        s.search()
        out = io.StringIO()
        s.stats.fprint_extended(out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and "window @" in outs[0]


# --- sidecars ------------------------------------------------------------------


def _random_blocks(seed, n, size, plant):
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
              for _ in range(n)]
    for i, at, needle in plant:
        blocks[i] = blocks[i][:at] + needle + blocks[i][at + len(needle):]
    return b"".join(blocks)


def _host_stream(data, block_size):
    buf = io.BytesIO()
    with Writer(buf, block_size=block_size, add_index=False,
                device=None) as w:
        w.write(data)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["plain", "deferred"])
def test_sidecar_build_and_search_match_jax(case):
    if case == "plain":
        needle = b"SIDECAR-NEEDLE-42"
        data = _random_blocks(11, 5, BS, [(2, 3000, needle)])
        block_size = BS
    else:
        needle = b"XSTRADDLEX"
        rng = np.random.default_rng(5)
        blocks = []
        for i in range(12):
            b = rng.integers(0, 256, 8 << 10, dtype=np.uint8).tobytes()
            if i in (3, 7):
                b = b[: -(len(needle) - 4)] + needle[: len(needle) - 4]
            if i == 5:
                b = b[:2000] + needle + b[2000 + len(needle):]
            blocks.append(b)
        data = b"".join(blocks)
        block_size = 8 << 10
    main = _host_stream(data, block_size)
    side = tside.build_sidecar(io.BytesIO(main),
                               ttable.SearchTableConfig(match_len=6))
    assert side == jside.build_sidecar(io.BytesIO(main),
                                       jtable.SearchTableConfig(match_len=6))
    assert len(side) < len(main)
    results = []
    for mod in (tside, jside):
        s = mod.SidecarSearcher(side, io.BytesIO(main), needle)
        results.append(([asdict(r) for r in s.search()], asdict(s.stats)))
    assert results[0] == results[1]
    assert [r["offset"] for r in results[0][0]] == _find_all(data, needle)
    assert results[0][1]["blocks_skipped"] >= 1


def test_sidecar_extract_matches_jax(twain):
    tstream, jstream = _streams(twain * 4, _no_prefix(True))
    assert tstream == jstream
    side = tside.extract_sidecar(io.BytesIO(tstream))
    assert side == jside.extract_sidecar(io.BytesIO(jstream))
    assert len(side) < len(tstream) and bytes([0x47]) in side


def test_writer_sidecar_diversion_matches_jax(twain):
    def make(mod):
        cfg = mod.SearchTableConfig(match_len=6, table_bits=17)
        cfg.max_reduced_population = 0.0
        return cfg

    data = twain * 8
    tcfg, jcfg = _cfgs(make)
    outs = []
    for W, cfg, opts in ((Writer, tcfg, {"device": None}),
                         (JaxWriter, jcfg, {})):
        main, side = io.BytesIO(), io.BytesIO()
        with W(main, block_size=BS, add_index=False, search_table=cfg,
               sidecar=side, concurrency=1, **opts) as w:
            w.write(data)
        outs.append((main.getvalue(), side.getvalue()))
    assert outs[0] == outs[1]
    raw, sc = outs[0]
    pos = 0
    while pos + 4 <= len(raw):
        assert raw[pos] not in (0x44, 0x45, 0x46, 0x47)
        pos += 4 + int.from_bytes(raw[pos + 1 : pos + 4], "little")
    s = tside.SidecarSearcher(io.BytesIO(sc), io.BytesIO(raw), b"Tom Sawyer")
    assert [r.offset for r in s.search()] == _find_all(data, b"Tom Sawyer")


# --- spec-built fixtures (tests/test_search_fixture.py) ----------------------

PRIME4 = 2654435761


def _hash4(window: bytes, bits: int) -> int:
    """SPEC_SEARCH.md §3.1 HashValue for matchLen=4 (independent impl)."""
    return ((int.from_bytes(window, "little") * PRIME4) & 0xFFFFFFFF) >> (
        32 - bits)


def _spec_table(data, bits, prefixes=b""):
    table = bytearray(1 << (bits - 3))
    for i in range(len(data) - 3):
        if prefixes and (i == 0 or data[i - 1] not in prefixes):
            continue
        x = _hash4(data[i : i + 4], bits)
        table[x >> 3] |= 1 << (x & 7)
    return table


def _chunk(ctype, payload):
    return bytes([ctype]) + len(payload).to_bytes(3, "little") + payload


def _fixture_stream(data, hdr, table, reductions=0):
    comp = blockapi.encode(data)
    payload = hdr + bytes([reductions]) + crc(bytes(table)).to_bytes(
        4, "little") + bytes(table)
    return (MAGIC_CHUNK + bytes([11]) + _chunk(0x44, hdr)
            + _chunk(0x45, payload)
            + _chunk(0x02, crc(data).to_bytes(4, "little") + comp[1:])
            + _chunk(0x20, put_uvarint(len(data))))


def _fixture_corpus():
    words = (b"alpha beta gamma delta epsilon zeta eta theta iota kappa "
             b"lambda mu nu xi omicron pi rho sigma tau upsilon ")
    return (words * 40)[:2048] + b" NEEDLE-IN-HAYSTACK " + (words * 20)[:700]


@pytest.mark.parametrize("kind", ["type1", "type1_reduced", "type2"])
def test_hand_built_chunks_consumed(kind):
    """0x44/0x45 chunks assembled byte by byte from the spec: the planted
    pattern is found, in-block windows never miss, and a pattern with
    absent windows skips the block without decoding it."""
    data = _fixture_corpus()
    bits = 10
    if kind == "type2":
        prefixes = b" aeiost-"
        enc = _fixture_stream(data, bytes([2, 4, bits]) + prefixes,
                              _spec_table(data, bits, prefixes))
        plen = 7
    else:
        table = _spec_table(data, bits)
        red = 0
        if kind == "type1_reduced":
            half = len(table) // 2
            table = bytes(a | b for a, b in zip(table[:half], table[half:]))
            red = 1
        enc = _fixture_stream(data, bytes([1, 4, bits]), table, red)
        plen = 6
    needle = b"NEEDLE-IN-HAYSTACK"
    got = _search(ts, enc, needle)
    assert got == _search(js, enc, needle)
    assert [r["offset"] for r in got[0]] == [data.index(needle)]
    for start in range(0, len(data) - plen, 131):
        pat = data[start : start + plen]
        offs = [r.offset for r in
                ts.BlockSearcher(io.BytesIO(enc), pat).search()]
        assert data.index(pat) in offs, (start, pat)
    if kind != "type2":
        s = ts.BlockSearcher(io.BytesIO(enc), b"\x01\x02\x03\xfe\xfd\xfc")
        assert s.search() == []
        assert s.stats.blocks_skipped == 1 and s.stats.blocks_decoded == 0


def test_writer_rejects_an_invalid_table_config():
    with pytest.raises(ValueError, match="match_len"):
        Writer(io.BytesIO(), device=None,
               search_table=ttable.SearchTableConfig(match_len=9))
