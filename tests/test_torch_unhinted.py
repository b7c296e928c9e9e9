"""Blocks without parse hints, as every MinLZ writer but this package's
device Writer leaves them, decoded on the device: the derived lane plan
(``ops/derive.py``) against the sequential walk of ``oracle/derive.py``,
the whole decode against ``oracle.decode.decode_block``, the ``Reader``'s
routes, hostile bodies, and K1's incoming repeat offset.  On the CPU the
plain torch versions run; the card cases at the end compare each kernel
with its plain version and skip without a GPU."""

import functools
import io

import numpy as np
import pytest
import torch

from minlz_tpu_torch import block as blockapi
from minlz_tpu_torch import trace
from minlz_tpu_torch.minlz import (CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
                                   MAGIC_CHUNK, CorruptError, put_uvarint)
from minlz_tpu_torch.oracle import derive as oder
from minlz_tpu_torch.oracle.decode import decode_block, parse_header
from minlz_tpu_torch.ops import derive, exec_block
from minlz_tpu_torch.ops.device_codec import get_device_codec
from minlz_tpu_torch.ops.parse import parse_segments_plain
from minlz_tpu_torch.ops.parse_model import parse_segments_model
from minlz_tpu_torch.stream import Reader, Writer

KB, MB = 1 << 10, 1 << 20
LEVELS = (-1, 1, 2, 3)
WORDS = [w.encode() for w in (
    "id type actor login repo name url payload push commit message author "
    "email distinct sha ref head before size created public org true false "
    "null issue comment body title state open closed label user html api "
    "github events forks watchers language python go rust java").split()]


def records(n: int, seed: int) -> bytes:
    """About ``n`` bytes of comma-separated records drawn from a small
    vocabulary: copies at every distance, repeats, short literals."""
    rng = np.random.default_rng(seed)
    k = n // 6 + 16
    words = rng.zipf(1.3, k) % len(WORDS)
    nums = rng.integers(0, 100000, k)
    parts = []
    for i, (w, v) in enumerate(zip(words.tolist(), nums.tolist())):
        parts.append(WORDS[w])
        parts.append(b"\n" if i % 7 == 6 else b",")
        if i % 3 == 0:
            parts.append(b"%d," % v)
    return b"".join(parts)[:n]


def far_copies(n: int, seed: int) -> bytes:
    """``n`` bytes that repeat a 1 MiB stretch with a byte changed every
    few KiB: copies that reach back about 1 MiB, across many lanes."""
    base = bytearray(records(MB, seed))
    rng = np.random.default_rng(seed + 1)
    out = bytearray()
    while len(out) < n:
        for p in rng.integers(0, len(base), 256).tolist():
            base[p] ^= 0x20
        out += base
    return bytes(out[:n])


def body_of(block: bytes):
    """(body after the uvarint, decoded length) of a compressed block."""
    lit_only, want, pos = parse_header(block)
    assert not lit_only
    return block[pos:], want


def encode(data: bytes, level: int):
    return body_of(blockapi.encode(data, level))


def plan_of(bodies, wants, seg, device="cpu"):
    lens = np.array([len(b) for b in bodies], np.int64)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(device)
    comp = torch.from_numpy(np.frombuffer(b"".join(bodies) or b"\0",
                                          np.uint8).copy()).to(device)
    out_len = torch.tensor(wants, dtype=torch.int32, device=device)
    return derive.derive_plan(comp, off, out_len, sum(wants), seg), off


def lane_tables(plan, off):
    """Per block, its lanes as ``oracle.derive.lane_table`` gives them."""
    host = {k: plan[k].cpu().tolist() for k in derive.LANES + ("range_lane",)}
    off = off.cpu().tolist()
    out = []
    for b in range(len(off) - 1):
        lanes = range(host["range_lane"][b], host["range_lane"][b + 1])
        out.append([(host["lane_start"][j] - off[b], host["lane_len"][j],
                     host["lane_lo"][j], host["lane_hi"][j],
                     host["lane_rep"][j]) for j in lanes])
    return out


def assert_plan_is_the_walk(bodies, wants, seg, device="cpu"):
    plan, off = plan_of(bodies, wants, seg, device)
    assert int(plan["bad"]) == 0
    got = lane_tables(plan, off)
    for b, (body, want) in enumerate(zip(bodies, wants)):
        assert got[b] == oder.lane_table(body, want, seg), b
    # The lanes past the last block's are empty, at the end of the bodies.
    last = int(plan["range_lane"][-1])
    assert plan["lane_len"][last:].eq(0).all()
    assert plan["lane_start"][last:].eq(int(off[-1])).all()
    return plan


@pytest.mark.parametrize("level,size", [
    (-1, 64 * KB), (-1, 2 * MB), (1, 256 * KB), (2, 64 * KB), (2, 2 * MB),
    (3, 256 * KB)])
def test_derived_plan_is_the_sequential_walk(level, size):
    body, want = encode(records(size, size + level), level)
    assert_plan_is_the_walk([body], [want], 4096)


def test_derived_plan_of_an_8_mib_block():
    body, want = encode(far_copies(8 * MB, 3), 2)
    assert any(t[3] > 512 * KB for t in oder.walk(body))  # reach far back
    assert_plan_is_the_walk([body], [want], 4096)


def lit(b: bytes) -> bytes:
    """A literal-run token and its bytes."""
    n = len(b)
    if n <= 29:
        return bytes([(n - 1) << 3]) + b
    nb = (n - 30).bit_length() + 7 >> 3 or 1
    return bytes([(28 + nb) << 3]) + (n - 30).to_bytes(nb, "little") + b


def rep(n: int) -> bytes:
    """A Repeat token of 1-29 bytes."""
    return bytes([(n - 1) << 3 | 4])


def copy2(off: int, n: int) -> bytes:
    """A Copy2 token: offset 64-65599, 4-64 bytes."""
    return bytes([(n - 4) << 2 | 2]) + (off - 64).to_bytes(2, "little")


def test_lanes_skipped_by_a_long_literal_run():
    """A literal run across several lanes: those lanes are empty, the next
    one starts after the run and enters with the offset set before it."""
    rng = np.random.default_rng(5)
    body = (lit(rng.integers(0, 256, 300, dtype=np.uint8).tobytes())
            + copy2(200, 40) + rep(9)
            + lit(rng.integers(0, 256, 20000, dtype=np.uint8).tobytes())
            + rep(20) + copy2(1000, 60) * 50 + rep(12) * 10 + lit(b"xyz")
            + copy2(700, 30))
    last = oder.walk(body)[-1]
    want = last[1] + last[2]
    assert len(decode_block(b"\0" + put_uvarint(want) + body)) == want
    assert_plan_is_the_walk([body], [want], 4096)
    lanes = oder.lane_table(body, want, 4096)
    assert [ln for _, ln, _, _, _ in lanes[1:4]] == [0, 0, 0]
    # Lane 4 starts after the run, at a Repeat of the offset set before it.
    assert lanes[4][1] > 0 and lanes[4][4] == 200
    assert oder.walk(body[lanes[4][0]:])[0][4] == "repeat"


def test_lanes_that_start_in_repeats():
    """Cut at 16 compressed bytes, many lanes start at a Repeat, which
    takes the offset the lane enters with."""
    bodies, wants = map(list, zip(*(encode(records(48 * KB, s), lvl)
                                    for s, lvl in ((1, 1), (2, 2), (3, 3)))))
    assert_plan_is_the_walk(bodies, wants, 16)
    starts_in_repeat = 0
    for body, want in zip(bodies, wants):
        kind = {t[0]: t[4] for t in oder.walk(body)}
        starts_in_repeat += sum(
            ln > 0 and kind[s] == "repeat" and rep != 1
            for s, ln, _, _, rep in oder.lane_table(body, want, 16))
    assert starts_in_repeat >= 10


def test_a_batch_of_mixed_blocks():
    """Blocks of every level and size in one plan, cut at several segment
    sizes: each block's lanes are its own walk's."""
    items = [encode(records(n, n), lvl) for n, lvl in
             ((30 * KB, -1), (64 * KB, 1), (100 * KB, 2), (17 * KB, 3))]
    items.append(body_of(blockapi.encode(b"ab" * 3000, 2)))
    bodies, wants = map(list, zip(*items))
    for seg in (16, 1000, 4096, 8192):
        assert_plan_is_the_walk(bodies, wants, seg)


@pytest.mark.parametrize("level", LEVELS)
def test_unhinted_decode_is_the_oracles(level):
    items = [encode(records(n, n + level), level)
             for n in (40 * KB, 64 * KB, 5 * KB)]
    bodies, wants = map(list, zip(*items))
    outs = exec_block.decode_blocks_unhinted(bodies, wants, device="cpu")
    for out, body, want in zip(outs, bodies, wants):
        assert out == oder.decode_unhinted(body, want)
        assert out == oder.decode_lanes(body, want, 4096)


def _stream(data: bytes, block: int = 64 * KB, level: int = 2) -> bytes:
    buf = io.BytesIO()
    with Writer(buf, device=None, level=level, block_size=block) as w:
        w.write(data)
    return buf.getvalue()


@pytest.mark.parametrize("route", ["readall", "read"])
def test_reader_decodes_a_host_written_stream_on_the_device(route):
    data = records(150 * KB, 9) + bytes(5 * KB)
    raw = _stream(data)
    codec = get_device_codec("cpu")
    before = codec.blocks_decoded
    r = Reader(io.BytesIO(raw), device="cpu")
    assert (r.readall() if route == "readall" else r.read()) == data
    assert r.host_unhinted_blocks == 0 and r.hint_fallbacks == 0
    assert codec.blocks_decoded - before == 3
    host = Reader(io.BytesIO(raw), device=None)
    assert host.read() == data and host.host_unhinted_blocks == 3


def test_unhinted_spans_and_counters():
    raw = _stream(records(100 * KB, 4))
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        Reader(io.BytesIO(raw), device="cpu").readall()
        Reader(io.BytesIO(raw), device=None).readall()
    snap = trace.snapshot()
    trace.reset()
    assert snap["counters"]["decode.unhinted_blocks"] == 2
    assert snap["counters"]["decode.derived_lanes"] >= 2
    assert snap["counters"]["reader.host_unhinted_blocks"] == 2
    for name in ("decode.unhinted", "decode.derive"):
        assert snap["spans"][name]["count"] == 1
    assert snap["spans"]["decode.derive"]["parent"] == "decode.unhinted"


def _sound():
    return encode(records(20 * KB, 8), 2)


def _hostile():
    body, want = _sound()
    return {
        "truncated": ([body[:-3]], [want]),
        "cut_in_a_header": ([body + b"\xfe"], [want]),
        "overlong": ([body + b"\x00a"], [want]),
        "short_length": ([body], [want - 1]),
        "long_length": ([body], [want + 7]),
        "body_longer_than_output": ([body], [len(body) - 1]),
        "empty_body": ([b""], [want]),
    }


@pytest.mark.parametrize("case", sorted(_hostile()))
def test_hostile_bodies_raise(case):
    bodies, wants = _hostile()[case]
    with pytest.raises(CorruptError):
        exec_block.decode_blocks_unhinted(bodies, wants, device="cpu")
    with pytest.raises(CorruptError):
        oder.decode_lanes(bodies[0], wants[0], 4096)
    plan, _ = plan_of(bodies, wants, 4096)
    assert int(plan["bad"]) != 0


def mutated(seed: int, count: int):
    """``count`` (bodies, wants, seg) of a sound body with 1-3 bytes
    changed, cut short on some, its length off by a few on others."""
    rng = np.random.default_rng(seed)
    body0, want0 = _sound()
    out = []
    for _ in range(count):
        b = bytearray(body0)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        if rng.random() < 0.3:
            b = b[:rng.integers(1, len(b))]
        want = want0 + int(rng.integers(-3, 4)) if rng.random() < 0.3 \
            else want0
        out.append(([bytes(b)], [want], int(rng.choice([16, 100, 4096]))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_mutated_bodies_are_judged_as_the_walk_judges_them(seed):
    """The derivation finds a body unsound exactly where the sequential
    walk does, and cuts the sound ones as the walk does."""
    for bodies, wants, seg in mutated(seed, 20):
        try:
            lanes = oder.lane_table(bodies[0], wants[0], seg)
        except CorruptError:
            lanes = None
        plan, off = plan_of(bodies, wants, seg)
        assert (lanes is None) == (int(plan["bad"]) != 0)
        if lanes is not None:
            assert lane_tables(plan, off)[0] == lanes


@pytest.mark.parametrize("want", [0, 9 * MB])
def test_lengths_outside_the_format_raise(want):
    body, _ = _sound()
    with pytest.raises(CorruptError):
        exec_block.decode_blocks_unhinted([body], [want], device="cpu")


def test_reader_names_a_corrupt_unhinted_block_on_the_host():
    """The device finds the block unsound, the host decoder names it."""
    body, want = _sound()
    payload = bytes(4) + put_uvarint(want) + body[:-3]
    raw = MAGIC_CHUNK + b"\x06" + bytes([CHUNK_TYPE_MINLZ_COMPRESSED_CRC]) + \
        len(payload).to_bytes(3, "little") + payload
    r = Reader(io.BytesIO(raw), device="cpu", ignore_crc=True,
               ignore_missing_eof=True)
    with pytest.raises(CorruptError):
        r.read()
    assert r.host_unhinted_blocks == 1


def test_k1_with_lane_rep_of_one_is_k1():
    body, want = encode(records(12 * KB, 6), 2)
    plan, _ = plan_of([body], [want], 512)
    args = (plan["comp"], plan["lane_start"], plan["lane_len"])
    ones = torch.ones_like(plan["lane_rep"])
    for parse in (parse_segments_plain,
                  lambda *a, **k: parse_segments_model(*a, **k)[:2]):
        recs, counts = parse(*args)
        recs1, counts1 = parse(*args, lane_rep=ones)
        assert torch.equal(recs, recs1) and torch.equal(counts, counts1)
    # The derived offsets: the plain K1 and its token-level model agree.
    got = parse_segments_plain(*args, lane_rep=plan["lane_rep"])
    want_ = parse_segments_model(*args, lane_rep=plan["lane_rep"])[:2]
    assert torch.equal(got[0], want_[0]) and torch.equal(got[1], want_[1])


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=1)
def _card_cases():
    cases = {f"records_{lvl}": [encode(records(n, n + lvl), lvl)
                                for n in (64 * KB, 2 * MB, 300 * KB)]
             for lvl in LEVELS}
    cases["far_8mib"] = [encode(far_copies(8 * MB, 3), 2)]
    rng = np.random.default_rng(5)
    cases["long_literal"] = [encode(
        rng.integers(0, 256, 40 * KB, dtype=np.uint8).tobytes()
        + records(60 * KB, 5), 2)]
    cases.update({f"hostile_{k}": list(zip(*v))
                  for k, v in _hostile().items()})
    return cases


CARD_CASES = sorted([f"records_{lvl}" for lvl in LEVELS]
                    + ["far_8mib", "long_literal"]
                    + [f"hostile_{k}" for k in (
                        "truncated", "cut_in_a_header", "overlong",
                        "short_length", "long_length",
                        "body_longer_than_output", "empty_body")])


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [4096, 1000, 16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_derive_kernel_matches_plain(case, seg):
    dev = _card()
    bodies, wants = map(list, zip(*_card_cases()[case]))
    plan, _ = plan_of(bodies, wants, seg, dev)
    plain, _ = plan_of(bodies, wants, seg, "cpu")
    for k in derive.LANES + derive.RANGES + ("bad",):
        assert torch.equal(plan[k].cpu(), plain[k]), k
    if not case.startswith("hostile"):
        assert int(plan["bad"]) == 0


@pytest.mark.cuda
def test_derive_kernel_on_mutated_bodies():
    dev = _card()
    for bodies, wants, seg in mutated(7, 60):
        plan, _ = plan_of(bodies, wants, seg, dev)
        plain, _ = plan_of(bodies, wants, seg, "cpu")
        for k in derive.LANES + derive.RANGES + ("bad",):
            assert torch.equal(plan[k].cpu(), plain[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in CARD_CASES
                                  if not c.startswith("hostile")])
def test_unhinted_decode_on_the_card(case):
    dev = _card()
    bodies, wants = map(list, zip(*_card_cases()[case]))
    outs = exec_block.decode_blocks_unhinted(bodies, wants, device=dev)
    for out, body, want in zip(outs, bodies, wants):
        assert out == decode_block(b"\0" + put_uvarint(want) + body)


@pytest.mark.cuda
def test_k1_lane_rep_on_the_card():
    dev = _card()
    bodies, wants = map(list, zip(*_card_cases()["records_2"]))
    plan, _ = plan_of(bodies, wants, 4096, dev)
    from minlz_tpu_torch.ops.parse import parse_planned

    args = (plan["comp"], plan["lane_start"], plan["lane_len"])
    recs, counts = parse_planned(*args)
    recs1, counts1 = parse_planned(*args, torch.ones_like(plan["lane_rep"]))
    assert torch.equal(recs, recs1) and torch.equal(counts, counts1)
    recs, counts = parse_planned(*args, plan["lane_rep"])
    host = [t.cpu() for t in args]
    recs_p, counts_p, _ = parse_segments_model(
        *host, lane_rep=plan["lane_rep"].cpu())
    assert torch.equal(counts.cpu(), counts_p)
    assert torch.equal(recs.cpu(), recs_p)


@pytest.mark.cuda
def test_k1_empty_lanes_leave_their_neighbours_alone():
    """An empty lane (a derived plan holds one past every batch's lanes, and
    one where a literal run skips a window) writes only its own slot, after
    other launches have left the shared memory dirty: K1 with an empty
    lane after every lane of a derived plan equals its plain version, run
    after run."""
    dev = _card()
    bodies, wants = map(list, zip(*_card_cases()["records_2"]))
    plan, _ = plan_of(bodies, wants, 4096, dev)
    from minlz_tpu_torch.ops.parse import parse_planned

    start, length, rep = (plan[k].cpu() for k in (
        "lane_start", "lane_len", "lane_rep"))
    args = (plan["comp"],
            torch.stack([start, start + length], 1).reshape(-1).to(dev),
            torch.stack([length, torch.zeros_like(length)], 1)
            .reshape(-1).to(dev),
            torch.stack([rep, torch.ones_like(rep)], 1).reshape(-1).to(dev))
    recs_p, counts_p = parse_segments_plain(*(a.cpu() for a in args))
    body = torch.from_numpy(np.frombuffer(bodies[1], np.uint8).copy()).to(dev)
    off = torch.tensor([0, len(bodies[1])], dtype=torch.int64, device=dev)
    out_len = torch.tensor(wants[1:2], dtype=torch.int32, device=dev)
    for _ in range(40):
        # The whole-block executor's tiles leave their bytes in shared memory.
        exec_block.decode_unhinted(body, off, out_len, wants[1])
        recs, counts = parse_planned(*args)
        assert torch.equal(counts.cpu(), counts_p)
        assert torch.equal(recs.cpu(), recs_p)


@pytest.mark.cuda
def test_unhinted_decode_reads_nothing_back():
    dev = _card()
    bodies, wants = map(list, zip(*_card_cases()["records_2"]))
    lens = np.array([len(b) for b in bodies], np.int64)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(dev)
    comp = torch.from_numpy(np.frombuffer(b"".join(bodies), np.uint8)
                            .copy()).to(dev)
    out_len = torch.tensor(wants, dtype=torch.int32, device=dev)
    exec_block.decode_unhinted(comp, off, out_len, sum(wants))  # built
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, bad = exec_block.decode_unhinted(comp, off, out_len, sum(wants))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(bad) == 0
    assert out.cpu().numpy().tobytes() == b"".join(
        decode_block(b"\0" + put_uvarint(w) + b) for b, w in
        zip(bodies, wants))


@pytest.mark.cuda
def test_card_reader_decodes_a_host_written_stream():
    _card()
    data = records(3 * MB, 12)
    raw = _stream(data, block=2 * MB)
    codec = get_device_codec("cuda")
    before = codec.blocks_decoded
    r = Reader(io.BytesIO(raw), device="cuda")
    assert r.readall() == data
    assert r.host_unhinted_blocks == 0 and r.hint_fallbacks == 0
    assert codec.blocks_decoded - before == 2
