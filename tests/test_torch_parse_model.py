"""The token-level model of K1 (minlz_tpu_torch.ops.parse_model) against the
byte-step plain version (parse.parse_segments_plain): all seven record
fields, the counts and the zero tails, exactly, at window sizes 64, 256 and
the kernel's own, so that literal runs, held runs, repeat offsets and record
slots cross many windows.  A subset also against the JAX transducer parse
(minlz_tpu.ops.decode_kernel.parse_segments_scan).  Tolerance 0: every
compared value is an integer."""

import functools

import numpy as np
import pytest
import torch

from minlz_tpu.ops.decode_kernel import pack_segments, parse_segments_scan
from minlz_tpu_torch.ops import parse as tparse
from minlz_tpu_torch.ops import parse_model as pm
from minlz_tpu_torch.ops.device_codec import RANGE
from minlz_tpu_torch.oracle import encode as oenc
from minlz_tpu_torch.testing import mutate

from conftest import TESTDATA
from test_torch_common import encode_segs

WINDOWS = (64, 256, pm.WINDOW)
LEVELS = (-1, 1, 2, 3)


def lanes_of(segs):
    lens = np.array([len(s) for s in segs], np.int32)
    start = (np.cumsum(lens) - lens).astype(np.int32)
    comp = np.frombuffer(b"".join(segs) or b"\x00", np.uint8).copy()
    return (torch.from_numpy(comp), torch.from_numpy(start),
            torch.from_numpy(lens))


def _twain() -> bytes:
    with open(f"{TESTDATA}/Mark.Twain-Tom.Sawyer.txt", "rb") as f:
        return f.read()


def _corpus_lanes():
    """16 KiB of the text at every level, in 4 KiB segments with the range
    clamp and in 16 KiB segments without it."""
    data = _twain()[5000:5000 + (16 << 10)]
    segs = []
    for level in LEVELS:
        segs += encode_segs(data, 4096, RANGE, level)
        segs += encode_segs(data, 16 << 10, 0, level)
    return segs


def _mutated_lanes():
    rng = np.random.default_rng(7)
    base = encode_segs(_twain()[:24 << 10], 4096, RANGE)
    segs = []
    for seed in range(3):
        for s in base:
            for _ in range(1 + seed):
                s = mutate(rng, s)
            segs.append(s)
    return segs


def _random_lanes():
    """Seeded random bytes, and random copy tokens only (no literal run to
    end the chain early), at lengths around the window sizes."""
    rng = np.random.default_rng(3)
    segs = []
    for n in (0, 1, 2, 3, 5, 63, 64, 65, 255, 256, 257, 1000, 2500):
        segs.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        b = rng.integers(0, 256, n, dtype=np.uint8)
        b |= (b & 3 == 0) * rng.integers(1, 4, n, dtype=np.uint8)
        segs.append(b.tobytes())
    return segs


def _truncated_lanes(follow):
    """Every first byte 0-255, followed by each truncation of 0-8 bytes."""
    return [bytes([b]) + follow[:t] for b in range(256) for t in range(9)]


def _crafted_lane(k: int) -> bytes:
    """Literal runs and RLE copies that cross windows, held runs fused into
    the next copy, repeats whose offset was set windows earlier, pending
    copies (Fused2, Copy3 with literals), and every length extension."""
    rng = np.random.default_rng(k)
    dst = bytearray()
    oenc.emit_literals(dst, rng.integers(0, 256, 300, np.uint8).tobytes())
    oenc.emit_copy1(dst, 17, 12)
    for i in range(40):
        oenc.emit_literals(dst, bytes([i, i + 1, i + 2][: 1 + i % 3]))
        if i % 4 == 0:
            oenc.emit_repeat(dst, 5 + i)
        elif i % 4 == 1:
            oenc.emit_copy2(dst, 2000 + i, 4 + 20 * i)
        elif i % 4 == 2:
            oenc.emit_fused2(dst, b"AB", 300 + i, 7)
        else:
            oenc.emit_copy3(dst, 70000 + i, 40 + i, b"xyz"[: i % 4])
    oenc.emit_repeat(dst, 70000)
    oenc.emit_literals(dst, b"Q" * 700)
    oenc.emit_copy3(dst, 76000, 80)
    oenc.emit_copy1(dst, 1000, 270)
    oenc.emit_literals(dst, b"Z" * (40 + k))
    return bytes(dst)


def _crafted_lanes():
    lanes = [_crafted_lane(k) for k in range(3)]
    # Cut short inside a header, inside a literal run, inside a pending
    # copy's literals, and after a held run.
    full = lanes[0]
    lanes += [full[:n] for n in (1, 2, 301, 302, 303, 307, 310, 500,
                                 len(full) - 30, len(full) - 1)]
    return lanes + [b"", b"\x00"]


INPUTS = {
    "corpus": _corpus_lanes,
    "mutated": _mutated_lanes,
    "random": _random_lanes,
    "truncated_random": lambda: _truncated_lanes(
        np.random.default_rng(1).integers(0, 256, 8, np.uint8).tobytes()),
    "truncated_ff": lambda: _truncated_lanes(b"\xff" * 8),
    "crafted": _crafted_lanes,
    "empty_and_one": lambda: [b"", b"\x01", b"", b"\xfc", b"\x00"],
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(lane tensors, the plain version's recs and counts), once a name."""
    args = lanes_of(INPUTS[name]())
    return args, tparse.parse_segments_plain(*args)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_model_equals_plain(name, window):
    args, (recs_p, counts_p) = _case(name)
    recs, counts, info = pm.parse_segments_model(*args, window=window)
    assert torch.equal(counts, counts_p)
    assert torch.equal(recs, recs_p)
    # Every record was placed: the slots past each lane's count are zero.
    lens = args[2].to(torch.int64)
    slot0 = args[1].to(torch.int64) + torch.arange(lens.numel())
    used = torch.zeros(recs.shape[1], dtype=torch.bool)
    for s0, c in zip(slot0.tolist(), counts.tolist()):
        used[s0:s0 + c] = True
    assert not recs[:, ~used].any()
    assert bool((recs[0, used] > 0).all())
    assert info["tokens"] >= int(counts.sum()) - lens.numel()
    if name == "corpus" and window == 64:
        assert info["windows"] > 4 * lens.numel()


@pytest.mark.parametrize("name", ["truncated_ff", "crafted", "random"])
def test_model_equals_jax_scan(name):
    """The model's records against the non-zero rows of the JAX lax.scan
    transducer, lane by lane."""
    segs = INPUTS[name]()
    mat, lens = pack_segments(segs)
    em = [np.asarray(e) for e in parse_segments_scan(mat, lens)]
    args = lanes_of(segs)
    recs, counts, _ = pm.parse_segments_model(*args, window=64)
    recs = recs.numpy()
    for lane in range(len(segs)):
        sel = em[0][:, lane] > 0
        want = np.stack([e[sel, lane] for e in em])
        s0 = int(args[1][lane]) + lane
        got = recs[:, s0:s0 + int(counts[lane])]
        np.testing.assert_array_equal(got, want, err_msg=f"lane {lane}")


def test_chain_counts_hops_and_windows():
    """Tokens of a lane of one-byte Copy1 tokens without extension: each is
    2 bytes, so a lane of 1000 bytes is 500 hops and 8 windows of 64."""
    segs = [bytes([1 | (3 << 2), 9]) * 500]
    recs, counts, info = pm.parse_segments_model(*lanes_of(segs), window=64)
    assert info == {"tokens": 500, "windows": 16, "max_tokens": 32}
    assert int(counts[0]) == 500
    assert recs[2, :500].tolist() == [7] * 500


def test_window_must_be_positive():
    with pytest.raises(ValueError, match="window"):
        pm.parse_segments_model(*lanes_of([b"\x00"]), window=0)
