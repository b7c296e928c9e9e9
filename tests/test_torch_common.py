"""Shared inputs of the test_torch_* files: one numpy array, made from a
seed, handed to the JAX function (jnp.asarray) and to the port
(torch.from_numpy), so both sides see the same bytes.  Tolerance 0: every
compared value is an integer."""

import numpy as np
import torch

from minlz_tpu_torch.ops import encode_kernel as tek

SEG = 4096
WIN2 = 2 * tek.WINDOW


def both(*arrays):
    """(jax arrays, torch tensors) of the same numpy arrays."""
    import jax.numpy as jnp  # the card-only tests run without jax

    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def pad_block(data: bytes, seg: int = SEG):
    """[1, N] int32 zero-padded block at the emit geometry, and its length."""
    n = len(data)
    N = -(-max(n, 1) // seg) * seg
    N = -(-N // WIN2) * WIN2
    flat = np.zeros((1, N), np.int32)
    flat[0, :n] = np.frombuffer(data, np.uint8)
    return flat, n


def real_proposals(data: bytes, seg: int = SEG, rng: int = 0, level: int = 2):
    """Match proposals of a real block, as [nseg, seg] int32 arrays."""
    flat, n = pad_block(data, seg)
    dist, length = tek.find_matches_dyn(torch.from_numpy(flat), [n], seg,
                                        rng, level)
    return (dist.numpy().astype(np.int32).reshape(-1, seg),
            length.numpy().astype(np.int32).reshape(-1, seg))


def random_proposals(seed: int, lanes: int, seg: int, hostile: bool):
    """Random proposals.  Tame: short lengths around the take threshold.
    Hostile: any int32, with negative and huge lengths and offsets, and
    runs of equal offsets so that is_rep fires."""
    rng = np.random.default_rng(seed)
    if not hostile:
        off = rng.integers(0, 6, (lanes, seg)).astype(np.int32)
        length = rng.integers(0, 12, (lanes, seg)).astype(np.int32)
        return off, length
    info = np.iinfo(np.int32)
    off = rng.integers(info.min, info.max, (lanes, seg), dtype=np.int64)
    length = rng.integers(info.min, info.max, (lanes, seg), dtype=np.int64)
    small = rng.random((lanes, seg)) < 0.7
    length = np.where(small, rng.integers(-3, 40, (lanes, seg)), length)
    off = np.where(rng.random((lanes, seg)) < 0.5,
                   rng.integers(-1, 3, (lanes, seg)), off)
    length[:, -1] = info.max
    length[0, 0] = info.max
    length[1, 0] = info.min
    return off.astype(np.int32), length.astype(np.int32)


def greedy_reference(off, length):
    """The greedy state machine, position by position, in Python ints."""
    lanes, seg = off.shape
    out = np.zeros((4, lanes, seg), np.int32)
    for b in range(lanes):
        skip, rep = 0, -1
        for r in range(seg):
            o, l = int(off[b, r]), int(length[b, r])
            if skip == 0 and l >= 4:
                out[:, b, r] = (1, o, l, int(o == rep))
                skip, rep = l - 1, o
            else:
                skip = max(skip - 1, 0)
    return out


GREEDY_WINDOWS = (64, 256, 512, 4096)


def greedy_edge_cases(seg: int, windows=GREEDY_WINDOWS):
    """Proposals made to corner the greedy chain, [lanes, seg] int32 each,
    from a seed: no candidate at all; every length exactly 4 (the longest
    chain); a first token whose offset is -1 (the initial rep); a length of
    2^31 - 1 at the first and at the last position; lengths of -2^31; for
    each window size, tokens ending exactly on every window boundary and a
    token that crosses two boundaries."""
    rng = np.random.default_rng(seg)
    info = np.iinfo(np.int32)

    def tame(lanes):
        return (rng.integers(-1, 3, (lanes, seg)).astype(np.int32),
                rng.integers(0, 12, (lanes, seg)).astype(np.int32))

    def fours(lanes):
        return (rng.integers(-1, 3, (lanes, seg)).astype(np.int32),
                np.full((lanes, seg), 4, np.int32))

    cases = {}
    off = rng.integers(info.min, info.max, (3, seg), dtype=np.int64)
    cases["no_candidates"] = (off.astype(np.int32),
                              rng.integers(-5, 4, (3, seg)).astype(np.int32))
    cases["every_length_4"] = fours(3)
    off, length = tame(3)
    off[:, 0], length[:, 0] = -1, 5
    off[2, :8] = -1
    cases["first_off_minus_one"] = (off, length)
    off, length = tame(2)
    length[:, 0] = info.max
    cases["max_len_first"] = (off, length)
    off, length = tame(3)
    length[:, -1] = info.max
    length[2] = np.minimum(length[2], 3)
    length[2, -1] = info.max
    cases["max_len_last"] = (off, length)
    off, length = tame(3)
    length[rng.random((3, seg)) < 0.3] = info.min
    length[:, 0] = info.min
    cases["min_len"] = (off, length)
    ends, crosses = [], []
    for w in windows:
        if w < seg:
            off, length = fours(1)
            length[0, w - 8::w] = 8
            ends.append((off, length))
        if 3 * w < seg:
            off, length = fours(1)
            length[0, w - 4] = 2 * w + 8
            crosses.append((off, length))
    for name, lanes in (("ends_on_window_boundary", ends),
                        ("crosses_two_windows", crosses)):
        if lanes:
            cases[name] = tuple(np.concatenate(a) for a in zip(*lanes))
    return cases


# The corpora of tests/test_emit.py, made from the Twain text and a
# generator.
EMIT_CORPORA = {
    "text": lambda t, r: (t * 6)[: 64 * 1024],
    "runs": lambda t, r: (b"abcabc" * 150 + bytes(400) + b"zz" * 600) * 16,
    "lowent": lambda t, r: r.integers(0, 8, 64 * 1024, np.uint8).tobytes(),
    "partial_tail": lambda t, r: (t * 2)[:20000],
    "json": lambda t, r: b"".join(
        b'{"k":%d,"v":"%s"}\n' % (i, bytes(t[i % 97 : i % 97 + 9]))
        for i in range(3000)
    ),
}


def emit_corpus(twain, name):
    return EMIT_CORPORA[name](twain, np.random.default_rng(11))


# Token layouts that corner emit_segments (the CUDA kernel walks a row in
# tiles of 1024 positions, so several fall on or cross multiples of 1024).
EMIT_CASES = ("lit_runs", "rep_across_tiles", "fused", "copy1_long",
              "copy3_far", "random_mix")


def _row_tokens(name, seg_n, rng):
    """(pos, off, len) tokens of one segment row of seg_n valid bytes,
    ascending and not overlapping; each len >= 4 and pos + len <= seg_n.
    Each row takes the case's (literals, offset, length) triples in an
    order of its own, so that the rows of a case cover all of them."""
    if name == "rep_across_tiles":
        # Equal offsets on both sides of every multiple of 1024: a repeat
        # right at the boundary, one after 4 literals, one after a token
        # that crosses the boundary.
        want = [(0, 777, 9)]
        for b in range(1024, seg_n + 1024, 1024):
            want += [(b - 8, 777, 8), (b, 777, 5), (b + 9, 777, 6),
                     (b + 100, 3000, 20), (b + 1000, 3000, 40),
                     (b + 1040, 3000, 9)]
        return _fit(want, seg_n)
    if name == "lit_runs":
        # Literal runs of 1-5, 29/30, 285/286 and 2000 (longer than a tile)
        # before copy1, copy2 and copy3 tokens; the flush follows.
        triples = [(nl, off, 12) for nl in (29, 30, 285, 286, 1, 2, 3, 4, 5,
                                            0, 2000)
                   for off in (5, 1000, 5000, 70000)]
    elif name == "fused":
        # fused2 with 1-4 literals and lengths 4-300 (an extension above
        # 11), fused3 with 1-3 literals; 4 literals at a copy3 offset and
        # offsets below 64 are not fused.
        triples = [(nl, off, ln) for nl in (1, 2, 3, 4)
                   for off in (63, 64, 65, 1024, 1025, 65599, 65600, 100000)
                   for ln in (4, 7, 11, 12, 40, 300)]
    elif name == "copy1_long":
        # copy1 on both sides of 18 and 273 (a repeat extension above it),
        # with and without literals before it.
        triples = [(nl, off, ln)
                   for ln in (4, 18, 19, 273, 274, 285, 286, 302, 600, 2000)
                   for nl in (0, 7) for off in (1, 64, 1024)]
    elif name == "copy3_far":
        # copy3 offsets whose word wraps int32 (near and past 2^21 + 65536),
        # at lengths on both sides of 64 and 319 (one and two extension
        # bytes), fused (1-3 literals) and not.
        triples = [(nl, off, ln)
                   for off in (65600, 70000, (1 << 21) + 65535, 1 << 21,
                               (1 << 21) + 65537, 8 << 20)
                   for ln in (8, 64, 65, 319, 320, 1000)
                   for nl in (0, 2, 9)]
    else:  # random_mix: a fifth of the takes repeat the previous offset
        triples, prev = [], 1
        for _ in range(seg_n // 4):
            off = prev if rng.random() < 0.2 else int(rng.choice(
                [rng.integers(1, 1025), rng.integers(64, 65600),
                 rng.integers(65600, 4 << 20)]))
            triples.append((int(rng.choice([0, 0, 1, 2, 3, 4, 5, 12, 40,
                                            300])),
                            off, int(rng.choice([4, 5, 8, 13, 30, 100, 280,
                                                 1500]))))
            prev = off
    if name != "random_mix":
        triples = [triples[i] for i in rng.permutation(len(triples))]
    want, cur = [], 0
    for nl, off, ln in triples:
        want.append((cur + nl, off, ln))
        cur += nl + ln
    return _fit(want, seg_n)


def _fit(want, seg_n):
    out, end = [], 0
    for pos, off, ln in want:
        if pos >= end and pos + ln <= seg_n:
            out.append((pos, off, ln))
            end = pos + ln
    return out


def emit_edge_case(name: str, seg: int):
    """Verified parse arrays for ``name`` of EMIT_CASES, from a seed: (data
    [B, N] uint8, surv, off, vlen [B, N] int32, n [B] int32), three blocks
    of four segments: a whole one, one whose last segment is partial and
    one whose last two segments are empty.  The tokens need not match the
    bytes: emission copies what it is given."""
    rng = np.random.default_rng(sum(map(ord, name)) + seg)
    nseg = 4
    N = nseg * seg
    ns = np.array([N, N - seg // 3, 2 * seg - 777], np.int32)
    B = len(ns)
    data = rng.integers(0, 256, (B, N), dtype=np.uint8)
    surv, off, vlen = (np.zeros((B, N), np.int32) for _ in range(3))
    for b in range(B):
        for s in range(nseg):
            seg_n = int(min(max(ns[b] - s * seg, 0), seg))
            for pos, o, ln in _row_tokens(name, seg_n, rng):
                at = s * seg + pos
                surv[b, at], off[b, at], vlen[b, at] = 1, o, ln
    return data, surv, off, vlen, ns


def encode_segs(data: bytes, seg: int, rng: int, level: int = 2):
    """The port's CPU encode of one block, checked against the oracle, as
    the list of its segments' compressed bytes."""
    from minlz_tpu_torch.oracle import decode as odec
    from minlz_tpu_torch.ops.device_codec import split_body

    block, hints = tek.encode_block_device(data, seg, rng, level, "cpu")
    assert odec.decode_block(block) == data
    _, _, pos = odec.parse_header(block)
    return split_body(block[pos:], [h[0] for h in hints])


def dense_ops_to_records(ops, counts, pc: int, guard: int, lane_start):
    """The JAX package's ``compact_ops_dense`` words -> the port's
    append-only records.  ops: [nchain, cap_chain, 3] int32 (llen | clen <<
    14, csrc, guard + lane * pc + lsrc); counts: the real record count of
    every chain; lane_start: the port's [lanes] offsets of the lanes'
    compressed bytes.  Returns [4, total] int32 (llen, clen, csrc, lit),
    chain after chain."""
    ops = np.asarray(ops)
    rows = np.concatenate([ops[ch, :n] for ch, n in enumerate(counts)])
    a, b, c = rows[:, 0], rows[:, 1], rows[:, 2]
    lane, lsrc = np.divmod(c - guard, pc)
    lit = np.asarray(lane_start, np.int64)[lane] + lsrc
    return np.stack([a & 0x3FFF, (a >> 14) & 0x3FFF, b, lit]).astype(np.int32)


def chunks(raw: bytes):
    """(offset, type, payload length) of every chunk of a stream."""
    out, pos = [], 0
    while pos + 4 <= len(raw):
        clen = int.from_bytes(raw[pos + 1:pos + 4], "little")
        out.append((pos, raw[pos], clen))
        pos += 4 + clen
    assert pos == len(raw)
    return out


class Decoded:
    """Blocks the codec decoded on the device inside a ``with``."""

    def __init__(self, codec):
        self.codec = codec

    def __enter__(self):
        self.before = self.codec.blocks_decoded
        return self

    def __exit__(self, *exc):
        self.n = self.codec.blocks_decoded - self.before


def test_dense_ops_to_records_undoes_the_arena_offset():
    ops = np.zeros((2, 4, 3), np.int32)
    ops[0, 0] = (5 | (9 << 14), 3, 512 + 0 * 1024 + 7)
    ops[1, 0] = (0 | (40 << 14), 1, 512 + 2 * 1024 + 100)
    ops[1, 1] = (300, 1, 512 + 3 * 1024)
    got = dense_ops_to_records(ops, [1, 2], 1024, 512, [0, 50, 80, 200])
    want = np.array([[5, 0, 300], [9, 40, 0], [3, 1, 1], [7, 180, 200]])
    np.testing.assert_array_equal(got, want)


def test_helpers_hand_over_the_same_values():
    off, length = random_proposals(0, 4, 64, hostile=True)
    (joff, jlen), (toff, tlen) = both(off, length)
    np.testing.assert_array_equal(np.asarray(joff), toff.numpy())
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    assert length.min() < 0 and length.max() == np.iinfo(np.int32).max
