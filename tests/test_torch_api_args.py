"""The port's functions called with the JAX package's arguments, against
the JAX functions on the same inputs: execute_ops_host on the scan layout
(ops/decode_kernel.py), find_matches_dyn's exact mode
(ops/encode_kernel.py), parse_step without a flush row
(ops/transducer.py), and the stream classes' bool ``device``.  Inputs are
Twain, the corpus mix (make_corpus) and mutated copies of it, and a block of
4-byte values of 2^31 and more, all encoded by the port or made from a seed
with numpy.  Tolerance 0: integers and bytes."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minlz_tpu.ops import decode_kernel as jdk
from minlz_tpu.ops import encode_kernel as jek
from minlz_tpu.ops import transducer as jtr
from minlz_tpu_torch import _device
from minlz_tpu_torch.corpus import make_corpus
from minlz_tpu_torch.ops import decode_kernel as tdk
from minlz_tpu_torch.ops import encode_kernel as tek
from minlz_tpu_torch.ops import transducer as ttr
from minlz_tpu_torch.stream import Reader, Writer, compress
from minlz_tpu_torch.testing import mutate

from test_torch_common import encode_segs, pad_block

SEG = 4096


# ---- execute_ops_host: the scan layout, JAX's arguments ---------------------

def _twain_pieces(twain):
    """Four 4 KiB pieces of Twain."""
    return [twain[i * 3000:i * 3000 + SEG] for i in range(4)]


def _twain_segs(twain):
    """Four 4 KiB pieces of Twain, each a block of one segment."""
    return [encode_segs(p, SEG, 0)[0] for p in _twain_pieces(twain)]


def _mutated_segs(twain):
    rng = np.random.default_rng(18)
    out = []
    for s in _twain_segs(twain):
        for _ in range(3):
            s = mutate(rng, s)
        out.append(s)
    return out


def _outcome(fn):
    try:
        return fn()
    except ValueError as exc:
        return type(exc), str(exc)


@pytest.mark.parametrize("case", ["twain", "mutated"])
def test_execute_ops_host_takes_the_scan_layout(twain, case):
    """execute_ops_host(*parse_segments_scan(...)[:6], mat, out_lens), the
    JAX package's own decode, on the port equals it on JAX: the batch, and
    for mutated lanes each lane alone too (one that raises spoils the
    batch: the same error on both)."""
    segs = (_twain_segs if case == "twain" else _mutated_segs)(twain)
    results = []
    alone = [[s] for s in segs] if case == "mutated" else []
    for lane in [segs] + alone:
        mat, lens = tdk.pack_segments(lane)
        jmat, jlens = jdk.pack_segments(lane)
        np.testing.assert_array_equal(mat, jmat)
        np.testing.assert_array_equal(lens, jlens)
        out_lens = [SEG] * len(lane)
        jemits = jdk.parse_segments_scan(jnp.asarray(mat), jnp.asarray(lens))
        temits = tdk.parse_segments_scan(torch.from_numpy(mat),
                                         torch.from_numpy(lens))
        want = _outcome(lambda: jdk.execute_ops_host(*jemits[:6], mat,
                                                     out_lens))
        got = _outcome(lambda: tdk.execute_ops_host(*temits[:6], mat,
                                                    out_lens))
        assert got == want
        # The JAX scan's arrays, as numpy, give the port's walk the same.
        assert _outcome(lambda: tdk.execute_ops_host(
            *(np.asarray(x) for x in jemits[:6]), mat, out_lens)) == want
        results.append(got)
    if case == "twain":
        assert results == [_twain_pieces(twain)]


def test_decode_segments_jnp_on_twain(twain):
    segs = _twain_segs(twain)
    want = jdk.decode_segments_jnp(segs, [SEG] * len(segs))
    assert tdk.decode_segments_jnp(segs, [SEG] * len(segs), "cpu") == want


def test_the_record_walk_is_the_ports_own_layout(twain):
    """execute_records_host, the walker of the port's records, decodes the
    same segments from pack_lanes and the dense parse."""
    segs = _twain_segs(twain)
    data = b"".join(_twain_pieces(twain))
    assert tdk.decode_segments(segs, len(data), SEG) == data
    comp, start, lens = tdk.pack_lanes(segs)
    assert bytes(comp[start[2]:start[2] + lens[2]]) == segs[2]


# ---- find_matches_dyn(exact=True) ------------------------------------------

_jax_find = jax.jit(jek.find_matches_dyn,
                    static_argnames=("seg", "rng", "level", "exact"))


def _high_block():
    """A block of 4-byte values of 2^31 and more (every byte >= 0x80): a
    seeded 256-byte alphabet of such bytes, repeated with mutations, so
    that the sorts carry values whose int32 wrap is negative."""
    rng = np.random.default_rng(31)
    pat = rng.integers(0x80, 0x100, 256, dtype=np.uint8)
    reps = np.tile(pat, 96)
    flips = rng.integers(0, len(reps), 600)
    reps[flips] = rng.integers(0x80, 0x100, len(flips), dtype=np.uint8)
    return reps[: 24 << 10].tobytes()


BLOCKS = {
    "twain": lambda t: t[: 24 << 10],
    "corpus": lambda t: make_corpus(64 << 10)[16 << 10:40 << 10],
    "high": lambda t: _high_block(),
}


@pytest.mark.parametrize("level", [-1, 1, 2, 3])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_find_matches_dyn_exact_matches_jax(twain, block, level):
    data = BLOCKS[block](twain)
    flat, n = pad_block(data)
    if block == "high":
        v0 = (flat[0, :n - 3].astype(np.int64)
              | flat[0, 1:n - 2].astype(np.int64) << 8
              | flat[0, 2:n - 1].astype(np.int64) << 16
              | flat[0, 3:n].astype(np.int64) << 24)
        assert (v0 >= 1 << 31).all()
    want = _jax_find(jnp.asarray(flat), n, SEG, 0, level, exact=True)
    got = tek.find_matches_dyn(torch.from_numpy(flat), [n], SEG, 0, level,
                               exact=True)
    for g, w in zip(got, want):
        assert g.shape == flat.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] > 0).sum()) > 100


def test_exact_only_keeps_candidates_of_equal_bytes(twain):
    """Every short-tier proposal of the exact mode points at the same four
    bytes (level -1 runs the short tier alone), where the hash-only mode
    proposes some that only share the 16-bit hash."""
    data = (twain * 2)[: 64 << 10]
    flat, n = pad_block(data)
    t = torch.from_numpy(flat)
    b = np.frombuffer(data, np.uint8)

    v = (b[:-3].astype(np.int64) | b[1:-2].astype(np.int64) << 8
         | b[2:-1].astype(np.int64) << 16 | b[3:].astype(np.int64) << 24)

    def false_hits(dist):
        d = dist[0, :n - 3].numpy()
        pos = np.nonzero(d > 0)[0]
        return int((v[pos] != v[pos - d[pos]]).sum())

    exact, _ = tek.find_matches_dyn(t, [n], SEG, 0, -1, exact=True)
    fast, _ = tek.find_matches_dyn(t, [n], SEG, 0, -1)
    assert false_hits(exact) == 0
    assert false_hits(fast) > 0


# ---- parse_step: JAX's default flush ---------------------------------------

def test_parse_step_without_a_flush_row():
    rng = np.random.default_rng(5)
    lanes = 16
    st_t, st_j = ttr.init_state(lanes, "cpu"), jtr.init_state((lanes,))
    for row in range(40):
        byte = rng.integers(0, 256, lanes).astype(np.int32)
        active = rng.random(lanes) < 0.9
        r = np.full(lanes, row, np.int32)
        st_t, emit_t = ttr.parse_step(st_t, torch.from_numpy(byte),
                                      torch.from_numpy(active),
                                      torch.from_numpy(r))
        st_j, emit_j = jtr.parse_step(st_j, jnp.asarray(byte),
                                      jnp.asarray(active), jnp.asarray(r))
        for g, w in zip(emit_t, emit_j):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in st_j:
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]))


# ---- the stream classes' bool device ----------------------------------------

def test_stream_device_reads_jax_bools(twain):
    assert _device.stream_device(False) is None
    assert _device.stream_device(True) == "cuda"
    assert _device.stream_device("cpu") == "cpu"
    host = compress(twain, device=None)
    assert compress(twain, device=False) == host
    assert Reader(io.BytesIO(host), device=False).codec is None
    assert Writer(io.BytesIO(), device=False).codec is None
    assert Reader(io.BytesIO(host), device=False).readall() == twain


def test_a_bool_is_no_torch_device():
    with pytest.raises(TypeError, match="bool|True"):
        _device.resolve_device(True)
    with pytest.raises(TypeError):
        _device.resolve_device(False)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device=True is the card")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Reader(io.BytesIO(b""), device=True)
