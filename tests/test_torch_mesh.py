"""Mesh parity: minlz_tpu_torch.parallel on two and on four gloo ranks
(``device="cpu"``, spawned by ``parallel.ranks.run``) against
minlz_tpu.parallel on the conftest's 8-device CPU mesh, with the same
seeded numpy blocks.  Each rank hands in its contiguous share of the
blocks, as ``P("blocks")`` splits them; the shares' outputs, put back in
rank order, equal the JAX outputs exactly (tolerance 0: every value is an
integer or a byte), and do not depend on the number of ranks.  The
Writer(mesh=) stream equals the JAX Writer(device=True, mesh=...) stream and
the port's own Writer(device_emit=True) stream."""

import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minlz_tpu import parallel as jpar
from minlz_tpu.oracle import encode as oenc
from minlz_tpu.oracle.decode import parse_header
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch.minlz import put_uvarint
from minlz_tpu_torch.native.codec import get_codec
from minlz_tpu_torch.ops import emit
from minlz_tpu_torch.oracle import decode as odec
from minlz_tpu_torch.parallel import assemble_blocks, mesh as tmesh, ranks
from minlz_tpu_torch.stream import Reader, Writer

SEG = 4096
NB = 8              # blocks: one per device of the JAX mesh
STEP_BLOCK = 16384  # the pipeline step's blocks
ENC_BLOCK = 16384   # the encode's blocks (window-padded)
DICT_LEN = 4 * SEG
DICT_BLOCK = 16384  # [dict || block] is one 32 KiB window pair
STREAM_BLOCK = 16 << 10
STREAM_BYTES = 96 << 10
RANK_TIMEOUT = 240


def _inputs(twain):
    rng = np.random.default_rng(42)
    step = rng.integers(0, 64, (NB, STEP_BLOCK)).astype(np.int32)
    step_n = np.full(NB, STEP_BLOCK, np.int32)
    step_n[-1] = STEP_BLOCK - 1000  # one short block

    enc = np.zeros((NB, ENC_BLOCK), np.int32)
    enc_n = np.full(NB, ENC_BLOCK, np.int32)
    for b in range(NB):
        d = bytearray((twain[b * 977:] + twain * 3)[:ENC_BLOCK])
        for _ in range(8):
            d[int(rng.integers(0, ENC_BLOCK))] = int(rng.integers(32, 127))
        enc[b] = np.frombuffer(bytes(d), np.uint8)
    enc_n[3] = 5000  # a partial block: its tail stays zero padding
    enc[3, 5000:] = 0

    # Decode parse: two compressed segments per block, of differing sizes.
    segs = []
    for b in range(NB):
        lo = (twain * 2)[b * 1500:b * 1500 + 3000 + 400 * b]
        hi = bytes(rng.integers(65, 70, 2000 + 100 * b, dtype=np.uint8))
        row = []
        for data in (lo, hi):
            blk = oenc.encode_block(data)
            _, _, pos = parse_header(blk)
            row.append(np.frombuffer(blk[pos:], np.uint8))
        segs.append(row)
    P = 1 << max(len(s) for row in segs for s in row).bit_length()
    mat = np.zeros((NB, P, 2), np.int32)
    lens = np.zeros((NB, 2), np.int32)
    for b, row in enumerate(segs):
        for s, a in enumerate(row):
            mat[b, : len(a), s] = a
            lens[b, s] = len(a)

    dict_bytes = (twain * 4)[:DICT_LEN]
    dblocks = np.zeros((NB, DICT_BLOCK), np.int32)
    for b in range(NB):
        d = bytearray((twain[b * 131:] + twain * 4)[:DICT_BLOCK])
        for _ in range(32):
            d[int(rng.integers(0, DICT_BLOCK))] = int(rng.integers(32, 127))
        dblocks[b] = np.frombuffer(bytes(d), np.uint8)
    dn = np.full(NB, DICT_BLOCK, np.int32)

    payload = (twain * 12)[:STREAM_BYTES]
    return dict(step=step, step_n=step_n, enc=enc, enc_n=enc_n, mat=mat,
                lens=lens, dict=np.frombuffer(dict_bytes, np.uint8),
                dblocks=dblocks, dn=dn, payload=payload)


@pytest.fixture(scope="module")
def inputs(twain):
    return _inputs(twain)


def _shares(world, *arrays):
    """Per-rank argument tuples: each array split into ``world``
    contiguous shares."""
    local = NB // world
    return [tuple(a[r * local:(r + 1) * local] for a in arrays)
            for r in range(world)]


CALLS = ("step", "encode", "encode_nocoll", "parse", "dict", "stream")


def _calls(world, x):
    stream_opts = dict(block_size=STREAM_BLOCK, add_index=False,
                       concurrency=1)
    return [
        (partial(tmesh.sharded_pipeline_step, seg=SEG),
         _shares(world, x["step"], x["step_n"])),
        (partial(tmesh.sharded_encode_blocks, seg=SEG),
         _shares(world, x["enc"], x["enc_n"])),
        (partial(tmesh.sharded_encode_blocks, seg=SEG, collectives=False),
         _shares(world, x["enc"], x["enc_n"])),
        (tmesh.sharded_decode_parse, _shares(world, x["mat"], x["lens"])),
        (partial(tmesh.sharded_encode_blocks_dict, seg=SEG),
         [(x["dict"],) + s for s in _shares(world, x["dblocks"], x["dn"])]),
        (ranks.write_stream, [(x["payload"], stream_opts)] * world),
    ]


WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(inputs):
    """{world: {call: [rank results]}}, one spawn of gloo ranks a world."""
    out = {}
    for world in WORLDS:
        res = ranks.run(_calls(world, inputs), world, backend="gloo",
                        devices="cpu", timeout=RANK_TIMEOUT)
        out[world] = dict(zip(CALLS, res))
    return out


@pytest.fixture(params=WORLDS, ids=["2ranks", "4ranks"])
def port(request, runs):
    return request.param, runs[request.param]


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(jax.devices())


def _cat(per_rank, i):
    """Output i of every rank, back in global block order."""
    return np.concatenate([r[i] for r in per_rank])


@pytest.fixture(scope="module")
def jax_step(jmesh, inputs):
    return [np.asarray(a) for a in jpar.sharded_pipeline_step(
        jmesh, jnp.asarray(inputs["step"]), jnp.asarray(inputs["step_n"]),
        SEG)]


def test_pipeline_step_matches_jax(port, jax_step):
    _, res = port
    for i, name in enumerate(("take", "tok_off", "tok_len", "est",
                              "offsets")):
        got = _cat(res["step"], i)
        want = jax_step[i].reshape(got.shape)
        np.testing.assert_array_equal(got, want, err_msg=name)
    est, offs = _cat(res["step"], 3), _cat(res["step"], 4)
    assert (np.diff(offs) == est[:-1]).all() and offs[0] == 0


@pytest.fixture(scope="module")
def jax_encode(jmesh, inputs):
    return [np.asarray(a) for a in jpar.sharded_encode_blocks(
        jmesh, jnp.asarray(inputs["enc"]), jnp.asarray(inputs["enc_n"]),
        SEG)]


def test_encode_blocks_match_jax(port, jax_encode, inputs):
    _, res = port
    for i, name in enumerate(("seg_bytes", "seg_lens", "sizes", "offsets")):
        got = _cat(res["encode"], i)
        np.testing.assert_array_equal(got, jax_encode[i], err_msg=name)
    # Every block decodes bit-exact, and its size is its body's.
    blocks = assemble_blocks(_cat(res["encode"], 0), _cat(res["encode"], 1),
                             inputs["enc_n"], SEG)
    sizes = _cat(res["encode"], 2)
    for b, blk in enumerate(blocks):
        n = int(inputs["enc_n"][b])
        assert blk is not None
        assert odec.decode_block(blk) == inputs["enc"][b, :n].astype(
            np.uint8).tobytes()
        assert len(blk) - 1 - len(put_uvarint(n)) == sizes[b]


def test_encode_without_collectives(port):
    """collectives=False: the same bytes, offsets zero."""
    _, res = port
    for i in range(3):
        np.testing.assert_array_equal(_cat(res["encode_nocoll"], i),
                                      _cat(res["encode"], i))
    assert not _cat(res["encode_nocoll"], 3).any()


@pytest.fixture(scope="module")
def jax_parse(jmesh, inputs):
    out = jpar.sharded_decode_parse(jmesh, jnp.asarray(inputs["mat"]),
                                    jnp.asarray(inputs["lens"]))
    return [np.asarray(a) for a in out]


def test_decode_parse_matches_jax(port, jax_parse, inputs):
    """Records lane by lane (the non-zero rows of the JAX parse, all seven
    fields), op counts and op offsets."""
    world, res = port
    local = NB // world
    S = inputs["lens"].shape[1]
    emits = jax_parse[:7]
    for r, (recs, lane_start, counts, _) in enumerate(res["parse"]):
        for k in range(local):
            b = r * local + k
            for s in range(S):
                lane = k * S + s
                sel = emits[0][b, :, s] > 0
                want = np.stack([e[b, sel, s] for e in emits])
                n = int(counts[k, s])
                s0 = int(lane_start[lane]) + lane
                np.testing.assert_array_equal(
                    recs[:, s0:s0 + n], want, err_msg=f"block {b} lane {s}")
    np.testing.assert_array_equal(_cat(res["parse"], 3), jax_parse[7])
    ops = np.concatenate([c.sum(axis=1) for _, _, c, _ in res["parse"]])
    np.testing.assert_array_equal(ops, (emits[0] > 0).sum(axis=(1, 2)))


@pytest.fixture(scope="module")
def jax_dict(jmesh, inputs):
    out = jpar.sharded_encode_blocks_dict(
        jmesh, jnp.asarray(inputs["dict"], jnp.int32),
        jnp.asarray(inputs["dblocks"]), jnp.asarray(inputs["dn"]), SEG)
    return [np.asarray(a) for a in out]


def test_dict_encode_matches_jax_and_decodes(port, jax_dict, inputs):
    _, res = port
    for i, name in enumerate(("seg_bytes", "seg_lens", "sizes", "offsets")):
        np.testing.assert_array_equal(_cat(res["dict"], i), jax_dict[i],
                                      err_msg=name)
    codec = get_codec()
    assert codec is not None
    seg_bytes, seg_lens = _cat(res["dict"], 0), _cat(res["dict"], 1)
    sizes = _cat(res["dict"], 2)
    blocks = assemble_blocks(seg_bytes, seg_lens, inputs["dn"], SEG)
    for b, blk in enumerate(blocks):
        raw = inputs["dblocks"][b].astype(np.uint8).tobytes()
        assert blk is not None
        assert codec.decode_block_dict(blk, inputs["dict"].tobytes()) == raw
    # The dictionary helps: no block is larger, and in all they are smaller
    # than the same blocks encoded without it.
    _, lens_nd = emit.encode_block_emit(
        torch.from_numpy(inputs["dblocks"]), inputs["dn"], SEG, 0)
    assert (sizes <= lens_nd.sum(dim=1).numpy()).all()
    assert sizes.sum() < lens_nd.sum().item()


def test_dict_must_be_whole_segments():
    mesh = tmesh.Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of seg"):
        tmesh.sharded_encode_blocks_dict(mesh, np.zeros(100, np.uint8),
                                         np.zeros((1, 8192), np.uint8),
                                         [8192], SEG)


@pytest.mark.parametrize("call", CALLS)
def test_outputs_do_not_depend_on_world(runs, call):
    """Two ranks and four ranks give the same outputs and offsets, put back
    in global block order; every rank writes the same stream."""
    a, b = (runs[w][call] for w in WORLDS)
    if call == "stream":
        assert len({stream for stream, _ in a + b}) == 1
        return
    if call == "parse":
        # Record slots follow the rank's own lanes: compare counts and
        # offsets here, records against JAX above.
        a = [(c, o) for _, _, c, o in a]
        b = [(c, o) for _, _, c, o in b]
    for i in range(len(a[0])):
        np.testing.assert_array_equal(_cat(a, i), _cat(b, i))


@pytest.fixture(scope="module")
def jax_stream(jmesh, inputs):
    buf = io.BytesIO()
    with JaxWriter(buf, device=True, mesh=jmesh, block_size=STREAM_BLOCK,
                   add_index=False, concurrency=1) as w:
        w.write(inputs["payload"])
    return buf.getvalue()


def test_mesh_writer_matches_jax_and_device_emit(port, jax_stream, inputs):
    _, res = port
    stream = res["stream"][0][0]
    assert all(s == stream for s, _ in res["stream"])
    assert stream == jax_stream
    buf = io.BytesIO()
    with Writer(buf, device="cpu", device_emit=True,
                block_size=STREAM_BLOCK, add_index=False,
                concurrency=1) as w:
        w.write(inputs["payload"])
    assert stream == buf.getvalue()
    r = Reader(io.BytesIO(stream), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == inputs["payload"]
    assert r.codec.blocks_decoded - before == STREAM_BYTES // STREAM_BLOCK


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    from minlz_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, backend="gloo", device="cpu", compute_kb=64,
                     per_rank=2, timeout=RANK_TIMEOUT)
    out = capsys.readouterr().out
    assert "sharded encode: 4 blocks bit-exact" in out
    assert "Writer(mesh=2 ranks) -> Reader bit-exact" in out


@pytest.mark.parametrize("case", ["no_init", "nccl_cpu"])
def test_make_mesh_checks(case, monkeypatch):
    import torch.distributed as dist

    if case == "no_init":
        with pytest.raises(RuntimeError, match="not initialised"):
            tmesh.make_mesh(device="cpu")
    else:
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(dist, "group", type("G", (), {"WORLD": None}))
        with pytest.raises(ValueError, match="NCCL"):
            tmesh.make_mesh(device="cpu")


def test_rank_device_map():
    assert ranks.device_map("cpu", 3) == ["cpu"] * 3
    assert ranks.device_map(["cpu", "cpu"], 2) == ["cpu", "cpu"]
    with pytest.raises(ValueError):
        ranks.device_map(["cpu"], 2)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            ranks.device_map("cuda", 2)
