"""Stream interchange: the port's Writer/Reader (minlz_tpu_torch.stream)
against minlz_tpu's, and the wire helpers against the JAX originals.  On the
CPU the port's codec runs its plain torch versions."""

import io

import pytest

from minlz_tpu.ops import device_codec as jdc
from minlz_tpu.stream import Reader as HostReader
from minlz_tpu.stream import Writer as JaxWriter
from minlz_tpu_torch.ops import device_codec as tdc
from minlz_tpu_torch.stream import Reader, Writer

BLOCK = 256 << 10


def test_wire_helpers_match_jax():
    assert tdc.HINT_MAGIC == jdc.HINT_MAGIC
    assert tdc.HINT_VERSION == jdc.HINT_VERSION
    hints = [(0, 0), (100, 4096), (250, 8192), (1000, 12288), (70000, 16384)]
    for seg, rng in ((4096, 0), (4096, tdc.RANGE), (8192, 1 << 20)):
        payload = tdc.marshal_hints(seg, hints, rng)
        assert payload == jdc.marshal_hints(seg, hints, rng)
        assert tdc.parse_hints(payload) == jdc.parse_hints(payload)
    v1 = bytearray(jdc.marshal_hints(4096, hints))
    v1[4] = 1
    del v1[8]  # v1 carries no range field (here the 1-byte uvarint 0)
    assert tdc.parse_hints(bytes(v1)) == jdc.parse_hints(bytes(v1))
    body = bytes(range(200)) * 7
    offs = [0, 13, 13, 700, 1399]
    assert tdc.split_body(body, offs) == jdc.split_body(body, offs)
    assert tdc.DeviceCodec._seg_for(5 << 20) == jdc.DeviceCodec._seg_for(
        5 << 20)


def test_bad_hints_are_corrupt():
    from minlz_tpu_torch.minlz import CorruptError

    good = tdc.marshal_hints(4096, [(0, 0), (10, 4096)], tdc.RANGE)
    for bad in (b"XXXX\x02", good[:4], good[:-1]):
        with pytest.raises(CorruptError):
            tdc.parse_hints(bad)


@pytest.fixture(scope="module")
def corpus():
    from minlz_tpu_torch.corpus import make_corpus

    return make_corpus(2 << 20)


@pytest.fixture(scope="module")
def jax_stream(corpus):
    buf = io.BytesIO()
    with JaxWriter(buf, device=True, block_size=BLOCK, concurrency=1) as w:
        w.write(corpus)
    return buf.getvalue()


@pytest.fixture(scope="module")
def port_stream(corpus):
    buf = io.BytesIO()
    w = Writer(buf, device="cpu", block_size=BLOCK, concurrency=1)
    before = w.codec.blocks_encoded     # the process's codec on the CPU
    with w:
        w.write(corpus)
    assert w.codec.blocks_encoded - before == len(corpus) // BLOCK
    return buf.getvalue()


def test_writer_bytes_match_jax_writer(port_stream, jax_stream, corpus):
    assert len(port_stream) < len(corpus)
    assert port_stream == jax_stream


def test_port_reader_roundtrip(port_stream, corpus):
    r = Reader(io.BytesIO(port_stream), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == corpus
    assert r.codec.blocks_decoded - before == len(corpus) // BLOCK


def test_port_reader_reads_jax_stream(jax_stream, corpus):
    r = Reader(io.BytesIO(jax_stream), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == corpus
    assert r.codec.blocks_decoded - before == len(corpus) // BLOCK


def test_host_reader_reads_port_stream(port_stream, corpus):
    assert HostReader(io.BytesIO(port_stream)).readall() == corpus


def test_partial_reads_decode_on_device(port_stream, corpus):
    """read(n) takes the per-block device path."""
    r = Reader(io.BytesIO(port_stream), device="cpu")
    before = r.codec.blocks_decoded
    head = r.read(1000)
    assert head == corpus[:1000]
    assert r.codec.blocks_decoded - before == 1


def test_device_failure_raises(port_stream, monkeypatch):
    """The JAX package's Reader would warn and decode on the host; the
    port's Reader fails instead, in the batched drain and in the per-block
    path."""
    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tdc.DeviceCodec, "decode_batch", boom)
    with pytest.raises(RuntimeError, match="injected device failure"):
        Reader(io.BytesIO(port_stream), device="cpu").readall()
    with pytest.raises(RuntimeError, match="injected device failure"):
        Reader(io.BytesIO(port_stream), device="cpu").read(10)


def test_corrupt_hints_decode_on_the_host(port_stream, corpus, monkeypatch):
    """Hints are advisory: a CorruptError from the device codec leaves the
    block to the host decoder, in both paths."""
    from minlz_tpu_torch.minlz import CorruptError

    def corrupt(*args, **kwargs):
        raise CorruptError("injected corrupt hints")

    monkeypatch.setattr(tdc.DeviceCodec, "decode_batch", corrupt)
    r = Reader(io.BytesIO(port_stream), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == corpus
    assert r.codec.blocks_decoded == before
    assert Reader(io.BytesIO(port_stream), device="cpu").read(10) \
        == corpus[:10]


@pytest.mark.parametrize("case", ["mesh_without_device", "mesh_elsewhere",
                                  "codec_elsewhere", "bad_search_table"])
def test_unported_options_raise(case):
    """The argument checks that stand where the mesh and search options
    were refused: a mesh needs a device, the mesh's own, and a search table
    config must be valid."""
    import torch

    from minlz_tpu_torch.parallel.mesh import Mesh
    from minlz_tpu_torch.search import SearchTableConfig

    elsewhere = Mesh(None, 0, 1, torch.device("meta"))
    with pytest.raises(ValueError):
        if case == "mesh_without_device":
            Writer(io.BytesIO(), device=None, mesh=elsewhere)
        elif case == "mesh_elsewhere":
            Writer(io.BytesIO(), device="cpu", mesh=elsewhere)
        elif case == "codec_elsewhere":
            tdc.DeviceCodec("cpu").encode_batch_mesh(elsewhere, [b"x"])
        else:
            Writer(io.BytesIO(), device="cpu",
                   search_table=SearchTableConfig(table_bits=30))


def test_host_only_reader_and_writer(corpus):
    """device=None keeps every block on the host: no codec, no hints, and
    the bytes of the JAX package's host Writer."""
    data = corpus[: 300_000]
    buf, jbuf = io.BytesIO(), io.BytesIO()
    w = Writer(buf, device=None, block_size=BLOCK, concurrency=1)
    with w:
        w.write(data)
    with JaxWriter(jbuf, block_size=BLOCK, concurrency=1) as jw:
        jw.write(data)
    assert w.codec is None
    assert buf.getvalue() == jbuf.getvalue()
    r = Reader(io.BytesIO(buf.getvalue()), device=None)
    assert r.codec is None and r.readall() == data


EMIT_BLOCK = 128 << 10
EMIT_BYTES = 4 * EMIT_BLOCK + 5000


@pytest.fixture(scope="module")
def emit_streams(corpus):
    """The same bytes through both packages' Writer(device_emit=True)."""
    data = corpus[-EMIT_BYTES:]
    jbuf, buf = io.BytesIO(), io.BytesIO()
    with JaxWriter(jbuf, device=True, device_emit=True,
                   block_size=EMIT_BLOCK, concurrency=1) as jw:
        jw.write(data)
    w = Writer(buf, device="cpu", device_emit=True, block_size=EMIT_BLOCK,
               concurrency=1)
    before = w.codec.blocks_encoded
    with w:
        w.write(data)
    assert w.codec.blocks_encoded - before == 5
    return data, jbuf.getvalue(), buf.getvalue()


def test_emit_writer_bytes_match_jax_writer(emit_streams):
    data, jax_bytes, port_bytes = emit_streams
    assert len(port_bytes) < len(data)
    assert port_bytes == jax_bytes


def test_emit_streams_interchange(emit_streams):
    """Each package's Reader reads the other's device_emit stream."""
    data, jax_bytes, port_bytes = emit_streams
    r = Reader(io.BytesIO(jax_bytes), device="cpu")
    before = r.codec.blocks_decoded
    assert r.readall() == data
    assert r.codec.blocks_decoded > before
    assert Reader(io.BytesIO(port_bytes), device=None).readall() == data
    assert HostReader(io.BytesIO(port_bytes)).readall() == data


def test_emit_per_block_path_matches_batched(emit_streams):
    """A custom encoder that declines sends every block through the
    per-block encode_emit call; the stream is the batched one."""
    data, _, port_bytes = emit_streams
    buf = io.BytesIO()
    with Writer(buf, device="cpu", device_emit=True, block_size=EMIT_BLOCK,
                concurrency=1, custom_encoder=lambda src, level: None) as w:
        w.write(data)
    assert buf.getvalue() == port_bytes


@pytest.mark.parametrize("stream", ["serializer", "emit"])
def test_corrupt_crc_raises(stream, port_stream, emit_streams):
    """One flipped CRC byte of the first data chunk: the port's Reader
    raises on the device path and on the host path."""
    from minlz_tpu_torch.minlz import (CHUNK_TYPE_MINLZ_COMPRESSED,
                                       CorruptError)

    good = port_stream if stream == "serializer" else emit_streams[2]
    pos = 0
    while good[pos] != CHUNK_TYPE_MINLZ_COMPRESSED:
        pos += 4 + int.from_bytes(good[pos + 1 : pos + 4], "little")
    bad = bytearray(good)
    bad[pos + 4] ^= 0x40
    for device in ("cpu", None):
        with pytest.raises(CorruptError, match="CRC"):
            Reader(io.BytesIO(bytes(bad)), device=device).readall()


def test_cuda_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        Writer(io.BytesIO(), device="cuda")
