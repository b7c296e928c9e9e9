"""The plain reference gives back the generated bytes from streams the
port writes on the CPU, checks CRC-32C, and imports nothing of the port;
no module under mzbench/ loads JAX or the JAX package."""

import ast
import io
import os

import numpy as np
import pytest

from mzbench import reference as R
from mzbench.data import gharchive_events, nyc_taxi_trips
from mzbench.run import forbidden

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = (1 << 33) + 5


def port_stream(data, **opts):
    from minlz_tpu_torch.stream import Writer

    buf = io.BytesIO()
    w = Writer(buf, device="cpu", block_size=64 << 10, **opts)
    w.encode_buffer(memoryview(data))
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("emit", [False, True], ids=["serializer", "emit"])
@pytest.mark.parametrize("gen", [nyc_taxi_trips, gharchive_events],
                         ids=lambda g: g.__name__)
def test_reference_decodes_what_the_port_writes(gen, emit):
    data = gen.generate(SEED, 3 * (64 << 10) + 1000, "cpu").numpy()
    blocks, eof = R.data_blocks(port_stream(data, device_emit=emit))
    assert eof == len(data)
    assert sum(R.block_size(b) for b in blocks) == len(data)
    out = b"".join(R.decode_stream_block(b) for b in blocks)
    assert out == data.tobytes()
    pos = 0
    for b in blocks:
        n = R.block_size(b)
        want = data[pos:pos + n]
        assert R.masked(int(R.crc32c_rows(want[None])[0])) == b["crc"]
        if b["kind"] == "compressed":
            seg, rng, offs = R.block_hints(b)
            assert (seg, rng) == (4096, 128 << 10)
            assert len(offs) == -(-n // seg)
        pos += n


def test_control_decoder_differs_where_copies_overlap():
    data = nyc_taxi_trips.generate(SEED, 64 << 10, "cpu").numpy()
    blocks, _ = R.data_blocks(port_stream(data))
    good = R.decode_stream_block(blocks[0])
    bad = R.decode_stream_block(blocks[0], overlap_safe=False)
    assert good == data.tobytes()
    assert len(bad) == len(good) and bad != good


def rehint(block, seg=None, rng=None, move=None):
    """The block with its parse hints rewritten: another segment size or
    range declared, or offset ``move`` one byte later."""
    from minlz_tpu_torch.ops import device_codec as dc

    seg0, offs, rng0 = dc.parse_hints(bytes(block["hints"]))
    if move is not None:
        offs[move] += 1
    seg = seg or seg0
    hints = dc.marshal_hints(seg, [(o, i * seg) for i, o in enumerate(offs)],
                             rng if rng is not None else rng0)
    return dict(block, hints=hints)


@pytest.mark.parametrize("case", ["moved", "narrow_range", "other_segment"])
def test_reference_holds_a_block_to_its_hints(case):
    data = gharchive_events.generate(SEED, 64 << 10, "cpu").numpy()
    blocks, _ = R.data_blocks(port_stream(data, device_emit=True))
    block = blocks[0]
    assert R.decode_stream_block(block, hinted=True) == data.tobytes()
    bad = {"moved": lambda: rehint(block, move=5),
           "narrow_range": lambda: rehint(block, rng=4096),
           "other_segment": lambda: rehint(block, seg=2048)}[case]()
    assert R.decode_stream_block(bad) == data.tobytes()
    with pytest.raises(R.Corrupt):
        R.decode_stream_block(bad, hinted=True)


def test_crc32c_known_values():
    assert int(R.crc32c_rows(np.frombuffer(b"123456789", np.uint8)[None])[0]) \
        == 0xE3069283
    rows = np.random.default_rng(1).integers(0, 256, (3, 1000), np.uint8)
    from minlz_tpu_torch.minlz import crc32c

    assert [int(c) for c in R.crc32c_rows(rows)] == \
        [crc32c(r.tobytes()) for r in rows]


def test_reference_finds_corrupt_framing():
    data = gharchive_events.generate(SEED, 64 << 10, "cpu").numpy()
    stream = bytearray(port_stream(data))
    with pytest.raises(R.Corrupt):
        R.data_blocks(bytes(stream[:-3]))
    stream[0] ^= 1
    with pytest.raises(R.Corrupt):
        R.data_blocks(bytes(stream))


def imports(path):
    """Top-level names of the modules a file imports, relative imports
    resolved inside mzbench."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("mzbench" if node.level else node.module.split(".")[0])
    return names


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: forbidden(imports(p)) for p in sources()}
    assert len(found) > 20
    assert {p: f for p, f in found.items() if f} == {}


def test_the_check_compares_whole_names():
    assert forbidden(["minlz_tpu_torch", "minlz_tpu_torch.ops",
                      "jaxtyping", "flaxen"]) == []
    assert forbidden(["jax.numpy", "jaxlib", "flax.linen",
                      "minlz_tpu.ops"]) == ["flax", "jax", "jaxlib",
                                            "minlz_tpu"]


def test_the_reference_imports_nothing_of_the_port():
    assert imports(os.path.join(HERE, "reference.py")) <= {"__future__",
                                                           "numpy"}
