"""Card-only checks of what the port does with the JAX package's arguments
and of random access on the card: find_matches_dyn(exact=True) on the card
equals it on the CPU, and ReadSeeker(device="cuda") reads seeded spans of
a stream with an index, each block it touches decoded by the decode kernels
(K1, the lane offset scan, K2, K3).  Skipped without a GPU; chip_smoke.py
runs the same at the main path's shapes (its "seek" and "api" paths)."""

import io

import numpy as np
import pytest
import torch

from minlz_tpu_torch.corpus import make_corpus

pytestmark = pytest.mark.cuda
MB = 1 << 20


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def test_find_matches_exact_on_card_matches_cpu():
    from minlz_tpu_torch.ops import encode_kernel as tek

    _need_gpu()
    data = np.frombuffer(make_corpus(2 * MB), np.uint8).reshape(2, MB)
    x = torch.from_numpy(data.copy())
    want = tek.find_matches_dyn(x, [MB, MB - 999], 4096, 128 << 10, 2,
                                exact=True)
    got = tek.find_matches_dyn(x.cuda(), [MB, MB - 999], 4096, 128 << 10, 2,
                               exact=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[0] > 0).sum()) > 100_000


def test_read_seeker_on_card():
    from minlz_tpu_torch import _build
    from minlz_tpu_torch.ops.device_codec import get_device_codec
    from minlz_tpu_torch.stream import ReadSeeker, Writer

    _need_gpu()
    data = make_corpus(6 * MB)
    buf = io.BytesIO()
    with Writer(buf, device="cuda", block_size=MB, add_index=True) as w:
        w.write(data)
    codec = get_device_codec("cuda")
    rs = ReadSeeker(io.BytesIO(buf.getvalue()), device="cuda")
    before = codec.blocks_decoded
    launches = _build.launch_counts()
    offs = np.random.default_rng(18).integers(0, len(data) - 4096, 8)
    for off in offs:
        assert rs.read_at(int(off), 4096) == data[off:off + 4096]
    touched = sum((o + 4095) // MB - o // MB + 1 for o in offs)
    assert codec.blocks_decoded - before == touched
    assert rs.hint_fallbacks == 0
    after = _build.launch_counts()
    for count in ("parse", "lane_offsets", "compact", "exec_range"):
        assert after[count] - launches[count] == touched, count
