"""Traffic loop: the stream compressor, writing passes over a buffer.

Set-up generates ``pass_bytes`` of the configuration's data in host
memory.  The window writes it through ``Writer(sink, device=...,
device_emit=...)`` in slices of ``batch_blocks`` blocks
(``Writer.encode_buffer``; the Writer encodes each full batch in one
dispatch), pass after pass, each pass a new stream closed with ``close()``,
as a log shipper rotates its files.  After each slice the host looks at the
clock; at the deadline the stream is closed and the window ends.  The sink
keeps the streams in memory.

After the window every stream is walked by the plain reference (framing,
EOF size, block sizes, the parse hints of every block), and a sample of
blocks drawn from the seed is decoded by it and compared with the input,
CRC included; the decode also holds each sampled block to its parse hints
(a token starts each segment where its hint says, no segment takes the
repeat offset of another, every copy reads inside its 128 KiB range).  The control is the program's own Writer with its CRC-32C
swapped for zlib's CRC-32, a step that would tempt a faster Writer.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from .. import reference as R
from ..trace import span
from .common import check, rng, sync


class Sink:
    """A file-like object that keeps what is written, in memory."""

    def __init__(self):
        self.parts, self.n = [], 0

    def write(self, b):
        self.parts.append(bytes(b))
        self.n += len(b)
        return len(b)

    def flush(self):
        pass


def _writer(state, sink):
    from minlz_tpu_torch.stream import Writer

    codec = state["cfg"]["codec"]
    return Writer(sink, device=state["device"], level=codec["level"],
                  block_size=codec["block_size"],
                  device_emit=state["mix"]["device_emit"])


def setup(cfg, mix, gen, seed, device, control=False):
    bs = cfg["codec"]["block_size"]
    step = bs * mix["batch_blocks"]
    if mix["pass_bytes"] % step:
        raise ValueError("pass_bytes must be whole batches")
    with span("setup.generate"):
        data = gen.generate(seed, mix["pass_bytes"], device).cpu().numpy()
    state = {"cfg": cfg, "mix": mix, "seed": seed, "device": device,
             "data": data, "step": step}
    if control:
        from minlz_tpu_torch.stream import writer

        state["crc"] = writer.crc
        writer.crc = lambda b: R.masked(zlib.crc32(b))
    with span("setup.warm"):
        view = memoryview(data)
        for _ in range(mix["warm_passes"]):
            w = _writer(state, Sink())
            for pos in range(0, mix["warm_batches"] * step, step):
                w.encode_buffer(view[pos:pos + step])
            w.close()
        sync(device)
    return state


def window(state, seconds):
    data, step = state["data"], state["step"]
    view = memoryview(data)
    passes = []
    start = time.perf_counter()
    deadline = start + seconds
    with span("window"):
        done = False
        while not done:
            sink = Sink()
            w = _writer(state, sink)
            pos = 0
            while pos < len(data) and not done:
                with span("Writer.encode_buffer"):
                    w.encode_buffer(view[pos:pos + step])
                pos += step
                done = time.perf_counter() >= deadline
            with span("Writer.close"):
                w.close()
            passes.append((sink, pos))
        end = time.perf_counter()
    state["passes"] = passes
    n_in = sum(p for _, p in passes)
    return {
        "kind": "encode",
        "window_s": end - start,
        "attempted": n_in // state["cfg"]["codec"]["block_size"],
        "bytes_in": n_in,
        "bytes_out": sum(s.n for s, _ in passes),
        "passes": len(passes),
    }


def release(state):
    """Put the Writer's CRC back after a control run."""
    if "crc" in state:
        from minlz_tpu_torch.stream import writer

        writer.crc = state.pop("crc")


def check_outputs(state, rec):
    """Walk every stream and decode a sample of blocks drawn from the seed.
    The number compared is ``bad_blocks``: every block of a stream whose
    framing or EOF size is wrong, every block whose size or parse hints
    are wrong, and every sampled block that does not decode to its input,
    breaks a promise of its parse hints, or whose CRC is not the input's;
    a window with no block counts one."""
    cfg, mix, data = state["cfg"], state["mix"], state["data"]
    bs, rg = cfg["codec"]["block_size"], cfg["codec"]["range"]
    bad = set()  # (pass, block index)
    walked = []  # (pass, block index, block)
    for p, (sink, n_in) in enumerate(state["passes"]):
        n_blocks = -(-n_in // bs)
        try:
            blocks, eof = R.data_blocks(b"".join(sink.parts))
        except R.Corrupt:
            bad |= {(p, k) for k in range(n_blocks)}
            continue
        if eof != n_in or len(blocks) != n_blocks:
            bad |= {(p, k) for k in range(max(n_blocks, len(blocks)))}
        for k, b in enumerate(blocks):
            ok = R.block_size(b) == bs
            if b["kind"] == "compressed":
                try:
                    seg, brg, _ = R.block_hints(b)
                    ok = ok and brg == rg and seg == cfg["codec"]["segment"]
                except R.Corrupt:
                    ok = False
            if not ok:
                bad.add((p, k))
            walked.append((p, k, b))
    pick = rng(state["seed"], 4)
    k = min(mix["check_sample"], len(walked))
    chosen = sorted(set(pick.choice(len(walked), size=k, replace=False)
                        .tolist()) | ({len(walked) - 1} if walked else set()))
    inputs = [data[walked[i][1] * bs:(walked[i][1] + 1) * bs]
              for i in chosen]
    crcs = R.crc32c_rows(np.stack(inputs)) if inputs else []
    for i, want, c in zip(chosen, inputs, crcs):
        p, blk_i, b = walked[i]
        try:
            ok = R.decode_stream_block(b, hinted=True) == want.tobytes()
        except R.Corrupt:
            ok = False
        if not ok or R.masked(int(c)) != b["crc"]:
            bad.add((p, blk_i))
    rec["failed"] = len(bad)
    rec["checked"] = f"{len(walked)} blocks walked, {len(chosen)} decoded"
    return [check("bad_blocks", len(bad) if walked else 1, 0)]
