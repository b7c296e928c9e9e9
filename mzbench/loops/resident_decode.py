"""Traffic loop: a compressed store resident on the card, read in extents.

Set-up generates ``store_extents`` x ``extent_blocks`` blocks of the
configuration's data, writes them as one stream with the program's default
device ``Writer`` (as a store is written), splits each block's body at its
parse hints (``device_codec.parse_hints``, ``split_body``), plans each
extent once (``exec_chain.plan_batch``) and puts the plan's tensors on the
card.

The window is a closed loop with ``in_flight`` requests outstanding.  Each
request picks an extent by Zipf (``zipf_theta``) over the extents, ranked
in an order drawn from the seed, and calls ``exec_chain.decode_planned``,
which leaves the decoded extent in device memory.  A request is done when a
CUDA event recorded after it has completed; its latency runs from the
host's submit to the host seeing that event done.

After the window, a sample of the requests' outputs drawn from the seed is
compared with the bytes the generator made.  The control decodes with the
plain reference in the program's place, with copies that overlap their
source made as one slice move (``reference.decode_block(...,
overlap_safe=False)``).
"""

from __future__ import annotations

import collections
import io
import time

import numpy as np
import torch

from .. import reference as R
from .. import yardstick
from ..trace import span
from .common import Marker, Reservoir, check, rng, sync


def setup(cfg, mix, gen, seed, device, control=False):
    from minlz_tpu_torch.ops import exec_chain
    from minlz_tpu_torch.ops.device_codec import parse_hints, split_body
    from minlz_tpu_torch.stream import Writer

    codec = cfg["codec"]
    bs = codec["block_size"]
    n_ext = cfg["scale"]["store_extents"]
    per = mix["extent_blocks"]
    with span("setup.generate"):
        data = gen.generate(seed, n_ext * per * bs, device).cpu().numpy()
    with span("setup.write_store"):
        sink = io.BytesIO()
        w = Writer(sink, device=device, level=codec["level"], block_size=bs)
        w.encode_buffer(memoryview(data))
        w.close()
    blocks, _ = R.data_blocks(sink.getbuffer())
    if len(blocks) != n_ext * per or any(b["kind"] != "compressed"
                                         for b in blocks):
        raise RuntimeError("the store holds a block that did not compress")
    plans, tensors, comp_bytes = [], [], []
    with span("setup.plan"):
        for e in range(n_ext):
            segs, comp, geometry = [], 0, set()
            for b in blocks[e * per:(e + 1) * per]:
                _, pos = R.uvarint(b["data"], 0)
                body = bytes(b["data"][pos:])
                seg, offs, rg = parse_hints(bytes(b["hints"]))
                geometry.add((seg, rg))
                segs.append(split_body(body, offs))
                comp += len(body)
            if len(geometry) != 1:
                raise RuntimeError("an extent mixes segment sizes or ranges")
            seg, rg = geometry.pop()
            plan = exec_chain.plan_batch(segs, seg, rg)
            plans.append(plan)
            tensors.append(plan.tensors(device))
            comp_bytes.append(comp)
    # The control decodes the stored blocks themselves.
    control_blocks = [[bytes(b["data"]) for b in blocks[e * per:(e + 1) * per]]
                      for e in range(n_ext)] if control else None
    del sink, blocks
    picks = rng(seed, 1)
    order = picks.permutation(n_ext)
    weights = 1.0 / np.arange(1, n_ext + 1) ** mix["zipf_theta"]
    state = {
        "cfg": cfg, "mix": mix, "seed": seed, "device": device,
        "control": control, "data": data, "plans": plans,
        "tensors": tensors, "comp_bytes": comp_bytes,
        "store_comp_bytes": sum(comp_bytes), "extent_bytes": per * bs,
        "order": order, "probs": weights / weights.sum(), "picks": picks,
        "control_blocks": control_blocks,
    }
    if control:
        return state  # the reference has nothing to build or warm
    with span("setup.warm"):
        for e in range(n_ext):
            _decode(state, e)
        sync(device)
        _loop(state, mix["warm_seconds"], Reservoir(mix["check_sample"],
                                                    rng(seed, 2)))
        sync(device)
    return state


def _decode(state, e):
    from minlz_tpu_torch.ops import exec_chain

    if state["control"]:
        return _control_decode(state, e)
    return exec_chain.decode_planned(state["plans"][e], state["device"],
                                     "fast", state["tensors"][e])


def _control_decode(state, e):
    """The plain reference in the program's place, on the same stored
    segments, with overlapping copies made as one slice move."""
    plan = state["plans"][e]
    out = np.zeros(plan.total_out, np.uint8)
    for (o, n), blk in zip(plan.block_out, state["control_blocks"][e]):
        got = np.frombuffer(R.decode_block(blk, overlap_safe=False),
                            np.uint8)
        out[o:o + len(got)] = got
    return torch.from_numpy(out)


def _loop(state, seconds, sample):
    """The closed loop for ``seconds``: per request (extent, submit,
    enqueued, done) host times, and the sample of outputs kept."""
    depth = state["mix"]["in_flight"]
    device = state["device"]
    picks, order, probs = state["picks"], state["order"], state["probs"]
    queue = picks.choice(len(order), size=1 << 16, p=probs)
    inflight = collections.deque()
    done = []
    n = 0

    def retire():
        i, e, out, mark, t0, t1 = inflight.popleft()
        with span("wait"):
            mark.wait()
        done.append((e, t0, t1, time.perf_counter()))
        sample.offer((i, e, out))

    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        if len(inflight) == depth:
            retire()
        if n == len(queue):
            queue = np.concatenate([queue, picks.choice(
                len(order), size=1 << 16, p=probs)])
        e = int(order[queue[n]])
        t0 = time.perf_counter()
        with span("decode_planned"):
            out = _decode(state, e)
            mark = Marker(device)
        inflight.append((n, e, out, mark, t0, time.perf_counter()))
        n += 1
    while inflight:
        retire()
    return start, time.perf_counter(), done


def window(state, seconds):
    sample = Reservoir(state["mix"]["check_sample"], rng(state["seed"], 3))
    with span("window"):
        start, end, done = _loop(state, seconds, sample)
    state["sample"] = sample.items
    ext = state["extent_bytes"]
    return {
        "kind": "decode",
        "window_s": end - start,
        "attempted": len(done),
        "bytes_out": [ext] * len(done),
        "bytes_in": [state["comp_bytes"][e] for e, *_ in done],
        "latency_s": [t3 - t0 for _, t0, _, t3 in done],
        "enqueue_s": [t1 - t0 for _, t0, t1, _ in done],
        "store_comp_bytes": state["store_comp_bytes"],
    }


def release(state):
    """Free the program's state on the card before the check."""
    state["tensors"] = None
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def check_outputs(state, rec):
    """Compare the sampled outputs with the generated bytes: the number
    compared is ``bad_bytes``, the bytes that differ over the sampled
    requests, and a window with no request to check counts an extent."""
    data, ext = state["data"], state["extent_bytes"]
    bs = state["cfg"]["codec"]["block_size"]
    bad_req = bad_bytes = 0
    for _, e, out in state["sample"]:
        got = out.cpu().numpy()
        want = data[e * ext:(e + 1) * ext]
        wrong = 0
        for k, (o, n) in enumerate(state["plans"][e].block_out):
            a = got[o:o + min(n, bs)]
            b = want[k * bs:(k + 1) * bs]
            if len(a) != len(b):
                wrong += len(b)
            else:
                wrong += int(np.count_nonzero(a != b))
        bad_bytes += wrong
        bad_req += wrong > 0
    if not state["sample"]:
        bad_bytes = ext
    rec["failed"] = bad_req
    store = state["store_comp_bytes"]
    rec["checked"] = (f"{len(state['sample'])} requests; the store holds "
                      f"{store} compressed bytes, "
                      f"{store / yardstick.L2_BYTES:.2f} times the card's L2")
    return [check("bad_bytes", bad_bytes, 0)]
