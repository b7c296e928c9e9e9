"""Traffic loop: a store of MinLZ blocks without parse hints, resident on
the card, read in extents; every request derives its plan anew.

Set-up generates ``store_extents`` x ``extent_blocks`` blocks of the
configuration's data and writes them as one stream with the program's
host ``Writer`` with parse hints off, as ``mz c`` writes a stream: no chunk
0x88.  Each extent's block bodies go to the card back to back, with its
block table (each body's offset, each block's decoded length: all the
framing says).  Nothing is derived from the bodies in set-up.

The window is a closed loop with ``in_flight`` requests outstanding.  Each
request picks an extent by Zipf (``zipf_theta``) over the extents, ranked
in an order drawn from the seed, and calls ``exec_block.decode_unhinted``,
which derives the extent's lanes on the card (token starts, each lane's
output span and incoming repeat offset), parses, compacts and executes
whole blocks, and leaves the decoded extent in device memory; nothing it
derives is kept for the next request.  A request is done when a CUDA event
recorded after it has completed; its latency runs from the host's submit to
the host seeing that event done.

After the window, a sample of the requests' outputs drawn from the seed is
compared with the bytes the generator made, and their derivations' verdicts
with 0; ``check_blocks`` blocks of sampled extents have their derived lanes
compared with the reference's walk (``derive_reference.lane_table``).  The
control decodes with the plain reference in the program's place, with
copies that overlap their source made as one slice move
(``reference.decode_block(..., overlap_safe=False)``).
"""

from __future__ import annotations

import collections
import io
import time

import numpy as np
import torch

from .. import derive_reference as D
from .. import reference as R
from .. import yardstick
from ..trace import span
from .common import Marker, Reservoir, check, rng, sync


def setup(cfg, mix, gen, seed, device, control=False):
    # The program's entry first: a program without it fails here, at once.
    from minlz_tpu_torch.ops.exec_block import decode_unhinted  # noqa: F401
    from minlz_tpu_torch.stream import Writer

    codec = cfg["codec"]
    bs = codec["block_size"]
    n_ext = cfg["scale"]["store_extents"]
    per = mix["extent_blocks"]
    with span("setup.generate"):
        data = gen.generate(seed, n_ext * per * bs, device).cpu().numpy()
    with span("setup.write_store"):
        sink = io.BytesIO()
        w = Writer(sink, device=None, level=codec["level"], block_size=bs,
                   parse_hints=False)
        w.encode_buffer(memoryview(data))
        w.close()
    blocks, _ = R.data_blocks(sink.getbuffer())
    if len(blocks) != n_ext * per or any(
            b["kind"] != "compressed" or b["hints"] is not None
            for b in blocks):
        raise RuntimeError("the store holds a block that did not compress "
                           "or that has parse hints")
    extents = []
    with span("setup.store"):
        for e in range(n_ext):
            bodies, wants = [], []
            for b in blocks[e * per:(e + 1) * per]:
                want, pos = R.uvarint(b["data"], 0)
                bodies.append(bytes(b["data"][pos:]))
                wants.append(want)
            lens = np.array([len(x) for x in bodies], np.int64)
            off = np.concatenate([[0], np.cumsum(lens)])
            extents.append({
                "comp": torch.from_numpy(np.frombuffer(
                    b"".join(bodies), np.uint8).copy()).to(device),
                "body_off": torch.from_numpy(off).to(device),
                "out_len": torch.tensor(wants, dtype=torch.int32,
                                        device=device),
                "total_out": sum(wants), "wants": wants,
                "comp_bytes": int(lens.sum()),
                "plan_bytes": D.plan_bytes(lens.tolist(),
                                           codec["segment"]),
                "control": ([bytes(b["data"]) for b in
                             blocks[e * per:(e + 1) * per]]
                            if control else None),
            })
    del sink, blocks
    picks = rng(seed, 1)
    order = picks.permutation(n_ext)
    weights = 1.0 / np.arange(1, n_ext + 1) ** mix["zipf_theta"]
    state = {
        "cfg": cfg, "mix": mix, "seed": seed, "device": device,
        "control": control, "data": data, "extents": extents,
        "store_comp_bytes": sum(x["comp_bytes"] for x in extents),
        "extent_bytes": per * bs, "order": order,
        "probs": weights / weights.sum(), "picks": picks,
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
    """(decoded extent, the derivation's verdict) of one request."""
    from minlz_tpu_torch.ops import exec_block

    x = state["extents"][e]
    if state["control"]:
        return _control_decode(x), None
    return exec_block.decode_unhinted(x["comp"], x["body_off"], x["out_len"],
                                      x["total_out"],
                                      state["cfg"]["codec"]["segment"])


def _control_decode(x):
    """The plain reference in the program's place, on the same stored
    blocks, with overlapping copies made as one slice move."""
    return torch.from_numpy(np.frombuffer(b"".join(
        R.decode_block(blk, overlap_safe=False) for blk in x["control"]),
        np.uint8).copy())


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
        with span("decode_unhinted"):
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
    extents = state["extents"]
    return {
        "kind": "decode",
        "window_s": end - start,
        "attempted": len(done),
        "bytes_out": [ext] * len(done),
        "bytes_in": [extents[e]["comp_bytes"] for e, *_ in done],
        "plan_bytes": [extents[e]["plan_bytes"] for e, *_ in done],
        "latency_s": [t3 - t0 for _, t0, _, t3 in done],
        "enqueue_s": [t1 - t0 for _, t0, t1, _ in done],
        "store_comp_bytes": state["store_comp_bytes"],
    }


def release(state):
    """Nothing the program keeps between requests: the store stays for the
    lane check, and the card's cache is emptied."""
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def _lane_mismatches(state, picks):
    """Lanes of ``check_blocks`` sampled blocks that the program's
    derivation and the reference's walk disagree on (a block the reference
    finds unsound counts all its lanes)."""
    from minlz_tpu_torch.ops import derive

    seg = state["cfg"]["codec"]["segment"]
    bad = 0
    for e, b in picks:
        x = state["extents"][e]
        plan = derive.derive_plan(x["comp"], x["body_off"], x["out_len"],
                                  x["total_out"], seg)
        first, last = plan["range_lane"][b:b + 2].tolist()
        o0, o1 = x["body_off"][b:b + 2].tolist()
        got = list(zip(*(plan[k][first:last].cpu().tolist() for k in (
            "lane_start", "lane_len", "lane_lo", "lane_hi", "lane_rep"))))
        got = [(s - o0, *rest) for s, *rest in got]
        body = x["comp"][o0:o1].cpu().numpy().tobytes()
        try:
            want = D.lane_table(body, x["wants"][b], seg)
        except R.Corrupt:
            bad += max(len(got), 1)
            continue
        bad += sum(g != w for g, w in zip(got, want))
        bad += abs(len(got) - len(want))
    return bad


def check_outputs(state, rec):
    """Compare the sampled outputs with the generated bytes: the numbers
    compared are ``bad_bytes``, the bytes that differ over the sampled
    requests (a window with no request to check counts an extent),
    ``bad_plans``, the sampled requests whose derivation found its extent
    unsound, and ``bad_lanes``, the derived lanes of sampled blocks that
    differ from the reference's walk."""
    data, ext = state["data"], state["extent_bytes"]
    bs = state["cfg"]["codec"]["block_size"]
    bad_req = bad_bytes = bad_plans = 0
    for _, e, (out, verdict) in state["sample"]:
        got = out.cpu().numpy()
        want = data[e * ext:(e + 1) * ext]
        wrong, o = 0, 0
        for k, n in enumerate(state["extents"][e]["wants"]):
            a = got[o:o + n]
            b = want[k * bs:(k + 1) * bs]
            o += n
            if len(a) != len(b):
                wrong += len(b)
            else:
                wrong += int(np.count_nonzero(a != b))
        bad_bytes += wrong
        bad_req += wrong > 0
        bad_plans += verdict is not None and int(verdict) != 0
    if not state["sample"]:
        bad_bytes = ext
    per = state["mix"]["extent_blocks"]
    draw = rng(state["seed"], 4)
    sampled = [e for _, e, _ in state["sample"]][:state["mix"]["check_blocks"]]
    bad_lanes = _lane_mismatches(
        state, [(e, int(draw.integers(0, per))) for e in sampled])
    rec["failed"] = bad_req
    store = state["store_comp_bytes"]
    rec["checked"] = (f"{len(state['sample'])} requests, the lanes of "
                      f"{len(sampled)} blocks; the store holds {store} "
                      f"compressed bytes, "
                      f"{store / yardstick.L2_BYTES:.2f} times the card's L2")
    return [check("bad_bytes", bad_bytes, 0),
            check("bad_plans", bad_plans, 0),
            check("bad_lanes", bad_lanes, 0)]
