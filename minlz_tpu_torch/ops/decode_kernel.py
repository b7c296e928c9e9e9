"""Host reference of the segment decode: transducer parse + a record walk.

The counterpart of ``minlz_tpu.ops.decode_kernel`` (``pack_segments``,
``execute_ops_host``, ``decode_segments_jnp``).  Nothing on a decode path
runs this module: the walk is one Python step per record, in numpy, and
shares no code with the executors of ``exec_chain.py`` and
``exec_block.py``, so the tests use it as their referee.

The layouts are the port's: the lanes' compressed bytes lie back to back in
one array, and record k of lane l sits in slot ``lane_start[l] + l + k`` of
the parse output (``ops/parse.py``).  Unlike the JAX walk, which decodes
every segment on its own, this one walks a whole block: lane l writes at
``l * seg + dst``, and a copy may read any earlier byte of the block.
"""

from __future__ import annotations

import numpy as np
import torch

from .parse import parse_segments_plain


def pack_segments(seg_bytes_list):
    """Pack ragged compressed segments into the parse's input: (comp [n >= 1]
    uint8, the segments back to back; lane_start [B] int32; lane_len [B]
    int32)."""
    lens = np.array([len(s) for s in seg_bytes_list], np.int64)
    comp = np.frombuffer(b"".join(bytes(s) for s in seg_bytes_list)
                         or b"\x00", np.uint8).copy()
    start = np.cumsum(lens) - lens
    return comp, start.astype(np.int32), lens.astype(np.int32)


def execute_ops_host(recs, counts, comp, lane_start, seg: int):
    """Walk every lane's records in order.  recs [7, n_slots] / counts
    [lanes]: the parse output (kind, dst, clen, csrc, lsrc, llen, lacc), as
    numpy arrays.  Each record places its literal run (llen bytes of the
    lane's compressed stream at lsrc) at ``lane * seg + dst``, then its copy
    (clen bytes from csrc back) behind it.  Returns the block's
    ``lanes * seg`` bytes.  Raises ValueError on a copy that reaches before
    the block or a record that leaves it."""
    recs = np.asarray(recs)
    comp = np.asarray(comp)
    lanes = len(counts)
    out = np.zeros(lanes * seg, np.uint8)
    for lane in range(lanes):
        slot0 = int(lane_start[lane]) + lane
        for k in range(int(counts[lane])):
            _, dst, clen, csrc, lsrc, llen, _ = (
                int(v) for v in recs[:, slot0 + k])
            d = lane * seg + dst
            if d + llen + clen > len(out):
                raise ValueError(f"lane {lane}: record leaves the block")
            if llen:
                src = int(lane_start[lane]) + lsrc
                out[d : d + llen] = comp[src : src + llen]
                d += llen
            if clen:
                if csrc <= 0 or csrc > d:
                    raise ValueError(
                        f"lane {lane}: copy offset {csrc} at position {d}")
                s = d - csrc
                if csrc >= clen:
                    out[d : d + clen] = out[s : s + clen]
                else:
                    # Overlap: byte-serial copy semantics make the result
                    # periodic with period csrc.
                    reps = -(-clen // csrc)
                    out[d : d + clen] = np.tile(out[s:d], reps)[:clen]
    return out.tobytes()


def decode_segments(seg_bytes_list, out_total: int, seg: int):
    """Decode one block from its segments on the host: the plain parse on
    the CPU, then the record walk.  Returns the block's first ``out_total``
    bytes."""
    comp, lane_start, lane_len = pack_segments(seg_bytes_list)
    recs, counts = parse_segments_plain(
        torch.from_numpy(comp), torch.from_numpy(lane_start),
        torch.from_numpy(lane_len))
    out = execute_ops_host(recs.numpy(), counts.numpy(), comp, lane_start,
                           seg)
    return out[:out_total]
