"""Host reference of the segment decode, and the transducer parse in the
JAX package's row layout.

The counterpart of ``minlz_tpu.ops.decode_kernel``.  Two layouts live here.

*The JAX package's* (``pack_segments``, ``parse_segments_scan``,
``execute_ops_host``, ``decode_segments_jnp``), under its names and with its
arguments: segments as the columns of a ``[P, B]`` byte matrix, and the
parse as seven ``[P, B]`` int32 arrays, one row per compressed byte row,
each record at the row where the transducer emits it.
``parse_segments_scan`` runs the parse kernel ``csrc/parse.cu`` for CUDA
tensors and then lays its records out at their rows; for CPU tensors it runs
``parse_segments_scan_plain``, the row-by-row scan of ``ops/transducer.py``.
``execute_ops_host`` walks each segment's records on its own, in numpy, and
``decode_segments_jnp`` is that scan parse, then that walk.

*The port's own* (``pack_lanes``, ``execute_records_host``,
``decode_segments``): the lanes' compressed bytes lie back to back in one
array, and record k of lane l sits in slot ``lane_start[l] + l + k`` of the
parse output (``ops/parse.py``).  The walk decodes a whole block: lane l
writes at ``l * seg + dst``, and a copy may read any earlier byte of the
block.  Nothing on a decode path runs it: it is one Python step per record,
in numpy, and shares no code with the executors of ``exec_chain.py`` and
``exec_block.py``, so the tests use it as their referee.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import parse_model as pm
from .parse import N_FIELDS, parse_planned, parse_segments_plain
from .transducer import init_state, parse_step

_I64 = torch.int64


def _host(x):
    """A tensor (on any device) or an array-like as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_lanes(seg_bytes_list):
    """Pack ragged compressed segments into the parse's input: (comp [n >= 1]
    uint8, the segments back to back; lane_start [B] int32; lane_len [B]
    int32)."""
    lens = np.array([len(s) for s in seg_bytes_list], np.int64)
    comp = np.frombuffer(b"".join(bytes(s) for s in seg_bytes_list)
                         or b"\x00", np.uint8).copy()
    start = np.cumsum(lens) - lens
    return comp, start.astype(np.int32), lens.astype(np.int32)


def execute_records_host(recs, counts, comp, lane_start, seg: int):
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
    comp, lane_start, lane_len = pack_lanes(seg_bytes_list)
    recs, counts = parse_segments_plain(
        torch.from_numpy(comp), torch.from_numpy(lane_start),
        torch.from_numpy(lane_len))
    out = execute_records_host(recs.numpy(), counts.numpy(), comp,
                               lane_start, seg)
    return out[:out_total]


# --------------------------------------------------------------------------
# The JAX package's row layout: [P, B] matrices
# --------------------------------------------------------------------------

def pack_segments(seg_bytes_list):
    """Pack ragged compressed segments into the scan's input: (mat [P, B]
    int32, column b = segment b zero padded; lens [B] int32).
    P is the power of two above the longest segment, so every lane has its
    flush row (row == len)."""
    B = len(seg_bytes_list)
    P = max((len(s) for s in seg_bytes_list), default=1)
    P = 1 << max(P, 1).bit_length()
    mat = np.zeros((P, B), np.int32)
    lens = np.zeros(B, np.int32)
    for b, s in enumerate(seg_bytes_list):
        a = np.frombuffer(bytes(s), np.uint8)
        mat[: len(a), b] = a
        lens[b] = len(a)
    return mat, lens


def _check_scan(mat, lens):
    """Types and shapes, then two reads back: mat holds bytes and every
    length leaves its lane a flush row (0 <= len < P)."""
    if mat.dtype != torch.int32 or mat.dim() != 2:
        raise ValueError("mat must be a [P, B] int32 tensor")
    if lens.dtype != torch.int32 or lens.shape != mat.shape[1:]:
        raise ValueError("lens must be a [B] int32 tensor")
    if lens.device != mat.device:
        raise ValueError(f"lens is on {lens.device}, mat on {mat.device}")
    if mat.numel() and (int(mat.min()) < 0 or int(mat.max()) > 255):
        raise ValueError("mat must hold bytes (0-255)")
    if lens.numel() and (int(lens.min()) < 0
                         or int(lens.max()) >= mat.shape[0]):
        raise ValueError("every length must be in [0, P): each lane needs "
                         "its flush row")


def parse_segments_scan(mat, lens):
    """The transducer parse in the scan's layout.  mat: [P, B] int32
    compressed bytes (column = segment); lens: [B] int32 lengths, each
    < P.  Returns seven [P, B] int32 arrays (kind, dst, clen, csrc, lsrc,
    llen, lacc), the values ``minlz_tpu.ops.decode_kernel.
    parse_segments_scan`` returns: a record at the row where the
    transducer emits it, and on every other row up to the flush row the
    transducer's held run (dst, lsrc) and literal accumulator (lacc);
    zeros past it.  CUDA tensors: the parse kernel, then
    ``scan_layout``; CPU tensors: ``parse_segments_scan_plain``."""
    _check_scan(mat, lens)
    if mat.device.type == "cpu":
        return parse_segments_scan_plain(mat, lens)
    if mat.device.type != "cuda":
        raise ValueError(f"no parse kernel for device {mat.device}")
    comp, lane_start, lane_len = _matrix_lanes(mat, lens)
    recs, counts = parse_planned(comp, lane_start, lane_len)
    return scan_layout(recs, counts, comp, lane_start, lane_len,
                       mat.shape[0])


def parse_segments_scan_plain(mat, lens):
    """Plain torch version of ``parse_segments_scan`` (any device): one
    ``transducer.parse_step`` a row, vectorised over the lanes, as the JAX
    ``lax.scan`` runs it.  Rows past every lane's flush row emit nothing,
    so the loop stops there."""
    _check_scan(mat, lens)
    P, B = mat.shape
    dev = mat.device
    out = torch.zeros((N_FIELDS, P, B), dtype=torch.int32, device=dev)
    st = init_state(B, dev)
    for row in range(int(lens.max()) + 1 if B else 0):
        r = torch.full((B,), row, dtype=torch.int32, device=dev)
        active = r < lens
        byte = torch.where(active, mat[row], 0)
        st, emit = parse_step(st, byte, active, r, r == lens)
        out[:, row] = torch.stack(emit)
    return tuple(out)


def _matrix_lanes(mat, lens):
    """[P, B] matrix -> the parse kernel's lanes: (comp [n >= 1] uint8,
    the columns' first lens[b] bytes back to back; lane_start; lane_len)."""
    rows = torch.arange(mat.shape[0], device=mat.device)
    inside = rows[None, :] < lens.to(_I64)[:, None]            # [B, P]
    comp = mat.t()[inside].to(torch.uint8)
    if comp.numel() == 0:
        comp = comp.new_zeros(1)
    start = torch.cumsum(lens, 0, dtype=torch.int32) - lens
    return comp, start, lens.contiguous()


def scan_layout(recs, counts, comp, lane_start, lane_len, n_rows: int):
    """The parse's dense records (``parse.parse_segments``: recs [7,
    n_slots], counts [lanes], on lanes that tile comp) laid out as the scan
    emits them: seven [n_rows, lanes] int32 arrays.  Every lane needs
    len < n_rows.

    The row of each record comes from the lane's tokens: the token starts
    are the offsets reached from 0 by ``parse_model.decode``'s next-token
    table, found by pointer doubling (log2 of the longest lane rounds of a
    gather and a scatter over all bytes; no walk).  A token emits, at the
    row where the transducer does: a held literal run alone at the last
    header row of the next literal-entering token; an immediate copy at
    its last header row; a Fused2 / Copy3 with literals at its last
    literal row, if that lies in the lane; and the held run at the flush
    row (len), if the lane's last complete token is a literal run.  The
    k-th of these is the lane's record k.  Between them the scan shows the
    transducer's state: the last held run's dst and lsrc (its output
    position and first literal row) and the accumulator of the last
    literal phase, its bytes up to that row."""
    dev = recs.device
    lanes = lane_len.numel()
    lens = lane_len.to(_I64)
    start = lane_start.to(_I64)
    out = torch.zeros((N_FIELDS, lanes, n_rows), dtype=torch.int32,
                      device=dev)
    total = int(lens.sum()) if lanes else 0
    if total == 0:
        return tuple(out.transpose(1, 2))

    # 1. The token that would start at every byte, and the next one's
    # global byte index (-1 past the lane end).  The lanes tile comp from
    # 0, so byte i of the batch is comp[i].
    lane_of = torch.repeat_interleave(torch.arange(lanes, device=dev), lens,
                                      output_size=total)
    at = torch.arange(total, device=dev) - start[lane_of]
    tab = pm.decode(pm.lane_bytes(comp, lane_start, lane_len, lane_of, at),
                    at, lens[lane_of])
    jump = torch.where(tab["nxt"] < lens[lane_of],
                       torch.arange(total, device=dev) + tab["nxt"] - at, -1)

    # 2. Token starts: after round k every start within 2^(k+1) - 1 hops of
    # a lane's offset 0 is marked (slot ``total`` takes the misses).
    reach = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    reach[start[lens > 0]] = True
    for _ in range(int(lens.max()).bit_length()):
        reach[torch.where(reach[:total] & (jump >= 0), jump, total)] = True
        jump = torch.where(jump >= 0, jump[jump.clamp(min=0)], -1)
    tok = torch.nonzero(reach[:total])[:, 0]   # lane-major, chain order
    t = {k: v[tok] for k, v in tab.items()}
    lane = lane_of[tok]
    idx = torch.arange(tok.numel(), device=dev)
    ev = pm.token_events(t, lane, lanes)
    ok, lit_prev, own = ev["ok"], ev["lit_prev"], ev["own"]
    flush = ev["flush"]
    e = t["e"]

    # 3. The events, in row order: the k-th of a lane is its record k.
    ev_lane = torch.cat([lane[lit_prev], lane[own],
                         torch.nonzero(flush)[:, 0]])
    ev_row = torch.cat([e[lit_prev] - 1,
                        torch.where(t["imm"], e - 1,
                                    e + t["litcnt"] - 1)[own],
                        lens[flush]])
    order = torch.argsort(ev_lane * (n_rows + 1) + ev_row)
    ev_lane, ev_row = ev_lane[order], ev_row[order]
    per_lane = torch.bincount(ev_lane, minlength=lanes)
    if not torch.equal(per_lane, counts.to(_I64)):
        raise ValueError("the records do not follow the lanes' tokens")
    rank = torch.arange(ev_lane.numel(), device=dev) - (
        torch.cumsum(per_lane, 0) - per_lane)[ev_lane]

    # 4. The state between records: the last held run and the last literal
    # phase, each seen from the row after its last header row (e) on.
    def latest(sel):
        mark = torch.full((lanes, n_rows + 1), -1, dtype=_I64, device=dev)
        mark[lane[sel], e[sel]] = idx[sel]
        got = torch.cummax(mark, 1).values[:, :n_rows]
        return got >= 0, got.clamp(min=0)

    w = t["w"]
    c = torch.cumsum(w, 0)
    seg_first = torch.cummax(torch.where(ev["first"], idx, 0), 0).values
    dpos = c - w - (c - w)[seg_first]
    rows = torch.arange(n_rows, device=dev)
    live = rows[None, :] <= lens[:, None]
    has, j = latest(ok & t["lit"])
    out[1] = pm.wrap32(torch.where(has & live, dpos[j], 0))
    out[4] = pm.wrap32(torch.where(has & live, e[j], 0))
    has, j = latest(ok & (t["lit"] | t["pend"]))
    nb = (rows[None, :] - e[j] + 1).clamp(0, 4)
    acc = t["pa"][j] & (torch.bitwise_left_shift(torch.ones_like(nb),
                                                 8 * nb) - 1)
    out[6] = pm.wrap32(torch.where(has & live, acc, 0))
    out[:, ev_lane, ev_row] = recs[:, start[ev_lane] + ev_lane + rank]
    return tuple(out.transpose(1, 2))


def execute_ops_host(op_kind, op_dst, op_clen, op_csrc, op_lsrc, op_llen,
                     mat, out_lens):
    """Walk each segment's records (the non-zero rows of the [P, B] arrays
    that ``parse_segments_scan`` returns; tensors or numpy arrays) on its
    own, in numpy.  Each record places its llen literal bytes (matrix rows
    from lsrc) at dst, then its copy (clen bytes from csrc back).  Returns
    the decoded bytes of every segment, out_lens[b] each; a copy reaching
    before its segment raises ValueError."""
    op_kind, op_dst, op_clen, op_csrc, op_lsrc, op_llen = (
        _host(x) for x in (op_kind, op_dst, op_clen, op_csrc, op_lsrc,
                           op_llen))
    mat = _host(mat).astype(np.uint8)
    outs = []
    for b in range(op_kind.shape[1]):
        out = np.zeros(int(out_lens[b]), dtype=np.uint8)
        for p in np.nonzero(op_kind[:, b])[0]:
            dst = int(op_dst[p, b])
            llen = int(op_llen[p, b])
            if llen:
                src = int(op_lsrc[p, b])
                out[dst : dst + llen] = mat[src : src + llen, b]
                dst += llen
            ln = int(op_clen[p, b])
            if ln:
                off = int(op_csrc[p, b])
                if off > dst:
                    raise ValueError(
                        f"segment {b}: copy offset {off} exceeds position "
                        f"{dst}")
                s = dst - off
                if off >= ln:
                    out[dst : dst + ln] = out[s : s + ln]
                else:
                    # Overlap: byte-serial copy semantics make the result
                    # periodic with period off.
                    reps = -(-ln // off)
                    out[dst : dst + ln] = np.tile(out[s:dst], reps)[:ln]
        outs.append(out.tobytes())
    return outs


def decode_segments_jnp(seg_bytes_list, out_lens, device="cuda"):
    """Decode a batch of segments, each on its own: ``pack_segments``, then
    ``parse_segments_scan`` on ``device`` (the parse kernel on the card,
    the plain scan on the CPU), then each segment's records walked on the
    host.  Returns one bytes object per segment, out_lens[b] long.  The
    name is the JAX package's reference decoder's."""
    dev = resolve_device(device)
    mat, lens = pack_segments(seg_bytes_list)
    emits = parse_segments_scan(torch.from_numpy(mat).to(dev),
                                torch.from_numpy(lens).to(dev))
    return execute_ops_host(*emits[:6], mat, out_lens)
