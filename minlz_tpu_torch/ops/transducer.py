"""Byte-lockstep parse transducer for MinLZ decode, in torch.

The twin of ``minlz_tpu.ops.transducer``: the same 27 state fields, the same
step and the same seven emitted record fields, computed on int32 tensors of
shape [lanes].  All lanes consume one compressed byte per step; divergence
between lanes lives in per-lane state, never in addressing.

It is the body of the plain version of the parse kernel
(``ops/parse.py::parse_segments_plain``); ``csrc/parse.cu`` computes the
same records token by token, not byte by byte (``ops/parse_model.py``
states how).

Emitted op records (one per row at most; literal runs are held and fused
onto the next copy token):
  kind:  0 = none, 1 = literal-only, 2 = has-copy (may carry fused lits)
  dst:   segment-local output offset of the record (lits first, then copy)
  clen:  copy length (0 for literal-only records)
  csrc:  copy back-reference distance (offset)
  lsrc:  compressed-stream row of the first literal byte
  llen:  literal run length (0 when the copy has no attached literals)
  lacc:  the literal accumulator after this step: the run's first four
         literal bytes packed little-endian
A held literal is flushed alone when another literal run begins or at the
end-of-segment flush row (row == segment compressed length).
"""

from __future__ import annotations

import torch

# Modes
IDLE, HDR, LIT = 0, 1, 2
# Kinds (internal)
K_LITRUN, K_REPEAT, K_COPY1, K_COPY2, K_COPY3, K_FUSED2 = 0, 1, 2, 3, 4, 5
# Emitted op kinds
OP_NONE, OP_LIT, OP_COPY = 0, 1, 2

STATE_FIELDS = (
    "mode", "kind", "code", "tagval", "litcnt",
    "off_left", "lext_left", "acc_off", "acc_off_cnt", "acc_len",
    "acc_len_cnt", "c3_pend", "c3_off",
    "lit_left", "have_pend", "pend_off", "pend_len",
    "pend_lsrc", "pend_llen",
    "have_lit", "hl_dst", "hl_src", "hl_len",
    "dpos", "rep", "lit_acc", "lit_pos",
)

_I32 = torch.int32
_CONST_CACHE = {}


def _consts(device) -> dict:
    """0-dim int32 constants on ``device``: torch wraps a Python scalar
    operand anew on every op, which dominates a step on small lanes."""
    c = _CONST_CACHE.get(device)
    if c is None:
        vals = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 18, 28, 29, 30, 60, 61, 63,
                64, 255, 65536)
        c = {v: torch.tensor(v, dtype=_I32, device=device) for v in vals}
        _CONST_CACHE[device] = c
    return c


def init_state(lanes: int, device) -> dict:
    st = {f: torch.zeros(lanes, dtype=_I32, device=device)
          for f in STATE_FIELDS}
    st["rep"] = torch.ones(lanes, dtype=_I32, device=device)
    return st


def parse_step(st, byte, active, row, flush=None):
    """One transducer step.

    st:     dict of [lanes] int32 tensors.
    byte:   [lanes] int32, the compressed byte at this row (any value where
            inactive).
    active: [lanes] bool, row < segment compressed length.
    row:    [lanes] int32 (or an int), the row index of each lane.
    flush:  [lanes] bool, row == segment compressed length (None: no lane
            is at its flush row).

    Returns (new_state, (kind, dst, clen, csrc, lsrc, llen, lacc)).
    """
    if flush is None:
        flush = torch.zeros_like(active)
    w = torch.where
    c = _consts(byte.device)
    zero = c[0]
    one = c[1]
    mode = st["mode"]
    is_idle = active & (mode == c[IDLE])
    is_hdr = active & (mode == c[HDR])
    is_lit = active & (mode == c[LIT])

    # ---------------- IDLE: byte is a tag ---------------------------------
    tag = byte & c[3]
    val = byte >> c[2]
    t0 = tag == zero
    t1 = tag == one
    t2 = tag == c[2]
    t3 = tag == c[3]
    c3 = (val & one) == one
    t12 = t1 | t2

    code0 = val >> one
    # K_LITRUN/K_REPEAT for tag 0, K_COPY1/K_COPY2 (= tag + 1) for tags 1
    # and 2, K_COPY3/K_FUSED2 for tag 3.
    i_kind = w(t0, w(c3, c[K_REPEAT], zero),
               w(t12, tag + one, w(c3, c[K_COPY3], c[K_FUSED2])))
    i_code = w(t0, code0,
               w(t1, val & c[15], w(t2, val, w(c3, zero, (val >> c[3]) & c[7]))))
    i_off_bytes = w(t0, zero, w(t1, one, w(t2 | ~c3, c[2], c[3])))
    i_lext = w(t0, torch.clamp(code0 - c[28], min=0),
               w(t1, ((val & c[15]) == c[15]).to(_I32),
                 w(t2, torch.clamp(val - c[60], min=0), zero)))
    i_c3_pend = (t3 & c3).to(_I32)
    lc = (val >> one) & c[3]
    i_litcnt = w(t3, w(c3, lc, lc + one), zero)

    # ---------------- HDR: accumulate header bytes -------------------------
    off_left0 = st["off_left"]
    to_off = is_hdr & (off_left0 > zero)
    to_len = is_hdr & (off_left0 == zero)
    h_acc_off = w(to_off, st["acc_off"] | (byte << (c[8] * st["acc_off_cnt"])),
                  st["acc_off"])
    h_acc_off_cnt = st["acc_off_cnt"] + to_off
    h_off_left = w(to_off, off_left0 - one, off_left0)
    h_acc_len = w(to_len, st["acc_len"] | (byte << (c[8] * st["acc_len_cnt"])),
                  st["acc_len"])
    h_acc_len_cnt = st["acc_len_cnt"] + to_len
    h_lext_left = w(to_len, st["lext_left"] - one, st["lext_left"])

    # Copy3 late resolution (SPEC.md §2.5.2).
    c3_ready = is_hdr & (st["c3_pend"] == one) & (h_off_left == zero)
    full = st["tagval"] | (h_acc_off << c[6])
    c3_code = (full >> c[3]) & c[63]
    h_code = w(c3_ready, c3_code, st["code"])
    h_c3_off = w(c3_ready, (full >> c[9]) + c[65536], st["c3_off"])
    h_lext_left = w(c3_ready, torch.clamp(c3_code - c[60], min=0),
                    h_lext_left)
    h_c3_pend = w(c3_ready, zero, st["c3_pend"])

    # ---------------- Merge IDLE/HDR views --------------------------------
    kind = w(is_idle, i_kind, st["kind"])
    code = w(is_idle, i_code, h_code)
    tagval = w(is_idle, val, st["tagval"])
    litcnt = w(is_idle, i_litcnt, st["litcnt"])
    off_left = w(is_idle, i_off_bytes, h_off_left)
    lext_left = w(is_idle, i_lext, h_lext_left)
    acc_off = w(is_idle, zero, h_acc_off)
    acc_off_cnt = w(is_idle, zero, h_acc_off_cnt)
    acc_len = w(is_idle, zero, h_acc_len)
    acc_len_cnt = w(is_idle, zero, h_acc_len_cnt)
    c3_pend = w(is_idle, i_c3_pend, h_c3_pend)
    c3_off_v = w(is_idle, zero, h_c3_off)

    # ---------------- Finalize (token header complete) ---------------------
    fin = (is_idle | is_hdr) & (off_left == zero) & (lext_left == zero) & (
        c3_pend == zero)
    k_lit = fin & (kind == c[K_LITRUN])
    k_rep = fin & (kind == c[K_REPEAT])
    k_c1 = fin & (kind == c[K_COPY1])
    k_c2 = fin & (kind == c[K_COPY2])
    k_c3 = fin & (kind == c[K_COPY3])
    k_f2 = fin & (kind == c[K_FUSED2])

    lit_len = w(code < c[29], code + one, acc_len + c[30])
    len_c1 = w(code < c[15], code + c[4], acc_len + c[18])
    len_c23 = w(code < c[61], code + c[4], acc_len + c[64])
    len_f2 = code + c[4]

    off_c1 = ((acc_off << c[2]) | (tagval >> c[4])) + one
    off_c2 = acc_off + c[64]
    off_f2 = off_c2
    off_c3v = c3_off_v

    has_lits = litcnt > zero
    imm_copy = k_rep | k_c1 | k_c2 | (k_c3 & ~has_lits)
    imm_off = w(k_rep, st["rep"], w(k_c1, off_c1, w(k_c2, off_c2, off_c3v)))
    imm_len = w(k_rep, lit_len, w(k_c1, len_c1, len_c23))

    pend = k_f2 | (k_c3 & has_lits)
    enter_lit = k_lit | pend
    lit_phase_len = w(k_lit, lit_len, litcnt)
    pend_off_new = w(k_f2, off_f2, off_c3v)
    pend_len_new = w(k_f2, len_f2, len_c23)

    # ---------------- LIT phase ------------------------------------------
    lit_left_dec = w(is_lit, st["lit_left"] - one, st["lit_left"])
    lit_end = is_lit & (lit_left_dec == zero)
    emit_pend = lit_end & (st["have_pend"] == one)

    do_acc = is_lit & (st["lit_pos"] < c[4])
    lacc_step = w(do_acc,
                  st["lit_acc"] | ((byte & c[255]) << (c[8] * st["lit_pos"])),
                  st["lit_acc"])
    lpos_step = st["lit_pos"] + is_lit

    # ---------------- Emission -------------------------------------------
    have_lit = st["have_lit"] == one
    hold_new = k_lit
    flush_held = (enter_lit | flush) & have_lit
    emit_comb = imm_copy | emit_pend

    comb_llen = w(emit_pend, st["pend_llen"], w(have_lit, st["hl_len"], zero))
    comb_lsrc = w(emit_pend, st["pend_lsrc"], w(have_lit, st["hl_src"], zero))
    comb_dst = w(emit_pend, st["dpos"] - st["pend_llen"],
                 w(have_lit, st["hl_dst"], st["dpos"]))
    op_kind = w(emit_comb, c[OP_COPY], w(flush_held, c[OP_LIT], zero))
    op_dst = w(emit_comb, comb_dst, st["hl_dst"])
    pend_or_zero_len = w(emit_pend, st["pend_len"], zero)
    op_clen = w(imm_copy, imm_len, pend_or_zero_len)
    op_csrc = w(imm_copy, imm_off, w(emit_pend, st["pend_off"], zero))
    op_lsrc = w(emit_comb, comb_lsrc, st["hl_src"])
    op_llen = w(emit_comb, comb_llen, w(flush_held, st["hl_len"], zero))

    # ---------------- State update ---------------------------------------
    dpos = st["dpos"] + w(enter_lit, lit_phase_len, op_clen)
    rep = w(k_c1, off_c1,
            w(k_c2, off_c2, w(k_c3, off_c3v, w(k_f2, off_f2, st["rep"]))))
    new_mode = w(
        enter_lit, c[LIT],
        w(fin, c[IDLE],
          w(is_lit, w(lit_end, c[IDLE], c[LIT]),
            w(is_idle | is_hdr, c[HDR], mode))),
    )

    a = active
    ap = active & pend
    ah = active & hold_new
    row1 = row + 1
    new_st = {
        "mode": w(a, new_mode, mode),
        "kind": w(a, kind, st["kind"]),
        "code": w(a, code, st["code"]),
        "tagval": w(a, tagval, st["tagval"]),
        "litcnt": w(a, litcnt, st["litcnt"]),
        "off_left": w(a, off_left, off_left0),
        "lext_left": w(a, lext_left, st["lext_left"]),
        "acc_off": w(a, acc_off, st["acc_off"]),
        "acc_off_cnt": w(a, acc_off_cnt, st["acc_off_cnt"]),
        "acc_len": w(a, acc_len, st["acc_len"]),
        "acc_len_cnt": w(a, acc_len_cnt, st["acc_len_cnt"]),
        "c3_pend": w(a, c3_pend, st["c3_pend"]),
        "c3_off": w(a, c3_off_v, st["c3_off"]),
        "lit_left": w(a, w(enter_lit, lit_phase_len, lit_left_dec),
                      st["lit_left"]),
        "have_pend": w(ap, one, w(a & emit_pend, zero, st["have_pend"])),
        "pend_off": w(ap, pend_off_new, st["pend_off"]),
        "pend_len": w(ap, pend_len_new, st["pend_len"]),
        "pend_lsrc": w(ap, row1, st["pend_lsrc"]),
        "pend_llen": w(ap, litcnt, st["pend_llen"]),
        "have_lit": w(ah, one,
                      w((a & (emit_comb | pend)) | flush,
                        zero, st["have_lit"])),
        "hl_dst": w(ah, st["dpos"], st["hl_dst"]),
        "hl_src": w(ah, row1, st["hl_src"]),
        "hl_len": w(ah, lit_phase_len, st["hl_len"]),
        "dpos": w(a, dpos, st["dpos"]),
        "rep": w(a, rep, st["rep"]),
        "lit_acc": w(a, w(enter_lit, zero, lacc_step), st["lit_acc"]),
        "lit_pos": w(a, w(enter_lit, zero, lpos_step), st["lit_pos"]),
    }
    live = active | flush
    emit = (
        w(live, op_kind, zero),
        w(live, op_dst, zero),
        w(live, op_clen, zero),
        w(live, op_csrc, zero),
        w(live, op_lsrc, zero),
        w(live, op_llen, zero),
        w(live, lacc_step, zero),
    )
    return new_st, emit
