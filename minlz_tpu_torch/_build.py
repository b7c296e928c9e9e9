"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled with nvcc for Hopper (``sm_90a``), one
nvcc process per source and all of them at once, and linked into one shared
library with a plain C interface, at first use, under
``build/minlz_tpu_torch/`` at the root of the checkout, and loaded with
ctypes.  Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  A missing nvcc or a failed compile
raises with the compiler's output.

Each kernel wrapper adds one to its entry in the launch counts when it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "minlz_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libminlz_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# One count per kernel.  "compact" counts the positioned compaction at
# range spans and at whole-block spans alike: it is one kernel.
# "lane_offsets" is the scan of the lane counts in front of both
# compactions.
KERNELS = ("parse", "lane_offsets", "compact", "exec_range", "greedy",
           "exec_block", "compact_dense", "exec_sched", "probe_scalar",
           "probe_gather", "probe_taa", "probe_chain_body", "ablate_exec",
           "emit", "derive")
_launches = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    # comp, n_comp, lane_start, lane_len, lane_rep (or null), lanes, recs,
    # n_slots, counts, stream
    "minlz_parse": [_P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int, _P,
                    ctypes.c_longlong, _P, _P],
    # lane_cnt, lanes, lane_out, stream
    "minlz_lane_offsets": [_P, ctypes.c_int, _P, _P],
    # recs, n_slots, lane_start, lane_len, lane_cnt, lane_out, lane_lo,
    # lane_hi, lanes, out, n_out, stream
    "minlz_compact": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                      ctypes.c_int, _P, ctypes.c_longlong, _P],
    # recs, n_slots, lane_start, lane_len, lane_cnt, lane_out, lanes, out,
    # n_out, stream
    "minlz_compact_dense": [_P, ctypes.c_longlong, _P, _P, _P, _P,
                            ctypes.c_int, _P, ctypes.c_longlong, _P],
    # recs, n_recs, range_first, range_out, range_span, n_ranges,
    # max_span, comp, n_comp, out, stream
    "minlz_exec_ranges": [_P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                          ctypes.c_int, _P, ctypes.c_longlong, _P, _P],
    # ... then pos (the int32 position scratch), stream
    "minlz_exec_sched": [_P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                         ctypes.c_int, _P, ctypes.c_longlong, _P, _P, _P],
    # recs, n_recs, block_first, block_out, block_span, n_blocks, comp,
    # n_comp, out, total_out, scratch, phases, stream
    "minlz_exec_blocks": [_P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                          _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P,
                          ctypes.c_int, _P],
    # off, len, lanes, seg, take, tok_off, tok_len, is_rep, stream
    "minlz_greedy": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P],
    # out[4]: registers, shared bytes, threads, resident blocks a SM
    "minlz_greedy_attrs": [_P],
    # comp, n_comp, body_off, out_len, n_blocks, total_out, seg, lanes,
    # lane_start, lane_len, lane_lo, lane_hi, lane_rep, range_lane,
    # range_out, range_span, bad, boff, tab, stream
    "minlz_derive": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # data, surv, off, vlen, n, rows, nseg, seg, out, out_lens, stream
    "minlz_emit": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P, _P],
    # seg, out[4]: as minlz_greedy_attrs, shared bytes at this seg
    "minlz_emit_attrs": [ctypes.c_int, _P],
    # rows, n_ops, n_chains, n_rows, buf, shared, grid, cluster, share,
    # smem, stream
    "minlz_probe_scalar": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P],
    # meta, n_ops, n_chains, n_rows, buf, shared, realign, stream
    "minlz_probe_chain_body": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               _P, ctypes.c_int, ctypes.c_int, _P],
    # tbl, tbl_n, idx, n_iters, out, grid, cluster, smem, scratch, tickets,
    # stream
    "minlz_probe_gather": [_P, ctypes.c_int, _P, ctypes.c_int, _P,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                           _P],
    # a, idx, n_iters, out, grid, cluster, smem, scratch, tickets, stream
    "minlz_probe_taa": [_P, _P, ctypes.c_int, _P, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, _P, _P],
    # counts, ops, cap, nchain, arena_in, out, n_rows, out_base_row,
    # chain_rows, variant, stream
    "minlz_ablate_exec": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, _P],
}


def sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build() -> tuple[float, str]:
    """Compile the kernels into LIB_PATH.  Returns (seconds, compiler
    output).  Raises RuntimeError with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    cmds = []
    for src in sources():
        if src.endswith(".cu"):
            stem = os.path.splitext(os.path.basename(src))[0]
            obj = os.path.join(BUILD_DIR, f"{stem}.{tag}.o")
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
    objs = [c[-2] for c in cmds]
    tmp = f"{LIB_PATH}.{tag}"
    log = []
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = None
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, out)
        if failed is None:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            log.append(res.stdout)
            if res.returncode != 0:
                failed = (cmd, res.returncode, res.stdout)
        if failed is not None:
            cmd, code, out = failed
            raise RuntimeError(
                f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    return time.perf_counter() - t0, "".join(log)


def load():
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.minlz_error_string.argtypes = [ctypes.c_int]
            lib.minlz_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib, err: int) -> None:
    if err != 0:
        msg = lib.minlz_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA launch failed: error {err} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(kernel: str) -> None:
    _launches[kernel] += 1


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)
