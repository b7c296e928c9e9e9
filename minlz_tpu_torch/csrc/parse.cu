// K1: MinLZ parse of hinted segment lanes into op records, token-parallel.
//
// Replaces the TPU kernel minlz_tpu/ops/pallas_decode.py::_make_parse_kernel
// (reached through parse_segments_pallas), which steps every lane through one
// compressed byte per row in lockstep and writes one record row per byte row.
//
// What bounds it here.  The records out (seven int32 fields in len + 1 slots
// per lane) are the bytes to move; the arithmetic is small.  But a token's
// start depends on the one before it, so some part of the work is a chain
// per lane, and a batch has only about 2048 lanes.  Walked byte by byte
// through the 27-field transducer step (ops/transducer.py) by one thread per
// lane, the chain is ~150 dependent operations per byte on 16 of 132 SMs.
//
// What the design does about it (ops/parse_model.py states the same
// algorithm in torch, window size as an argument; its docstring says what
// each token emits).  One thread block per lane, windows of kWindow bytes
// that each begin at a token start:
//
// 1. stage: the window's bytes (and kHalo more, zero past the lane end) go
//    to shared memory in 16-byte loads;
// 2. table: for every offset i of the window at once, the token that would
//    start there: header length (a Copy3 reads its offset bytes for its
//    length-extension count), literal count, nxt[i] = i + header + literals;
// 3. chain: jump tables nxt2 = nxt(nxt), nxt3, nxt4 (two more parallel
//    passes), then one thread follows them from the window's first byte,
//    four independent shared loads for four tokens (not per byte), and
//    lists the token starts;
// 4. records: one thread per token, in rounds of kThreads tokens; a block
//    scan gives each token what the transducer carries to it (dpos wrapping
//    sum, rep carry-forward from 1, the last literal phase's first bytes,
//    the record slot), and the held literal run is the token before.  A
//    token writes 0-2 records to consecutive slots: neighbouring threads
//    store to neighbouring addresses.  The scans' carries and the held run
//    pass from round to round and window to window.
//
// At the lane end the kernel flushes a held run and writes zeros to the
// lane's unused slots itself, so the caller allocates without a fill.
//
// Output: record k of lane l lands in slot lane_slot(l) + k of each of the
// seven field arrays (kind, dst, clen, csrc, lsrc, llen, lacc), with
// lane_slot(l) = lane_start[l] + l, so a lane has room for its len + 1
// rows.  counts[l] is the number of records of lane l.  Hostile bytes never
// fault: every read is bounded by the lane and by comp.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWindow = 2048;                     // ops/parse_model.py: WINDOW
constexpr int kHalo = 16;                         // bytes a decode may read
constexpr int kStage = kWindow + kHalo + 16;      // + the alignment shift
constexpr int kOut = 0xFFFF;                      // nxt leaves the window
constexpr unsigned kFull = 0xffffffffu;
enum { OP_LIT = 1, OP_COPY = 2 };

// The token that starts at s[0] (s[0 .. kHalo) staged, 0 past the lane
// end), at lane offset i of a lane of n bytes.
struct Tok {
  bool lit, imm, pend, rep, sets, complete, done;
  int litcnt, L, e, clen, off, pa;
  unsigned w;      // output bytes the token adds to dpos
  long long nxt;   // lane offset of the next token
};

__device__ __forceinline__ Tok decode(const unsigned char* s, int i, int n) {
  const int b0 = s[0];
  const int tag = b0 & 3, val = b0 >> 2;
  const bool c3 = (val & 1) != 0;
  const int code0 = val >> 1;
  const int c3_code = (val >> 3) | ((s[1] & 7) << 3);
  int off_bytes, code, lext;
  if (tag == 0) {
    off_bytes = 0, code = code0, lext = max(code0 - 28, 0);
  } else if (tag == 1) {
    off_bytes = 1, code = val & 15, lext = code == 15;
  } else if (tag == 2) {
    off_bytes = 2, code = val, lext = max(val - 60, 0);
  } else if (c3) {
    off_bytes = 3, code = c3_code, lext = max(c3_code - 60, 0);
  } else {
    off_bytes = 2, code = (val >> 3) & 7, lext = 0;
  }
  const int h = 1 + off_bytes + lext;
  int acc_off = 0, acc_len = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < off_bytes) acc_off |= s[1 + k] << (8 * k);
    if (k < lext) acc_len |= s[1 + off_bytes + k] << (8 * k);
  }
  Tok t;
  t.litcnt = tag == 3 ? ((val >> 1) & 3) + (c3 ? 0 : 1) : 0;
  const int lit_len = code < 29 ? code + 1 : acc_len + 30;
  const int len_c1 = code < 15 ? code + 4 : acc_len + 18;
  const int len_c23 = code < 61 ? code + 4 : acc_len + 64;
  t.rep = tag == 0 && c3;
  t.lit = tag == 0 && !c3;
  t.pend = tag == 3 && (!c3 || t.litcnt > 0);
  t.imm = !t.lit && !t.pend;
  t.sets = tag != 0;
  t.clen = tag == 0 ? lit_len
                    : (tag == 1 ? len_c1 : (tag == 3 && !c3 ? code + 4
                                                            : len_c23));
  t.off = tag == 1 ? ((acc_off << 2) | (val >> 4)) + 1
                   : (tag == 3 && c3 ? (acc_off >> 3) + 65536 : acc_off + 64);
  t.L = t.lit ? lit_len : (t.pend ? t.litcnt : 0);
  const long long e = (long long)i + h;
  t.e = (int)e;
  t.nxt = e + t.L;
  t.w = (unsigned)(t.lit ? lit_len : (t.imm ? t.clen : t.litcnt + t.clen));
  t.complete = e <= n;
  t.done = e + t.litcnt <= n;
  unsigned pa = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < t.L) pa |= (unsigned)s[h + k] << (8 * k);
  t.pa = (int)pa;
  return t;
}

// What the transducer carries from token to token, as a scan element.
struct Agg {
  unsigned d;   // dpos, wrapping
  int cnt;      // records
  int rep;      // repeat offset, if flags & 1
  int pa;       // literal accumulator, if flags & 2
  int flags;
};

__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  Agg c;
  c.d = a.d + b.d;
  c.cnt = a.cnt + b.cnt;
  c.rep = (b.flags & 1) ? b.rep : a.rep;
  c.pa = (b.flags & 2) ? b.pa : a.pa;
  c.flags = a.flags | b.flags;
  return c;
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int delta) {
  Agg b;
  b.d = __shfl_up_sync(kFull, a.d, delta);
  b.cnt = __shfl_up_sync(kFull, a.cnt, delta);
  b.rep = __shfl_up_sync(kFull, a.rep, delta);
  b.pa = __shfl_up_sync(kFull, a.pa, delta);
  b.flags = __shfl_up_sync(kFull, a.flags, delta);
  return b;
}

// A held literal run: the last token, if it was one.
struct Held {
  int have, dst, src, len;
};

__device__ __forceinline__ void put(int* __restrict__ recs, long long n_slots,
                                    long long s, int kind, int dst, int clen,
                                    int csrc, int lsrc, int llen, int lacc) {
  recs[s] = kind;
  recs[n_slots + s] = dst;
  recs[2 * n_slots + s] = clen;
  recs[3 * n_slots + s] = csrc;
  recs[4 * n_slots + s] = lsrc;
  recs[5 * n_slots + s] = llen;
  recs[6 * n_slots + s] = lacc;
}

// row[a .. b) = 0 by the whole block: 16-byte stores between the scalar
// head and tail (the unused slots are most of a lane's, so these stores are
// most of the kernel's bytes).
__device__ __forceinline__ void zero_fill(int* __restrict__ row, long long a,
                                          long long b) {
  const int tid = threadIdx.x;
  const int skew = (int)((reinterpret_cast<unsigned long long>(row + a) >> 2)
                         & 3);
  const long long head = min(b, a + ((4 - skew) & 3));
  if (a + tid < head) row[a + tid] = 0;
  const long long nv = max(b - head, 0LL) / 4;
  int4* v = reinterpret_cast<int4*>(row + head);
  for (long long j = tid; j < nv; j += kThreads) v[j] = make_int4(0, 0, 0, 0);
  for (long long s = head + 4 * nv + tid; s < b; s += kThreads) row[s] = 0;
}

// The window's bytes [g0, g0 + nbytes) of comp into stage[shift ..), zeros
// around them; 16-byte loads where a chunk lies wholly inside.
__device__ __forceinline__ void stage_window(
    const unsigned char* __restrict__ comp, long long n_comp, long long g0,
    int nbytes, unsigned char* stage, int* shift_out) {
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(comp + g0);
  const int shift = (int)(addr & 15);
  const long long lo = g0, hi = min(g0 + nbytes, n_comp);
  for (int c = threadIdx.x; c < kStage / 16; c += kThreads) {
    const long long ga = g0 - shift + 16LL * c;  // comp index of the chunk
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ga >= lo && ga + 16 <= hi) {
      v = __ldg(reinterpret_cast<const uint4*>(comp + ga));
    } else if (ga + 16 > lo && ga < hi) {
      unsigned wd[4] = {0, 0, 0, 0};
      for (int k = 0; k < 16; ++k) {
        const long long g = ga + k;
        if (g >= lo && g < hi) wd[k >> 2] |= (unsigned)comp[g] << (8 * (k & 3));
      }
      v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    reinterpret_cast<uint4*>(stage)[c] = v;
  }
  *shift_out = shift;
}

// Eight blocks a SM (64 registers a thread; 22.7 KB of shared memory each)
// keep 1056 lanes in flight.
__global__ void __launch_bounds__(kThreads, 8)
parse_kernel(const unsigned char* __restrict__ comp, long long n_comp,
             const int* __restrict__ lane_start,
             const int* __restrict__ lane_len, int* __restrict__ recs,
             long long n_slots, int* __restrict__ counts) {
  __shared__ __align__(16) unsigned char stage[kStage];
  __shared__ unsigned short nxt[kWindow];
  __shared__ unsigned short tok[kWindow];
  __shared__ unsigned short nxt2[kWindow], nxt3[kWindow], nxt4[kWindow];
  __shared__ Agg warp_tot[kThreads / 32];
  __shared__ Agg carry;
  __shared__ Held held;
  __shared__ int n_tok;
  __shared__ long long next_start;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31, warp = tid >> 5;
  const long long start = lane_start[lane];
  const int len = max(lane_len[lane], 0);
  const long long slot0 = start + lane;
  if (tid == 0) {
    carry = Agg{0u, 0, 1, 0, 0};  // rep starts at 1 in every segment
    held = Held{0, 0, 0, 0};
  }

  long long w0 = 0;  // lane offset of the window's first token
  while (w0 < len) {
    const int avail = (int)min((long long)kWindow, len - w0);
    int shift;
    stage_window(comp, n_comp, start + w0,
                 (int)min((long long)kWindow + kHalo, len - w0), stage,
                 &shift);
    __syncthreads();
    const unsigned char* win = stage + shift;
    for (int i = tid; i < avail; i += kThreads) {
      const long long q = decode(win + i, (int)w0 + i, len).nxt - w0;
      nxt[i] = (unsigned short)(q < avail ? q : kOut);
    }
    __syncthreads();
    for (int i = tid; i < avail; i += kThreads) {
      const int q = nxt[i];
      nxt2[i] = (unsigned short)(q == kOut ? kOut : nxt[q]);
    }
    __syncthreads();
    for (int i = tid; i < avail; i += kThreads) {
      const int q = nxt[i], q2 = nxt2[i];
      nxt3[i] = (unsigned short)(q == kOut ? kOut : nxt2[q]);
      nxt4[i] = (unsigned short)(q2 == kOut ? kOut : nxt2[q2]);
    }
    __syncthreads();
    if (tid == 0) {
      int p = 0, n = 0;
      for (;;) {
        const int q1 = nxt[p], q2 = nxt2[p], q3 = nxt3[p], q4 = nxt4[p];
        tok[n++] = (unsigned short)p;
        if (q1 == kOut) break;
        tok[n++] = (unsigned short)q1;
        if (q2 == kOut) { p = q1; break; }
        tok[n++] = (unsigned short)q2;
        if (q3 == kOut) { p = q2; break; }
        tok[n++] = (unsigned short)q3;
        if (q4 == kOut) { p = q3; break; }
        p = q4;
      }
      n_tok = n;
      next_start = decode(win + p, (int)w0 + p, len).nxt;
    }
    __syncthreads();

    const int n = n_tok;
    for (int r0 = 0; r0 < n; r0 += kThreads) {
      const int k = r0 + tid;
      const bool valid = k < n;
      Tok t{}, tp{};
      Held hd = {0, 0, 0, 0};
      Agg a = {0u, 0, 0, 0, 0};
      if (valid) {
        const int i = tok[k];
        t = decode(win + i, (int)w0 + i, len);
        if (k > 0) {
          const int ip = tok[k - 1];
          tp = decode(win + ip, (int)w0 + ip, len);
          hd = Held{tp.lit, 0, tp.e, tp.L};
        } else {
          hd = held;
        }
        if (t.complete) {
          a.d = t.w;
          a.cnt = (hd.have && (t.lit || t.pend)) +
                  (t.imm || (t.pend && t.done));
          a.rep = t.off;
          a.pa = t.pa;
          a.flags = (t.sets ? 1 : 0) | (t.lit || t.pend ? 2 : 0);
        } else {
          a.d = t.w;
        }
      }
      // Block scan: warp scans, then the warps' totals from the carry.
      Agg inc = a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const Agg y = shfl_up(inc, o);
        if (wl >= o) inc = combine(y, inc);
      }
      Agg exc = shfl_up(inc, 1);
      if (wl == 0) exc = Agg{0u, 0, 0, 0, 0};
      if (wl == 31) warp_tot[warp] = inc;
      __syncthreads();
      Agg pre = carry;
      for (int v = 0; v < warp; ++v) pre = combine(pre, warp_tot[v]);
      exc = combine(pre, exc);
      inc = combine(pre, inc);
      __syncthreads();
      if (tid == kThreads - 1) carry = inc;

      if (valid) {
        const int D = (int)exc.d;
        if (k > 0) hd.dst = (int)(exc.d - tp.w);
        // The held run after the window: this token, or, when its header
        // runs past the lane end (only the last token's can), the one before.
        if (k == n - 1) held = t.complete ? Held{t.lit, D, t.e, t.L} : hd;
      }
      if (valid && t.complete) {
        const int D = (int)exc.d;
        long long s = slot0 + exc.cnt;
        if (hd.have && (t.lit || t.pend))
          put(recs, n_slots, s++, OP_LIT, hd.dst, 0, 0, hd.src, hd.len,
              exc.pa);
        if (t.imm)
          put(recs, n_slots, s, OP_COPY, hd.have ? hd.dst : D, t.clen,
              t.rep ? exc.rep : t.off, hd.have ? hd.src : 0,
              hd.have ? hd.len : 0, exc.pa);
        else if (t.pend && t.done)
          put(recs, n_slots, s, OP_COPY, D, t.clen, t.off, t.e, t.litcnt,
              t.pa);
      }
    }
    w0 = next_start;
    __syncthreads();
  }

  // The flush row: the held run, then zeros in the lane's unused slots.
  const int flush = held.have;
  const long long used = (long long)carry.cnt + flush;
  if (tid == 0) {
    if (flush)
      put(recs, n_slots, slot0 + carry.cnt, OP_LIT, held.dst, 0, 0, held.src,
          held.len, carry.pa);
    counts[lane] = (int)used;
  }
  // The last lane also zeroes the slots past every lane (comp may be
  // longer than its lanes).
  const long long end = blockIdx.x + 1 == gridDim.x ? n_slots : slot0 + len + 1;
  for (int f = 0; f < 7; ++f)
    zero_fill(recs + f * n_slots, slot0 + used, end);
}

}  // namespace

// comp: [n_comp] uint8, the lanes' bytes; lane_start/lane_len: [lanes]
// int32, lane_start the exclusive prefix sum of lane_len; recs: [7,
// n_slots] int32 (any contents: every slot of every lane is written),
// n_slots >= the last lane's start + lanes; counts: [lanes] int32.
MINLZ_EXPORT int minlz_parse(const void* comp, long long n_comp,
                             const void* lane_start, const void* lane_len,
                             int lanes, void* recs, long long n_slots,
                             void* counts, void* stream) {
  if (lanes > 0) {
    parse_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)comp, n_comp, (const int*)lane_start,
        (const int*)lane_len, (int*)recs, n_slots, (int*)counts);
  }
  return (int)cudaGetLastError();
}

MINLZ_EXPORT const char* minlz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
