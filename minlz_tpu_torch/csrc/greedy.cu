// Greedy token selection of the encoder: one thread block per segment lane,
// the lane in windows staged in shared memory, a token chain over a
// next-candidate table.
//
// Replaces the TPU kernel minlz_tpu/ops/pallas_encode.py::_greedy_kernel
// (reached through greedy_parse_pallas), which walks all lanes in lockstep
// over every position and carries (skip, rep) across a sequential grid.
//
// What it computes, per lane, from the match proposals off[r], len[r]:
// with skip = 0 and rep = -1, at each position r in order,
//   take   = skip == 0 && len[r] >= 4
//   is_rep = take && off[r] == rep
//   skip   = take ? len[r] - 1 : max(skip - 1, 0)
//   rep    = take ? off[r] : rep
// and tok_off / tok_len = off / len where take, else 0.  Put as tokens: the
// first token is the first position q >= 0 with len[q] >= 4 (a candidate),
// and the token after one at r is the first candidate q >= r + len[r].
//
// What bounds it here.  The function moves 8 bytes in and 16 bytes out per
// position: 402.7 MB for the 16 x 1 MiB encode batch, 0.12 ms at the card's
// memory rate.  The chain from token to token is serial in each lane, so the
// design keeps it off device memory and keeps enough lanes in flight that
// their loads and stores, not their chains, set the pace.
//
// What the design does about it (ops/greedy_model.py states the same
// algorithm in torch, window size as an argument).  One block of kThreads
// threads per lane, windows of kWindow positions, thread t owning positions
// 4t .. 4t + 3 of a window:
//
// 1. stage: off and len of the window in one 16-byte load each per thread
//    (scalar loads at a ragged tail or an unaligned row), into registers and
//    into shared memory; the next window's loads are issued before this
//    window's chain, so they arrive while it runs;
// 2. table: nextc[i], the first candidate at or after i (the window's
//    length for none), by a block-wide suffix minimum; for a candidate i,
//    hop[i] = nextc[i + len[i]], with i + len[i] taken in 64 bits;
// 3. chain: one thread starts at nextc[cur - w0] and follows hop through
//    shared memory, two tokens a step (hop2[i] = hop[hop[i]] and the next
//    token's offset are tables too, so a step waits on one load); it marks
//    each token, with is_rep from the previous token's offset, and carries
//    (cur, rep) to the next window: cur = max(window end, last token + its
//    len), in 64 bits;
// 4. write: every thread writes all four rows of its four positions with
//    16-byte stores, zeros where no token starts.  Every output element is
//    written, so the caller allocates without a fill.
//
// A window that the previous token covers whole skips steps 2 and 3: its
// outputs are zeros.  off and len are proposals and may hold any int32: a
// length below 4 (negative ones included) is never taken, cur is kept in 64
// bits so r + len cannot wrap, and a block reads and writes only its own
// lane's seg positions.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 4 * kThreads;   // ops/greedy_model.py: WINDOW
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const int* off;
  const int* len;
  int* take;
  int* tok_off;
  int* tok_len;
  int* is_rep;
};

// The four positions p .. p + 3 of a lane row: one 16-byte load when the row
// allows it, else scalar loads of the positions before seg (0 after it).
__device__ __forceinline__ int4 load4(const int* __restrict__ row, long long p,
                                      int seg, bool vec) {
  if (vec && p + 4 <= seg)
    return __ldg(reinterpret_cast<const int4*>(row + p));
  int v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (p + i < seg) v[i] = __ldg(row + p + i);
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(int* __restrict__ row, long long p,
                                       int seg, bool vec, int4 v) {
  if (vec && p + 4 <= seg) {
    *reinterpret_cast<int4*>(row + p) = v;
    return;
  }
  const int a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (p + i < seg) row[p + i] = a[i];
}

__device__ __forceinline__ int elem(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
greedy_kernel(Rows rows, int seg) {
  __shared__ __align__(16) int len_s[kWindow];
  __shared__ __align__(16) int off_s[kWindow];
  __shared__ __align__(16) unsigned short nextc[kWindow];
  __shared__ __align__(16) unsigned short hop[kWindow];
  __shared__ __align__(16) unsigned short hop2[kWindow];  // hop[hop[i]]
  __shared__ __align__(16) int hoff[kWindow];              // off[hop[i]]
  __shared__ __align__(16) unsigned char mark[kWindow];  // 1 take, 2 is_rep
  __shared__ int warp_min[kWarps];
  __shared__ long long s_cur;  // first lane position that may start a token
  __shared__ int s_rep;

  const int tid = threadIdx.x;
  const int wl = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * seg;
  const int* off = rows.off + base;
  const int* len = rows.len + base;
  int* take = rows.take + base;
  int* tok_off = rows.tok_off + base;
  int* tok_len = rows.tok_len + base;
  int* is_rep = rows.is_rep + base;
  const bool vec =
      ((reinterpret_cast<unsigned long long>(off) |
        reinterpret_cast<unsigned long long>(len) |
        reinterpret_cast<unsigned long long>(take) |
        reinterpret_cast<unsigned long long>(tok_off) |
        reinterpret_cast<unsigned long long>(tok_len) |
        reinterpret_cast<unsigned long long>(is_rep)) & 15) == 0;
  if (tid == 0) {
    s_cur = 0;
    s_rep = -1;
  }
  reinterpret_cast<unsigned*>(mark)[tid] = 0;

  const int i0 = 4 * tid;  // this thread's first position in a window
  int4 l4 = load4(len, i0, seg, vec);
  int4 o4 = load4(off, i0, seg, vec);
  __syncthreads();
  for (long long w0 = 0; w0 < seg; w0 += kWindow) {
    const int wn = (int)min((long long)kWindow, seg - w0);
    // The next window's loads, in flight during this window's chain.
    const long long nw = w0 + kWindow;
    int4 nl4 = make_int4(0, 0, 0, 0), no4 = make_int4(0, 0, 0, 0);
    if (nw < seg) {
      nl4 = load4(len, nw + i0, seg, vec);
      no4 = load4(off, nw + i0, seg, vec);
    }
    const long long start = s_cur - w0;  // >= 0
    if (start < wn) {
      // 1. stage, and this thread's first candidate.
      reinterpret_cast<int4*>(len_s)[tid] = l4;
      reinterpret_cast<int4*>(off_s)[tid] = o4;
      int first = kWindow;
#pragma unroll
      for (int i = 3; i >= 0; --i)
        if (i0 + i < wn && elem(l4, i) >= 4) first = i0 + i;
      // 2. nextc by a suffix minimum over the threads, then hop.
      int inc = first;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(kFull, inc, o);
        if (wl + o < 32) inc = min(inc, y);
      }
      int after = __shfl_down_sync(kFull, inc, 1);
      if (wl == 31) after = kWindow;
      if (wl == 0) warp_min[warp] = inc;
      __syncthreads();
      for (int v = warp + 1; v < kWarps; ++v) after = min(after, warp_min[v]);
      unsigned short nx[4];
      int at = min(after, wn);
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        if (i0 + i < wn && elem(l4, i) >= 4) at = i0 + i;
        nx[i] = (unsigned short)at;
      }
      reinterpret_cast<uint2*>(nextc)[tid] =
          make_uint2(nx[0] | (unsigned)nx[1] << 16,
                     nx[2] | (unsigned)nx[3] << 16);
      __syncthreads();
      unsigned short hp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long to = (long long)(i0 + i) + elem(l4, i);
        hp[i] = (unsigned short)wn;
        if (i0 + i < wn && elem(l4, i) >= 4 && to < wn) hp[i] = nextc[to];
      }
      reinterpret_cast<uint2*>(hop)[tid] =
          make_uint2(hp[0] | (unsigned)hp[1] << 16,
                     hp[2] | (unsigned)hp[3] << 16);
      __syncthreads();
      // Two hops at once: the token after the next, and the next one's
      // offset, so that the chain waits on one load per two tokens.
      unsigned short h2[4];
      int ho[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h2[i] = (unsigned short)wn;
        ho[i] = 0;
        if (hp[i] < wn) {
          h2[i] = hop[hp[i]];
          ho[i] = off_s[hp[i]];
        }
      }
      reinterpret_cast<uint2*>(hop2)[tid] =
          make_uint2(h2[0] | (unsigned)h2[1] << 16,
                     h2[2] | (unsigned)h2[3] << 16);
      reinterpret_cast<int4*>(hoff)[tid] = make_int4(ho[0], ho[1], ho[2],
                                                     ho[3]);
      __syncthreads();
      // 3. the chain: shared memory only, four independent loads a step.
      if (tid == 0) {
        int s = nextc[start];
        int rep = s_rep, last = -1;
        while (s < wn) {
          const int q = hop[s], q2 = hop2[s], o = off_s[s], oq = hoff[s];
          mark[s] = (unsigned char)(1 | (o == rep ? 2 : 0));
          rep = o;
          last = s;
          if (q < wn) {
            mark[q] = (unsigned char)(1 | (oq == rep ? 2 : 0));
            rep = oq;
            last = q;
          }
          s = q2;
        }
        long long cur = w0 + wn;
        if (last >= 0) {
          cur = max(cur, w0 + last + (long long)len_s[last]);
          s_rep = rep;
        }
        s_cur = cur;
      }
      __syncthreads();
    }
    // 4. write the window, every position; clear this thread's marks.
    const unsigned m = reinterpret_cast<unsigned*>(mark)[tid];
    reinterpret_cast<unsigned*>(mark)[tid] = 0;
    int4 tk, to, tl, ir;
    tk.x = m & 1, tk.y = (m >> 8) & 1, tk.z = (m >> 16) & 1,
    tk.w = (m >> 24) & 1;
    ir.x = (m >> 1) & 1, ir.y = (m >> 9) & 1, ir.z = (m >> 17) & 1,
    ir.w = (m >> 25) & 1;
    to = make_int4(tk.x ? o4.x : 0, tk.y ? o4.y : 0, tk.z ? o4.z : 0,
                   tk.w ? o4.w : 0);
    tl = make_int4(tk.x ? l4.x : 0, tk.y ? l4.y : 0, tk.z ? l4.z : 0,
                   tk.w ? l4.w : 0);
    const long long p = w0 + i0;
    if (p < seg) {
      store4(take, p, seg, vec, tk);
      store4(tok_off, p, seg, vec, to);
      store4(tok_len, p, seg, vec, tl);
      store4(is_rep, p, seg, vec, ir);
    }
    l4 = nl4;
    o4 = no4;
  }
}

}  // namespace

// off, len: [lanes, seg] int32, lane-major.  take, tok_off, tok_len,
// is_rep: [lanes, seg] int32 (any contents: every element is written).
MINLZ_EXPORT int minlz_greedy(const void* off, const void* len, int lanes,
                              int seg, void* take, void* tok_off,
                              void* tok_len, void* is_rep, void* stream) {
  if (lanes > 0 && seg > 0) {
    const Rows rows = {(const int*)off, (const int*)len,   (int*)take,
                       (int*)tok_off,   (int*)tok_len,     (int*)is_rep};
    greedy_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(rows, seg);
  }
  return (int)cudaGetLastError();
}

// What the card made of the kernel: registers a thread, static shared
// memory a block, threads a block, and blocks resident on one SM.
MINLZ_EXPORT int minlz_greedy_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, greedy_kernel);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident,
                                                      greedy_kernel,
                                                      kThreads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = kThreads;
  out[3] = resident;
  return (int)err;
}
