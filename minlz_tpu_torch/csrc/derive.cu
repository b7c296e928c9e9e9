// The lane plan of unhinted MinLZ blocks, derived on the card.
//
// No TPU kernel: the JAX package decodes a block without parse hints on the
// host only.  Every MinLZ stream the upstream library and its `mz` write is
// such a stream: nothing says where a token starts but the token before it.
//
// What bounds it.  The plan (a few int32 words a 4 KiB lane) is small; the
// work is finding the lanes' first tokens, a chain through every token of a
// block (85,000 tokens in a 2 MiB block of JSON at level 2), each start
// known only once the token before it is decoded.  Walked token by token by
// one thread a block, that is 85,000 dependent steps on 32 threads of a
// 64 MiB request.
//
// What the design does about it.  Lane k of a block starts at the first
// token start at or after k * seg compressed bytes of its body, so the
// block's body is cut into windows of seg bytes, and every window is worked
// on at once, for every offset in it, whichever one a token turns out to
// start at:
//
// 1. blocks_kernel (one thread block): the block table.  Body offsets
//    clamped into comp and made non-decreasing, each block's lane count
//    ceil(n / seg) and decoded span, and their exclusive scans: the first
//    lane of each block (range_lane) and its output offset (range_out).
//    Sizes the format does not allow set a bit in `bad`.
// 2. table_kernel (one thread block a lane, 512 threads): the window's
//    bytes staged in shared memory; every offset decoded at once as K1
//    decodes it (token.cuh): the next token's offset, the output bytes, the
//    offset the token sets (0 for none); then pointer jumping in shared
//    memory, about log2(tokens) rounds, until every offset's chain has left
//    the window.  Per offset of comp it writes where the chain from there
//    leaves the window (exit), the output bytes on the way (saturated at
//    8 MiB + 1) and the last offset set on the way.
// 3. chain_kernel (one thread a block): from the body's start, one step a
//    window: the chain enters window k at e, leaves it at exit[e].  Each
//    step writes lane k: its start e, its output offset (the sum of the
//    steps before) and its incoming repeat offset (the last one set before,
//    1 where none is); a lane whose window the chain skipped (a literal run
//    across it) is empty.  At the end the chain must stand at the body's
//    end and the output at the block's decoded length, else `bad`.
//
// So a block costs its windows in parallel plus one dependent load a
// window (82 in a 2 MiB block at ratio 0.16), not one a token.  Nothing
// comes back to the host: hostile bodies set bits in `bad`, which the
// caller reads with the output, and every lane the plan holds lies inside
// comp and inside its block's span, so the kernels after it cannot fault.
//
// Lanes: lanes_bound = ceil(n_comp / seg) + n_blocks, a bound the host
// knows from the shapes; block b owns lanes [range_lane[b],
// range_lane[b + 1]), and the lanes past range_lane[n_blocks] are empty.

#include <climits>

#include "common.cuh"
#include "token.cuh"

namespace {

using minlz_token::decode;
using minlz_token::kHalo;
using minlz_token::stage_window;
using minlz_token::Tok;

constexpr int kMaxSeg = 4096;
constexpr int kThreads = 512;
constexpr int kPer = kMaxSeg / kThreads;  // offsets a thread
constexpr int kStage = kMaxSeg + kHalo + 16;
constexpr int kScanThreads = 1024;
constexpr int kChainThreads = 128;
constexpr long long kMaxBlock = 8LL << 20;
constexpr unsigned kSat = (8u << 20) + 1;  // output bytes, saturated
constexpr unsigned kFull = 0xffffffffu;

// Bits of `bad`.
constexpr int kBadTable = 1;  // offsets outside comp or not increasing
constexpr int kBadSize = 2;   // a decoded length outside 1..8 MiB, a body
                              // longer than it, or spans that do not add
                              // up to the output
constexpr int kBadChain = 4;  // a chain that does not end at the body's
                              // end, or tokens that do not decode to the
                              // block's length

// Exclusive scan of v over the thread block, by `op`, from `id`; *total
// gets the whole block's.  Every thread of the block calls it.
template <class Op>
__device__ long long block_scan(long long v, long long id, Op op,
                                long long* total) {
  __shared__ long long warp_tot[kScanThreads / 32];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (wl >= o) inc = op(y, inc);
  }
  if (wl == 31) warp_tot[warp] = inc;
  __syncthreads();
  long long pre = id, all = id;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w == warp) pre = all;
    all = op(all, warp_tot[w]);
  }
  long long exc = __shfl_up_sync(kFull, inc, 1);
  if (wl == 0) exc = id;
  *total = all;
  __syncthreads();
  return op(pre, exc);
}

struct Max {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};
struct Sum {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

__global__ void __launch_bounds__(kScanThreads)
blocks_kernel(const long long* __restrict__ body_off,
              const int* __restrict__ out_len, int n_blocks,
              long long n_comp, long long total_out, int seg,
              long long* __restrict__ boff, long long* __restrict__ range_lane,
              long long* __restrict__ range_out, int* __restrict__ range_span,
              int* __restrict__ bad) {
  __shared__ int flags;
  const int tid = threadIdx.x;
  if (tid == 0) flags = 0;
  __syncthreads();
  int my = 0;

  // Body offsets: clamped into comp, then a running maximum.
  const int n_off = n_blocks + 1;
  const int c1 = (n_off + kScanThreads - 1) / kScanThreads;
  const int a1 = min(tid * c1, n_off), b1 = min(a1 + c1, n_off);
  long long loc = 0;
  for (int i = a1; i < b1; ++i)
    loc = max(loc, min(max(body_off[i], 0LL), n_comp));
  long long total;
  long long run = block_scan(loc, 0LL, Max(), &total);
  for (int i = a1; i < b1; ++i) {
    run = max(run, min(max(body_off[i], 0LL), n_comp));
    if (run != body_off[i]) my |= kBadTable;
    boff[i] = run;
  }
  __syncthreads();

  // Lane counts and spans, and their exclusive scans.
  const int c2 = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int a2 = min(tid * c2, n_blocks), b2 = min(a2 + c2, n_blocks);
  long long lanes = 0, bytes = 0;
  for (int b = a2; b < b2; ++b) {
    const long long n = boff[b + 1] - boff[b];
    lanes += (n + seg - 1) / seg;
    bytes += min(max((long long)out_len[b], 0LL), kMaxBlock);
  }
  long long all_lanes, all_bytes;
  long long first = block_scan(lanes, 0LL, Sum(), &all_lanes);
  long long at = block_scan(bytes, 0LL, Sum(), &all_bytes);
  if (all_bytes != total_out) my |= kBadSize;
  for (int b = a2; b < b2; ++b) {
    const long long n = boff[b + 1] - boff[b];
    const long long want = out_len[b];
    const long long span = min(max(want, 0LL), kMaxBlock);
    if (want < 1 || want > kMaxBlock || n > want) my |= kBadSize;
    range_lane[b] = first;
    const long long o = min(at, total_out);
    range_out[b] = o;
    range_span[b] = (int)min(span, total_out - o);
    first += (n + seg - 1) / seg;
    at += span;
  }
  if (tid == kScanThreads - 1) range_lane[n_blocks] = all_lanes;
  if (my) atomicOr(&flags, my);
  __syncthreads();
  if (tid == 0) *bad = flags;
}

struct Lanes {
  int *start, *len, *lo, *hi, *rep;
};

__global__ void __launch_bounds__(kThreads)
table_kernel(const unsigned char* __restrict__ comp, long long n_comp,
             const long long* __restrict__ boff,
             const long long* __restrict__ range_lane, int n_blocks, int seg,
             int* __restrict__ tab_exit, unsigned* __restrict__ tab_w,
             int* __restrict__ tab_rep, Lanes lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_to = reinterpret_cast<int*>(smem);
  unsigned* s_w = reinterpret_cast<unsigned*>(s_to + kMaxSeg);
  int* s_rep = reinterpret_cast<int*>(s_w + kMaxSeg);
  unsigned char* stage = reinterpret_cast<unsigned char*>(s_rep + kMaxSeg);
  __shared__ int blk;

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  if (j >= range_lane[n_blocks]) {  // past every block's lanes: empty
    if (tid == 0) {
      lanes.start[j] = (int)boff[n_blocks];
      lanes.len[j] = lanes.lo[j] = lanes.hi[j] = 0;
      lanes.rep[j] = 1;
    }
    return;
  }
  if (tid == 0) {  // the block whose lanes hold j: range_lane[b] <= j
    int a = 0, b = n_blocks - 1;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (range_lane[m] <= j) a = m; else b = m - 1;
    }
    blk = a;
  }
  __syncthreads();
  const int b = blk;
  const long long base = boff[b];
  const int n = (int)(boff[b + 1] - base);
  const int w0 = (int)(j - range_lane[b]) * seg;
  const int W = min(seg, n - w0);
  const int we = w0 + W;  // the window's end, body-local
  int shift;
  stage_window<kStage, kThreads>(comp, n_comp, base + w0,
                                 min(W + kHalo, n - w0), stage, &shift);
  __syncthreads();
  const unsigned char* win = stage + shift;

  int to[kPer], rep[kPer];
  unsigned w[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < W) {
      const Tok t = decode(win + i, w0 + i, n);
      to[r] = (int)min(t.nxt, (long long)INT_MAX);
      w[r] = min(t.w, kSat);
      rep[r] = t.sets ? t.off : 0;
      s_to[i] = to[r], s_w[i] = w[r], s_rep[i] = rep[r];
    }
  }
  // Pointer jumping: each round an offset whose chain is still inside the
  // window takes on the chain from where its own points.
  bool open = true;
  while (__syncthreads_or(open)) {
    open = false;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kThreads;
      if (i < W && to[r] < we) {
        const int q = to[r] - w0;
        const int r2 = s_rep[q];
        w[r] = min(w[r] + s_w[q], kSat);
        rep[r] = r2 ? r2 : rep[r];
        to[r] = s_to[q];
        open |= to[r] < we;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kThreads;
      if (i < W) s_to[i] = to[r], s_w[i] = w[r], s_rep[i] = rep[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    if (i < W) {
      const long long g = base + w0 + i;
      tab_exit[g] = to[r];
      tab_w[g] = w[r];
      tab_rep[g] = rep[r];
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const long long* __restrict__ boff,
             const long long* __restrict__ range_lane,
             const int* __restrict__ out_len,
             const int* __restrict__ range_span, int n_blocks, int seg,
             const int* __restrict__ tab_exit,
             const unsigned* __restrict__ tab_w,
             const int* __restrict__ tab_rep, Lanes lanes,
             int* __restrict__ bad) {
  const int b = blockIdx.x * kChainThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const long long base = boff[b];
  const long long n = boff[b + 1] - base;
  const long long first = range_lane[b];
  const int count = (int)(range_lane[b + 1] - first);
  const long long span = range_span[b];
  long long e = 0, out = 0, prev_s = 0, prev_lo = 0;
  int rep = 1;
  bool sat = false;
  for (int k = 0; k < count; ++k) {
    const long long lane = first + k;
    const long long s = min(e, n);
    const long long lo = min(out, span);
    if (k > 0) {
      lanes.len[lane - 1] = (int)(s - prev_s);
      lanes.hi[lane - 1] = (int)lo;
    }
    lanes.start[lane] = (int)(base + s);
    lanes.lo[lane] = (int)lo;
    lanes.rep[lane] = rep;
    prev_s = s, prev_lo = lo;
    if (e < (long long)(k + 1) * seg && e < n) {
      const long long g = base + e;
      const unsigned w = tab_w[g];
      const int r = tab_rep[g];
      e = tab_exit[g];
      out += w;
      sat |= w >= kSat;
      rep = r ? r : rep;
    }
  }
  if (count > 0) {
    lanes.len[first + count - 1] = (int)(n - prev_s);
    lanes.hi[first + count - 1] = (int)min(out, span);
  }
  if (e != n || out != (long long)out_len[b] || sat) atomicOr(bad, kBadChain);
}

}  // namespace

// comp: [n_comp] uint8, the blocks' bodies (the bytes after each block's
// uvarint); body_off: [n_blocks + 1] int64, body b is comp[body_off[b],
// body_off[b + 1]); out_len: [n_blocks] int32, each block's decoded length;
// total_out: their sum, the output the plan is for; seg: the lane cut,
// 1..4096 compressed bytes.  Written: the lanes, [lanes] int32 each
// (lanes = ceil(n_comp / seg) + n_blocks); range_lane [n_blocks + 1] int64,
// range_out [n_blocks] int64, range_span [n_blocks] int32; bad [1] int32
// (0, or the kBad bits); scratch: int64 [n_blocks + 1] (the clamped body
// offsets) and int32 [3 * n_comp] (exit, output bytes, offset set, per
// compressed byte).
MINLZ_EXPORT int minlz_derive(const void* comp, long long n_comp,
                              const void* body_off, const void* out_len,
                              int n_blocks, long long total_out, int seg,
                              int lanes, void* lane_start, void* lane_len,
                              void* lane_lo, void* lane_hi, void* lane_rep,
                              void* range_lane, void* range_out,
                              void* range_span, void* bad, void* boff,
                              void* tab, void* stream) {
  if (seg < 1 || seg > kMaxSeg || n_blocks < 1 || n_comp >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  blocks_kernel<<<1, kScanThreads, 0, st>>>(
      (const long long*)body_off, (const int*)out_len, n_blocks, n_comp,
      total_out, seg, (long long*)boff, (long long*)range_lane,
      (long long*)range_out, (int*)range_span, (int*)bad);
  const Lanes l = {(int*)lane_start, (int*)lane_len, (int*)lane_lo,
                   (int*)lane_hi, (int*)lane_rep};
  int* tab_exit = (int*)tab;
  unsigned* tab_w = (unsigned*)(tab_exit + n_comp);
  int* tab_rep = (int*)(tab_w + n_comp);
  const int smem = 12 * kMaxSeg + kStage;
  cudaError_t err = cudaFuncSetAttribute(
      table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (lanes > 0)
    table_kernel<<<lanes, kThreads, smem, st>>>(
        (const unsigned char*)comp, n_comp, (const long long*)boff,
        (const long long*)range_lane, n_blocks, seg, tab_exit, tab_w,
        tab_rep, l);
  chain_kernel<<<(n_blocks + kChainThreads - 1) / kChainThreads,
                 kChainThreads, 0, st>>>(
      (const long long*)boff, (const long long*)range_lane,
      (const int*)out_len, (const int*)range_span, n_blocks, seg, tab_exit,
      tab_w, tab_rep, l, (int*)bad);
  return (int)cudaGetLastError();
}
