// Range executors, one thread block per 128 KiB output range.
//
// exec_range_kernel (K3) replaces the TPU kernel
// minlz_tpu/ops/exec_chain.py::_make_fast_kernel (reached through
// execute_fast), the v2 decoder that places each record's literals and then
// copies clen bytes from cur - csrc, range by range; its records carry their
// output position.
//
// minlz_exec_sched replaces minlz_tpu/ops/exec_chain.py::_make_sched_kernel
// (reached through execute_scheduled, in its packed and its planar arena
// alike: two layouts of one function).  Its records carry no position ([4,
// n]: llen, clen, csrc, lit): a cursor starts at 0 in every range, each
// record lands at the cursor, clipped to the range span, and the cursor
// stops at the span.  The cursor is a prefix sum, so it is two launches:
// sched_pos_kernel, a block scan per range over max(llen, 0) + max(clen, 0)
// in int64 that writes each record's position, min(scan, span), to a
// scratch row; then exec_range_kernel, K3 itself, reading the position from
// that row and the other four fields from the records.  A record belongs to
// one range at most: ranges that go backwards are cut (sched_pos_kernel).  The positioned
// records it sees move forward without overlapping by construction.  The
// TPU's deal of ranges to chains is work distribution, which the grid does
// here.
//
// What bounds K3 here: records are short (6.7 output bytes on average), and
// a copy may read what the records just before it wrote.  Walked one after
// the other, a range's 20 K records cost a shared-memory round trip and a
// barrier each, and the kernel's time is the longest range's walk.  Taken
// byte by byte instead, the dependence is a pointer chain per byte, and a
// chain is resolved in log2(depth) rounds of gathers in shared memory: what
// bounds the kernel then is the number of rounds of its deepest sub-tile
// times one gather pass over 32 KiB, not the record count.
//
// What the design does about it (resolve.cuh has the arithmetic and the
// proof): one thread block of 1024 threads per range; the range's final
// bytes are staged in dynamic shared memory and leave in 16-byte stores; the
// range is resolved in sub-tiles of 32 KiB, in output order, each expanded
// from the records into one 16-bit state word per byte (final value, or
// in-sub-tile source) and then resolved by doubling rounds with a block-wide
// vote for early exit.  No thread walks records in order: one pass finds
// each sub-tile's window of records, and a sub-tile reads its window with
// coalesced loads, a record per lane.  The scan in front of the append-only
// road reads 8 bytes a record and writes 4: a small share of K3's time.
//
// Hostile input never faults: every shared index is clamped into the range
// span and every comp index into the comp buffer.  A copy source before the
// range start reads 0.  The plain versions (ops/exec_chain.py) apply the
// same clamps and rules; K3 agrees with its plain version whenever a range's
// records with any bytes move forward without overlapping, which compaction
// guarantees (records of no bytes may stand anywhere).

#include <algorithm>

#include "common.cuh"
#include "resolve.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;    // consecutive records a thread sums

// K3: one range per thread block, resolved in shared memory.
__global__ void __launch_bounds__(resolve::kThreads, 1)
exec_range_kernel(resolve::Fields rec, long long n_recs,
                  const long long* __restrict__ range_first,
                  const long long* __restrict__ range_out,
                  const int* __restrict__ range_span, int max_span,
                  const unsigned char* __restrict__ comp, long long n_comp,
                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  resolve::Tile t;
  t.rec = rec;
  t.first = min(max(range_first[r], 0LL), n_recs);
  t.last = min(max(range_first[r + 1], t.first), n_recs);
  t.span = min(max(range_span[r], 0), max_span);
  t.base = 0;
  t.len = t.span;
  t.comp = comp;
  t.n_comp = n_comp;
  t.res = nullptr;
  uint16_t* st = reinterpret_cast<uint16_t*>(smem);
  unsigned char* stage = smem + resolve::state_bytes(max_span);
  resolve::resolve_tile<false>(t, stage, st);
  resolve::store_tile(stage, out + range_out[r], t.len);
}

// The append-only cursor, one range per thread block.  The ranges are
// taken as [M[r], M[r + 1]) with M the running maximum of range_first
// clamped into [0, n_recs], so a range that goes backwards takes back no
// record of an earlier one (for a plan's non-decreasing range_first, M is
// range_first); block r writes M[r + 1] to bounds[r + 1], block 0 also
// bounds[0].  pos[k] = min(sum of the range's clamped lengths before record
// k, span).  Records are loaded coalesced into shared memory, kScanItems *
// kScanThreads at a time; each thread sums kScanItems consecutive ones, a
// block scan in int64 gives its start, and the positions leave coalesced.
// Each block reads range_first[0 .. r + 1] for M: about r / 1024 loads a
// thread, nothing at a decode batch's few hundred ranges.
__global__ void __launch_bounds__(kScanThreads)
sched_pos_kernel(const int* __restrict__ llen_f,
                 const int* __restrict__ clen_f, long long n_recs,
                 const long long* __restrict__ range_first,
                 const int* __restrict__ range_span, int max_span,
                 long long* __restrict__ bounds, int* __restrict__ pos) {
  constexpr int kChunk = kScanThreads * kScanItems;
  __shared__ unsigned step[kChunk];
  __shared__ long long warp_sum[kScanThreads / 32];
  __shared__ long long carry;
  __shared__ unsigned long long m[2];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 2) m[tid] = 0;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int j = tid; j <= r + 1; j += kScanThreads) {
    const long long f = min(max(range_first[j], 0LL), n_recs);
    if (j <= r) atomicMax(m, (unsigned long long)f);
    atomicMax(m + 1, (unsigned long long)f);
  }
  __syncthreads();
  const long long first = (long long)m[0], last = (long long)m[1];
  if (tid == 0) {
    bounds[r + 1] = last;
    if (r == 0) bounds[0] = first;
  }
  const long long S = min(max(range_span[r], 0), max_span);
  for (long long k0 = first; k0 < last; k0 += kChunk) {
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const long long k = k0 + u * kScanThreads + tid;
      // Each length is at most 2^31 - 1, so the sum fits 32 unsigned bits.
      step[u * kScanThreads + tid] =
          k < last ? (unsigned)max(__ldg(llen_f + k), 0) +
                         (unsigned)max(__ldg(clen_f + k), 0)
                   : 0u;
    }
    __syncthreads();
    long long run = 0;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) run += step[tid * kScanItems + u];
    long long inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    long long before = carry + inc - run;
    for (int v = 0; v < warp; ++v) before += warp_sum[v];
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const unsigned st = step[tid * kScanItems + u];
      step[tid * kScanItems + u] = (unsigned)min(before, S);
      before += st;
    }
    __syncthreads();
    if (tid == kScanThreads - 1) carry = before;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const long long k = k0 + u * kScanThreads + tid;
      if (k < last) pos[k] = (int)step[u * kScanThreads + tid];
    }
    __syncthreads();
  }
}

int launch_ranges(resolve::Fields rec, long long n_recs,
                  const void* range_first, const void* range_out,
                  const void* range_span, int n_ranges, int max_span,
                  const void* comp, long long n_comp, void* out,
                  cudaStream_t stream) {
  const int smem = resolve::shared_bytes(std::max(max_span, 0));
  cudaError_t err = cudaFuncSetAttribute(
      exec_range_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  exec_range_kernel<<<n_ranges, resolve::kThreads, smem, stream>>>(
      rec, n_recs, (const long long*)range_first,
      (const long long*)range_out, (const int*)range_span, max_span,
      (const unsigned char*)comp, n_comp, (unsigned char*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// recs: [5, n_recs] int32 (pos, llen, clen, csrc, lit) from minlz_compact;
// range_first: [n_ranges + 1] int64 record offsets; range_out: [n_ranges]
// int64 output offsets; range_span: [n_ranges] int32, each <= max_span;
// comp: [n_comp] uint8; out: the decoded bytes.  One __global__ launch.
MINLZ_EXPORT int minlz_exec_ranges(const void* recs, long long n_recs,
                                   const void* range_first,
                                   const void* range_out,
                                   const void* range_span, int n_ranges,
                                   int max_span, const void* comp,
                                   long long n_comp, void* out,
                                   void* stream) {
  if (n_ranges <= 0) return (int)cudaGetLastError();
  return launch_ranges(resolve::fields_of((const int*)recs, n_recs), n_recs,
                       range_first, range_out, range_span, n_ranges,
                       max_span, comp, n_comp, out, (cudaStream_t)stream);
}

// As minlz_exec_ranges, on recs [4, n_recs] int32 (llen, clen, csrc, lit)
// from minlz_compact_dense, placed by an append-only cursor per range;
// scratch: int64 [n_ranges + 1] (the ranges as taken), then int32 [n_recs]
// (each record's position).  Two __global__ launches: the cursor scan, then
// K3 on the positioned records.
MINLZ_EXPORT int minlz_exec_sched(const void* recs, long long n_recs,
                                  const void* range_first,
                                  const void* range_out,
                                  const void* range_span, int n_ranges,
                                  int max_span, const void* comp,
                                  long long n_comp, void* out, void* scratch,
                                  void* stream) {
  if (n_ranges <= 0) return (int)cudaGetLastError();
  const int* f = (const int*)recs;
  long long* bounds = (long long*)scratch;
  int* pos = (int*)(bounds + n_ranges + 1);
  sched_pos_kernel<<<n_ranges, kScanThreads, 0, (cudaStream_t)stream>>>(
      f, f + n_recs, n_recs, (const long long*)range_first,
      (const int*)range_span, max_span, bounds, pos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const resolve::Fields rec{pos, f, f + n_recs, f + 2 * n_recs,
                            f + 3 * n_recs};
  return launch_ranges(rec, n_recs, bounds, range_out, range_span, n_ranges,
                       max_span, comp, n_comp, out, (cudaStream_t)stream);
}
