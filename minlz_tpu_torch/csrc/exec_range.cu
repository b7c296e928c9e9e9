// Range executors, one thread block per 128 KiB output range: two kernels.
//
// exec_range_kernel (K3) replaces the TPU kernel
// minlz_tpu/ops/exec_chain.py::_make_fast_kernel (reached through
// execute_fast), the v2 decoder that places each record's literals and then
// copies clen bytes from cur - csrc, range by range; its records carry their
// output position.
//
// exec_sched_kernel replaces minlz_tpu/ops/exec_chain.py::
// _make_sched_kernel (reached through execute_scheduled, in its packed and
// its planar arena alike: two layouts of one function).  Its records carry
// no position ([4, n]: llen, clen, csrc, lit): a cursor starts at 0 in every
// range, each record lands at the cursor, clipped to the range span, and the
// cursor stops at the span.  The TPU's deal of ranges to chains is work
// distribution, which the grid does here.
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
// coalesced loads, a record per lane.
//
// exec_sched_kernel is still the serial walk: its cursor is a prefix sum
// over the records, so it waits for a block scan in front of this core.
// Within a record its 256 threads copy the bytes in parallel, literal bytes
// from comp, then copy bytes by out[d + i] = out[d - csrc + i % csrc], and a
// barrier is taken only when a copy reads bytes written since the last one.
//
// Hostile input never faults: every shared index is clamped into the range
// span and every comp index into the comp buffer.  A copy source before the
// range start reads 0.  The plain versions (ops/exec_chain.py) apply the
// same clamps and rules; K3 agrees with its plain version whenever a range's
// records with any bytes move forward without overlapping, which compaction
// guarantees (records of no bytes may stand anywhere).

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "resolve.cuh"

namespace {

constexpr int kSchedThreads = 256;

// K3: one range per thread block, resolved in shared memory.
__global__ void __launch_bounds__(resolve::kThreads, 1)
exec_range_kernel(const int* __restrict__ recs, long long n_recs,
                  const long long* __restrict__ range_first,
                  const long long* __restrict__ range_out,
                  const int* __restrict__ range_span, int max_span,
                  const unsigned char* __restrict__ comp, long long n_comp,
                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  resolve::Tile t;
  t.recs = recs;
  t.n_recs = n_recs;
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

// The append-only executor: a serial walk over the range's records.
__global__ void exec_sched_kernel(const int* __restrict__ recs,
                                  long long n_recs,
                                  const long long* __restrict__ range_first,
                                  const long long* __restrict__ range_out,
                                  const int* __restrict__ range_span,
                                  int max_span,
                                  const unsigned char* __restrict__ comp,
                                  long long n_comp,
                                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage[];
  constexpr int kThreads = kSchedThreads;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = min(max(range_span[r], 0), max_span);

  // Zero the range (unwritten bytes decode as 0).
  uint4* st4 = reinterpret_cast<uint4*>(stage);
  for (int i = tid; i < S / 16; i += kThreads) st4[i] = make_uint4(0, 0, 0, 0);
  for (int i = (S / 16) * 16 + tid; i < S; i += kThreads) stage[i] = 0;
  __syncthreads();

  const int* llen_f = recs;
  const int* clen_f = llen_f + n_recs;
  const int* csrc_f = llen_f + 2 * n_recs;
  const int* lit_f = llen_f + 3 * n_recs;
  const long long first = min(max(range_first[r], 0LL), n_recs);
  const long long last = min(max(range_first[r + 1], first), n_recs);

  int dirty_lo = INT_MAX;  // lowest byte written since the last barrier
  int cursor = 0;          // where the next record lands
  for (long long k = first; k < last; ++k) {
    const int p = cursor;
    const int llen = min(max(llen_f[k], 0), S - p);
    const int clen = min(max(clen_f[k], 0), S - p - llen);
    cursor = p + llen + clen;
    const int csrc = max(csrc_f[k], 1);
    const long long lit = lit_f[k];
    for (int i = tid; i < llen; i += kThreads) {
      const long long g = min(max(lit + i, 0LL), n_comp - 1);
      stage[p + i] = n_comp > 0 ? comp[g] : 0;
    }
    if (llen > 0) dirty_lo = min(dirty_lo, p);
    if (clen > 0) {
      const int d = p + llen;
      const long long s0 = (long long)d - csrc;
      const long long read_hi = s0 + min(csrc, clen);
      if (read_hi > dirty_lo) {
        __syncthreads();
        dirty_lo = INT_MAX;
      }
      const bool rle = csrc < clen;
      for (int i = tid; i < clen; i += kThreads) {
        const long long s = s0 + (rle ? i % csrc : i);
        stage[d + i] = s >= 0 ? stage[s] : 0;
      }
      dirty_lo = min(dirty_lo, d);
    }
  }
  __syncthreads();

  unsigned char* dst = out + range_out[r];
  if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < S / 16; i += kThreads) d4[i] = st4[i];
    for (int i = (S / 16) * 16 + tid; i < S; i += kThreads) dst[i] = stage[i];
  } else {
    for (int i = tid; i < S; i += kThreads) dst[i] = stage[i];
  }
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
  if (n_ranges > 0) {
    const int smem = resolve::shared_bytes(std::max(max_span, 0));
    cudaError_t err = cudaFuncSetAttribute(
        exec_range_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    exec_range_kernel<<<n_ranges, resolve::kThreads, smem,
                        (cudaStream_t)stream>>>(
        (const int*)recs, n_recs, (const long long*)range_first,
        (const long long*)range_out, (const int*)range_span, max_span,
        (const unsigned char*)comp, n_comp, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

// As minlz_exec_ranges, on recs [4, n_recs] int32 (llen, clen, csrc, lit)
// from minlz_compact_dense, placed by an append-only cursor per range.
MINLZ_EXPORT int minlz_exec_sched(const void* recs, long long n_recs,
                                  const void* range_first,
                                  const void* range_out,
                                  const void* range_span, int n_ranges,
                                  int max_span, const void* comp,
                                  long long n_comp, void* out,
                                  void* stream) {
  if (n_ranges > 0) {
    const int smem = (std::max(max_span, 0) + 15) / 16 * 16;
    cudaError_t err = cudaFuncSetAttribute(
        exec_sched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    exec_sched_kernel<<<n_ranges, kSchedThreads, smem,
                        (cudaStream_t)stream>>>(
        (const int*)recs, n_recs, (const long long*)range_first,
        (const long long*)range_out, (const int*)range_span, max_span,
        (const unsigned char*)comp, n_comp, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}
