// Range executors, one thread block per 128 KiB output range: one kernel
// template, two instances.
//
// exec_range_kernel<false> (K3) replaces the TPU kernel
// minlz_tpu/ops/exec_chain.py::_make_fast_kernel (reached through
// execute_fast), the v2 decoder that places each record's literals and then
// copies clen bytes from cur - csrc, range by range; its records carry their
// output position.
//
// exec_range_kernel<true> replaces minlz_tpu/ops/exec_chain.py::
// _make_sched_kernel (reached through execute_scheduled, in its packed and
// its planar arena alike: two layouts of one function).  Its records carry
// no position ([4, n]: llen, clen, csrc, lit): a cursor starts at 0 in every
// range, each record lands at the cursor, clipped to the range span, and the
// cursor stops at the span.  The TPU's deal of ranges to chains is work
// distribution, which the grid does here.
//
// What bounds it here: records are short (a few bytes of literals and a copy
// of a few to a few dozen bytes), and a copy may read what the records just
// before it wrote, so the walk over a range's records is serial; the time
// goes to per-record latency (shared-memory round trips and barriers), not
// to bandwidth.  One block per range and 128 KiB of shared memory per block
// means one block per SM, and a batch of 8 MiB has only 64 ranges for the
// card's 132 SMs.
//
// What the design does about it: the whole range is staged in dynamic shared
// memory, so every copy source is a shared-memory read and the range leaves
// for device memory once, in 16-byte stores.  Within a record the block's
// threads copy the bytes in parallel: literal bytes from comp, then copy
// bytes by out[d + i] = out[d - csrc + i % csrc] (one formula for plain and
// overlapping copies, and every source lies before d).  A barrier is taken
// only when a copy reads bytes written since the last barrier.
//
// Hostile input never faults: every shared index is clamped into the range
// span and every comp index into the comp buffer.  A copy source before the
// range start reads 0.  The plain version (ops/exec_chain.py) applies the
// same clamps and rules.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kAppend>
__global__ void exec_range_kernel(const int* __restrict__ recs,
                                  long long n_recs,
                                  const long long* __restrict__ range_first,
                                  const long long* __restrict__ range_out,
                                  const int* __restrict__ range_span,
                                  int max_span,
                                  const unsigned char* __restrict__ comp,
                                  long long n_comp,
                                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = min(max(range_span[r], 0), max_span);

  // Zero the range (unwritten bytes decode as 0).
  uint4* st4 = reinterpret_cast<uint4*>(stage);
  for (int i = tid; i < S / 16; i += kThreads) st4[i] = make_uint4(0, 0, 0, 0);
  for (int i = (S / 16) * 16 + tid; i < S; i += kThreads) stage[i] = 0;
  __syncthreads();

  // Positioned records have one more row, in front.
  const int* pos_f = recs;
  const int* llen_f = recs + (kAppend ? 0 : 1) * n_recs;
  const int* clen_f = llen_f + n_recs;
  const int* csrc_f = llen_f + 2 * n_recs;
  const int* lit_f = llen_f + 3 * n_recs;
  const long long first = min(max(range_first[r], 0LL), n_recs);
  const long long last = min(max(range_first[r + 1], first), n_recs);

  int dirty_lo = INT_MAX;  // lowest byte written since the last barrier
  int cursor = 0;          // kAppend: where the next record lands
  for (long long k = first; k < last; ++k) {
    const int p = kAppend ? cursor : min(max(pos_f[k], 0), S);
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

template <bool kAppend>
int launch(const void* recs, long long n_recs, const void* range_first,
           const void* range_out, const void* range_span, int n_ranges,
           int max_span, const void* comp, long long n_comp, void* out,
           void* stream) {
  if (n_ranges > 0) {
    const int smem = (std::max(max_span, 0) + 15) / 16 * 16;
    cudaError_t err = cudaFuncSetAttribute(
        exec_range_kernel<kAppend>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    exec_range_kernel<kAppend>
        <<<n_ranges, kThreads, smem, (cudaStream_t)stream>>>(
            (const int*)recs, n_recs, (const long long*)range_first,
            (const long long*)range_out, (const int*)range_span, max_span,
            (const unsigned char*)comp, n_comp, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// recs: [5, n_recs] int32 (pos, llen, clen, csrc, lit) from minlz_compact;
// range_first: [n_ranges + 1] int64 record offsets; range_out: [n_ranges]
// int64 output offsets; range_span: [n_ranges] int32, each <= max_span;
// comp: [n_comp] uint8; out: the decoded bytes.
MINLZ_EXPORT int minlz_exec_ranges(const void* recs, long long n_recs,
                                   const void* range_first,
                                   const void* range_out,
                                   const void* range_span, int n_ranges,
                                   int max_span, const void* comp,
                                   long long n_comp, void* out,
                                   void* stream) {
  return launch<false>(recs, n_recs, range_first, range_out, range_span,
                       n_ranges, max_span, comp, n_comp, out, stream);
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
  return launch<true>(recs, n_recs, range_first, range_out, range_span,
                      n_ranges, max_span, comp, n_comp, out, stream);
}
