// Whole-block executor, one thread block per MinLZ block.
//
// Replaces the TPU kernel minlz_tpu/ops/pallas_decode.py::_make_exec_kernel
// (reached through execute_ops_pallas), the v1 decoder: one walk over a
// block's records in output order, each placing llen literal bytes and then
// clen bytes from csrc back, where the source may lie anywhere earlier in
// the block.  Blocks without a range clamp (hints v1, or a range the range
// executors do not take) decode here.
//
// What bounds it here: a copy may read what any earlier record wrote, so the
// walk over a block's records is serial, and a block of 1-8 MiB does not fit
// an SM's shared memory: every literal and copy byte is a round trip to
// device memory (the 50 MB L2 holds a batch's output and literals).  The
// time goes to per-record latency, on as many SMs as the batch has blocks,
// not to bandwidth.
//
// What the design does about it: the records are fetched ahead of the walk,
// kChunk at a time, with coalesced loads into shared memory, so the serial
// chain holds only the byte moves.  Within a record the threads move the
// bytes in parallel: literals from comp, then copy bytes by
// out[d + i] = out[d - csrc + i % csrc] (one formula for plain and
// overlapping copies; every source lies before d).  A barrier is taken only
// when a copy reads bytes written since the last barrier; most copies reach
// far back and need none.  The block's output is read and written in this
// one kernel, by one thread block: `out` is neither const nor __restrict__,
// so no load of it takes the read-only path, and __syncthreads() orders the
// block's own stores before its later loads.
//
// Hostile input never faults: every index is clamped into the block span and
// into comp, and a copy source before the block's first byte reads 0.  The
// plain version (execute_ranges_plain with the block span) applies the same
// clamps; the bytes agree because compaction keeps only records that move
// forward without overlap.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // records fetched per round, one per thread

__global__ void exec_block_kernel(const int* __restrict__ recs,
                                  long long n_recs,
                                  const long long* __restrict__ block_first,
                                  const long long* __restrict__ block_out,
                                  const int* __restrict__ block_span,
                                  const unsigned char* __restrict__ comp,
                                  long long n_comp, unsigned char* out) {
  __shared__ int s_pos[kChunk], s_llen[kChunk], s_clen[kChunk],
      s_csrc[kChunk], s_lit[kChunk];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = max(block_span[b], 0);
  unsigned char* dst = out + block_out[b];

  // Zero the block (unwritten bytes decode as 0).
  if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < S / 16; i += kThreads) d4[i] = make_uint4(0, 0, 0, 0);
    for (int i = (S / 16) * 16 + tid; i < S; i += kThreads) dst[i] = 0;
  } else {
    for (int i = tid; i < S; i += kThreads) dst[i] = 0;
  }

  const long long first = min(max(block_first[b], 0LL), n_recs);
  const long long last = min(max(block_first[b + 1], first), n_recs);

  for (long long base = first; base < last; base += kChunk) {
    // Every thread is done with the previous chunk's records, and every
    // byte written so far is visible to the whole block.
    __syncthreads();
    const int m = (int)min((long long)kChunk, last - base);
    if (tid < m) {
      const long long k = base + tid;
      s_pos[tid] = recs[k];
      s_llen[tid] = recs[n_recs + k];
      s_clen[tid] = recs[2 * n_recs + k];
      s_csrc[tid] = recs[3 * n_recs + k];
      s_lit[tid] = recs[4 * n_recs + k];
    }
    __syncthreads();

    int dirty_lo = INT_MAX;  // lowest byte written since the last barrier
    for (int j = 0; j < m; ++j) {
      const int p = min(max(s_pos[j], 0), S);
      const int llen = min(max(s_llen[j], 0), S - p);
      const int clen = min(max(s_clen[j], 0), S - p - llen);
      const int csrc = max(s_csrc[j], 1);
      const long long lit = s_lit[j];
      for (int i = tid; i < llen; i += kThreads) {
        const long long g = min(max(lit + i, 0LL), n_comp - 1);
        dst[p + i] = n_comp > 0 ? comp[g] : 0;
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
          dst[d + i] = s >= 0 ? dst[s] : 0;
        }
        dirty_lo = min(dirty_lo, d);
      }
    }
  }
}

}  // namespace

// recs: [5, n_recs] int32 (pos, llen, clen, csrc, lit) from minlz_compact
// at whole-block lane spans; block_first: [n_blocks + 1] int64 record
// offsets; block_out: [n_blocks] int64 output offsets; block_span:
// [n_blocks] int32; comp: [n_comp] uint8; out: the decoded bytes.
MINLZ_EXPORT int minlz_exec_blocks(const void* recs, long long n_recs,
                                   const void* block_first,
                                   const void* block_out,
                                   const void* block_span, int n_blocks,
                                   const void* comp, long long n_comp,
                                   void* out, void* stream) {
  if (n_blocks > 0) {
    exec_block_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)recs, n_recs, (const long long*)block_first,
        (const long long*)block_out, (const int*)block_span,
        (const unsigned char*)comp, n_comp, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}
