// Record compaction, one thread block per segment lane: two kernels.
//
// compact_kernel (K2) replaces the TPU kernel
// minlz_tpu/ops/exec_chain.py::_stitch3_kernel (reached through
// compact_ops_fast), which copies each lane's sorted, packed record words
// into its dense per-chain slot range and zero-fills the rest.
//
// The same kernel, launched with whole-block lane spans (lane i of a block
// owns [i * seg, (i + 1) * seg) of the block, see plan_batch(rng=0)), is the
// counterpart of minlz_tpu/ops/pallas_decode.py::_stitch_kernel (reached
// through compact_ops), the v1 compaction: one dense list per block in
// (lane, record) order, here with block-local positions and global literal
// indices.  Nothing in the kernel depends on how wide a range is: positions
// and spans are int32 and a block is at most 8 MiB.
//
// compact_dense_kernel replaces minlz_tpu/ops/exec_chain.py::_stitch_kernel
// (reached through compact_ops_dense), the append-only compaction: the same
// dense lists without an output position (the executor keeps a cursor), so
// there is no keep test and no scan; llen and clen are clamped at 0, csrc is
// at least 1 and the literal index lies within the lane's compressed bytes.
//
// What bounds it here: it moves about 20 bytes in and 20 bytes out per
// record, so it is bound by memory traffic and, for a batch of a few
// thousand lanes with a few hundred records each, by launch and scan
// latency more than by bandwidth.
//
// What the design does about it: one block per lane walks the lane's
// records in chunks of blockDim; neighbouring threads read and write
// neighbouring records (coalesced), and the only cross-thread step is a
// shared-memory max-scan of record ends.  The records land at the lane's
// offset in its range's dense list (lane_out, an exclusive prefix sum of the
// lane counts), already converted to range-local output positions and global
// literal indices, with the hostile-input clamps applied:
//   * a record is kept only if it starts at or after the end of every
//     earlier record of its lane (always true of a valid stream), so kept
//     records never overlap and only move forward;
//   * its bytes are confined to the lane's output span [lane_lo, lane_hi),
//     a part of its range: the literal length first, then the copy length;
//   * csrc is at least 1, and lsrc lies within the lane's compressed bytes.
// The executor (exec_range.cu) relies on the first two for its result and
// clamps every index again on its own for memory safety.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void compact_kernel(const int* __restrict__ recs, long long n_slots,
                               const int* __restrict__ lane_start,
                               const int* __restrict__ lane_len,
                               const int* __restrict__ lane_cnt,
                               const long long* __restrict__ lane_out,
                               const int* __restrict__ lane_lo,
                               const int* __restrict__ lane_hi,
                               int* __restrict__ out, long long n_out) {
  __shared__ long long scan[kThreads];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int cnt = lane_cnt[lane];
  const long long slot0 = (long long)lane_start[lane] + lane;
  const long long o0 = lane_out[lane];
  const long long lo = lane_lo[lane];
  const long long hi = lane_hi[lane];
  const long long cstart = lane_start[lane];
  const int clen_lane = lane_len[lane];
  const int* dst_f = recs + 1 * n_slots;
  const int* clen_f = recs + 2 * n_slots;
  const int* csrc_f = recs + 3 * n_slots;
  const int* lsrc_f = recs + 4 * n_slots;
  const int* llen_f = recs + 5 * n_slots;

  long long carry = 0;  // the largest record end seen so far in this lane
  for (int base = 0; base < cnt; base += kThreads) {
    const int k = base + tid;
    const long long slot = slot0 + k;
    const bool valid = k < cnt && slot < n_slots;
    long long dst = 0, llen = 0, clen = 0;
    int csrc = 0, lsrc = 0;
    if (valid) {
      dst = dst_f[slot];
      llen = max(llen_f[slot], 0);
      clen = max(clen_f[slot], 0);
      csrc = csrc_f[slot];
      lsrc = lsrc_f[slot];
    }
    scan[tid] = valid ? dst + llen + clen : LLONG_MIN;
    __syncthreads();
    // Inclusive max-scan of record ends (Hillis-Steele).
    for (int off = 1; off < kThreads; off <<= 1) {
      const long long v = tid >= off ? scan[tid - off] : LLONG_MIN;
      __syncthreads();
      scan[tid] = max(scan[tid], v);
      __syncthreads();
    }
    const long long prior = max(carry, tid > 0 ? scan[tid - 1] : LLONG_MIN);
    const long long o = o0 + k;
    if (valid && o < n_out) {
      const bool keep = dst >= prior;
      long long p = keep ? min(lo + dst, hi) : hi;
      const long long avail = hi - p;
      const long long ll = min(llen, avail);
      const long long cl = min(clen, avail - ll);
      const long long ls = min(max((long long)lsrc, 0LL), (long long)clen_lane);
      out[0 * n_out + o] = (int)p;
      out[1 * n_out + o] = (int)ll;
      out[2 * n_out + o] = (int)cl;
      out[3 * n_out + o] = max(csrc, 1);
      out[4 * n_out + o] = (int)(cstart + ls);
    }
    carry = max(carry, scan[kThreads - 1]);
    __syncthreads();
  }
}

__global__ void compact_dense_kernel(const int* __restrict__ recs,
                                     long long n_slots,
                                     const int* __restrict__ lane_start,
                                     const int* __restrict__ lane_len,
                                     const int* __restrict__ lane_cnt,
                                     const long long* __restrict__ lane_out,
                                     int* __restrict__ out, long long n_out) {
  const int lane = blockIdx.x;
  const int cnt = lane_cnt[lane];
  const long long cstart = lane_start[lane];
  const long long slot0 = cstart + lane;
  const long long o0 = lane_out[lane];
  const int clen_lane = lane_len[lane];
  const int* clen_f = recs + 2 * n_slots;
  const int* csrc_f = recs + 3 * n_slots;
  const int* lsrc_f = recs + 4 * n_slots;
  const int* llen_f = recs + 5 * n_slots;
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    const long long slot = slot0 + k;
    const long long o = o0 + k;
    if (slot >= n_slots || o >= n_out) break;
    const int ls = min(max(lsrc_f[slot], 0), clen_lane);
    out[0 * n_out + o] = max(llen_f[slot], 0);
    out[1 * n_out + o] = max(clen_f[slot], 0);
    out[2 * n_out + o] = max(csrc_f[slot], 1);
    out[3 * n_out + o] = (int)(cstart + ls);
  }
}

}  // namespace

// recs: [7, n_slots] int32 from minlz_parse; lane_start/lane_len/lane_cnt/
// lane_lo/lane_hi: [lanes] int32; lane_out: [lanes] int64; out: [5, n_out]
// int32 (pos, llen, clen, csrc, lit).
MINLZ_EXPORT int minlz_compact(const void* recs, long long n_slots,
                               const void* lane_start, const void* lane_len,
                               const void* lane_cnt, const void* lane_out,
                               const void* lane_lo, const void* lane_hi,
                               int lanes, void* out, long long n_out,
                               void* stream) {
  if (lanes > 0 && n_out > 0) {
    compact_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)recs, n_slots, (const int*)lane_start,
        (const int*)lane_len, (const int*)lane_cnt,
        (const long long*)lane_out, (const int*)lane_lo, (const int*)lane_hi,
        (int*)out, n_out);
  }
  return (int)cudaGetLastError();
}

// As minlz_compact, without lane spans; out: [4, n_out] int32 (llen, clen,
// csrc, lit).
MINLZ_EXPORT int minlz_compact_dense(const void* recs, long long n_slots,
                                     const void* lane_start,
                                     const void* lane_len,
                                     const void* lane_cnt,
                                     const void* lane_out, int lanes,
                                     void* out, long long n_out,
                                     void* stream) {
  if (lanes > 0 && n_out > 0) {
    compact_dense_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)recs, n_slots, (const int*)lane_start,
        (const int*)lane_len, (const int*)lane_cnt,
        (const long long*)lane_out, (int*)out, n_out);
  }
  return (int)cudaGetLastError();
}
