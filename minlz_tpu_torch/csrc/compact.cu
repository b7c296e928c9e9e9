// Record compaction: the lane offsets scanned on the card, then one warp per
// segment lane.  Three kernels.
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
// lane_offsets_kernel takes the place of the jnp.cumsum of the lane counts
// in front of the TPU kernels (minlz_tpu/ops/exec_chain.py:1220).
//
// What bounds it here: the compaction moves about 20 bytes in and 20 bytes
// out per record (16 and 16 for the dense one), so it is bound by memory
// traffic: 50 MB for the 8 x 1 MiB batch, 15 us at 3.35 TB/s (on an H100
// it streams at about 2 TB/s of mixed reads and writes, with the keep test's
// scan or without it).  A lane holds a few hundred records (609 on average
// there), too few for a thread block.  What costs more than the kernel is a
// read back in its launch contract: a host that reads the record total to
// allocate the output waits for the parse to finish before it can launch
// the compaction, and the card idles while it does.
//
// What the design does about it:
//   * The output is allocated at the slot capacity of the parse (len + 1
//     slots a lane, ops/parse.py), which no lane count can exceed, so nothing
//     comes back to the host.  The lane offsets come from one small launch in
//     front: one block of 1024 threads scans the lane counts in int64,
//     looping over any number of lanes, and writes lane_out[0 .. lanes] (the
//     last entry is the total).  This was chosen over a single pass with
//     decoupled look-back: the scan reads 8 KB for 2048 lanes and costs a
//     launch of a few microseconds, where a look-back needs block tickets in
//     launch order and flags that blocks spin on, for a saving of that one
//     launch.  Columns past the total are left unwritten; every consumer
//     reads only [range_first[r], range_first[r + 1]).
//   * One warp per lane, eight lanes a block (2048 lanes: 256 blocks, which
//     all fit on 132 SMs at once).  The warp walks its lane's records in
//     chunks of 32, one record a thread; each of the five input rows and
//     five output rows of a chunk is one coalesced access of 32 words.  A
//     warp takes four chunks a step and loads the next step's four before
//     it scans this one's, so up to 40 loads of 128 bytes are in flight a
//     warp: a lane is a serial walk, and with one chunk in flight each
//     chunk would wait a whole memory latency.
//   * The keep test needs, for each record, the largest end of the earlier
//     records of its lane: an inclusive max-scan by __shfl_up_sync, five
//     steps over 32 lanes, with the earlier chunks' maximum in a register.
//     No shared memory and no __syncthreads.  The ends are saturated into
//     [0, 2^31] and scanned as 32-bit unsigned words: a record's start is an
//     int32 below 2^31 and the earlier ends are compared with max(0, ...),
//     so the saturated test keeps exactly the records the 64-bit one keeps
//     (dst + llen + clen of hostile records overflows int32, not this).
//   * Every output slot below the total is written once; nothing is
//     zero-filled.
//
// The hostile-input clamps (those of the plain versions, ops/exec_chain.py):
//   * a record is kept only if it starts at or after the end of every
//     earlier record of its lane (always true of a valid stream), so kept
//     records never overlap and only move forward;
//   * its bytes are confined to the lane's output span [lane_lo, lane_hi),
//     a part of its range: the literal length first, then the copy length;
//   * csrc is at least 1, and lsrc lies within the lane's compressed bytes.
// The executors (exec_range.cu, exec_block.cu) rely on the first two for
// their result and clamp every index again on their own for memory safety.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // lanes (warps) per thread block
constexpr int kUnroll = 4;           // chunks of 32 records loaded at once
constexpr int kStep = 32 * kUnroll;  // records a warp takes per step
constexpr int kScanThreads = 1024;   // the lane-offset scan: one block
constexpr int kScanItems = 4;        // consecutive counts a thread sums
constexpr long long kEndCap = 1LL << 31;

// lane_out[k] = the sum of cnt[0 .. k) in int64, for k = 0 .. lanes.
__global__ void __launch_bounds__(kScanThreads)
lane_offsets_kernel(const int* __restrict__ cnt, int lanes,
                    long long* __restrict__ lane_out) {
  __shared__ long long warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int t = tid & 31, warp = tid >> 5;
  long long carry = 0;
  for (int base = 0; base < lanes; base += kScanThreads * kScanItems) {
    int v[kScanItems];
    long long run = 0;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const int k = base + tid * kScanItems + u;
      v[u] = k < lanes ? cnt[k] : 0;
      run += v[u];
    }
    long long inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, inc, o);
      if (t >= o) inc += y;
    }
    if (t == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      long long s = warp_sum[t];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, s, o);
        if (t >= o) s += y;
      }
      warp_sum[t] = s;
    }
    __syncthreads();
    long long before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + inc - run;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const int k = base + tid * kScanItems + u;
      if (k < lanes) lane_out[k] = before;
      before += v[u];
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  if (tid == 0) lane_out[lanes] = carry;
}

// One chunk of 32 records of a lane, one record per thread of the warp.
struct Chunk {
  int dst, clen, csrc, lsrc, llen;
};

// The kUnroll chunks of a step: records base + u * 32 + t of the lane, for
// u < kUnroll; the records past the lane's count (or past the slots) are
// zeros and are not used.
template <bool kPositioned>
__device__ __forceinline__ void load_step(Chunk (&c)[kUnroll],
                                          const int* __restrict__ recs,
                                          long long n_slots, long long slot0,
                                          int cnt, int base, int t) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = base + u * 32 + t;
    const long long slot = slot0 + k;
    c[u] = Chunk{0, 0, 0, 0, 0};
    if (k < cnt && slot < n_slots) {
      if (kPositioned) c[u].dst = __ldg(recs + 1 * n_slots + slot);
      c[u].clen = __ldg(recs + 2 * n_slots + slot);
      c[u].csrc = __ldg(recs + 3 * n_slots + slot);
      c[u].lsrc = __ldg(recs + 4 * n_slots + slot);
      c[u].llen = __ldg(recs + 5 * n_slots + slot);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
compact_kernel(const int* __restrict__ recs, long long n_slots,
               const int* __restrict__ lane_start,
               const int* __restrict__ lane_len,
               const int* __restrict__ lane_cnt,
               const long long* __restrict__ lane_out,
               const int* __restrict__ lane_lo,
               const int* __restrict__ lane_hi, int lanes,
               int* __restrict__ out, long long n_out) {
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;  // a whole warp: no shuffle is left waiting
  const int cnt = lane_cnt[lane];
  const long long cstart = lane_start[lane];
  const long long slot0 = cstart + lane;
  const long long o0 = lane_out[lane];
  const long long lo = lane_lo[lane];
  const long long hi = lane_hi[lane];
  const long long clen_lane = lane_len[lane];

  unsigned carry = 0;  // the largest (saturated) record end so far
  Chunk cur[kUnroll];
  load_step<true>(cur, recs, n_slots, slot0, cnt, 0, t);
  for (int base = 0; base < cnt; base += kStep) {
    Chunk nxt[kUnroll];
    load_step<true>(nxt, recs, n_slots, slot0, cnt, base + kStep, t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * 32 >= cnt) continue;  // the same for the whole warp
      const Chunk& c = cur[u];
      const int k = base + u * 32 + t;
      const bool valid = k < cnt && slot0 + k < n_slots;
      const long long llen = max(c.llen, 0);
      const long long clen = max(c.clen, 0);
      const long long end = (long long)c.dst + llen + clen;
      unsigned inc = valid ? (unsigned)min(max(end, 0LL), kEndCap) : 0u;
      // Inclusive max-scan of the record ends across the warp.
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, inc, o);
        if (t >= o) inc = max(inc, y);
      }
      const unsigned prev = __shfl_up_sync(kFull, inc, 1);
      const unsigned prior = t > 0 ? max(carry, prev) : carry;
      carry = max(carry, __shfl_sync(kFull, inc, 31));
      const long long o = o0 + k;
      if (valid && o < n_out) {
        const bool keep = (long long)c.dst >= (long long)prior;
        const long long p = keep ? min(lo + c.dst, hi) : hi;
        const long long avail = hi - p;
        const long long ll = min(llen, avail);
        const long long cl = min(clen, avail - ll);
        const long long ls = min(max((long long)c.lsrc, 0LL), clen_lane);
        out[0 * n_out + o] = (int)p;
        out[1 * n_out + o] = (int)ll;
        out[2 * n_out + o] = (int)cl;
        out[3 * n_out + o] = max(c.csrc, 1);
        out[4 * n_out + o] = (int)(cstart + ls);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
compact_dense_kernel(const int* __restrict__ recs, long long n_slots,
                     const int* __restrict__ lane_start,
                     const int* __restrict__ lane_len,
                     const int* __restrict__ lane_cnt,
                     const long long* __restrict__ lane_out, int lanes,
                     int* __restrict__ out, long long n_out) {
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;
  const int cnt = lane_cnt[lane];
  const long long cstart = lane_start[lane];
  const long long slot0 = cstart + lane;
  const long long o0 = lane_out[lane];
  const int clen_lane = lane_len[lane];
  Chunk cur[kUnroll];
  load_step<false>(cur, recs, n_slots, slot0, cnt, 0, t);
  for (int base = 0; base < cnt; base += kStep) {
    Chunk nxt[kUnroll];
    load_step<false>(nxt, recs, n_slots, slot0, cnt, base + kStep, t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Chunk& c = cur[u];
      const int k = base + u * 32 + t;
      const long long o = o0 + k;
      if (k < cnt && slot0 + k < n_slots && o < n_out) {
        const int ls = min(max(c.lsrc, 0), clen_lane);
        out[0 * n_out + o] = max(c.llen, 0);
        out[1 * n_out + o] = max(c.clen, 0);
        out[2 * n_out + o] = max(c.csrc, 1);
        out[3 * n_out + o] = (int)(cstart + ls);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

int blocks_for(int lanes) { return (lanes + kWarps - 1) / kWarps; }

}  // namespace

// lane_cnt: [lanes] int32; lane_out: [lanes + 1] int64, written: the
// exclusive prefix sums of the counts, then their total.  One launch of one
// block, for any number of lanes (0 included).
MINLZ_EXPORT int minlz_lane_offsets(const void* lane_cnt, int lanes,
                                    void* lane_out, void* stream) {
  if (lanes >= 0) {
    lane_offsets_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
        (const int*)lane_cnt, lanes, (long long*)lane_out);
  }
  return (int)cudaGetLastError();
}

// recs: [7, n_slots] int32 from minlz_parse; lane_start/lane_len/lane_cnt/
// lane_lo/lane_hi: [lanes] int32; lane_out: [lanes] int64 from
// minlz_lane_offsets; out: [5, n_out] int32 (pos, llen, clen, csrc, lit),
// columns [lane_out[l], lane_out[l] + lane_cnt[l]) written for every lane l
// (those below n_out), no other.
MINLZ_EXPORT int minlz_compact(const void* recs, long long n_slots,
                               const void* lane_start, const void* lane_len,
                               const void* lane_cnt, const void* lane_out,
                               const void* lane_lo, const void* lane_hi,
                               int lanes, void* out, long long n_out,
                               void* stream) {
  if (lanes > 0 && n_out > 0) {
    compact_kernel<<<blocks_for(lanes), kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
        (const int*)recs, n_slots, (const int*)lane_start,
        (const int*)lane_len, (const int*)lane_cnt,
        (const long long*)lane_out, (const int*)lane_lo, (const int*)lane_hi,
        lanes, (int*)out, n_out);
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
    compact_dense_kernel<<<blocks_for(lanes), kWarps * 32, 0,
                           (cudaStream_t)stream>>>(
        (const int*)recs, n_slots, (const int*)lane_start,
        (const int*)lane_len, (const int*)lane_cnt,
        (const long long*)lane_out, lanes, (int*)out, n_out);
  }
  return (int)cudaGetLastError();
}
