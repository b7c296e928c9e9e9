// Probe kernels: the microbenchmarks that price the primitives of the decode
// executors on this card.
//
// probe_scalar_kernel      replaces scripts/kernel_probe.py::make_scalar_kernel
//                          (reached through bench_scalar)
// probe_gather_kernel      replaces scripts/kernel_probe.py::make_gather_kernel
//                          (reached through bench_gather)
// probe_taa_kernel         replaces the kernel of
//                          scripts/kernel_probe.py::bench_taa
// probe_chain_body_kernel  replaces the kernel of
//                          scripts/exec_probe.py::bench_chain_body
//
// The first three run in ONE thread block (one SM), as the TPU probes run on
// one core: the question is what one SM sustains, since an executor gives a
// range or a block to one SM.  The chain body runs ONE BLOCK A CHAIN, spread
// over the SMs: its TPU kernel held the whole buffer in VMEM on a core that
// is the whole chip, and a chain's steps never touch another chain's rows,
// so the chains need not share an SM.
//
// What bounds them here: the two chain kernels are bound by latency, not by
// bytes or operations: every step loads a row that an earlier step of the
// same chain stored.  A warp walks one chain.  In probe_scalar the number of
// chains is the number of warps whose latencies overlap on the one SM; in
// the chain body every chain has an SM's memory path to itself, so a step
// costs the dependent latency of one row move of the space it walks.  The
// two gather kernels are bound by the SM's shared-memory banks
// (probe_gather: random indices conflict) and by its shuffle rate
// (probe_taa: four shuffles an element).
//
// What the designs do about it: the chain kernels fetch their step lists
// ahead of the walk, 32 steps at a time with one coalesced load per lane,
// and hand each step's row numbers out by shuffle, so the dependent chain
// holds only the row loads and the row store.  `kShared` stages rows in
// dynamic shared memory (the latency the range executors pay): probe_scalar
// the whole buffer, the chain body each block its own chain's region, as
// the TPU kept the buffer in VMEM.  Otherwise the walk runs in device
// memory, where a buffer of a few MiB sits in L2 (the latency the
// whole-block executor pays).  The buffer is read and written by the one
// kernel, so it is neither const nor __restrict__.
//
// Every row number and index is clamped into its buffer: hostile input never
// faults.  The plain versions (ops/probe.py) clamp the same way.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowWords = 128;            // one row: 128 int32 = 512 bytes
constexpr int kRowVecs = kRowWords / 4;   // 32 int4, one per lane
constexpr int kGatherThreads = 1024;      // one per element of the [8, 128] sum

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Copy n_vecs int4 between device and shared memory with the whole block.
__device__ __forceinline__ void copy_vecs(int4* dst, const int4* src,
                                          int n_vecs) {
  for (int i = threadIdx.x; i < n_vecs; i += blockDim.x) dst[i] = src[i];
}

// n_chains warps; warp w walks chain w: n_ops steps of
// buf[dst] = buf[src] + 1 on whole rows.  rows: [n_chains, n_ops, 2] int32
// (src, dst).  Lane l moves words 4l..4l+3 of the row with one 16-byte load
// and one 16-byte store.  A lane only ever reads words that it stored itself
// (rows are copied column for column), and a thread sees its own stores in
// program order, so no barrier stands between the steps.
template <bool kShared>
__global__ void probe_scalar_kernel(const int* __restrict__ rows, int n_ops,
                                    int n_rows, int* buf) {
  extern __shared__ int4 stage[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int4* base = reinterpret_cast<int4*>(buf);
  if (kShared) {
    copy_vecs(stage, base, n_rows * kRowVecs);
    __syncthreads();
    base = stage;
  }
  const int2* steps =
      reinterpret_cast<const int2*>(rows) + (long long)warp * n_ops;
  int2 nxt = lane < n_ops ? steps[lane] : make_int2(0, 0);
  for (int i0 = 0; i0 < n_ops; i0 += 32) {
    const int2 cur = nxt;
    const int ahead = i0 + 32 + lane;
    nxt = ahead < n_ops ? steps[ahead] : make_int2(0, 0);
    const int m = min(32, n_ops - i0);
    for (int k = 0; k < m; ++k) {
      const int src = clampi(__shfl_sync(kFull, cur.x, k), 0, n_rows - 1);
      const int dst = clampi(__shfl_sync(kFull, cur.y, k), 0, n_rows - 1);
      int4 v = base[src * kRowVecs + lane];
      v.x = wadd(v.x, 1);
      v.y = wadd(v.y, 1);
      v.z = wadd(v.z, 1);
      v.w = wadd(v.w, 1);
      base[dst * kRowVecs + lane] = v;
    }
  }
  if (kShared) {
    __syncthreads();
    copy_vecs(reinterpret_cast<int4*>(buf), stage, n_rows * kRowVecs);
  }
}

// One step of the chain body by one warp: rows r0 and r1 (src and src + 1)
// in, row d out.  Lane l owns words 4l..4l+3 of the 128-word window that
// starts at word off >> 2 of the two joined rows (kRealign) or of the
// word-wise sum of the two rows (the probe's "minimal" mode); it keeps bytes
// [off, min(off + 64, 512)) of the window and zeroes the rest.  A step reads
// words that OTHER lanes stored in an earlier step, and d may be one of the
// rows being read: __syncwarp() stands between the loads and the store, and
// after the store.  Without them the result depends on timing.  The three
// pointers may each lie in shared or in device memory.
template <bool kRealign>
__device__ __forceinline__ void body_step(const int* r0, const int* r1,
                                          int* d, int off, int lane) {
  int w[4];
  if (kRealign) {
    const int first = 4 * lane + (off >> 2);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int g = first + t;
      w[t] = g < kRowWords ? r0[g] : r1[g - kRowWords];
    }
  } else {
    const int4 a = reinterpret_cast<const int4*>(r0)[lane];
    const int4 b = reinterpret_cast<const int4*>(r1)[lane];
    w[0] = wadd(a.x, b.x);
    w[1] = wadd(a.y, b.y);
    w[2] = wadd(a.z, b.z);
    w[3] = wadd(a.w, b.w);
  }
  const int hi = min(off + 64, 512);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    unsigned msk = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = 16 * lane + 4 * t + b;
      if (p >= off && p < hi) msk |= 0xFFu << (8 * b);
    }
    w[t] = (int)((unsigned)w[t] & msk);
  }
  __syncwarp();
  reinterpret_cast<int4*>(d)[lane] = make_int4(w[0], w[1], w[2], w[3]);
  __syncwarp();
}

// Threads of a chain-body block in the shared space: all of them stage the
// region and write it back, warp 0 walks.  The global space launches one
// warp a block.
constexpr int kStageThreads = 512;

// Block c walks chain c.  meta: [n_chains, n_ops, 3] int32 (src row, dst
// row, byte offset, taken modulo 512); src + 1 is clamped into buf too.
//
// kShared: the block stages its chain's region, rows [c * region_rows,
// (c + 1) * region_rows), in dynamic shared memory, followed by one flag
// byte a region row that says whether the chain stored to it.  A step whose
// three rows lie in the region runs wholly in shared memory.  A row outside
// the region is read and written in device memory, so input whose chains
// stray from their regions stays exact, only slower, as long as the chains
// own disjoint rows (the wrapper's contract): no other chain touches the
// rows this chain reads or writes there, and the write-back copies only the
// region rows that this chain stored, so it never overwrites another
// chain's store to a row of this region.
template <bool kShared, bool kRealign>
__global__ void probe_chain_body_kernel(const int* __restrict__ meta,
                                        int n_ops, int n_rows,
                                        int region_rows, int* buf) {
  extern __shared__ int4 stage[];
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x;
  const int lo = chain * region_rows;
  int* s_words = reinterpret_cast<int*>(stage);
  unsigned char* stored =
      reinterpret_cast<unsigned char*>(stage + region_rows * kRowVecs);
  int4* g_region = reinterpret_cast<int4*>(buf) + (long long)lo * kRowVecs;
  if (kShared) {
    copy_vecs(stage, g_region, region_rows * kRowVecs);
    for (int i = threadIdx.x; i < region_rows; i += blockDim.x) stored[i] = 0;
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    const int* steps = meta + (long long)chain * n_ops * 3;
    int n_src = 0, n_dst = 0, n_off = 0;
    if (lane < n_ops) {
      n_src = steps[lane * 3];
      n_dst = steps[lane * 3 + 1];
      n_off = steps[lane * 3 + 2];
    }
    for (int i0 = 0; i0 < n_ops; i0 += 32) {
      const int c_src = n_src, c_dst = n_dst, c_off = n_off;
      const long long ahead = (long long)i0 + 32 + lane;
      n_src = n_dst = n_off = 0;
      if (ahead < n_ops) {
        n_src = steps[ahead * 3];
        n_dst = steps[ahead * 3 + 1];
        n_off = steps[ahead * 3 + 2];
      }
      const int m = min(32, n_ops - i0);
      for (int k = 0; k < m; ++k) {
        const int src = clampi(__shfl_sync(kFull, c_src, k), 0, n_rows - 1);
        const int src1 = min(src + 1, n_rows - 1);
        const int dst = clampi(__shfl_sync(kFull, c_dst, k), 0, n_rows - 1);
        const int off = __shfl_sync(kFull, c_off, k) & 511;
        if (!kShared) {
          body_step<kRealign>(buf + (long long)src * kRowWords,
                              buf + (long long)src1 * kRowWords,
                              buf + (long long)dst * kRowWords, off, lane);
          continue;
        }
        // Rows relative to the region; outside it as unsigned >= region_rows.
        const unsigned a = (unsigned)(src - lo), b = (unsigned)(src1 - lo),
                       d = (unsigned)(dst - lo);
        const unsigned n = (unsigned)region_rows;
        if (a < n && b < n && d < n) {
          body_step<kRealign>(s_words + a * kRowWords, s_words + b * kRowWords,
                              s_words + d * kRowWords, off, lane);
        } else {
          body_step<kRealign>(
              a < n ? s_words + a * kRowWords : buf + (long long)src * kRowWords,
              b < n ? s_words + b * kRowWords
                    : buf + (long long)src1 * kRowWords,
              d < n ? s_words + d * kRowWords : buf + (long long)dst * kRowWords,
              off, lane);
        }
        if (d < n && lane == 0) stored[d] = 1;
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < region_rows * kRowVecs; i += blockDim.x) {
      if (stored[i / kRowVecs]) g_region[i] = stage[i];
    }
  }
}

// out[t] = sum over i of tbl[idx[i * 1024 + t]], int32 wrap, t = 0..1023.
// The table lies in shared memory; per iteration one coalesced read of idx,
// one shared-memory gather at a random bank, one add.  Indices are clamped
// into the table.
__global__ void probe_gather_kernel(const int* __restrict__ tbl, int tbl_n,
                                    const int* __restrict__ idx, int n_iters,
                                    int* __restrict__ out) {
  extern __shared__ int4 stage[];
  int* s_tbl = reinterpret_cast<int*>(stage);
  for (int i = threadIdx.x; i < tbl_n; i += blockDim.x) s_tbl[i] = tbl[i];
  __syncthreads();
  const int t = threadIdx.x;
  unsigned acc = 0;
#pragma unroll 8
  for (int i = 0; i < n_iters; ++i) {
    const int ix = clampi(idx[(long long)i * kGatherThreads + t], 0,
                          tbl_n - 1);
    acc += (unsigned)s_tbl[ix];
  }
  out[t] = (int)acc;
}

// out[r, l] = sum over i of a[r, idx[8 i + r, l]], int32 wrap: a gather
// inside a row of 128, done in registers.  Thread t serves out[t >> 7,
// t & 127]; its warp holds row r of `a` as four registers a lane (register q
// is word 32 q + lane), serves an index with four shuffles at lane
// idx & 31 and keeps the one of quarter idx >> 5.  Indices are clamped into
// the row.
__global__ void probe_taa_kernel(const int* __restrict__ a,
                                 const int* __restrict__ idx, int n_iters,
                                 int* __restrict__ out) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int* row = a + (t >> 7) * kRowWords;
  const int a0 = row[lane], a1 = row[32 + lane], a2 = row[64 + lane],
            a3 = row[96 + lane];
  unsigned acc = 0;
#pragma unroll 8
  for (int i = 0; i < n_iters; ++i) {
    const int ix = clampi(idx[(long long)i * kGatherThreads + t], 0,
                          kRowWords - 1);
    const int from = ix & 31;
    const int q = ix >> 5;
    const int v0 = __shfl_sync(kFull, a0, from);
    const int v1 = __shfl_sync(kFull, a1, from);
    const int v2 = __shfl_sync(kFull, a2, from);
    const int v3 = __shfl_sync(kFull, a3, from);
    acc += (unsigned)(q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3);
  }
  out[t] = (int)acc;
}

template <typename Kernel>
int launch_chain(Kernel kernel, bool shared, const void* steps, int n_ops,
                 int n_chains, int n_rows, void* buf, void* stream) {
  if (n_chains <= 0 || n_rows <= 0) return (int)cudaGetLastError();
  const int smem = shared ? n_rows * kRowWords * 4 : 0;
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, 32 * n_chains, smem, (cudaStream_t)stream>>>(
      (const int*)steps, n_ops, n_rows, (int*)buf);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a chain-body block in the shared space: its
// region's rows and one flag byte a row, rounded up to 16 bytes.
int body_shared_bytes(int region_rows) {
  return region_rows * kRowWords * 4 + (region_rows + 15) / 16 * 16;
}

template <bool kRealign>
int launch_body(bool shared, const void* meta, int n_ops, int n_chains,
                int n_rows, void* buf, void* stream) {
  if (n_chains <= 0 || n_rows <= 0) return (int)cudaGetLastError();
  const int region = shared ? n_rows / n_chains : 0;
  const int smem = shared ? body_shared_bytes(region) : 0;
  auto kernel = shared ? probe_chain_body_kernel<true, kRealign>
                       : probe_chain_body_kernel<false, kRealign>;
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_chains, shared ? kStageThreads : 32, smem,
           (cudaStream_t)stream>>>((const int*)meta, n_ops, n_rows, region,
                                   (int*)buf);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: [n_chains, n_ops, 2] int32; buf: [n_rows, 128] int32, walked in
// place.  shared != 0 stages buf in dynamic shared memory (it must fit: the
// wrapper checks).  n_chains <= 32.
MINLZ_EXPORT int minlz_probe_scalar(const void* rows, int n_ops, int n_chains,
                                    int n_rows, void* buf, int shared,
                                    void* stream) {
  return shared ? launch_chain(probe_scalar_kernel<true>, true, rows, n_ops,
                               n_chains, n_rows, buf, stream)
                : launch_chain(probe_scalar_kernel<false>, false, rows, n_ops,
                               n_chains, n_rows, buf, stream);
}

// meta: [n_chains, n_ops, 3] int32; buf as above.  One block a chain;
// shared != 0 stages each chain's region of n_rows / n_chains rows (it must
// fit with its flags: the wrapper checks).  realign == 0 is the probe's
// "minimal" mode.
MINLZ_EXPORT int minlz_probe_chain_body(const void* meta, int n_ops,
                                        int n_chains, int n_rows, void* buf,
                                        int shared, int realign,
                                        void* stream) {
  return realign ? launch_body<true>(shared != 0, meta, n_ops, n_chains,
                                     n_rows, buf, stream)
                 : launch_body<false>(shared != 0, meta, n_ops, n_chains,
                                      n_rows, buf, stream);
}

// tbl: [tbl_n] int32 (tbl_n * 4 bytes of shared memory); idx: [n_iters,
// 1024] int32; out: [1024] int32.
MINLZ_EXPORT int minlz_probe_gather(const void* tbl, int tbl_n,
                                    const void* idx, int n_iters, void* out,
                                    void* stream) {
  if (tbl_n <= 0) return (int)cudaGetLastError();
  probe_gather_kernel<<<1, kGatherThreads, (tbl_n * 4 + 15) / 16 * 16,
                        (cudaStream_t)stream>>>(
      (const int*)tbl, tbl_n, (const int*)idx, n_iters, (int*)out);
  return (int)cudaGetLastError();
}

// a: [8, 128] int32; idx: [n_iters, 1024] int32; out: [1024] int32.
MINLZ_EXPORT int minlz_probe_taa(const void* a, const void* idx, int n_iters,
                                 void* out, void* stream) {
  probe_taa_kernel<<<1, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)idx, n_iters, (int*)out);
  return (int)cudaGetLastError();
}
