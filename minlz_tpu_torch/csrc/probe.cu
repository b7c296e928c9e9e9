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
// The two chain kernels run ONE BLOCK A CHAIN (probe_scalar: a cluster of
// blocks a chain where the chain's region does not fit one block), spread
// over the SMs: their TPU kernels held the whole buffer in VMEM on a core
// that is the whole chip, and a chain's steps never touch another chain's
// rows, so the chains need not share an SM.  The two gathers (probe_gather,
// probe_taa) spread their iterations over about one block an SM and sum the
// blocks' partial sums on the card in the same launch, by one reduction
// (sum_partials) that both call.
//
// What bounds them here: the two chain kernels are bound by latency, not by
// bytes or operations: every step loads a row that an earlier step of the
// same chain stored.  A warp walks one chain, with an SM's memory path to
// itself, so a step costs the dependent latency of one row move in the
// space it walks: device memory, the block's shared memory, or a cluster's
// distributed shared memory (DSMEM), where a row may lie in another SM.
// The gathers are bound by a launch and one wave: probe_gather's megabyte
// of indices is small against the card's rate, and random indices conflict
// in the shared-memory banks of each SM; probe_taa's 8 MiB of indices take
// 2.5 us at the card's rate, and its four shuffles an element about 1 us on
// 132 SMs, against the few us of a clustered launch with two cluster syncs
// and a ticket.
//
// What the designs do about it: the chain kernels fetch their step lists
// ahead of the walk, 32 steps at a time with one coalesced load per lane;
// lane k clamps and routes step k's two rows to addresses, and the walk
// shuffles step k + 1's addresses out before step k's load, so the
// dependent chain holds only the row load, the adds and the row store.  In
// the shared space each block (or cluster) stages its chain's region, rows
// [c * region, (c + 1) * region), in dynamic shared memory, followed by one
// flag byte a row that says whether the chain stored to it; rows off the
// region are walked in device memory, and the write-back copies only the
// region rows that the chain stored, so input whose chains stray from their
// regions stays exact as long as the chains own disjoint rows.  Otherwise
// the walk runs in device memory, where a buffer of a few MiB sits in L2.
// The buffer is read and written by the one kernel, so it is neither const
// nor __restrict__.
//
// Every row number and index is clamped into its buffer: hostile input never
// faults.  The plain versions (ops/probe.py) clamp the same way.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowWords = 128;            // one row: 128 int32 = 512 bytes
constexpr int kRowVecs = kRowWords / 4;   // 32 int4, one per lane
constexpr int kRowB = kRowWords * 4;      // 512
// Threads of a chain block in the shared space: all of them stage its rows
// and write them back, warp 0 walks.  The global space launches one warp a
// block.
constexpr int kStageThreads = 512;
constexpr int kGatherThreads = 1024;      // the elements of the [8, 128] sum

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Copy n_vecs int4 between device and shared memory with the whole block.
__device__ __forceinline__ void copy_vecs(int4* dst, const int4* src,
                                          int n_vecs) {
  for (int i = threadIdx.x; i < n_vecs; i += blockDim.x) dst[i] = src[i];
}

// ---- probe_scalar: a block a chain, or a cluster a chain -------------------

// Where probe_scalar walks a chain's region: device memory (a warp a block),
// one block's shared memory, or the shared memory of a cluster's blocks.
enum ScalarSpace { kGlobal = 0, kBlock = 1, kCluster = 2 };

__device__ __forceinline__ int4 plus1(int4 v) {
  return make_int4(wadd(v.x, 1), wadd(v.y, 1), wadd(v.z, 1), wadd(v.w, 1));
}

// The address of the row at shared-memory byte address `local` in the block
// of cluster rank `rank`, in the cluster's shared window.
__device__ __forceinline__ unsigned cluster_addr(unsigned local,
                                                 unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local),
      "r"(rank));
  return out;
}

// The rows of a walk, by what an address is.  Each moves a lane's 16 bytes.
struct GlobalRows {       // a row number; the row in device memory
  using Addr = int;
  int4* buf;
  __device__ int4 load(int a, int lane) const {
    return buf[(long long)a * kRowVecs + lane];
  }
  __device__ void store(int a, int lane, int4 v) const {
    buf[(long long)a * kRowVecs + lane] = v;
  }
};
struct BlockRows {        // an int4 index into the block's shared memory
  using Addr = int;
  __device__ int4 load(int a, int lane) const {
    extern __shared__ int4 stage[];
    return stage[a + lane];
  }
  __device__ void store(int a, int lane, int4 v) const {
    extern __shared__ int4 stage[];
    stage[a + lane] = v;
  }
};
struct ClusterRows {      // a byte address in the cluster's shared window
  using Addr = unsigned;
  __device__ int4 load(unsigned a, int lane) const {
    int4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(a + 16 * lane) : "memory");
    return v;
  }
  __device__ void store(unsigned a, int lane, int4 v) const {
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "r"(a + 16 * lane), "r"(v.x), "r"(v.y), "r"(v.z),
                 "r"(v.w) : "memory");
  }
};
struct AnyRows {          // a generic pointer: device or (distributed) shared
  using Addr = unsigned long long;
  __device__ int4 load(Addr a, int lane) const {
    return reinterpret_cast<const int4*>(a)[lane];
  }
  __device__ void store(Addr a, int lane, int4 v) const {
    reinterpret_cast<int4*>(a)[lane] = v;
  }
};

// m steps of buf[d] = buf[s] + 1 by one warp; lane k holds step k's
// addresses (s, d).  Step k + 1's addresses are shuffled out before step
// k's load, so that the dependent chain (step k + 1's load must see step
// k's store) holds only the load, the adds and the store.  A lane only ever
// reads words that it stored itself (rows are copied column for column),
// and a thread sees its own stores in program order, so no barrier stands
// between the steps.
template <class Rows>
__device__ __forceinline__ void walk(const Rows& rows, typename Rows::Addr s,
                                     typename Rows::Addr d, int m, int lane) {
  typename Rows::Addr sn = __shfl_sync(kFull, s, 0);
  typename Rows::Addr dn = __shfl_sync(kFull, d, 0);
  if (m == 32) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const auto a = sn, b = dn;
      sn = __shfl_sync(kFull, s, (k + 1) & 31);
      dn = __shfl_sync(kFull, d, (k + 1) & 31);
      rows.store(b, lane, plus1(rows.load(a, lane)));
    }
  } else {
    for (int k = 0; k < m; ++k) {
      const auto a = sn, b = dn;
      sn = __shfl_sync(kFull, s, (k + 1) & 31);
      dn = __shfl_sync(kFull, d, (k + 1) & 31);
      rows.store(b, lane, plus1(rows.load(a, lane)));
    }
  }
}

// Block (or cluster) c walks chain c: n_ops steps of buf[dst] = buf[src] + 1
// on whole rows, rows: [n_chains, n_ops, 2] int32 (src, dst), each clamped
// into buf.  Lane l moves words 4l..4l+3 of the row with one 16-byte load and
// one 16-byte store.
//
// kBlock / kCluster: chain c's region, rows [c * region, (c + 1) * region),
// is staged in shared memory: rank q of the chain's cluster of `k` blocks
// (kBlock: k = 1) holds rows [q * share, (q + 1) * share) of it, then one
// flag byte a share row.  Warp 0 of rank 0 walks; a batch of 32 steps whose
// rows all lie in the region runs wholly in shared memory (kCluster: through
// DSMEM, whatever rank holds a row), any other batch through generic
// pointers, a row off the region in device memory.  The flags come from the
// step list, not from the walk: the other warps mark every share row that
// a step stores to while warp 0 walks.  Between staging and walk, and
// between walk and write-back, the blocks of the cluster meet at
// cluster.sync(), so no block leaves while the walker may touch its shared
// memory.
template <int kSpace>
__global__ void probe_scalar_kernel(const int* __restrict__ rows, int n_ops,
                                    int n_rows, int region, int share, int k,
                                    int* buf) {
  extern __shared__ int4 stage[];
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x / k;
  const int rank = blockIdx.x % k;
  const int lo = chain * region;
  const int mine = max(0, min(share, region - rank * share));
  int4* g = reinterpret_cast<int4*>(buf);
  int4* g_share = g + (long long)(lo + rank * share) * kRowVecs;
  unsigned char* stored =
      reinterpret_cast<unsigned char*>(stage + share * kRowVecs);
  const int2* steps =
      reinterpret_cast<const int2*>(rows) + (long long)chain * n_ops;
  if (kSpace != kGlobal) {
    copy_vecs(stage, g_share, mine * kRowVecs);
    for (int i = threadIdx.x; i < share; i += blockDim.x) stored[i] = 0;
    if constexpr (kSpace == kCluster) cg::this_cluster().sync();
    else __syncthreads();
  }
  if (rank == 0 && threadIdx.x < 32) {
    const unsigned n = (unsigned)region;
    const unsigned base = (unsigned)__cvta_generic_to_shared(stage);
    int2 nxt = lane < n_ops ? steps[lane] : make_int2(0, 0);
    for (int i0 = 0; i0 < n_ops; i0 += 32) {
      const int2 cur = nxt;
      const int ahead = i0 + 32 + lane;
      nxt = ahead < n_ops ? steps[ahead] : make_int2(0, 0);
      const int m = min(32, n_ops - i0);
      const int src = clampi(cur.x, 0, n_rows - 1);
      const int dst = clampi(cur.y, 0, n_rows - 1);
      if constexpr (kSpace == kGlobal) {
        walk(GlobalRows{g}, src, dst, m, lane);
        continue;
      }
      // Rows relative to the region; outside it as unsigned >= region.
      const unsigned a = (unsigned)(src - lo), b = (unsigned)(dst - lo);
      const bool in = a < n && b < n;
      if (__all_sync(kFull, in || lane >= m)) {
        const unsigned sa = in ? a : 0, sb = in ? b : 0;
        if constexpr (kSpace == kBlock) {
          walk(BlockRows{}, (int)sa * kRowVecs, (int)sb * kRowVecs, m, lane);
        } else {
          const unsigned qa = sa / share, qb = sb / share;
          walk(ClusterRows{},
               cluster_addr(base + (sa - qa * share) * kRowB, qa),
               cluster_addr(base + (sb - qb * share) * kRowB, qb), m, lane);
        }
        continue;
      }
      auto any = [&](int row, unsigned rel) -> unsigned long long {
        if (rel >= n)
          return (unsigned long long)(g + (long long)row * kRowVecs);
        if constexpr (kSpace == kBlock)
          return (unsigned long long)(stage + rel * kRowVecs);
        const unsigned q = rel / share;
        return (unsigned long long)cg::this_cluster().map_shared_rank(
            stage + (rel - q * share) * kRowVecs, q);
      };
      walk(AnyRows{}, any(src, a), any(dst, b), m, lane);
    }
  } else if (kSpace != kGlobal) {
    // Mark the share rows that the chain stores to.
    const int first = rank == 0 ? 32 : 0;
    const unsigned own = (unsigned)(lo + rank * share);
    for (int i = threadIdx.x - first; i < n_ops; i += blockDim.x - first) {
      const unsigned r =
          (unsigned)clampi(steps[i].y, 0, n_rows - 1) - own;
      if (r < (unsigned)mine) stored[r] = 1;
    }
  }
  if (kSpace != kGlobal) {
    if constexpr (kSpace == kCluster) cg::this_cluster().sync();
    else __syncthreads();
    for (int i = threadIdx.x; i < mine * kRowVecs; i += blockDim.x) {
      if (stored[i / kRowVecs]) g_share[i] = stage[i];
    }
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

// ---- the gathers: spread over the card, summed in the same launch ----------

constexpr int kIterVecs = kGatherThreads / 4;   // uint4 of 1024 sums: 256
constexpr int kGatherBlock = kIterVecs;   // threads; four of the sums each
constexpr int kGatherCluster = 8;   // blocks a cluster; 128 sums a rank
constexpr int kSliceVecs = kIterVecs / kGatherCluster;             // 32 uint4

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The 1024 sums of an iteration's words, t = 0..1023, over block b's
// iterations [n_iters * b / grid, n_iters * (b + 1) / grid): thread j reads
// indices 4j..4j+3 of an iteration with one 16-byte load (the next
// iteration's before this one's lookups) and keeps their four words'
// unsigned sums.  look.prepare() runs after the first load is issued;
// look(v) gives the four words of the indices in v.
template <class Lookup>
__device__ __forceinline__ uint4 accumulate(Lookup& look,
                                            const int* __restrict__ idx,
                                            int n_iters) {
  const int grid = gridDim.x, b = blockIdx.x;
  const int i_lo = (int)((long long)n_iters * b / grid);
  const int i_hi = (int)((long long)n_iters * (b + 1) / grid);
  const int4* idx4 = reinterpret_cast<const int4*>(idx) + threadIdx.x;
  int4 v = i_lo < i_hi ? idx4[(long long)i_lo * kIterVecs]
                       : make_int4(0, 0, 0, 0);
  look.prepare();
  __syncthreads();
  uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int i = i_lo; i < i_hi; ++i) {
    const int4 nx = i + 1 < i_hi ? idx4[(long long)(i + 1) * kIterVecs] : v;
    acc = add4(acc, look(v));
    v = nx;
  }
  return acc;
}

// out[t] = the sum of every block's sum t, mod 2^32, written in the same
// launch; acc holds this thread's sums 4 threadIdx.x .. 4 threadIdx.x + 3.
// Addition mod 2^32 makes any order exact:
//   1. each block puts its 1024 sums at the front of its dynamic shared
//      memory; the blocks of a cluster meet; rank q adds slice q (sums
//      128 q .. 128 q + 127) over the cluster's blocks through DSMEM and
//      writes it to scratch[cluster, slice];
//   2. it takes a ticket on tickets[q]; the block that draws the last ticket
//      adds slice q over every cluster's row of scratch, writes it to out
//      and sets tickets[q] back to 0 for the next launch.
// So nothing is memset and nothing is read back, and the two gathers may
// share their tickets on a stream: launches on a stream run one after
// another, and each leaves every ticket at 0.
__device__ __forceinline__ void sum_partials(uint4 acc,
                                             uint4* __restrict__ scratch,
                                             unsigned* __restrict__ tickets,
                                             int* __restrict__ out) {
  extern __shared__ int4 stage[];
  uint4* part = reinterpret_cast<uint4*>(stage);           // 1024 sums
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  part[t] = acc;
  cluster.sync();
  const unsigned q = cluster.block_rank();
  const int n_clusters = gridDim.x / kGatherCluster;
  const int cl = blockIdx.x / kGatherCluster;
  const int slice = q * kSliceVecs + t;
  if (t < kSliceVecs) {
    uint4 sum = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kGatherCluster; ++r)
      sum = add4(sum, cluster.map_shared_rank(part, r)[slice]);
    scratch[(long long)cl * kIterVecs + slice] = sum;
    __threadfence();
  }
  cluster.sync();   // no block leaves while a peer reads its sums
  if (t < kSliceVecs) {
    __syncwarp();
    unsigned ticket = 0;
    if (t == 0) ticket = atomicAdd(tickets + q, 1u);
    ticket = __shfl_sync(kFull, ticket, 0);
    if (ticket == (unsigned)n_clusters - 1) {
      __threadfence();
      uint4 sum = make_uint4(0, 0, 0, 0);
      for (int c = 0; c < n_clusters; ++c)
        sum = add4(sum, __ldcg(scratch + (long long)c * kIterVecs + slice));
      reinterpret_cast<uint4*>(out)[slice] = sum;
      if (t == 0) tickets[q] = 0;
    }
  }
}

// probe_gather's lookup: flat indices into the table, which prepare()
// stages in shared memory behind the 1024 sums (at most 36 KiB).  Indices
// are clamped into the table.
struct TableLookup {
  const int* tbl;
  int tbl_n;
  __device__ void prepare() {
    extern __shared__ int4 stage[];
    copy_vecs(stage + kIterVecs, reinterpret_cast<const int4*>(tbl),
              tbl_n / 4);
  }
  __device__ uint4 operator()(int4 v) const {
    extern __shared__ int4 stage[];
    const int* s_tbl = reinterpret_cast<const int*>(stage + kIterVecs);
    const int last = tbl_n - 1;
    return make_uint4((unsigned)s_tbl[clampi(v.x, 0, last)],
                      (unsigned)s_tbl[clampi(v.y, 0, last)],
                      (unsigned)s_tbl[clampi(v.z, 0, last)],
                      (unsigned)s_tbl[clampi(v.w, 0, last)]);
  }
};

// probe_taa's lookup: positions in a row of 128, gathered inside the warp.
// Thread j's four elements lie in row j >> 5 (its warp's), which the warp
// holds as four registers a lane (register q is word 32 q + lane); an
// index is served by four shuffles at lane ix & 31, keeping the one of
// quarter ix >> 5.  Indices are clamped into the row.
struct RowLookup {
  const int* a;
  int r0, r1, r2, r3;
  __device__ void prepare() {
    const int lane = threadIdx.x & 31;
    const int* row = a + (threadIdx.x >> 5) * kRowWords;
    r0 = row[lane];
    r1 = row[32 + lane];
    r2 = row[64 + lane];
    r3 = row[96 + lane];
  }
  __device__ unsigned word(int ix) const {
    ix = clampi(ix, 0, kRowWords - 1);
    const int from = ix & 31, q = ix >> 5;
    const int v0 = __shfl_sync(kFull, r0, from);
    const int v1 = __shfl_sync(kFull, r1, from);
    const int v2 = __shfl_sync(kFull, r2, from);
    const int v3 = __shfl_sync(kFull, r3, from);
    return (unsigned)(q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3);
  }
  __device__ uint4 operator()(int4 v) const {
    return make_uint4(word(v.x), word(v.y), word(v.z), word(v.w));
  }
};

// out[t] = sum over i of tbl[idx[i * 1024 + t]], int32 wrap, t = 0..1023.
__global__ void probe_gather_kernel(const int* __restrict__ tbl, int tbl_n,
                                    const int* __restrict__ idx, int n_iters,
                                    uint4* __restrict__ scratch,
                                    unsigned* __restrict__ tickets,
                                    int* __restrict__ out) {
  TableLookup look{tbl, tbl_n};
  sum_partials(accumulate(look, idx, n_iters), scratch, tickets, out);
}

// out[r, l] = sum over i of a[r, idx[8 i + r, l]], int32 wrap: the TPU
// probe's take_along_axis inside a vreg row, here a gather inside a warp's
// registers.
__global__ void probe_taa_kernel(const int* __restrict__ a,
                                 const int* __restrict__ idx, int n_iters,
                                 uint4* __restrict__ scratch,
                                 unsigned* __restrict__ tickets,
                                 int* __restrict__ out) {
  RowLookup look{a};
  sum_partials(accumulate(look, idx, n_iters), scratch, tickets, out);
}

// Bytes of dynamic shared memory that `rows` staged rows take with their
// flag bytes, rounded up to 16 (ops/probe.py: stage_bytes).
int stage_bytes(int rows) {
  return rows * kRowWords * 4 + (rows + 15) / 16 * 16;
}

// A launch the card refused because no cluster of the requested size fits
// it (cudaOccupancyMaxActiveClusters returned 0).
constexpr int kClusterRefused = -1;

// Launch `kernel` on `grid` blocks in clusters of `cluster` blocks, after
// asking the card whether such a cluster fits it at all.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int grid, int threads, int smem,
                    int cluster, void* stream, Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int fits = 0;
  err = cudaOccupancyMaxActiveClusters(&fits, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (fits == 0) return kClusterRefused;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kRealign>
int launch_body(bool shared, const void* meta, int n_ops, int n_chains,
                int n_rows, void* buf, void* stream) {
  if (n_chains <= 0 || n_rows <= 0) return (int)cudaGetLastError();
  const int region = shared ? n_rows / n_chains : 0;
  const int smem = shared ? stage_bytes(region) : 0;
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

// Whether a gather's plan (ops/probe.py: gather_plan) is one the kernels
// take: `grid` blocks in clusters of kGatherCluster, each with the 1024
// sums and then `staged` words of table in `smem` bytes of shared memory.
bool gather_plan_ok(int n_iters, int grid, int cluster, int smem,
                    int staged) {
  return n_iters >= 0 && cluster == kGatherCluster && grid >= cluster &&
         grid % cluster == 0 && smem == (kGatherThreads + staged) * 4;
}

}  // namespace

// rows: [n_chains, n_ops, 2] int32; buf: [n_rows, 128] int32, walked in
// place.  The plan comes from ops/probe.py (scalar_plan) and is checked
// here: shared == 0 runs `grid` = n_chains blocks of one warp in device
// memory; shared != 0 runs n_chains clusters of `cluster` blocks (1, 2, 4,
// 8 or 16; 1 is a plain launch), each staging `share` rows of its chain's
// region of n_rows / n_chains rows in `smem` bytes.  Returns
// kClusterRefused when no such cluster fits the card.
MINLZ_EXPORT int minlz_probe_scalar(const void* rows, int n_ops, int n_chains,
                                    int n_rows, void* buf, int shared,
                                    int grid, int cluster, int share,
                                    int smem, void* stream) {
  if (n_chains <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const int region = n_rows / n_chains;
  const bool pow2 = cluster > 0 && cluster <= 16 &&
                    (cluster & (cluster - 1)) == 0;
  if (!pow2 || grid != n_chains * cluster ||
      (!shared && (cluster != 1 || share != 0 || smem != 0)) ||
      (shared && ((long long)share * cluster < region || share < 1 ||
                  smem != stage_bytes(share) || smem > 232448)))
    return (int)cudaErrorInvalidValue;
  const int* r = (const int*)rows;
  int* b = (int*)buf;
  cudaStream_t st = (cudaStream_t)stream;
  if (!shared) {
    probe_scalar_kernel<kGlobal><<<grid, 32, 0, st>>>(r, n_ops, n_rows,
                                                     region, 0, 1, b);
    return (int)cudaGetLastError();
  }
  if (cluster > 1)
    return launch_clusters(probe_scalar_kernel<kCluster>, grid,
                           kStageThreads, smem, cluster, stream, r, n_ops,
                           n_rows, region, share, cluster, b);
  cudaError_t err = cudaFuncSetAttribute(
      probe_scalar_kernel<kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_scalar_kernel<kBlock><<<grid, kStageThreads, smem, st>>>(
      r, n_ops, n_rows, region, share, 1, b);
  return (int)cudaGetLastError();
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

// tbl: [tbl_n] int32, tbl_n a multiple of 4; idx: [n_iters, 1024] int32;
// out: [1024] int32.  The plan comes from ops/probe.py (gather_plan) and is
// checked here: `grid` blocks in clusters of `cluster` (kGatherCluster),
// each with `smem` bytes of shared memory (the 1024 sums, then the table).
// scratch: [grid / cluster, 1024] int32, any contents; tickets: [cluster]
// uint32, zero before the launch and after it.  Returns kClusterRefused
// when no such cluster fits the card.
MINLZ_EXPORT int minlz_probe_gather(const void* tbl, int tbl_n,
                                    const void* idx, int n_iters, void* out,
                                    int grid, int cluster, int smem,
                                    void* scratch, void* tickets,
                                    void* stream) {
  if (tbl_n <= 0 || tbl_n % 4 ||
      !gather_plan_ok(n_iters, grid, cluster, smem, tbl_n))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(probe_gather_kernel, grid, kGatherBlock, smem,
                         cluster, stream,
                         (const int*)tbl, tbl_n, (const int*)idx, n_iters,
                         (uint4*)scratch, (unsigned*)tickets, (int*)out);
}

// a: [8, 128] int32; idx: [n_iters, 1024] int32; out: [1024] int32.  The
// plan is gather_plan's with no table (smem: the 1024 sums alone); scratch
// and tickets as for minlz_probe_gather, whose tickets these may be.
MINLZ_EXPORT int minlz_probe_taa(const void* a, const void* idx, int n_iters,
                                 void* out, int grid, int cluster, int smem,
                                 void* scratch, void* tickets,
                                 void* stream) {
  if (!gather_plan_ok(n_iters, grid, cluster, smem, 0))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(probe_taa_kernel, grid, kGatherBlock, smem, cluster,
                         stream, (const int*)a, (const int*)idx, n_iters,
                         (uint4*)scratch, (unsigned*)tickets, (int*)out);
}
