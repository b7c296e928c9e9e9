// Ablation probe of the executor's per-record step: nchain synthetic record
// chains over one arena, in five variants.
//
// Replaces the TPU kernel scripts/ablate_exec.py::make_kernel (reached
// through run).  The arena is [n_rows, 128] int32, read as bytes (little
// endian): rows 0..out_base_row-1 hold literal bytes, chain c owns the
// chain_rows rows from row out_base_row + c * chain_rows, and its cursor
// starts at the first byte of that region.  A record is three int32 words:
// llen | clen << 14 (14-bit fields), the copy offset, and the byte address of
// its literals.  ops: [nchain, cap, 3] int32; counts: [nchain] int32.
//
//   full       each record moves llen literal bytes to the cursor and then
//              copies clen bytes by out[d + i] = out[d - eff + i % eff]
//              (eff = max(offset, 1)), which is the TPU body's period
//              doubling byte for byte;
//   onewin     the TPU body's state machine with one literal-or-copy move an
//              iteration: a move ends at a 512-byte row boundary, a copy move
//              takes min(remaining, eff) bytes, and eff doubles when a move
//              took a whole period.  Same bytes as full;
//   norealign  the two-slot state machine, but a move takes its bytes from
//              the aligned 512-byte row that holds its source start, at the
//              destination's offset within the row (the TPU body without its
//              barrel shift);
//   nomask     the two-slot state machine, but every slot, also an empty one,
//              stores the whole 512-byte window that starts at its source
//              start minus the cursor's offset in the row over the cursor's
//              row (the TPU body without its byte mask);
//   minimal    a record copies the whole row (offset >> 9) over the cursor's
//              row and advances the cursor by llen + clen.
//
// norealign and nomask price the TPU's barrel shift and mask build.  A
// byte-addressed kernel has neither, so they shed nothing here; they are
// ported so that every variant's stored words have a counterpart.
//
// One THREAD BLOCK a chain, spread over the SMs: the TPU kernel kept the
// whole arena in VMEM on a core that is the whole chip, and a chain never
// sees another chain's stores, so the chains need not share an SM.  Warp 0
// walks the chain: a record moves about ten bytes, fewer than a warp has
// lanes, so more walkers would add barrier cost and no width, and
// __syncwarp() orders a chain's moves at a few cycles each.  All the
// block's threads stage the chain's region [lo, hi) of the arena in
// dynamic shared memory first and write it back once at the end, so every
// read and store of the region, including the copies that read what the
// chain has just written, stays in shared memory.
//
// What bounds it: the serial chain of moves of one chain (a copy may read
// what the move before it wrote), that is the latency of a dependent move
// in shared memory, not bytes.  What the design does about it: the records
// are fetched ahead, 32 at a time with coalesced loads, two batches in
// flight, and handed out by shuffle, so the chain holds only the byte
// moves; a read outside the region (the literal rows) goes through the
// read-only path, where the 4 KiB of literals stay in L1.
//
// A read takes the chain's own region from shared memory and every other
// byte from the input arena: a chain never sees another chain's stores, in
// whatever order the blocks run.  A read outside the arena gives 0 and a
// store outside the chain's region is dropped; the wrapper refuses input
// whose chains outgrow their regions, and regions that do not fit shared
// memory.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowB = 512;

enum Variant { kFullV = 0, kOnewin = 1, kNorealign = 2, kNomask = 3,
               kMinimal = 4 };

struct Chain {
  const unsigned char* in;  // the input arena
  unsigned char* stage;     // the chain's region, in shared memory
  long long lo, hi;         // the chain's region, byte addresses
  long long n_bytes;        // arena size
  int lane;

  __device__ __forceinline__ bool own(long long s) const {
    return s >= lo && s < hi;
  }
};

__device__ __forceinline__ unsigned char rd(const Chain& c, long long s) {
  if (c.own(s)) return c.stage[s - c.lo];
  if (s < 0 || s >= c.n_bytes) return 0;
  return __ldg(c.in + s);
}

__device__ __forceinline__ void wr(const Chain& c, long long d,
                                   unsigned char v) {
  if (c.own(d)) c.stage[d - c.lo] = v;
}

// n bytes from src to dst, the lanes side by side; every source byte was
// stored before the last __syncwarp().
__device__ __forceinline__ void move(const Chain& c, long long dst,
                                     long long src, int n) {
  for (int i = c.lane; i < n; i += 32) wr(c, dst + i, rd(c, src + i));
  __syncwarp();
}

// The 512 bytes from src over the row at dst: loaded whole, then stored.
// A source byte before the arena is the one 512 bytes on: the TPU body's
// window wraps inside row 0 there (its nomask variant stores such bytes).
__device__ __forceinline__ void move_row(const Chain& c, long long dst,
                                         long long src) {
  // An aligned source row (the minimal variant) lies wholly inside or
  // outside the chain's region, which is whole rows: one 16-byte load and
  // one 16-byte store a lane.  dst is always the first byte of a row.
  if ((src & (kRowB - 1)) == 0 && src >= 0 && src + kRowB <= c.n_bytes) {
    const int4 row =
        c.own(src)
            ? reinterpret_cast<const int4*>(c.stage + (src - c.lo))[c.lane]
            : __ldg(reinterpret_cast<const int4*>(c.in + src) + c.lane);
    __syncwarp();
    if (c.own(dst))
      reinterpret_cast<int4*>(c.stage + (dst - c.lo))[c.lane] = row;
    __syncwarp();
    return;
  }
  unsigned char v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long s = src + 16 * c.lane + k;
    v[k] = rd(c, s < 0 ? s + kRowB : s);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16; ++k) wr(c, dst + 16 * c.lane + k, v[k]);
  __syncwarp();
}

// First byte of the aligned row that the TPU body's window(byte_start)
// loads: the row index is clipped into [0, n_rows - 2].
__device__ __forceinline__ long long window_row(long long byte_start,
                                                int n_rows) {
  long long row = byte_start >> 9;  // arithmetic: floor
  row = min(max(row, 0LL), (long long)n_rows - 2);
  return row * kRowB;
}

// A chain's records, fetched 32 at a time, the next batch already in
// flight.
struct Records {
  const int* ops;
  int count, lane;
  int a, b, c;     // this lane's record of the current batch
  int na, nb, nc;  // and of the next
  int batch0;      // record index of the current batch's lane 0

  __device__ void load(int first, int& x, int& y, int& z) const {
    const long long j = (long long)first + lane;
    x = y = z = 0;
    if (j < count) {
      x = ops[j * 3];
      y = ops[j * 3 + 1];
      z = ops[j * 3 + 2];
    }
  }
  __device__ void init(const int* ops_, int count_, int lane_) {
    ops = ops_;
    count = count_;
    lane = lane_;
    batch0 = 0;
    load(0, a, b, c);
    load(32, na, nb, nc);
  }
  // Record `op` (taken in ascending order, by the whole warp).
  __device__ void get(int op, int& x, int& y, int& z) {
    if (op - batch0 >= 32) {
      batch0 += 32;
      a = na;
      b = nb;
      c = nc;
      load(batch0 + 32, na, nb, nc);
    }
    const int k = op - batch0;
    x = __shfl_sync(kFull, a, k);
    y = __shfl_sync(kFull, b, k);
    z = __shfl_sync(kFull, c, k);
  }
};

// Warp 0's walk of its chain: count records from ops, the chain's own.
template <int V>
__device__ void walk(const Chain& c, const int* __restrict__ ops, int count,
                     int n_rows) {
  const long long last_row = c.hi / kRowB - 1;
  Records recs;
  recs.init(ops, count, c.lane);
  long long cur = c.lo;

  if (V == kFullV) {
    for (int op = 0; op < count; ++op) {
      int a, b, cw;
      recs.get(op, a, b, cw);
      const int llen = a & 0x3FFF;
      const int clen = (a >> 14) & 0x3FFF;
      const int eff = max(b, 1);
      move(c, cur, cw, llen);
      const long long d = cur + llen;
      const bool rle = eff < clen;
      for (int i = c.lane; i < clen; i += 32)
        wr(c, d + i, rd(c, d - eff + (rle ? i % eff : i)));
      __syncwarp();
      cur = d + clen;
    }
    return;
  }

  if (V == kMinimal) {
    for (int op = 0; op < count; ++op) {
      int a, b, cw;
      recs.get(op, a, b, cw);
      const long long src_row = min(max((long long)(b >> 9), 0LL),
                                    (long long)n_rows - 1);
      move_row(c, min(cur >> 9, last_row) * kRowB, src_row * kRowB);
      cur += (a & 0x3FFF) + ((a >> 14) & 0x3FFF);
    }
    return;
  }

  // The TPU body's state machine: lr / cr literal and copy bytes left of the
  // current record, eff the copy period, ls the literal source.
  int op = 0, lr = 0, cr = 0, eff = 1;
  long long ls = 0;
  for (;;) {
    if (lr == 0 && cr == 0) {
      if (op >= count) break;
      int a, b, cw;
      recs.get(op, a, b, cw);
      lr = a & 0x3FFF;
      cr = (a >> 14) & 0x3FFF;
      eff = max(b, 1);
      ls = cw;
      ++op;
    }
    if (V == kOnewin) {
      const bool is_lit = lr > 0;
      const int q = (int)(cur & (kRowB - 1));
      const int ta = min(is_lit ? lr : min(cr, eff), kRowB - q);
      move(c, cur, is_lit ? ls : cur - eff, ta);
      cur += ta;
      if (is_lit) {
        ls += ta;
        lr -= ta;
      } else {
        cr -= ta;
        if (ta == eff && cr > 0) eff *= 2;
      }
      continue;
    }
    // Two slots an iteration: the literal part, then the copy part (empty
    // until the literals are done).
    const int q = (int)(cur & (kRowB - 1));
    const int ta = min(lr, kRowB - q);
    const long long row1 = min(cur >> 9, last_row) * kRowB;
    if (V == kNorealign) {
      move(c, cur, window_row(ls - q, n_rows) + q, ta);
    } else {
      move_row(c, row1, ls - q);
    }
    cur += ta;
    ls += ta;
    lr -= ta;
    const int q2 = (int)(cur & (kRowB - 1));
    const int tb = lr == 0 ? min(min(cr, eff), kRowB - q2) : 0;
    const long long row2 = min(cur >> 9, last_row) * kRowB;
    if (V == kNorealign) {
      move(c, cur, window_row(cur - eff - q2, n_rows) + q2, tb);
    } else {
      move_row(c, row2, cur - eff - q2);
    }
    cur += tb;
    cr -= tb;
    if (tb == eff && cr > 0) eff *= 2;
  }
}

// Threads of a block: all stage the region and write it back, warp 0
// walks.
constexpr int kStageThreads = 256;

// Block ch walks chain ch over its region, rows out_base_row + ch *
// chain_rows onwards, staged in chain_rows * 512 bytes of dynamic shared
// memory.
template <int V>
__global__ void ablate_kernel(const int* __restrict__ counts,
                              const int* __restrict__ ops, int cap,
                              const unsigned char* __restrict__ arena_in,
                              unsigned char* out, int n_rows,
                              int out_base_row, int chain_rows) {
  extern __shared__ int4 stage[];
  const int ch = blockIdx.x;
  Chain c;
  c.in = arena_in;
  c.stage = reinterpret_cast<unsigned char*>(stage);
  c.lane = threadIdx.x & 31;
  c.lo = ((long long)out_base_row + (long long)ch * chain_rows) * kRowB;
  c.hi = c.lo + (long long)chain_rows * kRowB;
  c.n_bytes = (long long)n_rows * kRowB;
  const int n_vecs = chain_rows * (kRowB / 16);
  const int4* from = reinterpret_cast<const int4*>(arena_in + c.lo);
  for (int i = threadIdx.x; i < n_vecs; i += blockDim.x)
    stage[i] = __ldg(from + i);
  __syncthreads();
  if (threadIdx.x < 32) {
    walk<V>(c, ops + (long long)ch * cap * 3, min(max(counts[ch], 0), cap),
            n_rows);
  }
  __syncthreads();
  int4* to = reinterpret_cast<int4*>(out + c.lo);
  for (int i = threadIdx.x; i < n_vecs; i += blockDim.x) to[i] = stage[i];
}

template <int V>
int launch(const void* counts, const void* ops, int cap, int nchain,
           const void* arena_in, void* out, int n_rows, int out_base_row,
           int chain_rows, cudaStream_t stream) {
  const int smem = chain_rows * kRowB;
  cudaError_t err = cudaFuncSetAttribute(
      ablate_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ablate_kernel<V><<<nchain, kStageThreads, smem, stream>>>(
      (const int*)counts, (const int*)ops, cap,
      (const unsigned char*)arena_in, (unsigned char*)out, n_rows,
      out_base_row, chain_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// counts: [nchain] int32; ops: [nchain, cap, 3] int32; arena_in: the input
// arena, [n_rows, 128] int32; out: a copy of it, whose regions the chains
// write.  variant: 0 full, 1 onewin, 2 norealign, 3 nomask, 4 minimal.  One
// block a chain; a region of chain_rows * 512 bytes must fit a block's
// shared memory (the wrapper checks).
MINLZ_EXPORT int minlz_ablate_exec(const void* counts, const void* ops,
                                   int cap, int nchain, const void* arena_in,
                                   void* out, int n_rows, int out_base_row,
                                   int chain_rows, int variant,
                                   void* stream) {
  if (nchain <= 0 || chain_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFullV:
      return launch<kFullV>(counts, ops, cap, nchain, arena_in, out, n_rows,
                            out_base_row, chain_rows, s);
    case kOnewin:
      return launch<kOnewin>(counts, ops, cap, nchain, arena_in, out, n_rows,
                             out_base_row, chain_rows, s);
    case kNorealign:
      return launch<kNorealign>(counts, ops, cap, nchain, arena_in, out,
                                n_rows, out_base_row, chain_rows, s);
    case kNomask:
      return launch<kNomask>(counts, ops, cap, nchain, arena_in, out, n_rows,
                             out_base_row, chain_rows, s);
    case kMinimal:
      return launch<kMinimal>(counts, ops, cap, nchain, arena_in, out,
                              n_rows, out_base_row, chain_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
