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
// One WARP per chain, all chains in one thread block: a record moves about
// ten bytes, fewer than a warp has lanes, so a whole block per chain would
// add barrier cost and no width, and __syncwarp() orders a chain's moves at
// a few cycles each.  The chains of one block share one SM, as the TPU's
// lockstep chains share one core, so the chain count is the number of walks
// whose latencies overlap.
//
// What bounds it: the serial chain of moves of one chain (a copy may read
// what the move before it wrote), that is latency in device memory (the
// arena of a megabyte sits in L2), not bytes.  What the design does about
// it: the records are fetched ahead, 32 at a time with coalesced loads, two
// batches in flight, and handed out by shuffle, so the chain holds only the
// byte moves.
//
// A read takes the chain's own region from the arena being written and every
// other byte from the input arena: a chain never sees another chain's
// stores, in whatever order the warps run.  A read outside the arena gives
// 0 and a store outside the chain's region is dropped; the wrapper refuses
// input whose chains outgrow their regions.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowB = 512;

enum Variant { kFullV = 0, kOnewin = 1, kNorealign = 2, kNomask = 3,
               kMinimal = 4 };

struct Chain {
  const unsigned char* in;  // the input arena
  unsigned char* out;       // the arena being written
  long long lo, hi;         // the chain's region, byte addresses
  long long n_bytes;        // arena size
  int lane;
};

__device__ __forceinline__ unsigned char rd(const Chain& c, long long s) {
  if (s < 0 || s >= c.n_bytes) return 0;
  return (s >= c.lo && s < c.hi) ? c.out[s] : c.in[s];
}

__device__ __forceinline__ void wr(const Chain& c, long long d,
                                   unsigned char v) {
  if (d >= c.lo && d < c.hi) c.out[d] = v;
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
    const unsigned char* from = (src >= c.lo && src < c.hi) ? c.out : c.in;
    const int4 row = reinterpret_cast<const int4*>(from + src)[c.lane];
    __syncwarp();
    if (dst >= c.lo && dst < c.hi)
      reinterpret_cast<int4*>(c.out + dst)[c.lane] = row;
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

template <int V>
__global__ void ablate_kernel(const int* __restrict__ counts,
                              const int* __restrict__ ops, int cap,
                              const unsigned char* __restrict__ arena_in,
                              unsigned char* out, int n_rows,
                              int out_base_row, int chain_rows) {
  const int ch = threadIdx.x >> 5;
  Chain c;
  c.in = arena_in;
  c.out = out;
  c.lane = threadIdx.x & 31;
  c.lo = ((long long)out_base_row + (long long)ch * chain_rows) * kRowB;
  c.hi = c.lo + (long long)chain_rows * kRowB;
  c.n_bytes = (long long)n_rows * kRowB;
  const long long last_row = c.hi / kRowB - 1;
  const int count = min(max(counts[ch], 0), cap);
  Records recs;
  recs.init(ops + (long long)ch * cap * 3, count, c.lane);
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

template <int V>
void launch(const void* counts, const void* ops, int cap, int nchain,
            const void* arena_in, void* out, int n_rows, int out_base_row,
            int chain_rows, cudaStream_t stream) {
  ablate_kernel<V><<<1, 32 * nchain, 0, stream>>>(
      (const int*)counts, (const int*)ops, cap,
      (const unsigned char*)arena_in, (unsigned char*)out, n_rows,
      out_base_row, chain_rows);
}

}  // namespace

// counts: [nchain] int32; ops: [nchain, cap, 3] int32; arena_in: the input
// arena, [n_rows, 128] int32; out: a copy of it, which the chains write.
// variant: 0 full, 1 onewin, 2 norealign, 3 nomask, 4 minimal.  nchain <= 32.
MINLZ_EXPORT int minlz_ablate_exec(const void* counts, const void* ops,
                                   int cap, int nchain, const void* arena_in,
                                   void* out, int n_rows, int out_base_row,
                                   int chain_rows, int variant,
                                   void* stream) {
  if (nchain <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFullV:
      launch<kFullV>(counts, ops, cap, nchain, arena_in, out, n_rows,
                     out_base_row, chain_rows, s);
      break;
    case kOnewin:
      launch<kOnewin>(counts, ops, cap, nchain, arena_in, out, n_rows,
                      out_base_row, chain_rows, s);
      break;
    case kNorealign:
      launch<kNorealign>(counts, ops, cap, nchain, arena_in, out, n_rows,
                         out_base_row, chain_rows, s);
      break;
    case kNomask:
      launch<kNomask>(counts, ops, cap, nchain, arena_in, out, n_rows,
                      out_base_row, chain_rows, s);
      break;
    case kMinimal:
      launch<kMinimal>(counts, ops, cap, nchain, arena_in, out, n_rows,
                       out_base_row, chain_rows, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
