// The core of the two positioned executors (exec_range.cu's K3 and
// exec_block.cu's tile phase): decode one tile of output, up to 128 KiB, in
// shared memory, without walking its records one after the other.
//
// Why it is exact.  After compaction each output byte is written by at most
// one record, and every copy byte d + i reads d - csrc + (csrc < clen ?
// i % csrc : i), which lies strictly before it.  So a byte is either
// terminal (a literal byte of comp, a byte no record writes = 0, a copy from
// before the range or block = 0) or it points to one earlier byte, and its
// value is the value at the end of its pointer chain.  A chain can be as
// deep as the tile is long (a run of csrc = 1, clen = 1 records), so the
// chains are resolved by doubling, ptr = ptr[ptr]: at most 15 rounds for a
// 32 KiB sub-tile.
//
// Shared-memory budget.  The tile's final bytes are staged (`stage`, up to
// kTile = 131,072 bytes) and leave for device memory in 16-byte stores.  One
// 32-bit pointer per byte would take 512 KiB, so the tile is resolved
// sub-tile by sub-tile in output order, kSub = 32,768 bytes each: a pointer
// that leaves the sub-tile backwards lands on a byte that is already final in
// the stage and is replaced by that byte's value while the records are
// expanded; a pointer that stays inside needs 15 bits.  One 16-bit state
// word per byte of the sub-tile carries either kFinal | value or the
// in-sub-tile source index: 131,072 (stage) + 65,536 (state) = 196,608
// bytes of the 232,448 a thread block can have.  A smaller sub-tile would
// only add passes over the records; a larger one does not fit beside the
// stage with 16-bit words.
//
// Expand.  One pass over the tile's records first finds, per sub-tile, the
// window of records that put a byte into it (by overlap, not by order, so
// records of no bytes may stand anywhere).  Then, sub-tile by sub-tile, a
// warp takes 32 consecutive records of the window with coalesced loads, one
// per lane, the next 32 already in flight, with the executors' clamps (p,
// llen, clen into the span, csrc >= 1, the literal index into comp).  A
// record that puts at most kShort bytes into the sub-tile is expanded by its
// own lane; one of up to kLong bytes is handed round by ballot and shuffle
// and expanded by its warp; a longer one (a 4 KiB literal run, an RLE copy)
// is queued and expanded by the whole block, so that no single warp's loop
// sets the tile's time.  A record that straddles a sub-tile boundary is
// expanded on both sides, each byte's source computed from the record's own
// d.
//
// Resolve.  Rounds of state[q] = state[state[q]] over the bytes that are not
// final, in place, until a block-wide vote (__syncthreads_or) finds none
// left.  In place is exact: whatever a thread reads at state[p] is either
// p's final word or a pointer to an ancestor of p, hence of q, with the same
// final value; a state word is one aligned 16-bit access, so flag and value
// travel together and no reader sees a torn pair; every pointer points
// strictly backwards, so every round shortens every open chain.
//
// Block mode (kBlock, exec_block.cu).  The tile is a slice of a MinLZ block
// and a copy may reach before the tile.  Such a byte is a residual: its
// block-local source index goes to `res` (int32 per output byte, device
// memory), and its state word points to itself, which the rounds treat as
// terminal.  A byte whose chain ends at a residual inherits that residual's
// source index.  `res` is -1 for a final byte.  A later pass follows the
// residuals through the finished tiles (exec_block.cu).
//
// Hostile input never faults: every record field is clamped as above, every
// pointer points strictly backwards inside the sub-tile, so the rounds end
// whatever the records are.  Records that overlap each other (which
// compaction never leaves) give unspecified bytes, in bounds.
#pragma once

#include <climits>

#include "common.cuh"

namespace resolve {

constexpr int kThreads = 1024;
constexpr int kTile = 128 << 10;   // most bytes a tile stages
constexpr int kSub = 32 << 10;     // bytes resolved at once
constexpr int kSubs = kTile / kSub;
constexpr int kShort = 16;         // longest piece a single lane expands
constexpr int kLong = 512;         // longest piece a single warp expands
constexpr int kQueue = kSub / kLong + 2;
constexpr unsigned kFinal = 0x8000u;
constexpr unsigned kFull = 0xffffffffu;

// A record list's five int32 fields, each its own row.
struct Fields {
  const int* pos;
  const int* llen;
  const int* clen;
  const int* csrc;
  const int* lit;
};

// The rows of a [5, n] record array (pos, llen, clen, csrc, lit).
__host__ __device__ inline Fields fields_of(const int* recs, long long n) {
  return Fields{recs, recs + n, recs + 2 * n, recs + 3 * n, recs + 4 * n};
}

struct Tile {
  Fields rec;
  long long first;     // the records that may touch the tile: [first, last)
  long long last;
  int span;            // the range's or block's span: records are clamped to it
  int base;            // position of the tile's first byte in that span
  int len;             // bytes of the tile, <= kTile
  const unsigned char* comp;
  long long n_comp;
  int* res;            // kBlock: residual row of the tile's first byte
};

// Shared memory a tile of at most `len` bytes needs: state words, then the
// stage.
__host__ __device__ inline int state_bytes(long long len) {
  const long long n = len < kSub ? (len + 15) / 16 * 16 : kSub;
  return (int)(n * 2);
}
__host__ __device__ inline int shared_bytes(long long len) {
  return state_bytes(len) + (int)((len + 15) / 16 * 16);
}

// The state word of output byte q (a position in the span) of a record.
template <bool kBlock>
__device__ __forceinline__ void place(const Tile& t, int t0,
                                      unsigned char* stage, uint16_t* st,
                                      int q, int p, int llen, int clen,
                                      int csrc, int lit) {
  const int o = q - t.base;  // tile-local
  unsigned w;
  if (q - p < llen) {
    const long long g = min(max((long long)lit + (q - p), 0LL), t.n_comp - 1);
    w = kFinal | (t.n_comp > 0 ? t.comp[g] : 0);
  } else {
    const int d = p + llen;
    const int j = q - d;
    const long long s = (long long)d - csrc + (csrc < clen ? j % csrc : j);
    const long long sl = s - t.base;
    if (s < 0) {
      w = kFinal;
    } else if (sl >= t0) {
      w = (unsigned)(sl - t0);
    } else if (!kBlock) {
      w = kFinal | stage[sl];
    } else {
      // Before the tile: a residual.  In an earlier sub-tile of the tile:
      // that byte's residual if it has one, else its value.
      const int r = sl < 0 ? (int)s : t.res[sl];
      if (r >= 0) {
        t.res[o] = r;
        w = (unsigned)(o - t0);
      } else {
        w = kFinal | stage[sl];
      }
    }
  }
  st[o - t0] = (uint16_t)w;
}

// The executors' clamps on record k; returns its bytes' span [p, end).
struct Rec {
  int p, llen, clen, csrc, lit;
};

__device__ __forceinline__ Rec clamp_rec(const Tile& t, int pos, int llen,
                                         int clen, int csrc, int lit) {
  Rec r;
  r.p = min(max(pos, 0), t.span);
  r.llen = min(max(llen, 0), t.span - r.p);
  r.clen = min(max(clen, 0), t.span - r.p - r.llen);
  r.csrc = max(csrc, 1);
  r.lit = lit;
  return r;
}

// Which records touch which sub-tile: win[2 * s] the lowest, win[2 * s + 1]
// one past the highest record (relative to t.first) with a byte in sub-tile
// s.  One pass over the tile's records, kAhead chunks of 32 loaded before
// any is used, so the loads' latency overlaps; a warp votes before it
// touches shared memory.  Records of no bytes, which may stand anywhere,
// are in no window's way.
__device__ __forceinline__ void windows(const Tile& t, int* win) {
  constexpr int kAhead = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kSubs) {
    win[2 * threadIdx.x] = INT_MAX;
    win[2 * threadIdx.x + 1] = 0;
  }
  __syncthreads();
  const int* pos_f = t.rec.pos;
  const int* llen_f = t.rec.llen;
  const int* clen_f = t.rec.clen;
  for (long long k0 = t.first + warp * 32; k0 < t.last;
       k0 += kThreads * kAhead) {
    int pos[kAhead], llen[kAhead], clen[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long k = k0 + u * kThreads + lane;
      const bool in = k < t.last;
      pos[u] = in ? __ldg(pos_f + k) : 0;
      llen[u] = in ? __ldg(llen_f + k) : 0;
      clen[u] = in ? __ldg(clen_f + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long kb = k0 + u * kThreads;
      if (kb >= t.last) break;
      const Rec r = clamp_rec(t, pos[u], llen[u], clen[u], 1, 0);
      const int a = max(r.p, t.base) - t.base;
      const int b = min(r.p + r.llen + r.clen, t.base + t.len) - t.base;
      const int rel = (int)(kb + lane - t.first);
      const int sa = a < b ? a / kSub : kSubs;
      const int sb = a < b ? (b - 1) / kSub : -1;
#pragma unroll
      for (int sub = 0; sub < kSubs; ++sub) {
        const bool in = sa <= sub && sub <= sb;
        const int lo = __reduce_min_sync(kFull, in ? rel : INT_MAX);
        const int hi = __reduce_max_sync(kFull, in ? rel + 1 : 0);
        if (lane == 0 && hi > 0) {
          atomicMin(win + 2 * sub, lo);
          atomicMax(win + 2 * sub + 1, hi);
        }
      }
    }
  }
  __syncthreads();
}

// State words of the sub-tile [t0, t0 + n) of the tile from the records
// [first, last).  A piece of at most kShort bytes is expanded by its lane,
// one of at most kLong by its warp, a longer one by the whole block (queue:
// at most kQueue such pieces fit a sub-tile when records do not overlap;
// what does not fit the queue is left to the warp).  Ends with a barrier.
template <bool kBlock>
__device__ __forceinline__ void expand(const Tile& t, int t0, int n,
                                       long long first, long long last,
                                       unsigned char* stage, uint16_t* st,
                                       int* queue, int* n_queue) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lo = t.base + t0;
  const int hi = lo + n;
  const int* pos_f = t.rec.pos;
  const int* llen_f = t.rec.llen;
  const int* clen_f = t.rec.clen;
  const int* csrc_f = t.rec.csrc;
  const int* lit_f = t.rec.lit;
  if (threadIdx.x == 0) *n_queue = 0;
  __syncthreads();
  // The next chunk's fields are loaded before this chunk is expanded.
  int f[5] = {0, 0, 0, 1, 0};
  long long k = first + warp * 32 + lane;
  if (k < last) {
    f[0] = __ldg(pos_f + k);
    f[1] = __ldg(llen_f + k);
    f[2] = __ldg(clen_f + k);
    f[3] = __ldg(csrc_f + k);
    f[4] = __ldg(lit_f + k);
  }
  for (long long k0 = first + warp * 32; k0 < last; k0 += kThreads) {
    const Rec r = clamp_rec(t, f[0], f[1], f[2], f[3], f[4]);
    const bool live = k < last;
    const long long rel = k - t.first;
    k += kThreads;
    if (k < last) {
      f[0] = __ldg(pos_f + k);
      f[1] = __ldg(llen_f + k);
      f[2] = __ldg(clen_f + k);
      f[3] = __ldg(csrc_f + k);
      f[4] = __ldg(lit_f + k);
    }
    const int a = max(r.p, lo);
    const int b = live ? min(r.p + r.llen + r.clen, hi) : a;
    int cnt = b - a;
    if (cnt > kLong) {
      const int slot = atomicAdd(n_queue, 1);
      if (slot < kQueue) {
        queue[slot] = (int)rel;
        cnt = 0;
      }
    }
    if (cnt > 0 && cnt <= kShort) {
      for (int q = a; q < b; ++q)
        place<kBlock>(t, t0, stage, st, q, r.p, r.llen, r.clen, r.csrc,
                      r.lit);
    }
    unsigned longs = __ballot_sync(kFull, cnt > kShort);
    while (longs) {
      const int src = __ffs(longs) - 1;
      longs &= longs - 1;
      const int wp = __shfl_sync(kFull, r.p, src);
      const int wl = __shfl_sync(kFull, r.llen, src);
      const int wc = __shfl_sync(kFull, r.clen, src);
      const int ws = __shfl_sync(kFull, r.csrc, src);
      const int wi = __shfl_sync(kFull, r.lit, src);
      const int wa = __shfl_sync(kFull, a, src);
      const int wb = __shfl_sync(kFull, b, src);
      for (int q = wa + lane; q < wb; q += 32)
        place<kBlock>(t, t0, stage, st, q, wp, wl, wc, ws, wi);
    }
  }
  __syncthreads();
  const int queued = min(*n_queue, kQueue);
  for (int e = 0; e < queued; ++e) {
    const long long kq = t.first + queue[e];
    const Rec r = clamp_rec(t, __ldg(pos_f + kq), __ldg(llen_f + kq),
                            __ldg(clen_f + kq), __ldg(csrc_f + kq),
                            __ldg(lit_f + kq));
    const int a = max(r.p, lo);
    const int b = min(r.p + r.llen + r.clen, hi);
    for (int q = a + threadIdx.x; q < b; q += kThreads)
      place<kBlock>(t, t0, stage, st, q, r.p, r.llen, r.clen, r.csrc, r.lit);
  }
  __syncthreads();
}

// Doubling rounds over the n state words of a sub-tile, in place.  Ends
// with a barrier.  A word that points to itself is terminal (a residual).
// A thread gathers for its eight words before it stores any of them, so
// the gathers do not wait for one another.
__device__ __forceinline__ void rounds(uint16_t* st, int n) {
  bool open;
  do {
    open = false;
    for (int g = threadIdx.x * 8; g < n; g += kThreads * 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(st + g);
      const unsigned all = v.x & v.y & v.z & v.w;
      if ((all & 0x80008000u) == 0x80008000u) continue;
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
      unsigned w[8], w2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        w[e] = (words[e >> 1] >> ((e & 1) * 16)) & 0xffffu;
        if (g + e >= n) w[e] = kFinal;
        w2[e] = (w[e] & kFinal) ? w[e] : st[w[e]];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (w2[e] == w[e]) continue;  // final, or at a residual: settled
        st[g + e] = (uint16_t)w2[e];
        open |= !(w2[e] & kFinal);
      }
    }
  } while (__syncthreads_or(open));
}

// Decode the tile: afterwards stage[0 .. t.len) holds its bytes (0 where a
// byte is a residual) and, kBlock, t.res[0 .. t.len) says which are.  All
// threads of the block call it; it ends with a barrier.
template <bool kBlock>
__device__ __forceinline__ void resolve_tile(const Tile& t,
                                             unsigned char* stage,
                                             uint16_t* st) {
  __shared__ int win[2 * kSubs];
  __shared__ int queue[kQueue];
  __shared__ int n_queue;
  const int tid = threadIdx.x;
  windows(t, win);
  for (int t0 = 0; t0 < t.len; t0 += kSub) {
    const int n = min(kSub, t.len - t0);
    // Bytes no record writes are final zeros; so are the pad words the
    // rounds read in their last group of eight.
    const uint4 zeros = make_uint4(kFinal * 0x10001u, kFinal * 0x10001u,
                                   kFinal * 0x10001u, kFinal * 0x10001u);
    for (int i = tid; i < (n + 7) / 8; i += kThreads)
      reinterpret_cast<uint4*>(st)[i] = zeros;
    const long long last = t.first + win[2 * (t0 / kSub) + 1];
    const long long first = min(t.first + win[2 * (t0 / kSub)], last);
    expand<kBlock>(t, t0, n, first, last, stage, st, queue, &n_queue);
    rounds(st, n);
    for (int i = tid; i < n; i += kThreads) {
      const unsigned w = st[i];
      if (w & kFinal) {
        stage[t0 + i] = (unsigned char)w;
        if (kBlock) t.res[t0 + i] = -1;
      } else {
        // Only kBlock leaves such words: the byte's chain ends at the
        // residual w, whose source index it takes.
        stage[t0 + i] = 0;
        if (kBlock && w != (unsigned)i) t.res[t0 + i] = t.res[t0 + w];
      }
    }
    __syncthreads();
  }
}

// The staged tile to device memory, 16 bytes a store where dst allows it.
__device__ __forceinline__ void store_tile(const unsigned char* stage,
                                           unsigned char* dst, int len) {
  const int tid = threadIdx.x;
  if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(stage);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < len / 16; i += kThreads) d4[i] = s4[i];
    for (int i = len / 16 * 16 + tid; i < len; i += kThreads)
      dst[i] = stage[i];
  } else {
    for (int i = tid; i < len; i += kThreads) dst[i] = stage[i];
  }
}

}  // namespace resolve
