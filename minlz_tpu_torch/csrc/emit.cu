// Token emission of the encoder: verified parse arrays -> the MinLZ bytes of
// every segment, one thread block a segment row, the row built in shared
// memory and written once.
//
// Replaces no TPU kernel: minlz_tpu/ops/emit.py::emit_segments is written in
// jnp (prefix sums, monotone fills and scatters over [N] and [N, 7] arrays),
// and ops/emit.py::emit_segments_plain is its torch counterpart, about a
// hundred ops whose intermediates each go through device memory.
//
// What it computes, per segment row of seg positions, from surv, off and
// vlen (a surviving take, its offset and its verified length) and the
// row's valid length seg_n: with cov(q) the running maximum of q' + vlen[q']
// over the takes q' <= q (0 at the other positions), each take q gets the
// literal run [lit_start, q), lit_start = cov(q - 1) (0 at q = 0), and one
// token chosen as encode_kernel.serialize_segment chooses it: a repeat when
// off equals the previous take's, else fused literals (copy2 with 1-4
// literals, copy3 with 1-3, off >= 64), else a literal header, the literals
// and copy1/2/3.  A token's bytes are prefix, literals, suffix; an
// exclusive sum of their counts places them; the literals after the last
// cover end, up to seg_n, are flushed at the end.  The row is seg + 64
// bytes, zeros after its length, and its length goes to out_lens.  The
// copy3 word is built in 32 bits unsigned: its bytes are those of the int32
// word that wraps (offsets near 2^21), as in the torch and jnp versions.
//
// What bounds it here.  It must read the block bytes and three int32
// arrays (13 bytes a position) and write seg + 64 bytes a row: about 235 MB
// for the 16 x 1 MiB encode batch, 0.07 ms at the card's memory rate.  The
// torch version moves some hundred times that through device memory.
//
// What the design does about it.  One block of kThreads threads a row:
//
// 1. stage: the row's valid bytes into shared memory with 16-byte loads,
//    and the output row zeroed there;
// 2. tiles of kTile positions, thread t owning positions 4t .. 4t + 3 (a
//    16-byte load of each input array), with three carries across tiles:
//    the cover end, the previous take's offset and the output cursor;
//    a block max-scan gives each thread the cover end and the last take
//    before it, a block sum of the token byte counts the output cursor;
// 3. each thread writes its takes' prefix and suffix bytes; the literal
//    runs are copied by a warp a run, shared memory to shared memory;
// 4. the trailing flush, then the row goes to device memory in 16-byte
//    stores, zeros included, so the caller allocates without a fill.
//
// Nothing but the output leaves the block, and a row of any seg walks the
// same tiles: only the shared memory grows with seg (2 seg + 64 bytes).  A
// write that would land past the row's seg + 64 bytes is dropped, as the
// jnp version's scatter drops it.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                 // positions a thread a tile
constexpr int kTile = kPer * kThreads;  // positions a tile
constexpr int kOutPad = 64;             // ops/emit.py: OUT_PAD
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticLimit = 48 * 1024;

struct Args {
  const unsigned char* data;  // [rows, seg]
  const int* surv;            // [rows, seg]
  const int* off;
  const int* vlen;
  const int* n;               // [B] valid bytes a block
  unsigned char* out;         // [rows, seg + kOutPad]
  int* out_lens;              // [rows]
  int nseg;
  int seg;
};

// Up to 7 token bytes, byte k in bits 8k .. 8k + 7, and their count.
struct Tok {
  unsigned long long b;
  int n;
};

__device__ __forceinline__ unsigned long long byte_at(int v, int k) {
  return (unsigned long long)((unsigned)v & 255u) << (8 * k);
}

// Literal-run header (ops/emit.py::_lit_hdr): none for nl <= 0.
__device__ __forceinline__ Tok lit_hdr(int nl) {
  const int b0 = nl < 30 ? shl(nl - 1, 3) : (nl < 286 ? 29 << 3 : 30 << 3);
  const int b1 = wsub(nl, 30);
  const int b2 = b1 >> 8;
  Tok t;
  t.b = byte_at(b0, 0) | byte_at(b1, 1) | byte_at(b2, 2);
  t.n = nl > 0 ? (nl < 30 ? 1 : (nl < 286 ? 2 : 3)) : 0;
  return t;
}

// Repeat token of length l (_rep_tok).
__device__ __forceinline__ Tok rep_tok(int l) {
  const int v = wsub(l, 1), v2 = wsub(l, 30);
  const int b0 = v < 29 ? (shl(v, 3) | 4)
                        : (v2 < 256 ? (29 << 3 | 4) : (30 << 3 | 4));
  Tok t;
  t.b = byte_at(b0, 0) | byte_at(v2, 1) | byte_at(v2 >> 8, 2);
  t.n = v < 29 ? 1 : (v2 < 256 ? 2 : 3);
  return t;
}

// Copy3 token with nl fused literals (_copy3_tok).
__device__ __forceinline__ Tok copy3_tok(int off, int l, int nl) {
  const int o = wsub(off, 65536), l3 = wsub(l, 4);
  const int code = l3 <= 60 ? l3 : (wsub(l3, 60) < 256 ? 61 : 62);
  const unsigned w = 7u | (unsigned)nl << 3 | (unsigned)code << 5 |
                     (unsigned)o << 11;
  const int ext = wsub(l3, 60);
  Tok t;
  t.b = (unsigned long long)w;
  if (code >= 61) t.b |= byte_at(ext, 4);
  if (code >= 62) t.b |= byte_at(ext >> 8, 5);
  t.n = 4 + (code >= 61) + (code >= 62);
  return t;
}

// Copy token without fused literals (_copy_tok): off >= 1, l >= 4.
__device__ __forceinline__ Tok copy_tok(int off, int l) {
  Tok t;
  if (off <= 1024) {
    const int o1 = shl(off - 1, 6);
    if (l <= 18) {
      const int x = o1 | shl(l - 4, 2) | 1;
      t.b = byte_at(x, 0) | byte_at(x >> 8, 1);
      t.n = 2;
    } else if (l <= 273) {
      const int x = o1 | 15 << 2 | 1;
      t.b = byte_at(x, 0) | byte_at(x >> 8, 1) | byte_at(l - 18, 2);
      t.n = 3;
    } else {
      const int x = o1 | 14 << 2 | 1;
      const Tok r = rep_tok(max(wsub(l, 18), 1));
      t.b = byte_at(x, 0) | byte_at(x >> 8, 1) | r.b << 16;
      t.n = 2 + r.n;
    }
    return t;
  }
  if (off <= 65599) {
    const int o2 = off - 64, l2 = wsub(l, 4);
    const unsigned long long ob = byte_at(o2, 1) | byte_at(o2 >> 8, 2);
    if (l2 <= 60) {
      t.b = byte_at(shl(l2, 2) | 2, 0) | ob;
      t.n = 3;
    } else if (l2 - 60 < 256) {
      t.b = byte_at(61 << 2 | 2, 0) | ob | byte_at(l2 - 60, 3);
      t.n = 4;
    } else {
      t.b = byte_at(62 << 2 | 2, 0) | ob | byte_at(l2 - 60, 3) |
            byte_at((l2 - 60) >> 8, 4);
      t.n = 5;
    }
    return t;
  }
  return copy3_tok(off, l, 0);
}

// The token of a take, as prefix (before its nl literals) and suffix
// (after them): emit_segments_plain's selection, decision for decision.
__device__ __forceinline__ void token(int off, int ln, int nl, bool is_rep,
                                      Tok& pre, Tok& suf) {
  const bool can_fuse = nl >= 1 && off >= 64 && !is_rep &&
                        (nl <= 3 || (off <= 65599 && nl <= 4));
  const int l4 = max(ln, 4);
  suf.b = 0;
  suf.n = 0;
  if (can_fuse && off <= 65599) {
    const int o2 = off - 64, l2 = l4 - 4;
    pre.b = byte_at(3 | shl(nl - 1, 3) | min(l2, 7) << 5, 0) |
            byte_at(o2, 1) | byte_at(o2 >> 8, 2);
    pre.n = 3;
    if (l2 > 7) suf = rep_tok(max(wsub(ln, 11), 1));
  } else if (can_fuse) {
    pre = copy3_tok(off, l4, nl);
  } else {
    pre = lit_hdr(nl);
    suf = is_rep ? rep_tok(max(ln, 1)) : copy_tok(max(off, 1), l4);
  }
}

__device__ __forceinline__ void put(unsigned char* out_s, int width, int at,
                                    const Tok& t) {
  for (int k = 0; k < t.n; ++k) {
    const int d = wadd(at, k);
    if ((unsigned)d < (unsigned)width)
      out_s[d] = (unsigned char)(t.b >> (8 * k));
  }
}

// Literal run: the cnt bytes from position `from` to output byte `to`,
// thread `first` of `step` taking every step-th byte.  Only positions in
// [0, seg_n) are literals, and only bytes in [0, width) are kept.
__device__ __forceinline__ void copy_run(unsigned char* out_s, int width,
                                         const unsigned char* data_s,
                                         int seg_n, int from, int cnt, int to,
                                         int first, int step) {
  const long long lo = max(0LL, -(long long)from);
  const long long hi = min((long long)cnt, (long long)seg_n - from);
  for (long long j = lo + first; j < hi; j += step) {
    const int d = wadd(to, (int)j);
    if ((unsigned)d < (unsigned)width) out_s[d] = data_s[from + j];
  }
}

// The four positions p .. p + 3 of a row: one 16-byte load when the row
// allows it, else scalar loads of the positions before seg (0 after it).
__device__ __forceinline__ int4 load4(const int* __restrict__ row, int p,
                                      int seg, bool vec) {
  if (vec && p + 4 <= seg)
    return __ldg(reinterpret_cast<const int4*>(row + p));
  int v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (p + i < seg) v[i] = __ldg(row + p + i);
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int elem(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

__host__ __device__ __forceinline__ int shared_bytes(int seg) {
  return round16(seg) + round16(seg + kOutPad);
}

__global__ void __launch_bounds__(kThreads) emit_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cov_w[kWarps], last_w[kWarps], sum_w[kWarps];
  __shared__ int last_off[kThreads];

  const int seg = a.seg, width = seg + kOutPad;
  unsigned char* data_s = smem;
  unsigned char* out_s = smem + round16(seg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int blk = (int)(row / a.nseg), s = (int)(row % a.nseg);
  const long long left = (long long)a.n[blk] - (long long)s * seg;
  const int seg_n = (int)max(0LL, min(left, (long long)seg));
  const long long base = row * seg;
  const unsigned char* data = a.data + base;
  const int* surv = a.surv + base;
  const int* off = a.off + base;
  const int* vlen = a.vlen + base;
  const bool vec =
      seg % 4 == 0 &&
      ((reinterpret_cast<unsigned long long>(surv) |
        reinterpret_cast<unsigned long long>(off) |
        reinterpret_cast<unsigned long long>(vlen)) & 15) == 0;

  // 1. stage the valid bytes; zero the output row.
  if (seg % 16 == 0 && (reinterpret_cast<unsigned long long>(data) & 15) == 0)
    for (int i = tid; i < round16(seg_n) / 16; i += kThreads)
      reinterpret_cast<uint4*>(data_s)[i] =
          __ldg(reinterpret_cast<const uint4*>(data) + i);
  else
    for (int i = tid; i < seg_n; i += kThreads) data_s[i] = data[i];
  for (int i = tid; i < round16(width) / 16; i += kThreads)
    reinterpret_cast<uint4*>(out_s)[i] = make_uint4(0, 0, 0, 0);

  // Carries across tiles: the cover end at the tile's last position (below
  // any value before the row's first), the last take's offset (-1: none)
  // and the output cursor.
  int cov_c = INT_MIN, rep_c = -1, cur_c = 0;
  for (int t0 = 0; t0 < seg; t0 += kTile) {
    const int p0 = t0 + kPer * tid;
    const int4 sv = load4(surv, p0, seg, vec);
    const int4 ov = load4(off, p0, seg, vec);
    const int4 lv = load4(vlen, p0, seg, vec);
    bool tk[kPer];
    int of[kPer], ln[kPer];
    int mcov = INT_MIN, mlast = -1, loff = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      tk[i] = p0 + i < seg && elem(sv, i) > 0;
      of[i] = elem(ov, i);
      ln[i] = elem(lv, i);
      if (p0 + i < seg) mcov = max(mcov, tk[i] ? wadd(p0 + i, ln[i]) : 0);
      if (tk[i]) {
        mlast = tid;
        loff = of[i];
      }
    }
    last_off[tid] = loff;

    // 2a. block max-scans: the cover end and the last take before each
    // thread, and over the whole tile.
    int ic = mcov, il = mlast;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int yc = __shfl_up_sync(kFull, ic, o);
      const int yl = __shfl_up_sync(kFull, il, o);
      if (lane >= o) {
        ic = max(ic, yc);
        il = max(il, yl);
      }
    }
    if (lane == 31) {
      cov_w[warp] = ic;
      last_w[warp] = il;
    }
    __syncthreads();
    int xc = __shfl_up_sync(kFull, ic, 1), xl = __shfl_up_sync(kFull, il, 1);
    if (lane == 0) {
      xc = INT_MIN;
      xl = -1;
    }
    int tc = INT_MIN, tl = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int wc = cov_w[w], wl = last_w[w];
      if (w < warp) {
        xc = max(xc, wc);
        xl = max(xl, wl);
      }
      tc = max(tc, wc);
      tl = max(tl, wl);
    }
    int cov_run = max(cov_c, xc);
    int rep_run = xl >= 0 ? last_off[xl] : rep_c;
    const int cov_next = max(cov_c, tc);
    const int rep_next = tl >= 0 ? last_off[tl] : rep_c;

    // 2b. each take's literal run and token.
    int lit[kPer], nl[kPer], tot = 0;
    Tok pre[kPer], suf[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = p0 + i;
      const int prev = cov_run;
      if (q < seg) cov_run = max(cov_run, tk[i] ? wadd(q, ln[i]) : 0);
      lit[i] = 0;
      nl[i] = 0;
      pre[i].b = suf[i].b = 0;
      pre[i].n = suf[i].n = 0;
      if (tk[i]) {
        lit[i] = q == 0 ? 0 : prev;
        nl[i] = wsub(q, lit[i]);
        token(of[i], ln[i], nl[i], of[i] == rep_run, pre[i], suf[i]);
        rep_run = of[i];
        tot = wadd(tot, wadd(pre[i].n + suf[i].n, nl[i]));
      }
    }

    // 2c. block sum of the byte counts: each thread's output cursor.
    int is = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, is, o);
      if (lane >= o) is = wadd(is, y);
    }
    if (lane == 31) sum_w[warp] = is;
    __syncthreads();
    int cur = wadd(cur_c, wsub(is, tot)), ts = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int ws = sum_w[w];
      if (w < warp) cur = wadd(cur, ws);
      ts = wadd(ts, ws);
    }

    // 3. token bytes by their thread, literal runs by a warp a run.
    int dst[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      dst[i] = 0;
      if (tk[i]) {
        put(out_s, width, cur, pre[i]);
        dst[i] = wadd(cur, pre[i].n);
        put(out_s, width, wadd(dst[i], nl[i]), suf[i]);
        cur = wadd(wadd(dst[i], nl[i]), suf[i].n);
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      unsigned m = __ballot_sync(kFull, tk[i] && nl[i] > 0);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int from = __shfl_sync(kFull, lit[i], src);
        const int cnt = __shfl_sync(kFull, nl[i], src);
        const int to = __shfl_sync(kFull, dst[i], src);
        copy_run(out_s, width, data_s, seg_n, from, cnt, to, lane, 32);
      }
    }
    cov_c = cov_next;
    rep_c = rep_next;
    cur_c = wadd(cur_c, ts);
  }

  // 4. the trailing literal flush, then the row.
  const int trail = max(wsub(seg_n, cov_c), 0);
  const Tok fl = lit_hdr(trail);
  if (tid == 0) put(out_s, width, cur_c, fl);
  const int fbase = wadd(cur_c, fl.n);
  copy_run(out_s, width, data_s, seg_n, cov_c, trail, fbase, tid, kThreads);
  __syncthreads();
  if (tid == 0) a.out_lens[row] = wadd(fbase, trail);
  unsigned char* out = a.out + row * width;
  if (width % 16 == 0 && (reinterpret_cast<unsigned long long>(out) & 15) == 0)
    for (int i = tid; i < width / 16; i += kThreads)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<uint4*>(out_s)[i];
  else
    for (int i = tid; i < width; i += kThreads) out[i] = out_s[i];
}

}  // namespace

// data: [rows, seg] uint8; surv, off, vlen: [rows, seg] int32; n: [rows /
// nseg] int32 valid bytes a block; out: [rows, seg + 64] uint8 and
// out_lens: [rows] int32 (any contents: every element is written).
MINLZ_EXPORT int minlz_emit(const void* data, const void* surv,
                            const void* off, const void* vlen, const void* n,
                            int rows, int nseg, int seg, void* out,
                            void* out_lens, void* stream) {
  if (rows > 0 && nseg > 0 && seg > 0) {
    const int smem = shared_bytes(seg);
    if (smem > kStaticLimit) {
      const cudaError_t err = cudaFuncSetAttribute(
          emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    const Args args = {(const unsigned char*)data, (const int*)surv,
                       (const int*)off,            (const int*)vlen,
                       (const int*)n,              (unsigned char*)out,
                       (int*)out_lens,             nseg,
                       seg};
    emit_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}

// What the card made of the kernel at this seg: registers a thread, shared
// memory a block (static and dynamic), threads a block, and blocks
// resident on one SM.
MINLZ_EXPORT int minlz_emit_attrs(int seg, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, emit_kernel);
  if (err != cudaSuccess) return (int)err;
  const int smem = shared_bytes(seg);
  if (smem > kStaticLimit) {
    err = cudaFuncSetAttribute(
        emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, emit_kernel,
                                                      kThreads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + smem;
  out[2] = kThreads;
  out[3] = resident;
  return (int)err;
}
