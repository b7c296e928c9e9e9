// The MinLZ token at a byte offset, decoded at once from the bytes there.
//
// Shared by K1 (parse.cu), which decodes every offset of a window to find
// a lane's tokens and then each token's records, and by the derivation
// (derive.cu), which decodes every offset of a window to find where a
// block's tokens start.  ops/parse_model.py::decode states it in torch.
#pragma once

#include "common.cuh"

namespace minlz_token {

constexpr int kHalo = 16;  // bytes past a token start that decoding may read

// The token that starts at s[0] (s[0 .. kHalo) staged, 0 past the lane
// end), at lane offset i of a lane of n bytes.
struct Tok {
  bool lit, imm, pend, rep, sets, complete, done;
  int litcnt, L, e, clen, off, pa;
  unsigned w;      // output bytes the token adds to dpos
  long long nxt;   // lane offset of the next token
};

__device__ __forceinline__ Tok decode(const unsigned char* s, int i, int n) {
  const int b0 = s[0];
  const int tag = b0 & 3, val = b0 >> 2;
  const bool c3 = (val & 1) != 0;
  const int code0 = val >> 1;
  const int c3_code = (val >> 3) | ((s[1] & 7) << 3);
  int off_bytes, code, lext;
  if (tag == 0) {
    off_bytes = 0, code = code0, lext = max(code0 - 28, 0);
  } else if (tag == 1) {
    off_bytes = 1, code = val & 15, lext = code == 15;
  } else if (tag == 2) {
    off_bytes = 2, code = val, lext = max(val - 60, 0);
  } else if (c3) {
    off_bytes = 3, code = c3_code, lext = max(c3_code - 60, 0);
  } else {
    off_bytes = 2, code = (val >> 3) & 7, lext = 0;
  }
  const int h = 1 + off_bytes + lext;
  int acc_off = 0, acc_len = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < off_bytes) acc_off |= s[1 + k] << (8 * k);
    if (k < lext) acc_len |= s[1 + off_bytes + k] << (8 * k);
  }
  Tok t;
  t.litcnt = tag == 3 ? ((val >> 1) & 3) + (c3 ? 0 : 1) : 0;
  const int lit_len = code < 29 ? code + 1 : acc_len + 30;
  const int len_c1 = code < 15 ? code + 4 : acc_len + 18;
  const int len_c23 = code < 61 ? code + 4 : acc_len + 64;
  t.rep = tag == 0 && c3;
  t.lit = tag == 0 && !c3;
  t.pend = tag == 3 && (!c3 || t.litcnt > 0);
  t.imm = !t.lit && !t.pend;
  t.sets = tag != 0;
  t.clen = tag == 0 ? lit_len
                    : (tag == 1 ? len_c1 : (tag == 3 && !c3 ? code + 4
                                                            : len_c23));
  t.off = tag == 1 ? ((acc_off << 2) | (val >> 4)) + 1
                   : (tag == 3 && c3 ? (acc_off >> 3) + 65536 : acc_off + 64);
  t.L = t.lit ? lit_len : (t.pend ? t.litcnt : 0);
  const long long e = (long long)i + h;
  t.e = (int)e;
  t.nxt = e + t.L;
  t.w = (unsigned)(t.lit ? lit_len : (t.imm ? t.clen : t.litcnt + t.clen));
  t.complete = e <= n;
  t.done = e + t.litcnt <= n;
  unsigned pa = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < t.L) pa |= (unsigned)s[h + k] << (8 * k);
  t.pa = (int)pa;
  return t;
}

// The window's bytes [g0, g0 + nbytes) of comp into stage[shift ..), zeros
// around them, by a block of kThreads threads into kStage bytes; 16-byte
// loads where a chunk lies wholly inside.
template <int kStage, int kThreads>
__device__ __forceinline__ void stage_window(
    const unsigned char* __restrict__ comp, long long n_comp, long long g0,
    int nbytes, unsigned char* stage, int* shift_out) {
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(comp + g0);
  const int shift = (int)(addr & 15);
  const long long lo = g0, hi = min(g0 + nbytes, n_comp);
  for (int c = threadIdx.x; c < kStage / 16; c += kThreads) {
    const long long ga = g0 - shift + 16LL * c;  // comp index of the chunk
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ga >= lo && ga + 16 <= hi) {
      v = __ldg(reinterpret_cast<const uint4*>(comp + ga));
    } else if (ga + 16 > lo && ga < hi) {
      unsigned wd[4] = {0, 0, 0, 0};
      for (int k = 0; k < 16; ++k) {
        const long long g = ga + k;
        if (g >= lo && g < hi)
          wd[k >> 2] |= (unsigned)comp[g] << (8 * (k & 3));
      }
      v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    reinterpret_cast<uint4*>(stage)[c] = v;
  }
  *shift_out = shift;
}

}  // namespace minlz_token
