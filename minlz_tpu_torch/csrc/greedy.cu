// Greedy token selection of the encoder, one warp per segment lane.
//
// Replaces the TPU kernel minlz_tpu/ops/pallas_encode.py::_greedy_kernel
// (reached through greedy_parse_pallas), which walks all lanes in lockstep
// over every position and carries (skip, rep) across a sequential grid.
//
// What it computes, per lane, from the match proposals off[r], len[r]:
// with skip = 0 and rep = -1, at each position r in order,
//   take   = skip == 0 && len[r] >= 4
//   is_rep = take && off[r] == rep
//   skip   = take ? len[r] - 1 : max(skip - 1, 0)
//   rep    = take ? off[r] : rep
// and tok_off / tok_len = off / len where take, else 0.  After a token is
// taken at r the next one can start no earlier than r + len[r], and every
// position in between has all four outputs 0.
//
// What bounds it here: the serial walk.  The function moves 8 bytes in and
// 16 bytes out per position, which at the card's memory rate is far less
// time than a chain of up to `seg` dependent steps per lane, so the kernel
// is bound by the latency of that chain (a ballot, a find-first-set and two
// shuffles per token), not by bytes or arithmetic.
//
// What the design does about it: a warp owns a lane and keeps (cur, rep) in
// registers, the same value in all 32 threads.  It loads the 32 positions
// around `cur` with one coalesced read per array, ballots len >= 4, and
// steps from token to token inside the chunk with find-first-set: one step
// per token, not per position.  A token that reaches past the chunk moves
// `cur` there directly, and the chunks it covers are never read.  The
// outputs arrive zeroed from the wrapper, so only the token positions are
// written.
//
// off and len are proposals and may hold any int32: cur is kept in 64 bits
// so r + len cannot wrap, a warp reads and writes only its own lane's `seg`
// positions, and a length below 4 (negative ones included) is never taken.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void greedy_kernel(const int* __restrict__ off,
                              const int* __restrict__ len, int lanes, int seg,
                              int* __restrict__ take, int* __restrict__ tok_off,
                              int* __restrict__ tok_len,
                              int* __restrict__ is_rep) {
  const int t = threadIdx.x & 31;
  const long long lane =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= lanes) return;  // the whole warp leaves together
  const long long row = lane * seg;
  long long cur = 0;  // first position that may start the next token
  int rep = -1;
  while (cur < seg) {
    const int base = (int)cur & ~31;
    const int p = base + t;
    int l = 0, o = 0;
    if (p < seg) {
      l = len[row + p];
      o = off[row + p];
    }
    const unsigned cand = __ballot_sync(kFull, l >= 4);
    const long long end = (long long)base + 32;
    while (cur < end) {
      const unsigned m = cand & (kFull << (unsigned)(cur - base));
      if (m == 0) {
        cur = end;
        break;
      }
      const int j = __ffs(m) - 1;
      const int lj = __shfl_sync(kFull, l, j);
      const int oj = __shfl_sync(kFull, o, j);
      if (t == j) {
        take[row + p] = 1;
        tok_off[row + p] = oj;
        tok_len[row + p] = lj;
        is_rep[row + p] = oj == rep ? 1 : 0;
      }
      rep = oj;
      cur = (long long)base + j + lj;
    }
  }
}

}  // namespace

// off, len: [lanes, seg] int32, lane-major.  take, tok_off, tok_len,
// is_rep: [lanes, seg] int32, zeroed by the caller.
MINLZ_EXPORT int minlz_greedy(const void* off, const void* len, int lanes,
                              int seg, void* take, void* tok_off,
                              void* tok_len, void* is_rep, void* stream) {
  if (lanes > 0 && seg > 0) {
    const int blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
    greedy_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        (const int*)off, (const int*)len, lanes, seg, (int*)take,
        (int*)tok_off, (int*)tok_len, (int*)is_rep);
  }
  return (int)cudaGetLastError();
}
