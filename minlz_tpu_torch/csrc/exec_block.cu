// Whole-block executor: every 128 KiB tile of every MinLZ block at once.
//
// Replaces the TPU kernel minlz_tpu/ops/pallas_decode.py::_make_exec_kernel
// (reached through execute_ops_pallas), the v1 decoder: one walk over a
// block's records in output order, each placing llen literal bytes and then
// clen bytes from csrc back, where the source may lie anywhere earlier in
// the block.  Blocks without a range clamp (hints v1, or a range the range
// executors do not take) decode here.
//
// What bounds it here: a block of 1-8 MiB does not fit an SM's shared
// memory, and walked record by record every byte move is a dependent round
// trip to device memory (about 390 ns a record, the price of the bare chain
// in L2), on as many SMs as the batch has blocks.  Taken byte by byte the
// dependence is a pointer chain per byte; inside a tile it resolves in
// shared memory (resolve.cuh), and what crosses tiles is a walk of at most
// (tiles of the block - 1) hops per byte through finished tiles.  The
// bounds are then the tile phase's rounds and, for the fix-up, the int32 of
// scratch per output byte that is written once and read once.
//
// What the design does about it: three launches on one stream.
//   1. index_kernel: one thread per record finds the tiles its bytes touch
//      and keeps, per tile, the lowest and highest such record (warp votes,
//      then one atomic per warp and tile).  A tile's records are then a
//      window of the block's list; no search, and records of no bytes, which
//      may stand anywhere, are skipped.
//   2. tile_kernel: one thread block per tile resolves it in shared memory
//      as K3 resolves a range.  A copy byte whose source lies before the
//      tile but inside the block is not 0 here: it becomes a residual, its
//      block-local source index kept in `res` (int32 per output byte), and
//      every byte of the tile whose chain ends at a residual inherits it.
//      Final bytes go to `out`; res is -1 for them.
//   3. fixup_kernel: one thread per output byte; a residual follows its
//      chain of source indices until it lands on a final byte.  Each hop
//      lands in a strictly earlier tile, so a chain has at most (tiles of
//      the block - 1) hops: 7 for 1 MiB, 63 for 8 MiB.  It reads `out` only
//      where res says final and writes only residual bytes, so no read races
//      a write; `out` and `res` are read and written within one launch and
//      are neither const nor __restrict__ there.
// A batch of 8 x 1 MiB gives 64 tiles instead of 8 walks, one 8 MiB block 64
// instead of 1.  The tile grid is (tiles the whole output could hold,
// blocks): a thread block past its block's span returns at once, so no
// count has to come back to the host before the launch.
//
// Scratch, allocated by the caller: int32 [total_out + 2 * n_blocks *
// tiles_x], tiles_x = ceil(total_out / 128 KiB): res, then the tiles' record
// windows.
//
// Hostile input never faults: every record field is clamped into the block
// span and into comp, a copy source before the block's first byte reads 0,
// and the fix-up follows an index only while it decreases.  The plain
// version (execute_ranges_plain with the block span) applies the same
// clamps; the bytes agree whenever a block's records with any bytes move
// forward without overlapping, which compaction guarantees.

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "resolve.cuh"

namespace {

using resolve::kTile;

constexpr int kIndexThreads = 256;
constexpr int kFixThreads = 256;
constexpr int kFixChunk = 4096;  // output bytes per thread block of the fix-up
constexpr int kPhaseTiles = 1;
constexpr int kPhaseFixup = 2;

// Window rows hold record indices relative to the block's first record:
// lo[tile] the lowest, nhi[tile] minus (the highest + 1), both kept by
// atomicMin from a fill of 0x7f bytes (an empty window: lo > -nhi).
constexpr int kWindowFill = 0x7f;

__device__ __forceinline__ void window_add(int* lo, int* nhi, int tiles_x,
                                           int tile, int rel_min,
                                           int rel_max) {
  if (tile >= tiles_x) return;  // a span beyond the output: no such tile
  if (lo[tile] > rel_min) atomicMin(lo + tile, rel_min);
  if (nhi[tile] > -(rel_max + 1)) atomicMin(nhi + tile, -(rel_max + 1));
}

__global__ void index_kernel(const int* __restrict__ recs, long long n_recs,
                             const long long* __restrict__ block_first,
                             const int* __restrict__ block_span, int tiles_x,
                             int* win_lo, int* win_nhi) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int S = max(block_span[b], 0);
  const long long first = min(max(block_first[b], 0LL), n_recs);
  const long long last = min(max(block_first[b + 1], first), n_recs);
  int* lo = win_lo + (long long)b * tiles_x;
  int* nhi = win_nhi + (long long)b * tiles_x;
  const long long stride = (long long)gridDim.x * kIndexThreads;
  for (long long k0 = first + (long long)blockIdx.x * kIndexThreads
                      + (threadIdx.x & ~31);
       k0 < last; k0 += stride) {
    const long long k = k0 + lane;
    int ta = -1, tb = -1;
    const int rel = (int)min(k - first, (long long)INT_MAX - 1);
    if (k < last) {
      const int p = min(max(recs[k], 0), S);
      const int llen = min(max(recs[n_recs + k], 0), S - p);
      const int clen = min(max(recs[2 * n_recs + k], 0), S - p - llen);
      if (llen + clen > 0) {
        ta = p / kTile;
        tb = (p + llen + clen - 1) / kTile;
      }
    }
    // One atomic per warp and tile for the tile of the record's first byte
    // and for that of its last; the tiles between, if any, one by one.
    for (int pass = 0; pass < 2; ++pass) {
      const int tile = pass == 0 ? ta : (tb != ta ? tb : -1);
      const unsigned peers = __match_any_sync(resolve::kFull, tile);
      const int rel_min = __reduce_min_sync(peers, rel);
      const int rel_max = __reduce_max_sync(peers, rel);
      if (tile >= 0 && lane == __ffs(peers) - 1)
        window_add(lo, nhi, tiles_x, tile, rel_min, rel_max);
    }
    for (int tile = ta + 1; tile < tb; ++tile)
      window_add(lo, nhi, tiles_x, tile, rel, rel);
  }
}

__global__ void __launch_bounds__(resolve::kThreads, 1)
tile_kernel(const int* __restrict__ recs, long long n_recs,
            const long long* __restrict__ block_first,
            const long long* __restrict__ block_out,
            const int* __restrict__ block_span, int tiles_x,
            const int* __restrict__ win_lo, const int* __restrict__ win_nhi,
            const unsigned char* __restrict__ comp, long long n_comp,
            int stage_bytes, unsigned char* out, int* res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int S = max(block_span[b], 0);
  const long long base = (long long)blockIdx.x * kTile;
  if (base >= S) return;
  const long long first = min(max(block_first[b], 0LL), n_recs);
  const long long last = min(max(block_first[b + 1], first), n_recs);
  const long long w = (long long)b * tiles_x + blockIdx.x;
  resolve::Tile t;
  t.rec = resolve::fields_of(recs, n_recs);
  t.first = min(first + win_lo[w], last);
  t.last = min(max(first - win_nhi[w], t.first), last);
  t.span = S;
  t.base = (int)base;
  t.len = (int)min((long long)min(kTile, stage_bytes), S - base);
  t.comp = comp;
  t.n_comp = n_comp;
  t.res = res + block_out[b] + base;
  uint16_t* st = reinterpret_cast<uint16_t*>(smem);
  unsigned char* stage = smem + resolve::state_bytes(stage_bytes);
  resolve::resolve_tile<true>(t, stage, st);
  resolve::store_tile(stage, out + block_out[b] + base, t.len);
}

__global__ void fixup_kernel(const long long* __restrict__ block_out,
                             const int* __restrict__ block_span,
                             unsigned char* out, const int* res) {
  const int b = blockIdx.y;
  const int S = max(block_span[b], 0);
  const long long lo = (long long)blockIdx.x * kFixChunk;
  const int hi = (int)min(lo + kFixChunk, (long long)S);
  unsigned char* out_b = out + block_out[b];
  const int* res_b = res + block_out[b];
  for (long long o = lo + threadIdx.x; o < hi; o += kFixThreads) {
    int r = res_b[o];
    if (r < 0) continue;
    r = min(r, (int)o);
    for (;;) {
      const int next = res_b[r];
      if (next < 0 || next >= r) break;
      r = next;
    }
    out_b[o] = out_b[r];
  }
}

}  // namespace

// recs: [5, n_recs] int32 (pos, llen, clen, csrc, lit) from minlz_compact
// at whole-block lane spans; block_first: [n_blocks + 1] int64 record
// offsets; block_out: [n_blocks] int64 output offsets; block_span:
// [n_blocks] int32; comp: [n_comp] uint8; out: [total_out] uint8, the
// decoded bytes; scratch: int32 [total_out + 2 * n_blocks * ceil(total_out
// / 131072)].  phases: 1 runs the index and tile launches, 2 the fix-up
// (which needs the scratch a tile phase left), 3 all three.
MINLZ_EXPORT int minlz_exec_blocks(const void* recs, long long n_recs,
                                   const void* block_first,
                                   const void* block_out,
                                   const void* block_span, int n_blocks,
                                   const void* comp, long long n_comp,
                                   void* out, long long total_out,
                                   void* scratch, int phases, void* stream) {
  if (n_blocks <= 0 || total_out <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (int)((total_out + kTile - 1) / kTile);
  int* res = (int*)scratch;
  int* win_lo = res + total_out;
  int* win_nhi = win_lo + (long long)n_blocks * tiles_x;
  if (phases & kPhaseTiles) {
    cudaError_t err = cudaMemsetAsync(
        win_lo, kWindowFill, 2 * sizeof(int) * (size_t)n_blocks * tiles_x, s);
    if (err != cudaSuccess) return (int)err;
    const long long per_grid = (n_recs + kIndexThreads - 1) / kIndexThreads;
    const dim3 igrid((unsigned)std::max(1LL, std::min(per_grid, 1024LL)),
                     n_blocks);
    index_kernel<<<igrid, kIndexThreads, 0, s>>>(
        (const int*)recs, n_recs, (const long long*)block_first,
        (const int*)block_span, tiles_x, win_lo, win_nhi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int stage_bytes = (int)std::min((long long)kTile, total_out);
    const int smem = resolve::shared_bytes(stage_bytes);
    err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    tile_kernel<<<dim3(tiles_x, n_blocks), resolve::kThreads, smem, s>>>(
        (const int*)recs, n_recs, (const long long*)block_first,
        (const long long*)block_out, (const int*)block_span, tiles_x, win_lo,
        win_nhi, (const unsigned char*)comp, n_comp, stage_bytes,
        (unsigned char*)out, res);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & kPhaseFixup) {
    const unsigned chunks = (unsigned)((total_out + kFixChunk - 1) / kFixChunk);
    fixup_kernel<<<dim3(chunks, n_blocks), kFixThreads, 0, s>>>(
        (const long long*)block_out, (const int*)block_span,
        (unsigned char*)out, (const int*)res);
  }
  return (int)cudaGetLastError();
}
