// Column walkers over a tile in dynamic shared memory, shared by the
// B3/S23 form of kernel A (bitlife.cu), the B2/S/C3 form of kernel C
// (bitgens.cu) and kernel E (life.cu, whose words are 4 horizontal byte
// cells, so its window's rows are single rows; kernel B's B3/S23 form
// and kernel D's B2/S/C3 form walk strips instead, strip.cuh); the
// tile's load and store a word at a time, which kernels B and D keep for
// their masks forms and for shapes strip.cuh's bulk form does not take
// (a width of no whole 16 bytes, say); and the thread-block cluster that
// runs kernels A and C (the end of this file).
//
// A block holds an extended tile (its interior plus ghost word-rows and
// ghost columns, toroidal indices modulo the board) in two copies, `cur`
// and `nxt`, addressed as 32-bit word offsets from `smem`. Within a
// turn, a work item is one column c of the extended tile and a segment
// of consecutive word-rows of it (ops/cuda_bitlife._walk_plan sets the
// segment length and the block size). The walker keeps a 3x3 window of
// words of `cur` in registers — rows r-1, r, r+1 of columns c-1, c, c+1
// — and walks down the segment; each step loads only row r+1 of the
// three columns (3 shared-memory loads) and hands the window and the
// word's offset in `nxt` to the rule's step, which writes that word.
// Lanes of a warp take consecutive columns, so each load of a warp reads
// 32 consecutive words of one row (no bank conflicts). The column wrap
// is resolved once per work item, the row wrap in the segment's prologue
// and by one compare-and-select per step; the turn loop divides nothing.
// The window rotates through three register triples, three steps a
// round, without moves. Only the thread that owns a word of `nxt` reads
// or writes it, so one barrier per turn is all the synchronisation.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"

namespace gol {

// The dynamic shared memory of the walking kernels.
extern __shared__ u32 smem[];

// Threads per block of the walkers, two blocks per SM: at the main
// path's 34 x 320-word tile, 640 threads of at most 48 registers
// (ops/cuda_bitlife._walk_plan plans within it; the launchers refuse
// more).
constexpr int kWalkThreads = 640;

// The walk plan, as kernel arguments (constant memory, so that none of
// it holds a register): the extended tile (er x ec words), the segment
// length, and the step from one of a thread's work items to its next
// (dcol columns and drow word-rows, before the column wraps).
struct Walk {
  int er, ec, words, seg_rows, dcol, drow;
};

// The plan of a tile with `halo` ghost word-rows and `ghost` ghost
// columns per side, walked by `threads` threads in `seg_rows` segments.
inline Walk make_walk(int tile_rows, int tile_cols, int halo, int ghost,
                      int threads, int seg_rows) {
  Walk k;
  k.er = tile_rows + 2 * halo;
  k.ec = tile_cols + 2 * ghost;
  k.words = k.er * k.ec;
  k.seg_rows = seg_rows;
  k.dcol = threads % k.ec;
  k.drow = threads / k.ec * seg_rows;
  return k;
}

// One turn of one work item: column c, word-rows r0..r1-1 of the
// extended tile at word `cur`; next(n, m, s, out) writes the word at
// offset `out` of the copy at word `nxt` from the window (rows north,
// mid, south; [0..2]: columns west, centre, east).
template <typename Next>
__device__ __forceinline__ void walk(const Walk k, int cur, int nxt, int c,
                                     int r0, int r1, Next next) {
  const int er = k.er, ec = k.ec, words = k.words;
  const int w = cur + (c == 0 ? ec : c) - 1;
  const int x = cur + c;
  const int e = cur + ((c + 1 == ec) ? 0 : c + 1);
  // Prologue: rows r0-1 (wrapped) and r0.
  const int rn = ((r0 == 0 ? er : r0) - 1) * ec;
  int south = r0 * ec;  // offset of the row the next step loads, less ec
  u32 a[3] = {smem[w + rn], smem[x + rn], smem[e + rn]};
  u32 b[3] = {smem[w + south], smem[x + south], smem[e + south]};
  u32 d[3];
  int out = nxt + south + c;
  int left = r1 - r0;
  // One step: load row r+1 into ss, write word r, move down a row.
  auto step = [&](const u32(&nn)[3], const u32(&mm)[3], u32(&ss)[3]) {
    south += ec;
    if (south == words) south = 0;
    ss[0] = smem[w + south];
    ss[1] = smem[x + south];
    ss[2] = smem[e + south];
    next(nn, mm, ss, out);
    out += ec;
  };
  for (;;) {
    step(a, b, d);
    if (--left == 0) break;
    step(b, d, a);
    if (--left == 0) break;
    step(d, a, b);
    if (--left == 0) break;
  }
}

// n turns of the extended tile loaded into the copy at word 0, the
// other copy at word k.words, by the block's walkers (one barrier before
// the first turn and after each). Returns the offset of the copy that
// turn n wrote (0 when n is 0).
template <typename Next>
__device__ __forceinline__ int walk_turns(const Walk k, int n, Next next) {
  const int ec = k.ec;
  int cur = 0, nxt = k.words;
  // Work items (column c, segment from word-row r), item i = (r /
  // seg_rows) * ec + c, strided by the block size: this thread's first
  // one here, the step to the next in `k`, so that the turn loop
  // divides nothing. The items run out where a segment would start
  // past the last row.
  const int seg0 = threadIdx.x / ec;
  const int col0 = threadIdx.x - seg0 * ec;
  const int row0 = seg0 * k.seg_rows;
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    for (int c = col0, r = row0; r < k.er;) {
      walk(k, cur, nxt, c, r, min(r + k.seg_rows, k.er), next);
      c += k.dcol;
      r += k.drow;
      if (c >= ec) {
        c -= ec;
        r += k.seg_rows;
      }
    }
    __syncthreads();
    const int tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// The identity, the default word transform of load_tile and
// store_interior.
struct Same {
  __device__ __forceinline__ u32 operator()(u32 x) const { return x; }
};

// Loads this block's extended tile (ec columns, `words` words) into
// `tile`, with toroidal indices modulo the board, each word through
// `f`. The grid's first row of tiles starts at board row `row0`.
template <typename F = Same>
__device__ __forceinline__ void load_tile(const u32* __restrict__ in,
                                          u32* tile, int rows, int cols,
                                          int tile_rows, int tile_cols,
                                          int halo, int ghost, int ec,
                                          int words, int row0 = 0,
                                          F f = F()) {
  const int r0 = row0 + blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_cols;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int tr = i / ec;
    const int tc = i - tr * ec;
    const int gr = wrap(r0 - halo + tr, rows);
    const int gc = wrap(c0 - ghost + tc, cols);
    tile[i] = f(in[(size_t)gr * cols + gc]);
  }
}

// Writes the interior of this block's extended tile `tile` (ec columns)
// to its place on the board, each word through `f`; `row0` as in
// load_tile.
template <typename F = Same>
__device__ __forceinline__ void store_interior(const u32* tile,
                                               u32* __restrict__ out,
                                               int rows, int cols,
                                               int tile_rows, int tile_cols,
                                               int halo, int ghost, int ec,
                                               int row0 = 0, F f = F()) {
  const int r0 = row0 + blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_cols;
  const int interior = tile_rows * tile_cols;
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    const int tr = i / tile_cols;
    const int tc = i - tr * tile_cols;
    const int gr = r0 + tr;
    const int gc = c0 + tc;
    if (gr < rows && gc < cols)
      out[(size_t)gr * cols + gc] = f(tile[(tr + halo) * ec + tc + ghost]);
  }
}

// --- The resident cluster of kernels A and C ---
//
// A cluster of `blocks` thread blocks (at most 8, the portable cluster
// size) holds the whole board: block b = blockIdx.y, its cluster rank,
// holds word-rows [b * slab_rows, (b + 1) * slab_rows) — every column —
// plus `halo` ghost word-rows a side, loaded by load_tile with
// tile_cols = cols and no ghost columns, so each slab wraps its columns
// exactly. Its own wrap of rows feeds garbage into the ghost rows, one
// bit-row a turn, so the interior stays exact for kRoundTurns * halo
// turns. The cluster runs the turns in rounds of that many and, between
// two rounds, refreshes every block's ghost rows from its neighbours'
// edge interior rows through distributed shared memory. With one block
// (halo 0) the slab is the board, its wrap the torus, and all n turns
// are one round with no cluster barrier.

// Turns bought per halo word-row (one bit-row of light cone per turn).
constexpr int kRoundTurns = 32;

// The most blocks of a cluster every sm_90 card schedules.
constexpr int kClusterBlocks = 8;

// Whether a cluster plan (ops/cuda_bitlife._cluster_plan) is one the
// kernels run: at most kClusterBlocks slabs of equal height covering
// the board, one ghost word-row a side exactly when there are several.
inline bool cluster_plan_ok(int rows, int blocks, int slab_rows, int halo) {
  return blocks >= 1 && blocks <= kClusterBlocks && slab_rows >= 1 &&
         blocks * slab_rows == rows && halo == (blocks > 1 ? 1 : 0);
}

// Between two rounds: every block's `halo` ghost word-rows of each of
// the `copies` tile copies (copy q at word q * k.words) from the same
// copy of its neighbours' edge interior rows — the top ones from the
// last interior rows of rank b-1, the bottom ones from the first of
// rank b+1 (ranks modulo the cluster). All blocks hold the same copy
// layout, so the exchange copies slot to slot. The first cluster
// barrier makes every block's round visible; the second keeps a block
// from writing any copy (its next round, or its exit) while a
// neighbour may still read it.
__device__ __forceinline__ void exchange_halo(const Walk k, int slab_rows,
                                              int halo, int copies) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned b = cluster.block_rank(), nb = cluster.num_blocks();
  const u32* north = cluster.map_shared_rank(smem, (b + nb - 1) % nb);
  const u32* south = cluster.map_shared_rank(smem, (b + 1) % nb);
  const int side = halo * k.ec;           // words of one side's ghost rows
  const int last = slab_rows * k.ec;      // a slab's last interior rows
  const int below = last + side;          // this slab's bottom ghost rows
  cluster.sync();
  for (int i = threadIdx.x; i < copies * 2 * side; i += blockDim.x) {
    const int q = i / (2 * side);
    const int j = i - q * 2 * side;
    const int at = q * k.words;
    if (j < side)
      smem[at + j] = north[at + last + j];
    else
      smem[at + below + j - side] = south[at + j];
  }
  cluster.sync();
}

// n turns of the resident cluster: round(t) steps this block's tile t
// turns from copy 0 and returns the word offset of the copy that holds
// the result; every round but the last is kRoundTurns * halo turns, an
// even count, so it ends in copy 0 again. Returns the last round's
// offset.
template <typename Round>
__device__ __forceinline__ int cluster_turns(const Walk k, int n,
                                             int slab_rows, int halo,
                                             int copies, Round round) {
  const int per = halo ? kRoundTurns * halo : n;
  for (int done = 0;;) {
    const int t = min(per, n - done);
    const int cur = round(t);
    done += t;
    if (done == n) return cur;
    exchange_halo(k, slab_rows, halo, copies);
  }
}

// The most boards of one batched launch: CUDA's limit on gridDim.z.
constexpr int kMaxGridZ = 65535;

// Launches `kernel` on a grid of (1, blocks, batch) blocks, each
// (1, blocks, 1) column of them one cluster, on `stream`; returns the
// launch's error code, or else cudaGetLastError() (0 = the launch was
// accepted).
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), int blocks,
                          int threads, size_t smem_bytes, void* stream,
                          int batch, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, blocks, batch);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = blocks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace gol
