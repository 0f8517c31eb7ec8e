// The persistent grid of kernel A (bitlife.cu, bitlife_resident_grid):
// one board spread over the card as a 2-D grid of small tiles, one
// block a tile and at most one block an SM, all resident together (a
// cooperative launch). Block (x, y) owns word-rows [y * tile_rows,
// (y + 1) * tile_rows) and columns [x * tile_cols, (x + 1) * tile_cols)
// of the board (the last tile of a row or column may be ragged), and
// holds them in shared memory with one ghost word-row and kGridGhost
// ghost columns a side, toroidal indices modulo the board: kernel B's
// light cone, so the interior stays exact for kRoundTurns turns.
//
// The turns run in rounds of kRoundTurns. A round loads the extended
// tile from the round's source board (the input in round 1), steps it
// in shared memory on its own torus (two copies, one barrier a turn),
// stores the interior to the round's destination board, and then the
// blocks meet at a barrier before the next round reads what their
// neighbours stored. The two boards a launch ping-pongs between are its
// output and a scratch board, ordered so that the last round writes the
// output; the 32-KB board of the main path stays in L2, so a round's
// edges cost a round trip, not bandwidth. Loads between rounds go
// through L2 (ld.global.cg), never the SM's L1, which is not coherent
// with the other SMs' stores.
//
// The barrier is the grid's own (cooperative_groups::this_grid().sync()),
// which also orders every block's stores before the next round's loads.
// Per-tile generation counters, each block waiting for its neighbours
// alone, were timed against it on the H100 and lost every shape by 1-14%
// (PERF.md §6), so they are not in the tree.
//
// The B3/S23 body steps a strip of W = 1, 2 or 4 adjacent words of one
// row of the extended tile a thread a turn, where the tile has at most
// kGridThreads words: each of the three rows around the strip is one
// shared-memory load of the strip (32, 64 or 128 bits) and one of each
// edge word, each of the W + 2 columns' vertical sum is formed once
// (swar.cuh col_sum), each word finished from the three sums around it
// (strip.cuh life_of_sums), and the strip stored in one access: 12 + 8/W
// LOP3/SHF a word. bitlife.cu runs every other rule, and larger tiles,
// on its run-time masks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "strip.cuh"
#include "swar.cuh"
#include "walk.cuh"

namespace gol {

// Ghost columns a side of a grid tile: one round's light cone.
constexpr int kGridGhost = kRoundTurns;

// Most threads of a grid block, and the words of an extended tile the
// one-word-a-thread body steps at most (its copy stride in shared
// memory).
constexpr int kGridThreads = 1024;

// The grid plan as a kernel argument: the tile, its extended form
// (er x ec words, `words` in all) and the tiles a row and a column of
// the board.
struct Grid {
  int tile_rows, tile_cols, er, ec, words, tiles_x, tiles_y;
};

inline Grid make_grid(int rows, int cols, int tile_rows, int tile_cols) {
  Grid g;
  g.tile_rows = tile_rows;
  g.tile_cols = tile_cols;
  g.er = tile_rows + 2;
  g.ec = tile_cols + 2 * kGridGhost;
  g.words = g.er * g.ec;
  g.tiles_x = (cols + tile_cols - 1) / tile_cols;
  g.tiles_y = (rows + tile_rows - 1) / tile_rows;
  return g;
}

// Rounds of n turns: at least one, so that 0 turns is a copy.
__host__ __device__ __forceinline__ int grid_rounds(int n) {
  return n > 0 ? (n + kRoundTurns - 1) / kRoundTurns : 1;
}

// Loads this block's extended tile of `src` into `tile`, through L2.
__device__ __forceinline__ void grid_load(const u32* src, u32* tile,
                                          int rows, int cols,
                                          const Grid g) {
  const int r0 = (int)blockIdx.y * g.tile_rows - 1;
  const int c0 = (int)blockIdx.x * g.tile_cols - kGridGhost;
  for (int i = threadIdx.x; i < g.words; i += blockDim.x) {
    const int tr = i / g.ec;
    const int tc = i - tr * g.ec;
    tile[i] = __ldcg(src + (size_t)wrap(r0 + tr, rows) * cols +
                     wrap(c0 + tc, cols));
  }
}

// Writes the interior of this block's extended tile `tile` to `dst`
// (the part of a ragged tile inside the board).
__device__ __forceinline__ void grid_store(const u32* tile, u32* dst,
                                           int rows, int cols,
                                           const Grid g) {
  const int r0 = (int)blockIdx.y * g.tile_rows;
  const int c0 = (int)blockIdx.x * g.tile_cols;
  const int interior = g.tile_rows * g.tile_cols;
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    const int tr = i / g.tile_cols;
    const int tc = i - tr * g.tile_cols;
    if (r0 + tr < rows && c0 + tc < cols)
      dst[(size_t)(r0 + tr) * cols + c0 + tc] =
          tile[(tr + 1) * g.ec + tc + kGridGhost];
  }
}

// Where this thread's strip of W words of the extended tile lies, fixed
// for the launch: its word in a copy (-1 for a thread past the tile),
// the board word its load starts at (toroidal), and the board word its
// store starts at (-1 where the strip is not interior, or lies past a
// ragged tile's edge). With the board's and the tile's widths whole
// strips, a strip never crosses the board's wrap or edge.
struct GridStrip {
  int tile, load, store;
};

template <int W>
__device__ __forceinline__ GridStrip grid_strip(int rows, int cols,
                                                const Grid g) {
  GridStrip at = {-1, 0, -1};
  const int i = threadIdx.x * W;
  if (i >= g.words) return at;
  const int tr = i / g.ec;
  const int tc = i - tr * g.ec;
  const int r = (int)blockIdx.y * g.tile_rows + tr - 1;
  const int c = (int)blockIdx.x * g.tile_cols + tc - kGridGhost;
  at.tile = i;
  at.load = wrap(r, rows) * cols + wrap(c, cols);
  if (tr >= 1 && tr <= g.tile_rows && tc >= kGridGhost &&
      tc < kGridGhost + g.tile_cols && r < rows && c < cols)
    at.store = r * cols + c;
  return at;
}

// W words as one access (16, 8 or 4 bytes).
template <int W>
struct Words;
template <>
struct Words<4> {
  using T = uint4;
};
template <>
struct Words<2> {
  using T = uint2;
};
template <>
struct Words<1> {
  using T = u32;
};

// The strip's load from `src` (through L2) into copy 0.
template <int W>
__device__ __forceinline__ void grid_load_strip(const u32* src,
                                                const GridStrip at) {
  using T = typename Words<W>::T;
  if (at.tile >= 0)
    *reinterpret_cast<T*>(smem + at.tile) =
        __ldcg(reinterpret_cast<const T*>(src + at.load));
}

// The strip's store from the copy at `tile` to `dst`, where interior.
template <int W>
__device__ __forceinline__ void grid_store_strip(const u32* tile, u32* dst,
                                                 const GridStrip at) {
  using T = typename Words<W>::T;
  if (at.store >= 0)
    *reinterpret_cast<T*>(dst + at.store) =
        *reinterpret_cast<const T*>(tile + at.tile);
}

// One row of a strip of W words at offset `at` of a copy, with its edge
// words at `west` and `east`: x[0] west, x[1..W] the strip, x[W+1] east.
template <int W>
__device__ __forceinline__ void grid_row(const u32* s, int at, int west,
                                         int east, u32 (&x)[W + 2]) {
  x[0] = s[west];
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(s + at);  // LDS.128
    x[1] = v.x;
    x[2] = v.y;
    x[3] = v.z;
    x[4] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(s + at);  // LDS.64
    x[1] = v.x;
    x[2] = v.y;
  } else {
    x[1] = s[at];
  }
  x[W + 1] = s[east];
}

// t turns of B3/S23 on the extended tile in copy 0 (copy 1 at
// kGridThreads words), thread i stepping the strip of words [W i, W i +
// W) of one row (g.ec % W == 0, g.words <= W blockDim) from the three
// rows around it, wrapped on the extended tile; the offsets are fixed
// for the launch, so a turn is three rows' loads, the count, one store
// and the barrier. Returns the offset of the copy that holds turn t (0
// when t is 0).
template <int W>
__device__ __forceinline__ int grid_life_turns(const Grid g, int t) {
  const int i = threadIdx.x * W;
  const bool live = i < g.words;
  const int r = live ? i / g.ec : 0;
  const int c = live ? i - r * g.ec : 0;
  const int rn = ((r == 0 ? g.er : r) - 1) * g.ec;
  const int rm = r * g.ec;
  const int rs = (r + 1 == g.er ? 0 : r + 1) * g.ec;
  const int cw = (c == 0 ? g.ec : c) - 1;
  const int ce = c + W == g.ec ? 0 : c + W;
  auto turn = [&](int from, int to) {
    if (live) {
      const u32* s = smem + from;
      u32 n[W + 2], m[W + 2], so[W + 2];
      grid_row<W>(s, rn + c, rn + cw, rn + ce, n);
      grid_row<W>(s, rm + c, rm + cw, rm + ce, m);
      grid_row<W>(s, rs + c, rs + cw, rs + ce, so);
      ColSum sum[W + 2];
#pragma unroll
      for (int j = 0; j < W + 2; ++j) sum[j] = col_sum(n[j], m[j], so[j]);
      u32 o[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        o[j] = life_of_sums(sum[j], sum[j + 1], sum[j + 2], m[j + 1]);
      u32* d = smem + to + rm + c;
      if constexpr (W == 4) {
        *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
      } else if constexpr (W == 2) {
        *reinterpret_cast<uint2*>(d) = make_uint2(o[0], o[1]);
      } else {
        d[0] = o[0];
      }
    }
    __syncthreads();
  };
  int k = 0;
  for (; k + 2 <= t; k += 2) {
    turn(0, kGridThreads);
    turn(kGridThreads, 0);
  }
  if (k < t) {
    turn(0, kGridThreads);
    return kGridThreads;
  }
  return 0;
}

// Launches `kernel` on the plan's tiles_x x tiles_y grid of `threads`
// threads cooperatively (all blocks resident together, or the launch is
// refused) on `stream`; returns the launch's error code, or else
// cudaGetLastError() (0 = the launch was accepted).
template <typename... Params, typename... Args>
inline int launch_grid(void (*kernel)(Params...), const Grid g, int threads,
                       size_t smem_bytes, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.tiles_x, g.tiles_y, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace gol
