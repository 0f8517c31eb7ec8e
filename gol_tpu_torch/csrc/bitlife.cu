// Packed Game of Life kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels compute one function: (packed board, n, rule) -> packed
// board after n toroidal turns. Layout as in ops/bitlife.py: word
// (r, x) holds rows 32r..32r+31 of column x, bit i = row 32r+i. The
// words are int32 in PyTorch and are read here as uint32, so every
// shift is logical.
//
// A. bitlife_resident — replaces gol_tpu/ops/pallas_bitlife.py
//    step_n_packed_pallas_raw (whole packed board resident in VMEM).
//    One thread block holds the whole board in dynamic shared memory,
//    ping-ponging two buffers, one __syncthreads() per turn; device
//    memory is read once and written once per launch. Bound on the
//    H100: integer operations (Life needs at least 12 LOP3/SHF
//    instructions per word per turn, chip_smoke.py; this run-time-rule
//    form executes more); the bytes are 8 per word per launch. What the
//    design does about it: nothing beyond keeping the board on chip — it
//    runs on ONE of
//    the 132 SMs, so it reaches at most 1/132 of the card's integer
//    rate. A cluster over distributed shared memory, or several blocks
//    with a grid barrier, is the first speed item (ROADMAP.md).
//
// B. bitlife_tiled — replaces step_n_packed_pallas_tiled_raw and
//    step_n_packed_pallas_tiled2d_raw (strip / 2-D tiles with deep
//    halos). A grid of blocks over (tile word-rows x tile columns); each
//    block loads its tile plus `halo` ghost word-rows and `ghost` ghost
//    columns per side (toroidal indices modulo the board) into shared
//    memory, runs n <= min(32*halo, ghost) turns there, and writes only
//    the interior to a second buffer (other blocks read this tile's
//    ghosts from the input). Light cone: the extended tile wraps onto
//    itself, which feeds garbage into its outermost bit-row and column;
//    the garbage advances one bit-row and one column per turn, so the
//    interior stays exact for 32*halo turns vertically and `ghost`
//    turns horizontally. Bound: integer operations, as for A; the
//    design buys one device-memory round trip per n turns for the
//    redundant ghost compute (34x320 words stepped per 32x256
//    interior, a third more, at h=1, g=32).
//
// Shared arithmetic: the column-sum CSA count and the run-time rule
// masks of swar.cuh, combined in the form the rule compiler classified
// (ops/bitlife.py _combine_masks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"

namespace {

using gol::u32;

// Combine forms, the same numbering as cuda_bitlife.COMBINE.
enum { B_SUBSET = 0, S_SUBSET = 1, GENERAL = 2 };

// Next value of word (r, c) of a rows x cols board held in `s`, with
// toroidal wrap on that board.
__device__ __forceinline__ u32 next_word(const u32* __restrict__ s, int rows,
                                         int cols, int r, int c, u32 birth,
                                         u32 survive, int combine) {
  const gol::Masks m = gol::count_masks(s, rows, cols, r, c, birth, survive);
  if (combine == B_SUBSET) return m.birth | (m.p & m.survive);
  if (combine == S_SUBSET) return m.survive | (~m.p & m.birth);
  return (m.p & m.survive) | (~m.p & m.birth);
}

// n turns of a rows x cols board resident in `cur` (ping-pong with
// `nxt`); returns the buffer that holds the result.
__device__ __forceinline__ u32* run_turns(u32* cur, u32* nxt, int rows,
                                          int cols, int n, u32 birth,
                                          u32 survive, int combine) {
  for (int t = 0; t < n; ++t) {
    gol::for_each_word(rows, cols, [&](int i, int r, int c) {
      nxt[i] = next_word(cur, rows, cols, r, c, birth, survive, combine);
    });
    __syncthreads();
    u32* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

__global__ void __launch_bounds__(1024, 1)
    bitlife_resident(const u32* __restrict__ in, u32* __restrict__ out,
                     int rows, int cols, int n, u32 birth, u32 survive,
                     int combine) {
  extern __shared__ u32 smem[];
  const int words = rows * cols;
  u32* cur = smem;
  u32* nxt = smem + words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) cur[i] = in[i];
  __syncthreads();
  cur = run_turns(cur, nxt, rows, cols, n, birth, survive, combine);
  for (int i = threadIdx.x; i < words; i += blockDim.x) out[i] = cur[i];
}

__global__ void __launch_bounds__(512, 2)
    bitlife_tiled(const u32* __restrict__ in, u32* __restrict__ out,
                  int rows, int cols, int tile_rows, int tile_cols, int halo,
                  int ghost, int n, u32 birth, u32 survive, int combine) {
  extern __shared__ u32 smem[];
  const int er = tile_rows + 2 * halo;
  const int ec = tile_cols + 2 * ghost;
  const int words = er * ec;
  u32* cur = smem;
  u32* nxt = smem + words;
  const int r0 = blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_cols;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int tr = i / ec;
    const int tc = i - tr * ec;
    const int gr = gol::wrap(r0 - halo + tr, rows);
    const int gc = gol::wrap(c0 - ghost + tc, cols);
    cur[i] = in[(size_t)gr * cols + gc];
  }
  __syncthreads();
  cur = run_turns(cur, nxt, er, ec, n, birth, survive, combine);
  const int interior = tile_rows * tile_cols;
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    const int tr = i / tile_cols;
    const int tc = i - tr * tile_cols;
    const int gr = r0 + tr;
    const int gc = c0 + tc;
    if (gr < rows && gc < cols)
      out[(size_t)gr * cols + gc] = cur[(tr + halo) * ec + tc + ghost];
  }
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = the
// launch was accepted); the Python wrapper raises on anything else.

int bitlife_resident_launch(const void* in, void* out, int rows, int cols,
                            int n, unsigned birth, unsigned survive,
                            int combine, int threads, void* stream) {
  const size_t smem = 2 * sizeof(u32) * (size_t)rows * cols;
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_resident, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  bitlife_resident<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, rows, cols, n, birth, survive, combine);
  return (int)cudaGetLastError();
}

int bitlife_tiled_launch(const void* in, void* out, int rows, int cols,
                         int tile_rows, int tile_cols, int halo, int ghost,
                         int n, unsigned birth, unsigned survive, int combine,
                         int threads, void* stream) {
  const size_t smem = 2 * sizeof(u32) * (size_t)(tile_rows + 2 * halo) *
                      (tile_cols + 2 * ghost);
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((cols + tile_cols - 1) / tile_cols,
                  (rows + tile_rows - 1) / tile_rows);
  bitlife_tiled<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, rows, cols, tile_rows, tile_cols, halo,
      ghost, n, birth, survive, combine);
  return (int)cudaGetLastError();
}

const char* bitlife_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
