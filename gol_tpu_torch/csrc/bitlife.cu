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
//    turns horizontally.
//    Within a turn, column walkers (walk.cuh, shared with kernel D): a
//    work item is one column of the extended tile and a segment of its
//    word-rows; the walker keeps a 3x3 window of words in registers and
//    walks down the segment, loading only the row below each step, so a
//    word costs 3 shared-memory loads and 1 store, not 9 and 1; the
//    turn loop divides nothing. This is the B3/S23 instantiation,
//    summing all nine cells in the LOP3/SHF form (swar.cuh life_next).
//    Every other rule runs kernel A's per-word run-time masks on the
//    same tile (512 threads): the masks fed from the walkers' window
//    were slower than that body, not faster.
//    Bound on the H100: integer operations, 12 LOP3/SHF per word-turn
//    (chip_smoke.life_fewest_instructions); the bytes are 8 per word per
//    launch. Spent per word by the walkers: 3 LDS, 1 STS, and 20
//    LOP3/SHF (the form with each column's sum formed three times, once
//    by each walker that reads it) plus the walk's index steps, on the
//    extended tile's words (34x320 per 32x256 interior, a third more, at
//    h=1, g=32). Still left: column sums shared across lanes (shuffles)
//    and the ghost overhead.
//
// Shared arithmetic: the column-sum CSA count and the run-time rule
// masks of swar.cuh, combined in the form the rule compiler classified
// (ops/bitlife.py _combine_masks); kernel B's B3/S23 form, also there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"
#include "walk.cuh"

namespace {

using gol::load_tile;
using gol::store_interior;
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

// Kernel B's rule forms: B3/S23 by column walkers summing nine cells,
// or any rule by kernel A's per-word run-time masks.
enum { FORM_LIFE = 0, FORM_MASKS = 1 };

// Threads per block of kernel B, two blocks per SM: the walkers take up
// to gol::kWalkThreads (walk.cuh), the masks form kMaskThreads.
constexpr int kMaskThreads = 512;
template <int kForm>
constexpr int kTiledThreads =
    kForm == FORM_LIFE ? gol::kWalkThreads : kMaskThreads;

template <int kForm>
__global__ void __launch_bounds__(kTiledThreads<kForm>, 2)
    bitlife_tiled(const u32* __restrict__ in, u32* __restrict__ out,
                  int rows, int cols, int tile_rows, int tile_cols, int halo,
                  int ghost, int n, u32 birth, u32 survive, int combine,
                  const gol::Walk k) {
  if constexpr (kForm == FORM_LIFE) {
    using gol::smem;
    load_tile(in, smem, rows, cols, tile_rows, tile_cols, halo, ghost, k.ec,
              k.words);
    const int cur = gol::walk_turns(
        k, n, [](const u32(&nn)[3], const u32(&mm)[3], const u32(&ss)[3],
                 int at) { smem[at] = gol::life_next(nn, mm, ss); });
    store_interior(smem + cur, out, rows, cols, tile_rows, tile_cols, halo,
                   ghost, k.ec);
  } else {
    extern __shared__ u32 smem[];
    const int er = tile_rows + 2 * halo;
    const int ec = tile_cols + 2 * ghost;
    u32* cur = smem;
    load_tile(in, cur, rows, cols, tile_rows, tile_cols, halo, ghost, ec,
              er * ec);
    __syncthreads();
    cur = run_turns(cur, smem + er * ec, er, ec, n, birth, survive, combine);
    store_interior(cur, out, rows, cols, tile_rows, tile_cols, halo, ghost,
                   ec);
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

// Kernel B picks its instantiation from the rule: B3/S23 (birth {3},
// survive {2, 3}) runs the walkers on `threads` (at most
// gol::kWalkThreads) and `seg_rows`, every other rule the masks on
// kMaskThreads.
int bitlife_tiled_launch(const void* in, void* out, int rows, int cols,
                         int tile_rows, int tile_cols, int halo, int ghost,
                         int n, unsigned birth, unsigned survive, int combine,
                         int threads, int seg_rows, void* stream) {
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  void (*kernel)(const u32*, u32*, int, int, int, int, int, int, int, u32,
                 u32, int, const gol::Walk) =
      life ? bitlife_tiled<FORM_LIFE> : bitlife_tiled<FORM_MASKS>;
  if (!life) threads = kMaskThreads;
  if (threads > gol::kWalkThreads) return (int)cudaErrorInvalidValue;
  const gol::Walk k = gol::make_walk(tile_rows, tile_cols, halo, ghost,
                                     threads, seg_rows);
  const size_t smem = 2 * sizeof(u32) * (size_t)k.words;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((cols + tile_cols - 1) / tile_cols,
                  (rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, rows, cols, tile_rows, tile_cols, halo,
      ghost, n, birth, survive, combine, k);
  return (int)cudaGetLastError();
}

const char* bitlife_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
