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
//    Within a turn, column walkers: a work item is one column c of the
//    extended tile and a segment of consecutive word-rows of it
//    (ops/cuda_bitlife._walk_plan sets the segment length and the
//    block size). The walker keeps a 3x3 window of words in registers
//    — rows r-1, r, r+1 of columns c-1, c, c+1 — and walks down the
//    segment; each step loads only row r+1 of the three columns, so a
//    word costs 3 shared-memory loads and 1 store, not 9 and 1. Lanes of
//    a warp take consecutive columns, so each load of a warp reads 32
//    consecutive words of one row (no bank conflicts). The column wrap is
//    resolved once per work item, the row wrap in the segment's prologue
//    and by one compare-and-select per step; the turn loop divides
//    nothing. The window rotates through three register triples, three
//    steps a round, without moves. This is the B3/S23 instantiation,
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

// Kernel B's rule forms: B3/S23 by column walkers summing nine cells,
// or any rule by kernel A's per-word run-time masks.
enum { FORM_LIFE = 0, FORM_MASKS = 1 };

// Threads per block of kernel B, two blocks per SM. The walkers take up
// to kWalkThreads (ops/cuda_bitlife._walk_plan plans within it, and the
// launcher refuses more): at the main path's 34 x 320-word tile, 640
// threads of at most 48 registers. The masks form runs kMaskThreads.
constexpr int kWalkThreads = 640;
constexpr int kMaskThreads = 512;
template <int kForm>
constexpr int kTiledThreads = kForm == FORM_LIFE ? kWalkThreads : kMaskThreads;

// Kernel B's walk plan, as kernel arguments (constant memory, so that
// none of it holds a register): the extended tile (er x ec words), the
// segment length, and the step from one of a thread's work items to its
// next (dcol columns and drow word-rows, before the column wraps).
struct Walk {
  int er, ec, words, seg_rows, dcol, drow;
};

// One B3/S23 turn of one work item: column c, word-rows r0..r1-1 of the
// extended tile at word `cur` of the block's shared memory, written to
// the copy at word `nxt`. Shared-memory words are addressed by 32-bit
// offsets from the one array.
__device__ __forceinline__ void walk(const Walk k, int cur, int nxt, int c,
                                     int r0, int r1) {
  extern __shared__ u32 smem[];
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
    smem[out] = gol::life_next(nn, mm, ss);
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

// Loads this block's extended tile (ec columns, `words` words) into
// `tile`, with toroidal indices modulo the board.
__device__ __forceinline__ void load_tile(const u32* __restrict__ in,
                                          u32* tile, int rows, int cols,
                                          int tile_rows, int tile_cols,
                                          int halo, int ghost, int ec,
                                          int words) {
  const int r0 = blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_cols;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int tr = i / ec;
    const int tc = i - tr * ec;
    const int gr = gol::wrap(r0 - halo + tr, rows);
    const int gc = gol::wrap(c0 - ghost + tc, cols);
    tile[i] = in[(size_t)gr * cols + gc];
  }
}

// Writes the interior of this block's extended tile `tile` (ec columns)
// to its place on the board.
__device__ __forceinline__ void store_interior(const u32* tile,
                                               u32* __restrict__ out,
                                               int rows, int cols,
                                               int tile_rows, int tile_cols,
                                               int halo, int ghost, int ec) {
  const int r0 = blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_cols;
  const int interior = tile_rows * tile_cols;
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    const int tr = i / tile_cols;
    const int tc = i - tr * tile_cols;
    const int gr = r0 + tr;
    const int gc = c0 + tc;
    if (gr < rows && gc < cols)
      out[(size_t)gr * cols + gc] = tile[(tr + halo) * ec + tc + ghost];
  }
}

template <int kForm>
__global__ void __launch_bounds__(kTiledThreads<kForm>, 2)
    bitlife_tiled(const u32* __restrict__ in, u32* __restrict__ out,
                  int rows, int cols, int tile_rows, int tile_cols, int halo,
                  int ghost, int n, u32 birth, u32 survive, int combine,
                  const Walk k) {
  extern __shared__ u32 smem[];
  if constexpr (kForm == FORM_LIFE) {
    const int ec = k.ec;
    int cur = 0, nxt = k.words;  // the two copies, as word offsets
    load_tile(in, smem, rows, cols, tile_rows, tile_cols, halo, ghost, ec,
              k.words);
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
        walk(k, cur, nxt, c, r, min(r + k.seg_rows, k.er));
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
    store_interior(smem + cur, out, rows, cols, tile_rows, tile_cols, halo,
                   ghost, ec);
  } else {
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
// survive {2, 3}) runs the walkers on `threads` (at most kWalkThreads)
// and `seg_rows`, every other rule the masks on kMaskThreads.
int bitlife_tiled_launch(const void* in, void* out, int rows, int cols,
                         int tile_rows, int tile_cols, int halo, int ghost,
                         int n, unsigned birth, unsigned survive, int combine,
                         int threads, int seg_rows, void* stream) {
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  void (*kernel)(const u32*, u32*, int, int, int, int, int, int, int, u32,
                 u32, int, const Walk) =
      life ? bitlife_tiled<FORM_LIFE> : bitlife_tiled<FORM_MASKS>;
  if (!life) threads = kMaskThreads;
  if (threads > kWalkThreads) return (int)cudaErrorInvalidValue;
  Walk k;
  k.er = tile_rows + 2 * halo;
  k.ec = tile_cols + 2 * ghost;
  k.words = k.er * k.ec;
  k.seg_rows = seg_rows;
  k.dcol = threads % k.ec;
  k.drow = threads / k.ec * seg_rows;
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
