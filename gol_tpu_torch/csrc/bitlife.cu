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
//    One board (bitlife_resident_grid, grid.cuh) is spread over the card
//    as a persistent grid of small tiles, one block an SM at most, all
//    resident together (a cooperative launch): each block holds its tile
//    with one ghost word-row and 32 ghost columns a side in shared
//    memory, steps it 32 turns (a round) on its own torus, stores the
//    interior, and the blocks meet at a barrier before the next round
//    loads the edges its neighbours stored (through L2; the 32-KB board
//    of the main path never leaves it). B3/S23 steps a strip of 4 words
//    of the extended tile a thread a turn (three rows of one LDS.128 and
//    two LDS.32, each column's sum once, 14 LOP3/SHF a word, one
//    STS.128, one barrier); every other rule the run-time masks below.
//    A stack of boards (the batched entry: the tiled stepper's slab, the
//    session buckets) keeps the resident cluster (walk.cuh): one
//    thread-block cluster of up to 8 row slabs a board, every column,
//    one ghost word-row a side, ghost rows refreshed from the neighbours
//    over distributed shared memory every 32 turns (two cluster barriers,
//    two ghost word-rows of each of a block's two copies, a round); B3/S23
//    by the column walkers of walk.cuh, every other rule by kernel B's
//    run-time masks (9 LDS and about 35 operations for the count, then
//    the rule's mask loop). A board that no split into 2..8 slabs fits
//    runs as one slab, its wrap the torus, with no exchange.
//    Bound on the H100: integer operations, 12 LOP3/SHF per word-turn
//    (chip_smoke.life_fewest_instructions); the bytes are 8 per word per
//    launch. Measured at 512^2 (PERF.md §6; 128 tiles of 1 x 64 words, 3
//    x 128 extended words a block, 96 threads): ~0.195 us a turn at
//    65,536-turn launches against the cluster's ~0.765, a round of 32
//    turns ~6.4 us — the turns ~4.5, the load, store and grid barrier
//    ~1.9. What bounds it: the turn's latency with one warp a scheduler
//    (its 56 LOP3/SHF fill ~112 of a turn's ~276 cycles), the frame (a
//    block steps 6x its interior's words, 384 for 64), then the round's
//    barrier and L2 round trips.
//
// B. bitlife_tiled — replaces step_n_packed_pallas_tiled_raw and
//    step_n_packed_pallas_tiled2d_raw (strip / 2-D tiles with deep
//    halos). A grid of blocks over (tile word-rows x tile columns); each
//    block loads its tile plus `halo` ghost word-rows and `ghost` ghost
//    columns per side (toroidal indices modulo the board) into shared
//    memory, runs n <= min(32*halo, ghost) turns there, and writes only
//    the interior to a second buffer (other blocks read this tile's
//    ghosts from the input). Light cone: whatever the extended tile's
//    outermost bit-row and column read beyond it, they are garbage after
//    one turn; the garbage advances one bit-row and one column per turn,
//    so the interior stays exact for 32*halo turns vertically and
//    `ghost` turns horizontally.
//    B3/S23 runs on strip walkers (strip.cuh, kernel B's own): a work
//    item is a strip of 4 adjacent columns of the extended tile and a
//    segment of its word-rows; each step loads one new row of the strip
//    (one LDS.128, and two LDS.32 for the edge columns), forms each of
//    the 6 columns' vertical sum once (swar.cuh col_sum), finishes the 4
//    words from the three column sums around each and stores them with
//    one STS.128. The tile's row pitch is padded to whole strips (the
//    extra columns are more ghost columns), so every geometry of the two
//    entry points takes this body. Every other rule runs kernel A's
//    per-word run-time masks on the same tile (512 threads): the masks
//    fed from a walker's window were slower than that body, not faster.
//    Bound on the H100: integer operations, 12 LOP3/SHF per word-turn
//    (chip_smoke.life_fewest_instructions); the bytes are 8 per word per
//    launch. Spent per word by the strip walkers: 14 LOP3/SHF (12 + 8/4:
//    the two edge columns' sums are formed again by the strips beside
//    them) and, once for 4 words, the shared-memory accesses above, two
//    pointer steps and the loop count: 65 instructions a step of 4 words,
//    56 of them on the LOP3/SHF pipe, which bounds the step. The tile
//    moves in and out in strip.cuh's bulk form (FORM_LIFE_BULK: 16-byte
//    row pieces, every copy of the block in flight together, no divide or
//    modulo a word) wherever the board's width, the tile's and the ghost
//    columns are whole 16-byte units, the buffers 16-byte aligned and the
//    pitch within the board's width (every shape of the benchmark and
//    the main paths); any other shape (4096 x 131, say) moves it word by
//    word (FORM_LIFE: walk.cuh load_tile and store_interior). Measured
//    on an H100 (PERF.md §6): a 32-turn launch at 5120^2 ~58 µs, of
//    which the load and store ~3.7 µs (a 0-turn launch; word by word
//    11.0); the turn loop runs at about three quarters of the pipe's
//    issue rate. Still left: the ghost frame (34 x 320 extended words a
//    32 x 256 interior at h=1, g=32: 0.75 of the words stepped are kept)
//    and the fill of the card (a 5120^2 board is 100 blocks on 132
//    SMs).
//
// Shared arithmetic: the column-sum CSA count and the run-time rule
// masks of swar.cuh, combined in the form the rule compiler classified
// (ops/bitlife.py _combine_masks); the B3/S23 form of kernel A, and the
// column sums of kernel B's strip walkers, also there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "strip.cuh"
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

// Kernel B's rule forms: B3/S23 by strip walkers summing nine cells, its
// tile moved word by word (FORM_LIFE) or in the bulk form
// (FORM_LIFE_BULK: 16-byte row pieces, strip.cuh), or any rule by kernel
// A's per-word run-time masks. Kernel A runs FORM_LIFE, B3/S23 by column
// walkers, and FORM_MASKS.
enum { FORM_LIFE = 0, FORM_MASKS = 1, FORM_LIFE_BULK = 2 };

// Threads per block of kernel B (two blocks per SM): the strip walkers
// take up to gol::kStripThreads (strip.cuh), the masks form kMaskThreads.
constexpr int kMaskThreads = 512;
template <int kForm>
constexpr int kTiledThreads =
    kForm == FORM_MASKS ? kMaskThreads : gol::kStripThreads;
// Threads per block of kernel A: its column walkers take up to
// gol::kWalkThreads (walk.cuh), the masks form kMaskThreads.
template <int kForm>
constexpr int kResidentThreads =
    kForm == FORM_LIFE ? gol::kWalkThreads : kMaskThreads;

template <int kForm>
__global__ void __launch_bounds__(kTiledThreads<kForm>, 2)
    bitlife_tiled(const u32* __restrict__ in, u32* __restrict__ out,
                  int rows, int cols, int tile_rows, int tile_cols, int halo,
                  int ghost, int n, u32 birth, u32 survive, int combine,
                  const gol::Strips k) {
  if constexpr (kForm == FORM_LIFE) {
    using gol::smem;
    load_tile(in, smem + gol::strip_copy(k, 0), rows, cols, tile_rows,
              tile_cols, halo, ghost, k.pitch, k.words);
    const int cur = gol::strip_turns<gol::LifeStrip>(k, n);
    store_interior(smem + cur, out, rows, cols, tile_rows, tile_cols, halo,
                   ghost, k.pitch);
  } else if constexpr (kForm == FORM_LIFE_BULK) {
    gol::bulk_load_tile(k, in, 1, rows, cols, tile_rows, tile_cols, halo,
                        ghost);
    const int cur = gol::strip_turns<gol::LifeStrip>(k, n);
    gol::bulk_store_interior(k, cur, out, 1, rows, cols, tile_rows,
                             tile_cols, halo, ghost);
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

// Kernel A: the forms of kernel B, B3/S23 on column walkers, run by the
// resident cluster (walk.cuh) on row slabs with `halo` ghost word-rows
// and no ghost columns. A batch of boards of one shape, stored one after the
// other, runs as one launch: the grid's z index picks the board, and
// each board is its own cluster.
template <int kForm>
__global__ void __launch_bounds__(kResidentThreads<kForm>, 1)
    bitlife_resident(const u32* __restrict__ in, u32* __restrict__ out,
                     int rows, int cols, int slab_rows, int halo, int n,
                     u32 birth, u32 survive, int combine, const gol::Walk k) {
  using gol::smem;
  const size_t board = (size_t)blockIdx.z * rows * cols;
  in += board;
  out += board;
  load_tile(in, smem, rows, cols, slab_rows, cols, halo, 0, k.ec, k.words);
  const int cur = gol::cluster_turns(k, n, slab_rows, halo, 2, [&](int t) {
    if constexpr (kForm == FORM_LIFE) {
      return gol::walk_turns(
          k, t, [](const u32(&nn)[3], const u32(&mm)[3], const u32(&ss)[3],
                   int at) { smem[at] = gol::life_next(nn, mm, ss); });
    } else {
      __syncthreads();
      return (int)(run_turns(smem, smem + k.words, k.er, k.ec, t, birth,
                             survive, combine) -
                   smem);
    }
  });
  store_interior(smem + cur, out, rows, cols, slab_rows, cols, halo, 0,
                 k.ec);
}

// Kernel A on one board as the persistent grid (grid.cuh): rounds of
// kRoundTurns turns on the plan's tiles, ping-ponging between `out` and
// `scratch` so that the last round writes `out` (`in` is only read, in
// round 1), the blocks meeting at the grid's barrier between rounds.
// B3/S23 steps a strip of kWidth words a thread (FORM_LIFE, tiles of at
// most kGridThreads words), which also moves its strip in and out as one
// access; every other rule, and a larger tile, the masks (kWidth 1),
// moving the tile a word at a time.
template <int kForm, int kWidth>
__global__ void __launch_bounds__(gol::kGridThreads, 1)
    bitlife_resident_grid(const u32* in, u32* out, u32* scratch, int rows,
                          int cols, int n, u32 birth, u32 survive,
                          int combine, const gol::Grid g) {
  using gol::smem;
  const int rounds = gol::grid_rounds(n);
  const gol::GridStrip at = gol::grid_strip<kWidth>(rows, cols, g);
  const u32* src = in;
  for (int k = 0, done = 0; k < rounds; ++k) {
    u32* dst = ((rounds - 1 - k) & 1) ? scratch : out;
    if constexpr (kForm == FORM_LIFE)
      gol::grid_load_strip<kWidth>(src, at);
    else
      gol::grid_load(src, smem, rows, cols, g);
    __syncthreads();
    const int t = min(gol::kRoundTurns, n - done);
    int cur;
    if constexpr (kForm == FORM_LIFE) {
      cur = gol::grid_life_turns<kWidth>(g, t);
      gol::grid_store_strip<kWidth>(smem + cur, dst, at);
    } else {
      cur = (int)(run_turns(smem, smem + g.words, g.er, g.ec, t, birth,
                            survive, combine) -
                  smem);
      gol::grid_store(smem + cur, dst, rows, cols, g);
    }
    done += t;
    if (k + 1 < rounds) cooperative_groups::this_grid().sync();
    src = dst;
  }
}

// The grid's instantiations: B3/S23 at strip widths 1, 2 and 4, and the
// masks.
using GridKernel = void (*)(const u32*, u32*, u32*, int, int, int, u32, u32,
                            int, const gol::Grid);

GridKernel grid_kernel(bool walk, int width) {
  if (!walk) return bitlife_resident_grid<FORM_MASKS, 1>;
  if (width == 4) return bitlife_resident_grid<FORM_LIFE, 4>;
  if (width == 2) return bitlife_resident_grid<FORM_LIFE, 2>;
  return bitlife_resident_grid<FORM_LIFE, 1>;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = the
// launch was accepted); the Python wrapper raises on anything else.

// Kernel A runs the cluster plan (`blocks` slabs of `slab_rows`
// word-rows, `halo` ghost word-rows a side) in kernel B's forms: B3/S23
// on the walkers with `threads` and `seg_rows`, every other rule on the
// masks with kMaskThreads, on each of `batch` boards of rows x cols
// words stored one after the other (one cluster a board). A plan, block
// size or batch the kernel does not run is refused
// (cudaErrorInvalidValue), as is a cluster the card cannot schedule (by
// the launch).
int bitlife_resident_launch(const void* in, void* out, int batch, int rows,
                            int cols, int n, unsigned birth,
                            unsigned survive, int combine, int blocks,
                            int slab_rows, int halo, int threads,
                            int seg_rows, void* stream) {
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  void (*kernel)(const u32*, u32*, int, int, int, int, int, u32, u32, int,
                 const gol::Walk) =
      life ? bitlife_resident<FORM_LIFE> : bitlife_resident<FORM_MASKS>;
  if (!life) threads = kMaskThreads;
  if (threads > gol::kWalkThreads || batch < 1 ||
      batch > gol::kMaxGridZ ||
      !gol::cluster_plan_ok(rows, blocks, slab_rows, halo))
    return (int)cudaErrorInvalidValue;
  const gol::Walk k =
      gol::make_walk(slab_rows, cols, halo, 0, threads, seg_rows);
  const size_t smem = 2 * sizeof(u32) * (size_t)k.words;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return gol::launch_cluster(kernel, blocks, threads, smem, stream, batch,
                             (const u32*)in, (u32*)out, rows, cols,
                             slab_rows, halo, n, (u32)birth, (u32)survive,
                             combine, k);
}

// Kernel A on one board as the persistent grid: tiles of `tile_rows` x
// `tile_cols` words (ceil-divided over the board), one block each,
// launched cooperatively, the grid's barrier between rounds; B3/S23
// steps strips of `width` words (1, 2 or 4, dividing the tile's and the
// board's widths, the buffers aligned to a strip), moved in and out
// whole. `scratch` (a board of the input's shape) is needed when n takes
// more than one round, and may be null otherwise. A plan or buffer the
// kernel does not run is refused (cudaErrorInvalidValue), as is a grid
// the card cannot hold resident (by the launch).
int bitlife_resident_grid_launch(const void* in, void* out, void* scratch,
                                 int rows, int cols, int n, unsigned birth,
                                 unsigned survive, int combine,
                                 int tile_rows, int tile_cols, int width,
                                 void* stream) {
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  if (rows < 1 || cols < 1 || n < 0 || tile_rows < 1 || tile_cols < 1 ||
      tile_rows > rows || tile_cols > cols ||
      (width != 1 && width != 2 && width != 4))
    return (int)cudaErrorInvalidValue;
  const gol::Grid g = gol::make_grid(rows, cols, tile_rows, tile_cols);
  if (gol::grid_rounds(n) > 1 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool walk = life && g.words <= gol::kGridThreads;
  if (!walk) width = 1;
  const uintptr_t align = 4 * width;
  if (g.ec % width || cols % width ||
      ((uintptr_t)in | (uintptr_t)out | (uintptr_t)scratch) % align)
    return (int)cudaErrorInvalidValue;
  const int items = (g.words + width - 1) / width;
  const int threads = items < gol::kGridThreads ? (items + 31) / 32 * 32
                                                : gol::kGridThreads;
  const size_t smem =
      2 * sizeof(u32) * (size_t)(walk ? gol::kGridThreads : g.words);
  const GridKernel kernel = grid_kernel(walk, width);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return gol::launch_grid(kernel, g, threads, smem, stream, (const u32*)in,
                          (u32*)out, (u32*)scratch, rows, cols, n, (u32)birth,
                          (u32)survive, combine, g);
}

// Kernel B picks its instantiation from the rule: B3/S23 (birth {3},
// survive {2, 3}) runs the strip walkers on `threads` (at most
// gol::kStripThreads) in `segs` segments a strip, its tile moved in the
// bulk form where `bulk` is set (a shape gol::bulk_ok refuses is
// refused), else word by word; every other rule runs the masks on
// kMaskThreads, word by word.
int bitlife_tiled_launch(const void* in, void* out, int rows, int cols,
                         int tile_rows, int tile_cols, int halo, int ghost,
                         int n, unsigned birth, unsigned survive, int combine,
                         int bulk, int threads, int segs, void* stream) {
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  void (*kernel)(const u32*, u32*, int, int, int, int, int, int, int, u32,
                 u32, int, const gol::Strips) =
      !life  ? bitlife_tiled<FORM_MASKS>
      : bulk ? bitlife_tiled<FORM_LIFE_BULK>
             : bitlife_tiled<FORM_LIFE>;
  if (!life) threads = kMaskThreads;
  if (threads > gol::kStripThreads || segs < 1 ||
      segs > tile_rows + 2 * halo)
    return (int)cudaErrorInvalidValue;
  const gol::Strips k = gol::make_strips(tile_rows, tile_cols, halo, ghost,
                                         threads, segs);
  if (life && bulk && !gol::bulk_ok(k, cols, tile_cols, ghost, in, out))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      life ? gol::strip_smem_bytes(k)
           : 2 * sizeof(u32) * (size_t)(tile_rows + 2 * halo) *
                 (tile_cols + 2 * ghost);
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
