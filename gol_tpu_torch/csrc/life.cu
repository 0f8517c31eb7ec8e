// Dense Game of Life kernel for Hopper (sm_90a), plain C interface.
//
// E. life_dense — replaces gol_tpu/ops/pallas_life.py step_n_pallas
//    (an int32 {0,1} board resident in VMEM for all n turns: four
//    pltpu.rolls for the separable toroidal 3-sum, then the B/S
//    indicator combine; one HBM round trip a call). It computes one
//    function: (uint8 (H, W) board, nonzero = alive; n; rule) -> the
//    {0,255} board after n toroidal turns.
//
//    Bound on the H100 for a call of n turns: the board read once and
//    written once (2 bytes a cell, whatever n), and at least 9 integer
//    instructions per 32-bit word of 4 cells per turn in byte-SIMD form
//    (chip_smoke.dense_fewest_instructions). From n = 5 on the
//    operations bound it.
//
//    Design: temporal blocking of byte-SIMD words on the column walkers
//    of walk.cuh. A 32-bit word holds 4 horizontally adjacent cells
//    (byte k = column 4j+k, little-endian) as {0,1} bytes in shared
//    memory. A grid of blocks covers the board with tiles of tile_rows
//    rows x tile_words words; each block loads its tile plus `halo`
//    ghost rows and `ghost` ghost words a side, with toroidal indices
//    modulo the board (so the stencil runs on the torus's cover, exact
//    for any H, W >= 1, boards smaller than the frame included),
//    normalising nonzero bytes to 1. It runs k <= min(halo, 4 * ghost)
//    turns there, and writes the interior as {0,255} ((x << 8) - x on
//    {0,1} bytes) to the other buffer: the extended tile wraps onto
//    itself, which feeds garbage in at its edges one row and one cell a
//    turn, so the interior stays exact for k turns. One C call issues
//    all ceil(n / k) passes of an n-turn call, alternating between the
//    wrapper's two buffers (the input is never written), so the host
//    crosses into C once per call and the board makes one device-memory
//    round trip per k turns, not per turn.
//    The walkers' 3x3 window of words is the packed kernels' window
//    transposed: there a word holds 32 vertical cells and horizontal
//    neighbours are separate words; here a word holds 4 horizontal
//    cells and vertical neighbours are separate rows. So the window's
//    north / mid / south rows give the vertical sums (IADD, at most 3 a
//    byte) and its west / centre / east words the byte carries, by
//    funnel shift of the column triple sums. B3/S23 is a compile-time
//    form, 11 instructions a word: three triples, 2 SHF, the neighbour
//    sum, and [(count | alive) == 3] per byte (no byte overflows: a
//    count is at most 8). Every other Life-like rule reads an 18-bit
//    table (birth | survive << 9) at count + 9 * alive per byte.
//    Widths that are not a multiple of 4: a byte-granular loader reads
//    the extended tile byte by byte with the column modulo W and the
//    store clips at W, around the same walkers and step (a uniform
//    branch on W % 4). Rows of tiles beyond a grid's 65,535 go to
//    further launches of the same pass, each from its first board row
//    `row0`, so every board of up to 2^31 - 1 cells runs.
//
//    Why tiles and not the resident cluster of kernels A and C: a dense
//    board is 8x the packed one (512^2 is 65,536 words), so the cluster's
//    8 SMs would take about 6 us a turn, and it fits only boards up to
//    about 0.8 MiB; a grid of ghost-framed tiles fills all 132 SMs and
//    takes every board the gate takes, 16384^2 included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"
#include "walk.cuh"

namespace {

using gol::u32;

// The rule forms: B3/S23 at compile time, or the run-time table.
enum { FORM_LIFE = 0, FORM_TABLE = 1 };

constexpr u32 kOnes = 0x01010101u;

// 1 in each byte of x that is nonzero, else 0.
__device__ __forceinline__ u32 nonzero_bytes(u32 x) {
  return ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7) & kOnes;
}

// {0,1} bytes -> {0,255} bytes (exact: no byte borrows).
__device__ __forceinline__ u32 to_255(u32 x) { return (x << 8) - x; }

// Next value of the centre word of a 3x3 window of {0,1} byte words
// (rows north, mid, south; [0..2]: words west, centre, east).
template <int kForm>
__device__ __forceinline__ u32 dense_next(const u32 (&n)[3], const u32 (&m)[3],
                                          const u32 (&s)[3], u32 table) {
  const u32 ns = n[1] + s[1];
  const u32 vw = n[0] + m[0] + s[0];       // column triples, <= 3 a byte
  const u32 vc = ns + m[1];
  const u32 ve = n[2] + m[2] + s[2];
  const u32 left = __funnelshift_l(vw, vc, 8);   // triple of column x-1
  const u32 right = __funnelshift_r(vc, ve, 8);  // triple of column x+1
  const u32 count = left + right + ns;           // neighbours, <= 8 a byte
  if constexpr (kForm == FORM_LIFE) {
    const u32 x = (count | m[1]) ^ 0x03030303u;  // byte 0 iff (c|a) == 3
    return ~((x + 0x0F0F0F0Fu) >> 4) & kOnes;    // bit 4: x byte != 0
  } else {
    const u32 at = count + m[1] * 9u;            // count + 9 * alive, <= 17
    u32 next = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      next |= ((table >> ((at >> (8 * b)) & 0xFFu)) & 1u) << (8 * b);
    return next;
  }
}

// Loads the extended tile byte by byte (any width): byte tb of row tr
// is cell (r0 - halo + tr, c0 - 4 * ghost + tb) of the board, indices
// modulo the board, normalised to {0,1}.
__device__ __forceinline__ void load_tile_bytes(
    const uint8_t* __restrict__ in, uint8_t* tile, int rows, int cols,
    int row0, int tile_rows, int tile_words, int halo, int ghost, int ec,
    int words) {
  const int r0 = row0 + blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_words * 4;
  const int eb = ec * 4;
  for (int i = threadIdx.x; i < words * 4; i += blockDim.x) {
    const int tr = i / eb;
    const int tb = i - tr * eb;
    const int gr = gol::wrap(r0 - halo + tr, rows);
    const int gc = gol::wrap(c0 - 4 * ghost + tb, cols);
    tile[i] = in[(size_t)gr * cols + gc] != 0;
  }
}

// Writes the interior of the extended tile byte by byte as {0,255},
// clipped at the board's last row and column.
__device__ __forceinline__ void store_interior_bytes(
    const uint8_t* tile, uint8_t* __restrict__ out, int rows, int cols,
    int row0, int tile_rows, int tile_words, int halo, int ghost, int ec) {
  const int r0 = row0 + blockIdx.y * tile_rows;
  const int c0 = blockIdx.x * tile_words * 4;
  const int tb_n = tile_words * 4;
  for (int i = threadIdx.x; i < tile_rows * tb_n; i += blockDim.x) {
    const int tr = i / tb_n;
    const int tb = i - tr * tb_n;
    const int gr = r0 + tr;
    const int gc = c0 + tb;
    if (gr < rows && gc < cols)
      out[(size_t)gr * cols + gc] =
          tile[(tr + halo) * ec * 4 + tb + 4 * ghost] ? 255 : 0;
  }
}

// One pass of n <= min(halo, 4 * ghost) turns of a rows x cols (cells)
// board from `in` into `out`, for the rows of tiles from board row
// `row0` on.
template <int kForm>
__global__ void __launch_bounds__(gol::kWalkThreads, 2)
    life_dense(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int rows, int cols, int row0, int tile_rows, int tile_words,
               int halo, int ghost, int n, u32 table, const gol::Walk k) {
  using gol::smem;
  const bool whole = (cols & 3) == 0;  // rows of whole words
  if (whole)
    gol::load_tile((const u32*)in, smem, rows, cols / 4, tile_rows,
                   tile_words, halo, ghost, k.ec, k.words, row0,
                   [](u32 x) { return nonzero_bytes(x); });
  else
    load_tile_bytes(in, (uint8_t*)smem, rows, cols, row0, tile_rows,
                    tile_words, halo, ghost, k.ec, k.words);
  const int cur = gol::walk_turns(
      k, n, [table](const u32(&nn)[3], const u32(&mm)[3], const u32(&ss)[3],
                    int at) {
        smem[at] = dense_next<kForm>(nn, mm, ss, table);
      });
  if (whole)
    gol::store_interior(smem + cur, (u32*)out, rows, cols / 4, tile_rows,
                        tile_words, halo, ghost, k.ec, row0,
                        [](u32 x) { return to_255(x); });
  else
    store_interior_bytes((const uint8_t*)(smem + cur), out, rows, cols,
                         row0, tile_rows, tile_words, halo, ghost, k.ec);
}

// Most rows of tiles one launch's grid holds (CUDA's grid height).
constexpr int kMaxGridY = 65535;

}  // namespace

extern "C" {

// All ceil(n / turns) passes of an n-turn call on `stream`: pass p
// reads `in` (p = 0) or the buffer pass p - 1 wrote and writes buf0
// (p even) or buf1 (p odd); every pass runs `turns` turns but the last,
// which runs the rest; a pass is one launch, or one for each 65,535
// rows of tiles where the board has more. The plan
// (ops/cuda_life._dense_plan): tiles of tile_rows rows x tile_words
// words with `halo` ghost rows and `ghost` ghost words a side, walked by
// `threads` threads in segments of seg_rows rows. B3/S23 (birth {3},
// survive {2, 3}) runs the compile-time form, every other rule the
// table. A plan the kernel does not run (turns outside its light cone,
// more than gol::kWalkThreads threads) is refused
// (cudaErrorInvalidValue). Sets *launched to the launches it issued and
// the device accepted, and returns the first launch error, or 0 when
// every launch was accepted.
int life_dense_launch(const void* in, void* buf0, void* buf1, int rows,
                      int cols, int n, unsigned birth, unsigned survive,
                      int tile_rows, int tile_words, int halo, int ghost,
                      int turns, int threads, int seg_rows, int* launched,
                      void* stream) {
  *launched = 0;
  const bool life = birth == (1u << 3) && survive == ((1u << 2) | (1u << 3));
  void (*kernel)(const uint8_t*, uint8_t*, int, int, int, int, int, int,
                 int, int, u32, const gol::Walk) =
      life ? life_dense<FORM_LIFE> : life_dense<FORM_TABLE>;
  if (turns < 1 || turns > halo || turns > 4 * ghost ||
      threads > gol::kWalkThreads)
    return (int)cudaErrorInvalidValue;
  const gol::Walk k = gol::make_walk(tile_rows, tile_words, halo, ghost,
                                     threads, seg_rows);
  const size_t smem = 2 * sizeof(u32) * (size_t)k.words;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int words = (cols + 3) / 4;
  const int tiles_x = (words + tile_words - 1) / tile_words;
  const int tiles_y = (rows + tile_rows - 1) / tile_rows;
  const u32 table = birth | (survive << 9);
  const uint8_t* src = (const uint8_t*)in;
  for (int done = 0, p = 0; done < n; ++p) {
    const int t = turns < n - done ? turns : n - done;
    uint8_t* dst = (uint8_t*)(p % 2 ? buf1 : buf0);
    for (int y0 = 0; y0 < tiles_y; y0 += kMaxGridY) {
      const int gy = tiles_y - y0 < kMaxGridY ? tiles_y - y0 : kMaxGridY;
      kernel<<<dim3(tiles_x, gy), threads, smem, (cudaStream_t)stream>>>(
          src, dst, rows, cols, y0 * tile_rows, tile_rows, tile_words, halo,
          ghost, t, table, k);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      ++*launched;
    }
    src = dst;
    done += t;
  }
  return 0;
}

}  // extern "C"
