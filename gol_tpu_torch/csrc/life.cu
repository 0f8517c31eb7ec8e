// Dense Game of Life kernel for Hopper (sm_90a), plain C interface.
//
// E. life_dense — replaces gol_tpu/ops/pallas_life.py step_n_pallas (an
//    int32 {0,1} board resident in VMEM for n turns: separable toroidal
//    3-sum, then the B/S indicator combine). One launch computes ONE
//    turn of a uint8 board (nonzero = alive) into a second buffer as
//    {0,255}: one thread per cell sums its 8 toroidal neighbours and
//    looks the next state up in the rule's two 9-bit masks (bit c set =
//    count c in the set), which is the indicator combine
//    alive * survive(count) + (1 - alive) * birth(count). The wrapper
//    launches it n times, ping-ponging two buffers.
//
//    Why one turn a launch: a dense board does not fit one block's
//    shared memory (512^2 is 256 KiB a copy against 227 KB), so the
//    TPU's whole-board residency does not carry over. Between launches
//    the board stays in the 50 MB L2 (512^2 and 512x1024 are 0.25 and
//    0.5 MiB), so a turn costs a launch and an L2 round trip, not a
//    device-memory one. Bound on the H100 for a call of n turns: the
//    function needs the board read once and written once (2 bytes a
//    cell, whatever n) and at least 9 integer instructions per 32-bit
//    word of 4 cells per turn in byte-SIMD form (chip_smoke.py), so
//    from n = 5 on it is bound by integer operations; the per-turn
//    round trip is this design's, not the function's. Temporal
//    blocking (a tile with g ghost cells a side, g turns a launch, as
//    bitlife_tiled does on bits) is the speed item (ROADMAP.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
    life_dense(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int rows, int cols, unsigned birth, unsigned survive) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int y = i / cols;
  const int x = i - y * cols;
  const int yn = (y == 0 ? rows : y) - 1;
  const int ys = (y + 1 == rows) ? 0 : y + 1;
  const int xw = (x == 0 ? cols : x) - 1;
  const int xe = (x + 1 == cols) ? 0 : x + 1;
  const uint8_t* north = in + yn * cols;
  const uint8_t* mid = in + y * cols;
  const uint8_t* south = in + ys * cols;
  const int count = (north[xw] != 0) + (north[x] != 0) + (north[xe] != 0) +
                    (mid[xw] != 0) + (mid[xe] != 0) + (south[xw] != 0) +
                    (south[x] != 0) + (south[xe] != 0);
  const unsigned set = mid[x] != 0 ? survive : birth;
  out[i] = ((set >> count) & 1u) ? 255 : 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = the launch was
// accepted); the Python wrapper raises on anything else.
int life_dense_launch(const void* in, void* out, int rows, int cols,
                      unsigned birth, unsigned survive, int threads,
                      void* stream) {
  const int cells = rows * cols;
  const int blocks = (cells + threads - 1) / threads;
  life_dense<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, rows, cols, birth, survive);
  return (int)cudaGetLastError();
}

}  // extern "C"
