// Packed Generations kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels compute one function: (C-1 one-hot packed planes, n,
// rule) -> the planes after n toroidal Generations turns. Planes as in
// ops/bitgens.py: plane 0 is the alive (state 1) mask, plane j >= 1 the
// mask of dying state j+1; each plane is a packed board in the layout
// of swar.cuh. One turn:
//   survive, birth = the rule masks over the alive plane's counts
//   dead           = ~alive & ~dying_1 & ... & ~dying_{C-2}
//   new alive      = (alive & survive) | (dead & birth)
//   new dying_1    = alive & ~survive
//   new dying_j+1  = dying_j (aging is a rename; the oldest falls off)
// Only the alive plane is read across words. So the kernels ping-pong
// the alive plane and keep the C-2 dying planes in a ring of slots whose
// oldest slot moves back one place per turn: each thread reads all
// dying slots of its own word for `dead`, then writes the new dying_1
// word into the oldest slot — the word it alone reads and writes, so
// the one barrier per turn (for the alive plane) is all the
// synchronisation. Shared memory: C plane copies, against 2(C-1) for
// ping-ponging every plane. C = 2 has no dying planes and is the Life
// step in the general combine form.
//
// C. bitgens_resident — replaces gol_tpu/ops/pallas_bitgens.py
//    step_n_packed_gens_pallas_raw (every plane resident in VMEM). The
//    resident cluster of kernel A (walk.cuh): up to 8 blocks hold every
//    plane of the board as row slabs with one ghost word-row a side,
//    exchange the ghost rows of every shared-memory copy through
//    distributed shared memory between rounds of 32 turns, and read and
//    write device memory once per launch. Only the alive plane carries
//    information across cells, so the dying planes' ghost rows are exact
//    wherever the alive plane's are; the exchange still refreshes every
//    copy, since the dying planes live in them (B2/S/C3: the alive
//    plane's ping-pong partner; other rules: the ring's C-2 slots, whose
//    oldest slot every block advances alike). Each round steps the slab:
//    B2/S/C3 by the column walkers of walk.cuh (4 LDS, 1 STS and 20
//    LOP3/SHF a word-turn, two copies: a slab wraps its columns exactly,
//    with no ghost columns, so kernel D's strip layout, which wraps
//    nothing, does not serve it), every other rule by kernel D's
//    run-time masks of gens_turns (C copies). Bound on the H100:
//    integer operations, 12 LOP3/SHF per word-turn for B2/S/C3
//    (chip_smoke.gens_fewest_instructions) and 15 for B2/S345/C4
//    (chip_smoke.starwars_fewest_instructions); the bytes are 8 per word
//    and plane per launch. Still left, as for kernel A: 8 of the 132 SMs
//    at most, the ghost rows (as many as the interior's at 512^2), and,
//    for every rule but B2/S/C3, the run-time masks.
//
// D. bitgens_tiled — replaces step_n_packed_gens_pallas_tiled_raw and
//    step_n_packed_gens_pallas_tiled2d_raw. bitlife_tiled per plane: a
//    grid of (tile word-rows x tile columns) blocks, each loading its
//    tile plus `halo` ghost word-rows and `ghost` ghost columns of EVERY
//    plane (toroidal indices modulo the board), running
//    n <= min(32*halo, ghost) turns, and writing the interior of every
//    plane to a second buffer. Light cone: only the alive plane carries
//    information across cells, so the garbage that the extended tile's
//    self-wrap feeds in advances one bit-row and one column per turn, as
//    for Life; the dying planes are exact wherever the alive plane is.
//    B2/S/C3 (Brian's Brain) runs kernel B's strip walkers (strip.cuh)
//    with its own finishing form: a work item is a strip of 4 adjacent
//    columns of the extended tile and a segment of its word-rows, in
//    kernel B's padded layout (two copies at the strip pitch between
//    three pads). The rule has no survive set and one dying state, so
//    one turn is new alive = [sum9 == 2] & ~alive & ~dying and new
//    dying = old alive: the dying plane is the alive plane's ping-pong
//    partner. Copy 0 is loaded with the alive plane, copy 1 with the
//    dying plane; the buffer that turn t writes holds alive(t-1) until
//    the write — exactly dying(t) — so each step reads its strip's own
//    4 dying words of that buffer (one LDS.128) before it overwrites
//    them with the 4 new alive words (one STS.128). After n turns the
//    copy turn n wrote is the alive plane and the other the dying one
//    (n = 0: copies 0 and 1 as loaded). 90,928 B at the main path's 34 x
//    320 words, so two blocks of 640 threads share an SM; dying(t) =
//    alive(t-1) is exact wherever alive(t) is, so the light cone is
//    unchanged. Bound on the H100: integer operations, 12 LOP3/SHF per
//    word-turn (chip_smoke.gens_fewest_instructions); the bytes are 16
//    per word per launch. Spent per word-turn by the strip walkers: 13
//    LOP3/SHF (6 for the 6 columns' sums over 4 words, 7 to finish)
//    and, once for 4 words, one LDS.128 of the next row, two LDS.32 of
//    its edge columns, one LDS.128 of the dying words, one STS.128 and
//    the walk's index steps, on the extended tile's words (34x320 per
//    32x256 interior, a third more); the column walkers spent 4 LDS, 1
//    STS and 20 LOP3/SHF a word-turn. Both planes' tiles move in and out
//    in strip.cuh's bulk form (FORM_BRAIN_BULK: 16-byte row pieces of
//    both planes, every copy of the block in flight together, no divide
//    or modulo a word) wherever kernel B's does; any other shape (4096 x
//    131, say) moves them word by word (FORM_BRAIN). A 0-turn launch at
//    5120^2, both planes' load and store, takes ~5.3 µs (word by word
//    19.6; PERF.md §6). Still left: the 1.33x ghost overhead, the fill
//    of the card (a 5120^2 board is 100 blocks on 132 SMs), and
//    generated code for the other rules, which run the per-word run-time
//    masks (gens_turns, 512 threads, C copies: the alive ping-pong and a
//    ring of the C-2 dying planes), word by word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip.cuh"
#include "swar.cuh"
#include "walk.cuh"

namespace {

using gol::u32;

// n Generations turns of a rows x cols region: `cur` / `nxt` ping-pong
// the alive plane, `ring` holds the nd = C-2 dying planes (slot stride
// rows * cols) with the oldest in slot *oldest. Returns the buffer that
// holds the final alive plane and leaves the final oldest slot in
// *oldest; dying_j then sits in slot (*oldest + j) % nd.
__device__ __forceinline__ u32* gens_turns(u32* cur, u32* nxt, u32* ring,
                                           int nd, int rows, int cols, int n,
                                           u32 birth, u32 survive,
                                           int* oldest) {
  const int words = rows * cols;
  int old = *oldest;
  for (int t = 0; t < n; ++t) {
    gol::for_each_word(rows, cols, [&](int i, int r, int c) {
      const gol::Masks m =
          gol::count_masks(cur, rows, cols, r, c, birth, survive);
      u32 dead = ~m.p;
      for (int j = 0; j < nd; ++j) dead &= ~ring[j * words + i];
      nxt[i] = (m.p & m.survive) | (dead & m.birth);
      if (nd) ring[old * words + i] = m.p & ~m.survive;
    });
    __syncthreads();
    u32* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (nd) old = (old == 0 ? nd : old) - 1;
  }
  *oldest = old;
  return cur;
}

// Shared-memory slot of plane q at load time: the alive plane in slot 0
// (its ping-pong partner in slot 1), dying_j in ring slot j-1.
__device__ __forceinline__ int load_slot(int q) { return q == 0 ? 0 : q + 1; }

// Kernel D's rule forms: B2/S/C3 by strip walkers (kernel C: column
// walkers), its tile moved word by word (FORM_BRAIN) or, kernel D only,
// in the bulk form (FORM_BRAIN_BULK: 16-byte row pieces, strip.cuh), or
// any rule by the per-word run-time masks of gens_turns.
enum { FORM_BRAIN = 0, FORM_MASKS = 1, FORM_BRAIN_BULK = 2 };

// Threads per block of kernels D and C: D's strip walkers take up to
// gol::kStripThreads and C's column walkers gol::kWalkThreads (kernel D:
// two blocks per SM); the masks form kMaskThreads, one block per SM.
constexpr int kMaskThreads = 512;
template <int kForm>
constexpr int kTiledThreads =
    kForm == FORM_MASKS ? kMaskThreads : gol::kStripThreads;
template <int kForm>
constexpr int kTiledBlocks = kForm == FORM_MASKS ? 1 : 2;
template <int kForm>
constexpr int kResidentThreads =
    kForm == FORM_BRAIN ? gol::kWalkThreads : kMaskThreads;

template <int kForm>
__global__ void __launch_bounds__(kTiledThreads<kForm>, kTiledBlocks<kForm>)
    bitgens_tiled(const u32* __restrict__ in, u32* __restrict__ out,
                  int planes, int rows, int cols, int tile_rows,
                  int tile_cols, int halo, int ghost, int n, u32 birth,
                  u32 survive, const gol::Strips plan) {
  if constexpr (kForm == FORM_BRAIN) {
    using gol::smem;
    // The alive plane into copy 0, the dying plane into copy 1.
    const int copy0 = gol::strip_copy(plan, 0);
    const int copy1 = gol::strip_copy(plan, 1);
    const size_t plane = (size_t)rows * cols;
    gol::load_tile(in, smem + copy0, rows, cols, tile_rows, tile_cols, halo,
                   ghost, plan.pitch, plan.words);
    gol::load_tile(in + plane, smem + copy1, rows, cols, tile_rows,
                   tile_cols, halo, ghost, plan.pitch, plan.words);
    const int cur = gol::strip_turns<gol::BrainStrip>(plan, n);
    gol::store_interior(smem + cur, out, rows, cols, tile_rows, tile_cols,
                        halo, ghost, plan.pitch);
    gol::store_interior(smem + (copy0 + copy1 - cur), out + plane, rows,
                        cols, tile_rows, tile_cols, halo, ghost, plan.pitch);
  } else if constexpr (kForm == FORM_BRAIN_BULK) {
    // Both planes' copies in flight together: alive into copy 0, dying
    // into copy 1; out, the copy turn n wrote and the other.
    gol::bulk_load_tile(plan, in, 2, rows, cols, tile_rows, tile_cols, halo,
                        ghost);
    const int cur = gol::strip_turns<gol::BrainStrip>(plan, n);
    gol::bulk_store_interior(plan, cur, out, 2, rows, cols, tile_rows,
                             tile_cols, halo, ghost);
  } else {
    extern __shared__ u32 smem[];
    const int er = tile_rows + 2 * halo;
    const int ec = tile_cols + 2 * ghost;
    const int words = er * ec;
    const int nd = planes - 1;
    const int r0 = blockIdx.y * tile_rows;
    const int c0 = blockIdx.x * tile_cols;
    const size_t plane = (size_t)rows * cols;
    for (int i = threadIdx.x; i < planes * words; i += blockDim.x) {
      const int q = i / words;
      const int k = i - q * words;
      const int tr = k / ec;
      const int tc = k - tr * ec;
      const int gr = gol::wrap(r0 - halo + tr, rows);
      const int gc = gol::wrap(c0 - ghost + tc, cols);
      smem[load_slot(q) * words + k] = in[q * plane + (size_t)gr * cols + gc];
    }
    __syncthreads();
    int oldest = nd - 1;
    u32* alive = gens_turns(smem, smem + words, smem + 2 * words, nd, er, ec,
                            n, birth, survive, &oldest);
    const int interior = tile_rows * tile_cols;
    for (int i = threadIdx.x; i < planes * interior; i += blockDim.x) {
      const int q = i / interior;
      const int k = i - q * interior;
      const int tr = k / tile_cols;
      const int tc = k - tr * tile_cols;
      const int gr = r0 + tr;
      const int gc = c0 + tc;
      if (gr < rows && gc < cols) {
        const u32* src =
            q == 0 ? alive : smem + (2 + (oldest + q) % nd) * words;
        out[q * plane + (size_t)gr * cols + gc] =
            src[(tr + halo) * ec + tc + ghost];
      }
    }
  }
}

// Kernel C: the forms of kernel D, B2/S/C3 on column walkers, run by
// the resident cluster (walk.cuh) on row slabs with `halo` ghost
// word-rows and no ghost columns.
template <int kForm>
__global__ void __launch_bounds__(kResidentThreads<kForm>, 1)
    bitgens_resident(const u32* __restrict__ in, u32* __restrict__ out,
                     int planes, int rows, int cols, int slab_rows, int halo,
                     int n, u32 birth, u32 survive, const gol::Walk k) {
  using gol::smem;
  const int words = k.words, ec = k.ec;
  const size_t plane = (size_t)rows * cols;
  if constexpr (kForm == FORM_BRAIN) {
    // The alive plane into copy 0, the dying plane into copy 1.
    gol::load_tile(in, smem, rows, cols, slab_rows, cols, halo, 0, ec,
                   words);
    gol::load_tile(in + plane, smem + words, rows, cols, slab_rows, cols,
                   halo, 0, ec, words);
    const int cur = gol::cluster_turns(k, n, slab_rows, halo, 2, [&](int t) {
      return gol::walk_turns(
          k, t,
          [](const u32(&nn)[3], const u32(&mm)[3], const u32(&ss)[3],
             int at) { smem[at] = gol::brain_next(nn, mm, ss, smem[at]); });
    });
    gol::store_interior(smem + cur, out, rows, cols, slab_rows, cols, halo,
                        0, ec);
    gol::store_interior(smem + (words - cur), out + plane, rows, cols,
                        slab_rows, cols, halo, 0, ec);
  } else {
    const int nd = planes - 1;
    for (int q = 0; q < planes; ++q)
      gol::load_tile(in + q * plane, smem + load_slot(q) * words, rows, cols,
                     slab_rows, cols, halo, 0, ec, words);
    int oldest = nd - 1;
    const int cur =
        gol::cluster_turns(k, n, slab_rows, halo, planes + 1, [&](int t) {
          __syncthreads();
          return (int)(gens_turns(smem, smem + words, smem + 2 * words, nd,
                                  k.er, ec, t, birth, survive, &oldest) -
                       smem);
        });
    gol::store_interior(smem + cur, out, rows, cols, slab_rows, cols, halo,
                        0, ec);
    for (int q = 1; q < planes; ++q)
      gol::store_interior(smem + (2 + (oldest + q) % nd) * words,
                          out + q * plane, rows, cols, slab_rows, cols, halo,
                          0, ec);
  }
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = the
// launch was accepted); the Python wrapper raises on anything else.
// Shared memory: `planes` + 1 copies of the (extended) board or slab,
// two for the B2/S/C3 forms of kernels C and D (D's at the strip pitch,
// between three pads).

// Kernel C runs the cluster plan (as kernel A) in kernel D's forms:
// B2/S/C3 on the column walkers with `threads` and `seg_rows` over two
// copies of the slab, every other rule on the masks with kMaskThreads
// over `planes` + 1 copies. A plan or block size the kernel does not run is
// refused (cudaErrorInvalidValue), as is a cluster the card cannot
// schedule (by the launch).
int bitgens_resident_launch(const void* in, void* out, int planes, int rows,
                            int cols, int n, unsigned birth,
                            unsigned survive, int blocks, int slab_rows,
                            int halo, int threads, int seg_rows,
                            void* stream) {
  const bool brain = planes == 2 && birth == (1u << 2) && survive == 0;
  void (*kernel)(const u32*, u32*, int, int, int, int, int, int, u32, u32,
                 const gol::Walk) =
      brain ? bitgens_resident<FORM_BRAIN> : bitgens_resident<FORM_MASKS>;
  if (!brain) threads = kMaskThreads;
  if (threads > gol::kWalkThreads ||
      !gol::cluster_plan_ok(rows, blocks, slab_rows, halo))
    return (int)cudaErrorInvalidValue;
  const gol::Walk k =
      gol::make_walk(slab_rows, cols, halo, 0, threads, seg_rows);
  const size_t smem = sizeof(u32) * (size_t)(brain ? 2 : planes + 1) * k.words;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return gol::launch_cluster(kernel, blocks, threads, smem, stream, 1,
                             (const u32*)in, (u32*)out, planes, rows, cols,
                             slab_rows, halo, n, (u32)birth, (u32)survive, k);
}

// Kernel D picks its instantiation from the rule: B2/S/C3 (two planes,
// birth {2}, survive {}) runs the strip walkers on `threads` (at most
// gol::kStripThreads) in `segs` segments a strip over two copies of the
// tile at the strip pitch, both planes moved in the bulk form where
// `bulk` is set (a shape gol::bulk_ok refuses is refused), else word by
// word; every other rule runs the masks on kMaskThreads over `planes` + 1
// copies, word by word.
int bitgens_tiled_launch(const void* in, void* out, int planes, int rows,
                         int cols, int tile_rows, int tile_cols, int halo,
                         int ghost, int n, unsigned birth, unsigned survive,
                         int bulk, int threads, int segs, void* stream) {
  const bool brain = planes == 2 && birth == (1u << 2) && survive == 0;
  void (*kernel)(const u32*, u32*, int, int, int, int, int, int, int, int,
                 u32, u32, const gol::Strips) =
      !brain ? bitgens_tiled<FORM_MASKS>
      : bulk ? bitgens_tiled<FORM_BRAIN_BULK>
             : bitgens_tiled<FORM_BRAIN>;
  if (!brain) threads = kMaskThreads;
  if (threads > gol::kStripThreads || segs < 1 ||
      segs > tile_rows + 2 * halo)
    return (int)cudaErrorInvalidValue;
  const gol::Strips k = gol::make_strips(tile_rows, tile_cols, halo, ghost,
                                         threads, segs);
  if (brain && bulk && !gol::bulk_ok(k, cols, tile_cols, ghost, in, out))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      brain ? gol::strip_smem_bytes(k)
            : sizeof(u32) * (size_t)(planes + 1) * (tile_rows + 2 * halo) *
                  (tile_cols + 2 * ghost);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((cols + tile_cols - 1) / tile_cols,
                  (rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)in, (u32*)out, planes, rows, cols, tile_rows, tile_cols,
      halo, ghost, n, birth, survive, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
