// Strip walkers over a tile in dynamic shared memory: the B3/S23 body of
// kernel B (bitlife.cu) and the B2/S/C3 body of kernel D (bitgens.cu),
// one walk with the rule's finishing form as a template argument. The
// column walkers of walk.cuh, which kernels A, C and E keep, form each
// column's vertical sum three times, once for each word that reads it; a
// strip walker forms it once for the W words of its strip, and moves
// those words as one 16-byte shared-memory access.
//
// A block holds the extended tile (its interior plus ghost word-rows and
// ghost columns, toroidal indices modulo the board) in two copies, `cur`
// and `nxt`, at word offsets from `smem`. A copy's row pitch is its width
// rounded up to whole strips (the load fills the extra columns with more
// of the board, so they are ghost columns too), and the two copies sit
// between three pads of a row and a strip each, which nothing writes:
//
//   [pad][copy 0: er x pitch][pad][copy 1: er x pitch][pad]
//
// Kernel B loads the board into copy 0; kernel D loads the alive plane
// into copy 0 and the dying plane into copy 1, and its step reads the
// strip's own dying words from the row it is about to overwrite (below).
// Both move their tiles in the bulk form at the end of this file (16-byte
// row pieces, all in flight together, no divide or modulo a word) where
// the shape allows, else word by word (walk.cuh load_tile and
// store_interior).
//
// Within a turn, a work item is one strip s — columns W*s .. W*s+W-1 —
// and one of `segs` segments of consecutive word-rows of it, their
// lengths within one row of each other (ops/cuda_bitlife._strip_plan
// sets the number of segments and the block size, so that a scheduler's
// warps walk about as many rows a turn as another's). The walker keeps
// rows r-1, r and r+1 of the strip and of its two edge columns (W*s-1
// and W*s+W) in registers, three rows of W+2 words, and walks down the
// segment. Each step:
//   1. forms the (sum, carry) of the vertical triple of each of the W+2
//      columns of row r once (swar.cuh col_sum: 2 SHF, 2 LOP3);
//   2. finishes each of the W words of row r from the three column sums
//      around it: B3/S23 in 8 LOP3 (life_of_sums), so a word costs 12 +
//      8/W LOP3/SHF, 14 at W = 4, against the column walkers' 20;
//      B2/S/C3 in 7 (brain_of_sums) after one LDS.128 of the strip's W
//      dying words, 13 a word against 20;
//   3. loads row r+2 of the strip (one LDS.128) and of its edge columns
//      (two LDS.32) into the registers row r-1 held;
//   4. stores the W results with one STS.128 and moves both pointers
//      down a row: the index steps are paid once for the W words.
// Lanes of a warp take consecutive strips, so the LDS.128 and STS.128
// of a warp read and write 512 consecutive bytes of a row (4 wavefronts,
// no bank conflict); the edge loads, 16 bytes apart from lane to lane,
// fall 4 to a bank (4 wavefronts each). A step's 16 wavefronts a warp
// stay under its 28 cycles of the SM's LOP3/SHF issue, which bounds the
// step (B2/S/C3: 20 wavefronts, with the dying words, under 26 cycles).
//
// Nothing wraps within the tile: a strip's west edge at column 0 is the
// word before it in memory (the previous row's last word, or a pad), its
// east edge past the last column the next row's first word, and the rows
// above row 0 and below the last row are pads. That is sound because the
// extended tile's outermost column and bit-row are garbage after one
// turn whatever their neighbours hold (the light cone, bitlife.cu): the
// garbage advances one column and one bit-row a turn and reaches the
// interior only after `ghost` turns and 32*halo turns (kernel D's dying
// words are read only by their own word's step, so they carry nothing
// across words and the cone is the alive plane's). So the turn loop
// wraps nothing and divides nothing, every access has a fixed offset
// from one of two pointers, and only the thread that owns a word of
// `nxt` writes it: one barrier per turn is all the synchronisation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"

namespace gol {

// The dynamic shared memory of the walking kernels (walk.cuh declares
// the same array).
extern __shared__ u32 smem[];

// Columns of a strip, W: one 16-byte shared-memory access a row.
constexpr int kStripCols = 4;

// Threads per block of the strip walkers, two blocks per SM
// (ops/cuda_bitlife._strip_plan plans within it; the launcher refuses
// more).
constexpr int kStripThreads = 640;

// The strip plan, as kernel arguments (constant memory, so that none of
// it holds a register): the extended tile (er word-rows, `pitch` words a
// row, `strips` strips of kStripCols a row, `words` words a copy), the
// pad before each copy, the segments (`segs` of them: the first `rem`
// of q+1 word-rows, the others of q), and the step from one of a
// thread's work items to its next (dstrip strips and dseg segments,
// before the strips wrap).
struct Strips {
  int er, pitch, strips, words, pad, segs, q, rem, dstrip, dseg;
};

// The plan of a tile with `halo` ghost word-rows and `ghost` ghost
// columns per side, walked by `threads` threads in `segs` segments.
inline Strips make_strips(int tile_rows, int tile_cols, int halo, int ghost,
                          int threads, int segs) {
  Strips k;
  k.er = tile_rows + 2 * halo;
  k.pitch = (tile_cols + 2 * ghost + kStripCols - 1) / kStripCols *
            kStripCols;
  k.strips = k.pitch / kStripCols;
  k.words = k.er * k.pitch;
  k.pad = k.pitch + kStripCols;  // a row above, and a word before it
  k.segs = segs;
  k.q = k.er / segs;
  k.rem = k.er % segs;
  k.dstrip = threads % k.strips;
  k.dseg = threads / k.strips;
  return k;
}

// Word offset of copy q (0 or 1) from `smem`: 16-byte aligned, since the
// pitch and the pad are whole strips.
__device__ __forceinline__ int strip_copy(const Strips k, int q) {
  return k.pad + q * (k.words + k.pad);
}

// Bytes of dynamic shared memory of the layout: two copies, three pads.
inline size_t strip_smem_bytes(const Strips& k) {
  return sizeof(u32) * (2 * (size_t)k.words + 3 * (size_t)k.pad);
}

// Row at `p` (a strip's first word) with its edge columns: x[0] west,
// x[1..W] the strip, x[W+1] east.
__device__ __forceinline__ void load_strip_row(const u32* p,
                                               u32 (&x)[kStripCols + 2]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);  // LDS.128
  x[0] = p[-1];
  x[1] = v.x;
  x[2] = v.y;
  x[3] = v.z;
  x[4] = v.w;
  x[5] = p[kStripCols];
}

// One LOP3 of truth table kLut over (a, b, c) = (0xF0, 0xCC, 0xAA),
// as written: left to the compiler, the finishing form's logic becomes 5
// LOP3 a word, not 4.
template <unsigned kLut>
__device__ __forceinline__ u32 lop3(u32 a, u32 b, u32 c) {
  u32 d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}

// Next B3/S23 value of a word from the column sums west (w), centre (x)
// and east (e) of it and its own value: swar.cuh's sum9 and life_next
// from the column sums on, line for line, in 8 LOP3.
__device__ __forceinline__ u32 life_of_sums(ColSum w, ColSum x, ColSum e,
                                            u32 alive) {
  const u32 z0 = lop3<0x96>(w.s, x.s, e.s);  // sum9 bit 0
  const u32 c0 = lop3<0xE8>(w.s, x.s, e.s);  // its carry (weight 2)
  const u32 a = lop3<0x96>(w.c, x.c, e.c);   // weight-2 parity
  const u32 w4 = lop3<0xE8>(w.c, x.c, e.c);  // weight-4 carry
  const u32 b1 = lop3<0x3C>(a, c0, 0);       // sum9 bit 1: a ^ c0
  const u32 b2 = lop3<0x78>(w4, a, c0);      // sum9 bit 2: w4 ^ (a & c0)
  const u32 g = lop3<0x42>(z0, b1, b2);      // sum9 in {3, 4}
  return lop3<0xE0>(g, alive, z0);           // 3, or 4 with the centre alive
}

// The finishing forms of a strip step: the next values of the strip's W
// words of row r from the column sums c[0..W+1] of its W+2 columns, the
// row's words m (m[1..W] the strip) and `dst`, the strip's W words of row
// r in the copy the step writes, which only this thread reads or writes.

// B3/S23 (kernel B): each word from the three column sums around it.
struct LifeStrip {
  __device__ __forceinline__ uint4 operator()(
      const ColSum (&c)[kStripCols + 2], const u32 (&m)[kStripCols + 2],
      const u32*) const {
    return {life_of_sums(c[0], c[1], c[2], m[1]),
            life_of_sums(c[1], c[2], c[3], m[2]),
            life_of_sums(c[2], c[3], c[4], m[3]),
            life_of_sums(c[3], c[4], c[5], m[4])};
  }
};

// Next B2/S/C3 alive value of a word from the column sums around it, its
// alive word and its dying word, in 7 LOP3: birth needs a dead centre,
// where sum9 = z0 + 2 (c0 + a) + 4 w4 is the neighbour count, so
// next = [sum9 == 2] & ~alive & ~dying = (c0 ^ a) & ~w4 & ~z0 & ~alive
// & ~dying.
__device__ __forceinline__ u32 brain_of_sums(ColSum w, ColSum x, ColSum e,
                                             u32 alive, u32 dying) {
  const u32 z0 = lop3<0x96>(w.s, x.s, e.s);  // sum9 bit 0
  const u32 c0 = lop3<0xE8>(w.s, x.s, e.s);  // its carry (weight 2)
  const u32 a = lop3<0x96>(w.c, x.c, e.c);   // weight-2 parity
  const u32 w4 = lop3<0xE8>(w.c, x.c, e.c);  // weight-4 carry
  const u32 two = lop3<0x14>(c0, a, w4);     // (c0 ^ a) & ~w4
  const u32 dead = lop3<0x01>(z0, alive, dying);  // ~z0 & ~alive & ~dying
  return lop3<0xC0>(two, dead, 0);
}

// B2/S/C3 (kernel D): the copy the step writes holds alive(t-1), which is
// dying(t), until the step overwrites it; one LDS.128 reads the strip's W
// dying words there.
struct BrainStrip {
  __device__ __forceinline__ uint4 operator()(
      const ColSum (&c)[kStripCols + 2], const u32 (&m)[kStripCols + 2],
      const u32* dst) const {
    const uint4 dying = *reinterpret_cast<const uint4*>(dst);  // LDS.128
    return {brain_of_sums(c[0], c[1], c[2], m[1], dying.x),
            brain_of_sums(c[1], c[2], c[3], m[2], dying.y),
            brain_of_sums(c[2], c[3], c[4], m[3], dying.z),
            brain_of_sums(c[3], c[4], c[5], m[4], dying.w)};
  }
};

// Next values of the strip's W words of row r, from rows r-1 (n), r (m)
// and r+1 (s): each column's sum once, then each word by Finish.
template <typename Finish>
__device__ __forceinline__ uint4 next_strip(const u32 (&n)[kStripCols + 2],
                                            const u32 (&m)[kStripCols + 2],
                                            const u32 (&s)[kStripCols + 2],
                                            const u32* dst) {
  ColSum c[kStripCols + 2];
#pragma unroll
  for (int j = 0; j < kStripCols + 2; ++j) c[j] = col_sum(n[j], m[j], s[j]);
  return Finish()(c, m, dst);
}

// One turn of one work item: strip s, word-rows r0..r1-1 of the copy at
// word `cur`, written to the copy at word `nxt` in the form Finish.
template <typename Finish>
__device__ __forceinline__ void strip_walk(const Strips k, int cur, int nxt,
                                           int s, int r0, int r1) {
  const int pitch = k.pitch;
  // Prologue: rows r0-1, r0 and r0+1 (a pad row above row 0; row er is
  // the pad below).
  const u32* src = smem + cur + (r0 - 1) * pitch + kStripCols * s;
  u32* dst = smem + nxt + r0 * pitch + kStripCols * s;
  u32 a[kStripCols + 2], b[kStripCols + 2], d[kStripCols + 2];
  load_strip_row(src, a);
  load_strip_row(src + pitch, b);
  load_strip_row(src + 2 * pitch, d);
  src += 3 * pitch;  // the row the next load reads
  int left = r1 - r0;
  // One step: row r from (nn, mm, ss); unless it was the segment's last,
  // load row r+2 into `free` (nn's registers, read by now); store row r.
  auto step = [&](const u32(&nn)[kStripCols + 2],
                  const u32(&mm)[kStripCols + 2],
                  const u32(&ss)[kStripCols + 2],
                  u32(&free)[kStripCols + 2]) {
    const uint4 o = next_strip<Finish>(nn, mm, ss, dst);
    const bool more = --left != 0;
    if (more) {
      load_strip_row(src, free);
      src += pitch;
    }
    *reinterpret_cast<uint4*>(dst) = o;  // STS.128
    dst += pitch;
    return more;
  };
  // The window rotates through three register rows, three steps a
  // round, without moves.
  while (step(a, b, d, a) && step(b, d, a, b) && step(d, a, b, d)) {
  }
}

// n turns of the extended tile loaded into copy 0, by the block's strip
// walkers in the form Finish (one barrier before the first turn and after
// each). Returns the offset of the copy that turn n wrote (copy 0's when
// n is 0).
template <typename Finish>
__device__ __forceinline__ int strip_turns(const Strips k, int n) {
  int cur = strip_copy(k, 0), nxt = strip_copy(k, 1);
  // Work items (strip s, segment g), item i = g * strips + s, strided
  // by the block size: this thread's first one here, the step to the
  // next in `k`, so that the turn loop divides nothing. Segment g starts
  // at word-row g * q + min(g, rem).
  const int seg0 = threadIdx.x / k.strips;
  const int strip0 = threadIdx.x - seg0 * k.strips;
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    for (int s = strip0, g = seg0; g < k.segs;) {
      const int r0 = g * k.q + min(g, k.rem);
      strip_walk<Finish>(k, cur, nxt, s, r0, r0 + k.q + (g < k.rem));
      s += k.dstrip;
      g += k.dseg;
      if (s >= k.strips) {
        s -= k.strips;
        g += 1;
      }
    }
    __syncthreads();
    const int tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// --- The bulk form: the tile's load and store as 16-byte row pieces ---
//
// walk.cuh's load_tile and store_interior move the tile a word at a time,
// with a divide and two modulos a word, each word's load awaited before
// its store. Under the strip layout the extended tile's row is `pitch`
// consecutive board columns from column c0 - ghost, so its columns wrap
// only where the tile crosses the board's west or east edge: a row is
// one piece of a board row, or two, and the bulk form wraps the first
// column once a block and each row once, never a word. Where every piece
// is 16-byte aligned in both memories and whole 16-byte units long, and
// a row at most two of them (bulk_ok; the wrappers pick the form,
// ops/cuda_bitlife._tile_form), each warp takes whole rows and its lanes
// the row's 16-byte units: the load is one cp.async.cg (LDGSTS) a unit,
// which holds no register for the word in transit, with every copy of
// the block in flight before one wait; the store one LDS.128 and one
// STG.128 a unit. Every other shape keeps load_tile and store_interior.
// The extended tile holds the same words either way, so the light cone
// is unchanged. Hopper's bulk-copy engine (cp.async.bulk, one copy a
// row piece against an mbarrier, issued by one warp) moved the same
// pieces slower: a 0-turn launch at 5120^2 took 5.0 us against 3.7 for
// kernel B and 7.9 against 5.3 for kernel D (PERF.md §6).

// Words of a 16-byte unit, the bulk form's alignment and copy.
constexpr int kBulkWords = 4;

// Whether the bulk form moves this plan's tiles of a board `cols` words
// wide between `in` and `out`: the board's width, the tile's and the
// ghost columns whole 16-byte units, both buffers 16-byte aligned (so
// every plane of them: a plane is a whole number of rows), and the pitch
// within the board's width (at most two pieces a row).
inline bool bulk_ok(const Strips& k, int cols, int tile_cols, int ghost,
                    const void* in, const void* out) {
  return cols % kBulkWords == 0 && tile_cols % kBulkWords == 0 &&
         ghost % kBulkWords == 0 && k.pitch <= cols &&
         (uintptr_t)in % (4 * kBulkWords) == 0 &&
         (uintptr_t)out % (4 * kBulkWords) == 0;
}

// Loads the extended tile of each of `planes` planes of a rows x cols
// board (plane q at in + q * rows * cols) into copy q in the bulk form,
// the pads untouched, and waits for this thread's copies; the caller's
// next barrier (strip_turns' first) publishes the tile, as after
// load_tile.
__device__ __forceinline__ void bulk_load_tile(const Strips k,
                                               const u32* __restrict__ in,
                                               int planes, int rows,
                                               int cols, int tile_rows,
                                               int tile_cols, int halo,
                                               int ghost) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int r0 = (int)blockIdx.y * tile_rows - halo;
  // The row's first column on the board, and its words before the
  // board's east edge: all of the pitch, or the first piece of two.
  const int c = wrap((int)blockIdx.x * tile_cols - ghost, cols);
  const int first = min(k.pitch, cols - c);
  for (int q = 0; q < planes; ++q) {
    for (int tr = threadIdx.x / 32; tr < k.er; tr += warps) {
      const u32* row = in + ((size_t)q * rows + wrap(r0 + tr, rows)) * cols;
      const u32* east = row + c;  // the first piece; the second is `row`
      u32* to = smem + strip_copy(k, q) + tr * k.pitch;
      for (int j = kBulkWords * lane; j < k.pitch; j += kBulkWords * 32) {
        const u32* from = j < first ? east + j : row + (j - first);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(to + j)),
                     "l"(from)
                     : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Stores the interior of the copy at word `cur` to plane 0 of `out` and,
// with two planes (kernel D's dying plane), the other copy's to plane 1,
// in the bulk form (each row clipped to the board at a ragged last tile);
// called after the barrier that ends the last turn, as store_interior.
__device__ __forceinline__ void bulk_store_interior(const Strips k, int cur,
                                                    u32* __restrict__ out,
                                                    int planes, int rows,
                                                    int cols, int tile_rows,
                                                    int tile_cols, int halo,
                                                    int ghost) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * tile_rows, c0 = blockIdx.x * tile_cols;
  const int words = min(tile_cols, cols - c0);
  const int other = strip_copy(k, 0) + strip_copy(k, 1) - cur;
  for (int q = 0; q < planes; ++q) {
    const u32* from = smem + (q == 0 ? cur : other) + halo * k.pitch + ghost;
    for (int tr = threadIdx.x / 32; tr < tile_rows && r0 + tr < rows;
         tr += warps) {
      u32* to = out + ((size_t)q * rows + r0 + tr) * cols + c0;
      for (int j = kBulkWords * lane; j < words; j += kBulkWords * 32)
        *reinterpret_cast<uint4*>(to + j) =
            *reinterpret_cast<const uint4*>(from + tr * k.pitch + j);
    }
  }
}

}  // namespace gol
