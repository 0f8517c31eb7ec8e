// Shared SWAR arithmetic of the packed kernels (bitlife.cu, bitgens.cu).
//
// Layout as in ops/bitlife.py: word (r, x) holds rows 32r..32r+31 of
// column x, bit i = row 32r+i. The words are int32 in PyTorch and are
// read here as uint32, so every shift is logical.
//
// The neighbour count is the column-sum CSA of ops/bitlife.py
// rule_masks: vertical triple -> two bit slices, left/right column sums
// -> 4 count bits. The rule arrives at run time as two 9-bit masks
// (bit c set = count c in the set); each needed count's equality term is
// ANDed from the 4 count bits and ORed into the survive / birth masks.
// One build serves every rule.

#pragma once

#include <stdint.h>

namespace gol {

typedef uint32_t u32;

// Centre word and the survive / birth masks over its neighbour counts.
struct Masks {
  u32 p;
  u32 survive;
  u32 birth;
};

// Masks of word (r, c) of a rows x cols board held in `s`, with
// toroidal wrap on that board.
__device__ __forceinline__ Masks count_masks(const u32* __restrict__ s,
                                             int rows, int cols, int r,
                                             int c, u32 birth, u32 survive) {
  const int rn = (r == 0 ? rows : r) - 1;
  const int rs = (r + 1 == rows) ? 0 : r + 1;
  const int cw = (c == 0 ? cols : c) - 1;
  const int ce = (c + 1 == cols) ? 0 : c + 1;
  const u32* north = s + rn * cols;
  const u32* mid = s + r * cols;
  const u32* south = s + rs * cols;

  // Centre column: up = row y-1, down = row y+1 (carries across words).
  const u32 p = mid[c];
  const u32 up = (p << 1) | (north[c] >> 31);
  const u32 down = (p >> 1) | (south[c] << 31);
  const u32 upd = up ^ down;
  const u32 pc = up & down;

  // Left and right columns: their vertical triples as (sum, carry).
  u32 ls, lc, rsum, rc;
  {
    const u32 q = mid[cw];
    const u32 qu = (q << 1) | (north[cw] >> 31);
    const u32 qd = (q >> 1) | (south[cw] << 31);
    const u32 qud = qu ^ qd;
    ls = qud ^ q;
    lc = (qu & qd) | (q & qud);
  }
  {
    const u32 q = mid[ce];
    const u32 qu = (q << 1) | (north[ce] >> 31);
    const u32 qd = (q >> 1) | (south[ce] << 31);
    const u32 qud = qu ^ qd;
    rsum = qud ^ q;
    rc = (qu & qd) | (q & qud);
  }

  // count = (ls,lc) + (rs,rc) + (upd, pc), as 4 bit slices.
  const u32 x = ls ^ rsum;
  const u32 k0 = (ls & rsum) | (upd & x);
  const u32 y = lc ^ rc;
  const u32 t1 = y ^ pc;
  const u32 k1 = (lc & rc) | (pc & y);
  const u32 b0 = x ^ upd;
  const u32 b1 = t1 ^ k0;
  const u32 k2 = t1 & k0;
  const u32 b2 = k1 ^ k2;
  const u32 b3 = k1 & k2;
  const u32 nb0 = ~b0, nb1 = ~b1, nb2 = ~b2, nb3 = ~b3;

  Masks m = {p, 0, 0};
#pragma unroll
  for (int cnt = 0; cnt < 9; ++cnt) {
    const u32 bit = 1u << cnt;
    if ((birth | survive) & bit) {
      // Count 8 is the only pattern with bit 3 set (9..15 cannot occur).
      const u32 eq = (cnt == 8) ? b3
                                : (((cnt & 1) ? b0 : nb0) &
                                   ((cnt & 2) ? b1 : nb1) &
                                   ((cnt & 4) ? b2 : nb2) & nb3);
      if (survive & bit) m.survive |= eq;
      if (birth & bit) m.birth |= eq;
    }
  }
  return m;
}

// f(i, r, c) for every word i = r * cols + c of a rows x cols region
// that this thread owns (words strided by the block size).
template <typename F>
__device__ __forceinline__ void for_each_word(int rows, int cols, F f) {
  const int words = rows * cols;
  const int stride = blockDim.x;
  const int dr = stride / cols, dc = stride - dr * cols;
  int r = threadIdx.x / cols;
  int c = threadIdx.x - r * cols;
  for (int i = threadIdx.x; i < words; i += stride) {
    f(i, r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      r += 1;
    }
  }
}

__device__ __forceinline__ int wrap(int v, int m) {
  v %= m;
  return v < 0 ? v + m : v;
}

}  // namespace gol
