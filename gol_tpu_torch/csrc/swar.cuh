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
// One build serves every rule. `life_next` is B3/S23 alone and
// `brain_next` B2/S/C3 alone, each as a nine-cell sum over a 3x3 window
// in registers (the column walkers of walk.cuh); `col_sum` is one
// column's vertical sum, the strip walkers' of kernels B and D
// (strip.cuh).

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

__device__ __forceinline__ u32 maj(u32 a, u32 b, u32 c) {
  return (a & b) | (a & c) | (b & c);
}

// Bits 0 and 1 of a column's vertical triple sums: for each bit of the
// centre word m, the cell above it, itself and the cell below it (n and
// s bring in the words above and below), in 2 SHF and 2 LOP3: the column
// sums of sum9 below, one column at a time (the strip walkers of
// kernels B and D, strip.cuh). sum9 keeps its own loop, the code kernels
// A and C are measured with.
struct ColSum {
  u32 s, c;
};

__device__ __forceinline__ ColSum col_sum(u32 n, u32 m, u32 s) {
  const u32 up = __funnelshift_l(n, m, 1);    // SHF: row y-1
  const u32 down = __funnelshift_r(m, s, 1);  // SHF: row y+1
  return {up ^ m ^ down,                      // column sum, bit 0
          maj(up, m, down)};                  // column sum, bit 1
}

// Bits 0..2 of the sum of all nine cells of a 3x3 window (n, m, s: rows
// north, mid, south; [0..2]: columns west, centre, east), in the LOP3/SHF
// form of chip_smoke.life_fewest_instructions, line for line. Bit 3 (a
// sum of 8 or 9) is not formed: b1 and b2 are then clear.
struct Sum9 {
  u32 z0, b1, b2;
};

__device__ __forceinline__ Sum9 sum9(const u32 (&n)[3], const u32 (&m)[3],
                                     const u32 (&s)[3]) {
  u32 cs[3], cc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const u32 up = __funnelshift_l(n[k], m[k], 1);    // SHF: row y-1
    const u32 down = __funnelshift_r(m[k], s[k], 1);  // SHF: row y+1
    cs[k] = up ^ m[k] ^ down;                         // column sum, bit 0
    cc[k] = maj(up, m[k], down);                      // column sum, bit 1
  }
  const u32 z0 = cs[0] ^ cs[1] ^ cs[2];    // sum9 bit 0
  const u32 c0 = maj(cs[0], cs[1], cs[2]); // its carry (weight 2)
  const u32 a = cc[0] ^ cc[1] ^ cc[2];     // weight-2 parity
  const u32 w4 = maj(cc[0], cc[1], cc[2]); // weight-4 carry
  const u32 b1 = a ^ c0;                   // sum9 bit 1
  const u32 b2 = w4 ^ (a & c0);            // sum9 bit 2 (bit 3: 8 or 9)
  return {z0, b1, b2};
}

// Next B3/S23 value of the centre word of a 3x3 window: it sums all
// nine cells, so next = [sum9 == 3] | (alive & [sum9 == 4]). Each
// column's sum is formed here, so a walker spends 20 instructions a word
// where the form, sharing column sums across words, spends 12 (kernel
// B's strip walkers, strip.cuh, which form each once for 4 words: 14).
__device__ __forceinline__ u32 life_next(const u32 (&n)[3], const u32 (&m)[3],
                                         const u32 (&s)[3]) {
  const Sum9 q = sum9(n, m, s);
  const u32 g = (q.z0 & q.b1 & ~q.b2) | (~q.z0 & ~q.b1 & q.b2);  // {3, 4}
  return g & (m[1] | q.z0);  // 3, or 4 with the centre alive
}

// Next B2/S/C3 (Brian's Brain) alive value of the centre word of a 3x3
// window of the alive plane, given the centre's dying word, in the form
// of chip_smoke.gens_fewest_instructions: birth needs a dead centre, so
// the nine-cell sum is the neighbour count wherever it matters, and
// next = [sum9 == 2] & ~alive & ~dying. (The next dying word is the
// alive word itself: the survive set is empty.) Kernel C's column
// walkers spend 20 instructions a word here; kernel D's strip walkers
// (strip.cuh, brain_of_sums) 13.
__device__ __forceinline__ u32 brain_next(const u32 (&n)[3],
                                          const u32 (&m)[3],
                                          const u32 (&s)[3], u32 dying) {
  const Sum9 q = sum9(n, m, s);
  const u32 g = ~q.z0 & q.b1 & ~q.b2;  // sum9 == 2
  return g & ~m[1] & ~dying;           // ... on a dead cell
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
