"""The benchmark's yardstick: the card's peaks, the operations and bytes
of the Life kernels' work, roofline shares, and the device's busy time
read from a profiler trace.

Frozen here so that a change to the program cannot move it. The counts
and peaks are those the port's kernel table has used since its first
bring-up measurements:

- One B3/S23 turn of a packed board costs 12 INT32 instructions per
  32-bit word of 32 cells (`life_packed_step_counted`, the
  fewest-instruction LOP3/SHF form known for sm_90; the test suite holds
  it equal to the plain step).
- One pass of a kernel reads each word once and writes it once: 8 bytes
  per word.
- An NVIDIA H100 SXM (data sheet): 3.35e12 bytes/s of HBM; 132 SMs x 64
  INT32 lanes x 1980 MHz = 16.727e12 INT32 instructions/s.
"""

from __future__ import annotations

#: Published H100 SXM memory rate, bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: 132 SMs x 64 INT32 lanes x 1980 MHz (the H100 SXM's boost clock).
INT32_OPS_PER_S = 132 * 64 * 1980e6
#: Cells per packed word.
WORD = 32
#: Bytes a kernel pass moves per packed word: read once, written once.
BYTES_PER_WORD_PASS = 8


def _lsr(p, k: int):
    """Logical right shift of int32 words (the uint32 `>>`)."""
    return (p >> k) & ((1 << (WORD - k)) - 1)


def life_packed_step_counted(p):
    """One B3/S23 turn of a packed int32 board (H/32, W) — bit i of word
    [r, x] is the cell at row 32r + i, column x, on a torus — in the
    fewest 32-bit integer instructions known for sm_90. Each `ins(...)`
    is one instruction: a funnel shift (SHF) for each vertical carry, one
    LOP3 for any logic of up to three inputs. It sums all nine cells, the
    centre too, so next = [sum9 == 3] | (alive & [sum9 == 4]). Each
    word's column sum is formed once and read by both neighbours;
    bringing a neighbour's word in (shared memory, shuffle) is no integer
    operation. Returns (next board, instructions per word)."""
    import torch

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    def maj(a, b, c):
        return (a & b) | (a & c) | (b & c)

    def west(x):
        return torch.roll(x, 1, 1)

    def east(x):
        return torch.roll(x, -1, 1)

    up = ins((p << 1) | _lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(_lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    g = ins((z0 & b1 & ~b2) | (~z0 & ~b1 & b2))  # sum9 in {3, 4}
    return ins(g & (p | z0)), count            # 3, or 4 with the centre alive


#: INT32 instructions per packed word per B3/S23 turn.
LIFE_OPS_PER_WORD_TURN = 12


def packed_words(height: int, width: int, boards: int = 1) -> int:
    """Packed int32 words of `boards` (height, width) boards."""
    return boards * (height // WORD) * width


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(least seconds, what bounds it): operations over the INT32 rate
    against bytes over the memory rate."""
    op_s = ops / INT32_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    return max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def life_roofline_pct(launches: int, kernel_seconds: float, words: int,
                      turns_per_launch: float) -> "tuple | None":
    """(share of the roofline in %, what bounds it) for `launches` launches
    of a packed Life kernel that took `kernel_seconds` on the card in all,
    each stepping `words` words `turns_per_launch` turns in one pass.
    None when there is nothing to read."""
    if launches <= 0 or kernel_seconds <= 0 or turns_per_launch <= 0:
        return None
    ops = launches * words * turns_per_launch * LIFE_OPS_PER_WORD_TURN
    nbytes = launches * words * BYTES_PER_WORD_PASS
    least, bound = least_seconds(ops, nbytes)
    return 100.0 * least / kernel_seconds, bound


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]
    (any unit; the result is in the same unit)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) gaps in [lo, hi] that no interval covers, longest
    first."""
    gaps, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
