"""The yardstick of the Generations kernels beside `yardstick.py`'s:
the operations and bytes of one B2/S/C3 (Brian's Brain) turn of packed
planes, and kernel D's share of its roofline.

Frozen here so that a change to the program cannot move it, with the
counts the port's kernel table has used since its bring-up:

- One B2/S/C3 turn costs 12 INT32 instructions per 32-bit word of one
  plane (`brain_packed_step_counted`, the fewest-instruction LOP3/SHF
  form known for sm_90; the test suite holds it equal to the plain
  step). The dying plane costs none: it is the old alive plane.
- One pass of a kernel reads each word of both planes once and writes
  it once: 16 bytes per word of one plane.
- The card's peaks are `yardstick.py`'s.
"""

from __future__ import annotations

from perfbench import yardstick

#: INT32 instructions per packed word (of one plane) per B2/S/C3 turn.
BRAIN_OPS_PER_WORD_TURN = 12
#: Bytes a kernel pass moves per packed word of one plane: two planes,
#: each read once and written once.
BRAIN_BYTES_PER_WORD_PASS = 2 * yardstick.BYTES_PER_WORD_PASS


def brain_packed_step_counted(planes):
    """One B2/S/C3 turn of packed int32 planes (alive, dying), each
    (H/32, W) — bit i of word [r, x] is the cell at row 32r + i, column
    x, on a torus — in the fewest 32-bit integer instructions known for
    sm_90, counted as `yardstick.life_packed_step_counted` counts Life.
    Birth needs a dead centre, so the nine-cell sum equals the neighbour
    count wherever it matters: new alive = [sum9 == 2] & ~alive &
    ~dying. The survive set is empty, so the new dying plane IS the old
    alive plane (a rename, no instruction) and the old dying plane falls
    off. Returns (next planes, instructions per word)."""
    import torch

    lsr = yardstick._lsr
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

    p, dying = planes[0], planes[1]
    up = ins((p << 1) | lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    g = ins(~z0 & b1 & ~b2)                    # sum9 == 2
    born = ins(g & ~p & ~dying)                # ... on a dead cell
    return torch.stack([born, p]), count


def brain_roofline_pct(launches: int, kernel_seconds: float, words: int,
                       turns_per_launch: float) -> "tuple | None":
    """(share of the roofline in %, what bounds it) for `launches`
    launches of a packed B2/S/C3 kernel that took `kernel_seconds` on the
    card in all, each stepping both planes of `words` words (one plane's)
    `turns_per_launch` turns in one pass. None when there is nothing to
    read."""
    if launches <= 0 or kernel_seconds <= 0 or turns_per_launch <= 0:
        return None
    ops = launches * words * turns_per_launch * BRAIN_OPS_PER_WORD_TURN
    nbytes = launches * words * BRAIN_BYTES_PER_WORD_PASS
    least, bound = yardstick.least_seconds(ops, nbytes)
    return 100.0 * least / kernel_seconds, bound
