"""The plain reference the benchmark holds the port against: Conway's
Life, B3/S23, eight neighbours on a torus (the coursework's
`gol/distributor.go:325-342`), in plain PyTorch on whatever device the
boards are on, and the seeded soup every cell starts from.

It imports nothing of the program. Boards are uint8 tensors of 0 and 1
of shape (..., H, W); a leading batch dimension steps several boards of
one shape together.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: Cells per packed word.
WORD = 32


def soup(height: int, width: int, seed: int,
         density: float = 0.25) -> np.ndarray:
    """The seeded soup: each cell alive with probability `density`, as
    {0, 255} uint8 (H, W). A frozen copy of the port's recipe for a
    seeded session (`sessions.manager.seeded_board`): the same seed gives
    the same board."""
    rng = np.random.default_rng(int(seed))
    return ((rng.random((height, width)) < float(density))
            .astype(np.uint8) * np.uint8(255))


def to_bits(board) -> torch.Tensor:
    """{0, 255} (or any nonzero) board -> uint8 0/1 tensor."""
    return torch.from_numpy(np.asarray(board) != 0).to(torch.uint8)


def step(b: torch.Tensor, torus: bool = True) -> torch.Tensor:
    """One turn. The 3x3 sum counts the centre too, so a cell is alive
    next turn when the sum is 3, or 4 with the cell alive. With
    `torus=False` the cells beyond the edge are dead: the control, a
    board that breaks the configuration's torus."""
    if torus:
        v = b + b.roll(1, -2) + b.roll(-1, -2)
        s = v + v.roll(1, -1) + v.roll(-1, -1)
    else:
        p = F.pad(b, (1, 1, 1, 1))
        v = p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]
        s = v[..., :-2] + v[..., 1:-1] + v[..., 2:]
    return ((s == 3) | ((s == 4) & (b == 1))).to(torch.uint8)


def step_packed(p: torch.Tensor, torus: bool = True) -> torch.Tensor:
    """`step` on packed boards (`pack`): the same sum of nine cells as
    bit slices of int32 words, 32 cells a word. The test suite holds it
    equal to `step`; the harness runs it on the card, where it is many
    times faster on large boards."""
    up = (p << 1) | _lsr(_shift(p, 1, -2, torus), 31)    # row y-1
    dn = _lsr(p, 1) | (_shift(p, -1, -2, torus) << 31)   # row y+1
    s0 = up ^ p ^ dn                     # column sums of three, bit 0
    s1 = (up & p) | (dn & (up ^ p))      # and bit 1
    w0, e0 = _shift(s0, 1, -1, torus), _shift(s0, -1, -1, torus)
    w1, e1 = _shift(s1, 1, -1, torus), _shift(s1, -1, -1, torus)
    z0 = w0 ^ s0 ^ e0                    # sum of nine, bit 0
    c0 = (w0 & s0) | (e0 & (w0 ^ s0))    # its carry
    a = w1 ^ s1 ^ e1
    m = (w1 & s1) | (e1 & (w1 ^ s1))
    b1 = a ^ c0                          # bit 1
    b2 = m ^ (a & c0)                    # bit 2 (bit 3 only for 8 and 9)
    three_or_four = (z0 & b1 & ~b2) | (~z0 & ~b1 & b2)
    return three_or_four & (p | z0)      # 3, or 4 with the cell alive


def _lsr(p: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words."""
    return (p >> k) & ((1 << (WORD - k)) - 1)


def _shift(p: torch.Tensor, by: int, dim: int, torus: bool) -> torch.Tensor:
    """result[i] = p[i - by] along `dim` (by = 1 or -1): wrapped on a
    torus, else dead beyond the edge."""
    if torus:
        return p.roll(by, dim)
    z = torch.zeros_like(p.narrow(dim, 0, 1))
    n = p.shape[dim]
    if by == 1:
        return torch.cat([z, p.narrow(dim, 0, n - 1)], dim)
    return torch.cat([p.narrow(dim, 1, n - 1), z], dim)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., H, W) 0/1 -> (..., H/32, W) int32; bit i of word [r, x] is
    the cell at row 32r + i, column x."""
    *lead, h, w = bits.shape
    words = bits.reshape(*lead, h // WORD, WORD, w).to(torch.int64)
    weights = 2 ** torch.arange(WORD, dtype=torch.int64, device=bits.device)
    v = (words * weights.view(WORD, 1)).sum(-2)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack(p: torch.Tensor, height: int) -> torch.Tensor:
    """`pack`'s inverse: (..., H/32, W) int32 -> (..., H, W) uint8 0/1."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=p.device)
    bits = (p.unsqueeze(-2) >> shifts.view(WORD, 1)) & 1
    return bits.reshape(*p.shape[:-2], height, p.shape[-1]).to(torch.uint8)


def run_packed(p: torch.Tensor, turns: int, torus: bool = True,
               block: int = 64) -> torch.Tensor:
    """`turns` turns of `step_packed`. On a CUDA device whole blocks of
    `block` turns replay as one captured CUDA graph, which takes the
    host's launch cost off the reference's time."""
    if p.device.type != "cuda" or turns < 2 * block:
        for _ in range(turns):
            p = step_packed(p, torus)
        return p

    def steps(x):
        for _ in range(block):
            x = step_packed(x, torus)
        return x

    static = p.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = steps(static)
    whole, rest = divmod(turns, block)
    for _ in range(whole):
        graph.replay()
        static.copy_(out)
    for _ in range(rest):
        static = step_packed(static, torus)
    return static


def run_to(boards: torch.Tensor, turns, torus: bool = True) -> torch.Tensor:
    """Step a (K, H, W) stack of 0/1 boards and return board i as it
    stands after `turns[i]` turns (each board its own count). Boards
    whose height is a whole number of words step packed."""
    turns = [int(t) for t in turns]
    if len(turns) != boards.shape[0]:
        raise ValueError("one turn count per board")
    h = boards.shape[-2]
    packed = h % WORD == 0
    out = boards.clone()
    live = list(range(len(turns)))
    cur = pack(boards) if packed else boards
    done = 0
    for target in sorted(set(turns)):
        k = target - done
        if packed:
            cur = run_packed(cur, k, torus)
        else:
            for _ in range(k):
                cur = step(cur, torus)
        done = target
        keep = []
        for j, i in enumerate(live):
            if turns[i] == target:
                out[i] = unpack(cur[j], h) if packed else cur[j]
            else:
                keep.append(j)
        live = [live[j] for j in keep]
        cur = cur[keep]
    return out


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Cells in which two 0/1 boards (or stacks) differ."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    return int((a != b).sum().item())


def read_pgm(path) -> np.ndarray:
    """A binary (P5, maxval 255) PGM as (H, W) uint8."""
    data = open(path, "rb").read()
    fields, at = [], 0
    while len(fields) < 4:
        while data[at:at + 1].isspace():
            at += 1
        if data[at:at + 1] == b"#":
            at = data.index(b"\n", at) + 1
            continue
        end = at
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[at:end])
        at = end
    at += 1  # the single whitespace byte before the raster
    magic, width, height, maxval = fields[0], *map(int, fields[1:])
    if magic != b"P5" or maxval != 255:
        raise ValueError(f"{path}: not an 8-bit binary PGM")
    raster = np.frombuffer(data, np.uint8, width * height, at)
    return raster.reshape(height, width)
