"""The plain reference for Generations (B/S/C) rules: the step on uint8
state grids, in plain PyTorch on whatever device the boards are on; a
packed two-plane form of Brian's Brain (B2/S/C3) that runs on the card
as CUDA-graph replays; the frozen table between states and the gray
levels a board is handed over in; and the seeded soup.

The rule, as LifeWiki's "Generations" and "Brian's Brain" pages
(https://conwaylife.com/wiki/Brian%27s_Brain) define it and Golly runs
`/2/3`: a cell is dead (0), alive (1) or dying (2 .. C-1). Only alive
cells count as neighbours, eight of them, on a torus. A dead cell with
a neighbour count in B is born; an alive cell with a count in S stays,
else it starts dying; a dying cell ages by one each turn and is dead
after state C-1. Brian's Brain is B2/S/C3: every alive cell dies at
once, every dying cell is dead next turn.

Departures from LifeWiki's definition: the board is a torus of fixed
size (LifeWiki's plane is unbounded); `torus=False` makes the cells
beyond the edge dead instead, the control the check runs. States
travel as gray levels (`LEVELS`), which LifeWiki does not define.

It imports nothing of the program. Boards are uint8 tensors of shape
(..., H, W); a leading batch dimension steps several boards of one
shape together. The soup is `life.soup`'s, handed to the program as
gray levels: states 0 and 1 only (levels 0 and 255); `mismatches`
counts the cells in which two boards of states differ.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.life import (WORD, _lsr, _shift, mismatches, pack,
                                      soup, unpack)

__all__ = ["LEVELS", "parse", "soup", "to_states", "step", "step_packed",
           "run_packed", "run_to", "alive", "mismatches"]

#: Gray level of each state of a C = 3 rule, index = state: dead 0,
#: alive 255, dying 170 (255 - (s - 1) * (255 // C) for the dying
#: states). A frozen copy of the port's table for C = 3.
LEVELS = (0, 255, 170)
#: What `to_states` gives a level that is no state's: no state, so it
#: differs from every state the reference can hold.
UNKNOWN = 255


def parse(rule: str) -> tuple:
    """"B2/S/C3" -> (birth counts, survive counts, states C)."""
    parts = rule.upper().split("/")
    if len(parts) != 3 or not (parts[0].startswith("B")
                               and parts[1].startswith("S")
                               and parts[2].startswith("C")):
        raise ValueError(f"not a B/S/C rule: {rule!r}")
    birth = frozenset(int(c) for c in parts[0][1:])
    survive = frozenset(int(c) for c in parts[1][1:])
    states = int(parts[2][1:])
    if not 2 <= states <= 255:
        raise ValueError(f"C must lie in 2..255: {rule!r}")
    return birth, survive, states


def to_states(board) -> torch.Tensor:
    """A board of gray levels (H, W) -> uint8 states by `LEVELS`; a level
    no state has becomes `UNKNOWN`."""
    board = torch.from_numpy(np.ascontiguousarray(board, dtype=np.uint8))
    out = torch.full_like(board, UNKNOWN)
    for state, level in enumerate(LEVELS):
        out[board == level] = state
    return out


def _neighbours(alive: torch.Tensor, torus: bool) -> torch.Tensor:
    """Alive cells among each cell's eight neighbours (uint8)."""
    if torus:
        v = alive + alive.roll(1, -2) + alive.roll(-1, -2)
        s = v + v.roll(1, -1) + v.roll(-1, -1)
    else:
        p = F.pad(alive, (1, 1, 1, 1))
        v = p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]
        s = v[..., :-2] + v[..., 1:-1] + v[..., 2:]
    return s - alive


def _counts(counts: frozenset, device) -> torch.Tensor:
    """(9,) bool: whether each neighbour count 0..8 is in `counts`."""
    table = torch.zeros(9, dtype=torch.bool, device=device)
    table[sorted(counts)] = True
    return table


def step(state: torch.Tensor, rule: str = "B2/S/C3",
         torus: bool = True) -> torch.Tensor:
    """One turn of a B/S/C rule on uint8 states (..., H, W). With
    `torus=False` the cells beyond the edge are dead."""
    birth, survive, states = parse(rule)
    alive = (state == 1).to(torch.uint8)
    n = _neighbours(alive, torus).long()
    born = (state == 0) & _counts(birth, n.device)[n]
    stays = (state == 1) & _counts(survive, n.device)[n]
    older = state.to(torch.int32) + 1
    aged = torch.where((state > 0) & (older < states), older, 0)
    return torch.where(born | stays, 1, aged).to(torch.uint8)


def step_packed(x: torch.Tensor, torus: bool = True) -> torch.Tensor:
    """One B2/S/C3 turn of packed planes (..., 2, H/32, W): plane 0 the
    alive cells, plane 1 the dying ones, each as `life.pack` packs a
    board. The nine-cell sum's bits as in `life.step_packed`; a dead
    cell (in neither plane) is born on a sum of 2, which with the centre
    dead is the neighbour count; the alive plane becomes the dying one.
    The test suite holds it equal to `step`."""
    p, dying = x[..., 0, :, :], x[..., 1, :, :]
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
    born = ~z0 & b1 & ~b2 & ~p & ~dying  # a sum of 2 on a dead cell
    return torch.stack([born, p], dim=-3)


def run_packed(x: torch.Tensor, turns: int, torus: bool = True,
               block: int = 64) -> torch.Tensor:
    """`turns` turns of `step_packed`. On a CUDA device whole blocks of
    `block` turns replay as one captured CUDA graph."""
    if x.device.type != "cuda" or turns < 2 * block:
        for _ in range(turns):
            x = step_packed(x, torus)
        return x

    def steps(y):
        for _ in range(block):
            y = step_packed(y, torus)
        return y

    static = x.clone()
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


def _pack_states(states: torch.Tensor) -> torch.Tensor:
    """(K, H, W) B2/S/C3 states -> (K, 2, H/32, W) packed planes."""
    return torch.stack([pack((states == 1).to(torch.uint8)),
                        pack((states == 2).to(torch.uint8))], dim=1)


def _unpack_states(x: torch.Tensor, height: int) -> torch.Tensor:
    """(2, H/32, W) packed planes -> (H, W) B2/S/C3 states."""
    return unpack(x[0], height) + 2 * unpack(x[1], height)


def run_to(boards: torch.Tensor, turns, rule: str = "B2/S/C3",
           torus: bool = True) -> torch.Tensor:
    """Step a (K, H, W) stack of states and return board i as it stands
    after `turns[i]` turns (each board its own count). B2/S/C3 boards
    whose height is a whole number of words step packed."""
    turns = [int(t) for t in turns]
    if len(turns) != boards.shape[0]:
        raise ValueError("one turn count per board")
    h = boards.shape[-2]
    packed = h % WORD == 0 and parse(rule) == parse("B2/S/C3")
    out = boards.clone()
    live = list(range(len(turns)))
    cur = _pack_states(boards) if packed else boards
    done = 0
    for target in sorted(set(turns)):
        k = target - done
        if packed:
            cur = run_packed(cur, k, torus)
        else:
            for _ in range(k):
                cur = step(cur, rule, torus)
        done = target
        keep = []
        for j, i in enumerate(live):
            if turns[i] == target:
                out[i] = _unpack_states(cur[j], h) if packed else cur[j]
            else:
                keep.append(j)
        live = [live[j] for j in keep]
        cur = cur[keep]
    return out


def alive(states: torch.Tensor) -> int:
    """Alive (state-1) cells of a board or stack."""
    return int((states == 1).sum().item())
