"""Dense Game of Life step — plain PyTorch, one byte per cell.

The counterpart of `gol_tpu.ops.life`: a separable toroidal 3×3 sum
(two `torch.roll` pairs — 4 shifted adds instead of the reference's 8
wrapped reads per cell, ref: gol/distributor.go:382-417), then the B/S
rule as a boolean combine. No TPU kernel backs these functions, so the
port has none either; they run wherever their tensors live.

Every function takes and returns tensors on the caller's device; the
world convention is (H, W) uint8 with values {0, 255}.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from gol_tpu_torch.models.rules import LIFE, Rule, get_rule
from gol_tpu_torch.utils.cell import cells_from_mask

#: Alive pixel value — the grid is 2-valued {0, 255} like the reference's
#: PGM world (ref: gol/io.go raster; README.md:24-31).
ALIVE = 255


def to_bits(world: torch.Tensor) -> torch.Tensor:
    """{0,255} uint8 world -> {0,1} uint8 occupancy."""
    return (torch.as_tensor(world) != 0).to(torch.uint8)


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} occupancy -> {0,255} uint8 world."""
    return bits.to(torch.uint8) * ALIVE


def neighbour_counts(bits: torch.Tensor) -> torch.Tensor:
    """8-neighbour counts with toroidal wraparound: vertical 3-sum, then
    horizontal 3-sum of that, minus the centre (counts fit uint8)."""
    v = bits + torch.roll(bits, 1, 0) + torch.roll(bits, -1, 0)
    n = v + torch.roll(v, 1, 1) + torch.roll(v, -1, 1)
    return n - bits


def count_in(counts: torch.Tensor, ns) -> torch.Tensor:
    """Membership mask `counts ∈ ns` for a static neighbour-count set."""
    terms = [counts == k for k in sorted(ns)]
    if not terms:
        return torch.zeros(counts.shape, dtype=torch.bool,
                           device=counts.device)
    return functools.reduce(operator.or_, terms)


def apply_rule(bits: torch.Tensor, counts: torch.Tensor,
               rule: Rule) -> torch.Tensor:
    """B/S rule as a boolean combine over the rule's static sets."""
    alive = bits != 0
    nxt = torch.where(alive, count_in(counts, rule.survive),
                      count_in(counts, rule.birth))
    return nxt.to(torch.uint8)


def step_bits(bits: torch.Tensor, rule: Rule = LIFE) -> torch.Tensor:
    """One turn on a {0,1} grid."""
    return apply_rule(bits, neighbour_counts(bits), rule)


def _resolve(rule: Rule | str | None) -> Rule:
    if rule is None:
        return LIFE
    if isinstance(rule, str):
        return get_rule(rule)
    return rule


def step(world: torch.Tensor, rule: Rule | str = LIFE) -> torch.Tensor:
    """One turn on a {0,255} uint8 world (the serial-engine analog,
    ref: gol/distributor.go:350-379)."""
    return from_bits(step_bits(to_bits(world), _resolve(rule)))


def step_n(world: torch.Tensor, n: int,
           rule: Rule | str = LIFE) -> torch.Tensor:
    """`n` turns on a {0,255} uint8 world."""
    rule = _resolve(rule)
    bits = to_bits(world)
    for _ in range(n):
        bits = step_bits(bits, rule)
    return from_bits(bits)


def step_n_counted(world: torch.Tensor, n: int, rule: Rule | str = LIFE):
    """`n` turns plus the resulting alive count (int32 device scalar)."""
    rule = _resolve(rule)
    bits = to_bits(world)
    for _ in range(n):
        bits = step_bits(bits, rule)
    return from_bits(bits), torch.sum(bits, dtype=torch.int32)


def step_with_diff(world: torch.Tensor, rule: Rule | str = LIFE):
    """One turn plus the flipped-cell mask plus the alive count — the
    device-side analog of the reference's per-turn diff scan that feeds
    `CellFlipped` events (ref: gol/distributor.go:212-220)."""
    world = torch.as_tensor(world)
    bits = step_bits(to_bits(world), _resolve(rule))
    new = from_bits(bits)
    return new, world != new, torch.sum(bits, dtype=torch.int32)


def alive_count(world: torch.Tensor) -> torch.Tensor:
    """Number of alive cells as an int32 device scalar
    (ref: gol/distributor.go:420-432)."""
    return torch.sum(torch.as_tensor(world) != 0, dtype=torch.int32)


def alive_cells(world) -> list:
    """Host-side alive-cell set as Cell(x=col, y=row) — the payload of
    `FinalTurnComplete` (ref: gol/distributor.go:420-432,
    gol/event.go:65-68)."""
    return cells_from_mask(_host(world))


def flipped_cells(mask) -> list:
    """Host-side coordinates of a diff mask, as Cell(x, y)."""
    return cells_from_mask(_host(mask))


def _host(arr):
    """A tensor on any device as numpy; anything else as it is."""
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr


def random_world(height: int, width: int, density: float = 0.25,
                 seed: int = 0) -> np.ndarray:
    """Random {0,255} host world from numpy's `default_rng(seed)` — the
    same boards as `gol_tpu.ops.life.random_world` for the same seed."""
    rng = np.random.default_rng(seed)
    return (rng.random((height, width)) < density).astype(np.uint8) * np.uint8(ALIVE)
