"""Generations (multi-state) step — the B/S/C model family, plain PyTorch.

The counterpart of `gol_tpu.ops.generations`. State domain: uint8 0
(dead), 1 (alive), 2..C-1 (dying). One turn (the two-state reference
rule is the C=2 special case, ref: gol/distributor.go:325-342):

- neighbour counts see ONLY state-1 cells;
- alive stays alive iff n ∈ survive, else it starts dying (state 2,
  which for C=2 wraps straight to dead);
- dead is born iff n ∈ birth;
- dying ages by one per turn and wraps to dead at C.

The count is the separable toroidal 3-sum of `ops/life.py`. No TPU
kernel backs these functions, so the port has none either; they run
wherever their tensors live.

On-disk/PGM representation: states map to gray levels — 0 -> 0,
1 -> 255, dying s -> evenly spaced grays below 255 — injectively, so a
PGM snapshot is a complete checkpoint for a resume, as for the
two-state board.
"""

from __future__ import annotations

import numpy as np
import torch

from gol_tpu_torch.models.rules import GenRule
from gol_tpu_torch.ops.life import ALIVE, count_in, neighbour_counts


def step_states(state: torch.Tensor, rule: GenRule) -> torch.Tensor:
    """One Generations turn on a uint8 state grid (values 0..C-1)."""
    alive = state == 1
    n = neighbour_counts(alive.to(torch.uint8))
    born = (state == 0) & count_in(n, rule.birth)
    stays = alive & count_in(n, rule.survive)
    # Non-surviving alive cells and dying cells both age; age wraps to
    # dead at C (for C=2 an alive cell that fails survive dies at once).
    # C <= 255 keeps state + 1 within uint8.
    aged = torch.where(state > 0, state + 1, state)
    aged = torch.where(aged >= rule.states, 0, aged).to(torch.uint8)
    return torch.where(born | stays, 1, aged).to(torch.uint8)


def step_n_states(state: torch.Tensor, n: int, rule: GenRule) -> torch.Tensor:
    for _ in range(n):
        state = step_states(state, rule)
    return state


def alive_count(state: torch.Tensor) -> torch.Tensor:
    """Number of alive (state-1) cells as an int32 device scalar."""
    return torch.sum(state == 1, dtype=torch.int32)


def step_n_counted_states(state: torch.Tensor, n: int, rule: GenRule):
    """`n` turns plus the alive (state-1) count (int32 device scalar)."""
    s = step_n_states(state, n, rule)
    return s, alive_count(s)


def step_with_diff_states(state: torch.Tensor, rule: GenRule):
    """One turn + changed-cell mask + alive count (the per-turn live
    view; 'flipped' means any state change)."""
    new = step_states(state, rule)
    return new, state != new, alive_count(new)


def levels(rule: GenRule) -> np.ndarray:
    """state -> gray level LUT: 0->0, 1->255, dying states evenly
    spaced below 255 — injective for the whole parseable range
    2 <= C <= 255 (the spacing 255//C is >= 1 there and dying levels
    stay strictly inside (0, 255))."""
    lut = np.zeros(rule.states, np.uint8)
    lut[1] = ALIVE
    for s in range(2, rule.states):
        lut[s] = ALIVE - (s - 1) * (ALIVE // rule.states)
    return lut


def states_from_levels(world, rule: GenRule) -> np.ndarray:
    """Inverse of `levels` for PGM-roundtrip resume. Unknown levels
    (e.g. a plain two-state board seeding a generations run) map via
    nearest: 0 stays dead, anything else starts alive."""
    lut = levels(rule)
    world = np.asarray(world)
    out = np.zeros(world.shape, np.uint8)
    for s in range(rule.states - 1, 0, -1):
        out[world == lut[s]] = s
    out[(world != 0) & ~np.isin(world, lut)] = 1
    return out


def levels_from_states(state, rule: GenRule) -> np.ndarray:
    return levels(rule)[np.asarray(state)]
