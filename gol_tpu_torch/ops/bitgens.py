"""Bit-packed Generations stepping — one-hot state planes, SWAR counts.

The counterpart of `gol_tpu.ops.bitgens`, and the plain version every
CUDA kernel of `ops/cuda_bitgens.py` is held against. Packed form: C-1
bit-planes of 32-cells-per-word int32 boards (layout of
`ops/bitlife.py`) — plane 0 is the alive (state 1) mask, planes
1..C-2 are one-hot dying-age masks. The update rule:

- neighbour counts come from the SAME carry-save machinery as Life,
  run on the alive plane only (`bitlife.rule_masks`' column-sum CSA,
  with the birth/survive masks minimized by `ops/rulecomp.py`);
- a dead cell is ``~(alive | any dying plane)``;
- aging is a PLANE RENAME: new dying plane i+1 *is* old plane i, and
  the oldest plane wraps to dead by falling off;
- the only new work is ``new_dying[0] = alive & ~survive``.

C=2 degenerates to zero dying planes and exactly the life-like packed
step. Only state-1 cells count as neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

from gol_tpu_torch.models.rules import GenRule, Rule
from gol_tpu_torch.ops import bitlife, rulecomp
from gol_tpu_torch.ops.bitlife import WORD


def packable_gens(height: int, width: int) -> bool:
    del width
    return height % WORD == 0 and height >= WORD


def pack_states(state, rule: GenRule) -> np.ndarray:
    """uint8 states (H, W) -> (C-1, H/32, W) uint32 one-hot planes."""
    state = np.asarray(state)
    return np.stack(
        [bitlife.pack_np((state == s) * np.uint8(255))
         for s in range(1, rule.states)]
    )


def unpack_states(planes, height: int, rule: GenRule) -> np.ndarray:
    """(C-1, H/32, W) one-hot planes -> uint8 states (H, W)."""
    planes = np.asarray(planes)
    out = np.zeros((height, planes.shape[2]), np.uint8)
    for s in range(1, rule.states):
        mask = bitlife.unpack_np(planes[s - 1], height) != 0
        out[mask] = s
    return out


def _life_view(rule: GenRule) -> Rule:
    """The life-like (B/S) shadow of a generations rule — what the
    count/rule machinery sees (cached by rulecomp's lru on Rule)."""
    return Rule(name=rule.name, birth=rule.birth, survive=rule.survive)


def step_planes(planes: tuple, rule: GenRule, up: torch.Tensor,
                down: torch.Tensor, roll=None) -> tuple:
    """One turn on a TUPLE of C-1 one-hot plane tensors, given the two
    vertically-shifted alive bitboards (callers supply their roll
    primitive, as for `bitlife.combine_packed`)."""
    alive = planes[0]
    plan = rulecomp.compile_rule(_life_view(rule))
    # combine_packed fuses the masks into the two-state next board, but
    # here birth and survive feed DIFFERENT planes — so the shared CSA
    # (`rule_masks`) emits them separately.
    survive_mask, birth_mask = (
        bitlife.resolve_mask(m, alive)
        for m in bitlife.rule_masks(alive, up, down, plan, roll)
    )
    dead = ~alive
    for q in planes[1:]:
        dead = dead & ~q
    new_alive = (alive & survive_mask) | (dead & birth_mask)
    if rule.states == 2:
        return (new_alive,)
    # Aging is a plane rename; the first dying plane is the alive cells
    # that failed survive.
    return (new_alive, alive & ~survive_mask) + tuple(planes[1:-1])


def step_packed_gens(planes: torch.Tensor, rule: GenRule) -> torch.Tensor:
    """One turn on stacked (C-1, rows, W) int32 one-hot planes."""
    alive = planes[0]
    new = step_planes(
        tuple(planes[i] for i in range(rule.states - 1)), rule,
        bitlife._shift_up(alive), bitlife._shift_down(alive),
    )
    return torch.stack(new)


def step_n_packed_gens_raw(planes: torch.Tensor, n: int,
                           rule: GenRule) -> torch.Tensor:
    """`n` turns, planes in / planes out — the plain version of every
    kernel in `ops/cuda_bitgens.py`."""
    for _ in range(n):
        planes = step_packed_gens(planes, rule)
    return planes


def step_n_packed_gens(planes: torch.Tensor, n: int, rule: GenRule):
    """`n` turns + alive count (int32 device scalar) on one-hot planes."""
    planes = step_n_packed_gens_raw(planes, n, rule)
    return planes, bitlife.count_packed(planes[0])
