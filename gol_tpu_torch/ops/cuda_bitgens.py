"""Packed Generations kernels in hand-written CUDA for Hopper.

The counterpart of `gol_tpu.ops.pallas_bitgens`. Every entry point
computes one function — (stacked (C-1, H/32, W) int32 one-hot planes,
n, rule) -> the planes after n toroidal Generations turns — and is held
bit-exact against the plain version `ops.bitgens.step_n_packed_gens_raw`:

- `step_n_packed_gens_cuda_raw`: kernel C (`bitgens_resident` in
  csrc/bitgens.cu), every plane resident for all n turns in one
  thread-block cluster of row slabs, the plan of kernel A's batched
  entry (`cb._cluster_plan`, planned for C copies). Replaces
  `step_n_packed_gens_pallas_raw`.
- `step_n_packed_gens_tiled_raw` / `step_n_packed_gens_tiled2d_raw`:
  kernel D (`bitgens_tiled`), kernel B of `ops/cuda_bitlife.py` per
  plane — every plane carries the ghost frame, k <= min(32*halo, ghost)
  turns per launch. Replaces `step_n_packed_gens_pallas_tiled_raw` and
  `step_n_packed_gens_pallas_tiled2d_raw`; both keep their names and
  override knobs, and share kernel B's tile plans, strip plan
  (`cb._strip_plan`) and pass loop.

Shared memory holds C copies of the (extended) board: the alive plane
ping-pongs, the C-2 dying planes sit in a ring whose oldest slot takes
each turn's new youngest dying plane (csrc/bitgens.cu). At 512² a plane
is 32 KiB, so kernel C takes C <= 7 there (C = 7: 224 KiB, which its
cluster spreads over 8 blocks of 56 KiB with their ghost rows; the gate
is the one-block board, the plan of any board that passes it). Kernel
C's slabs and kernel D's tiles are planned for C copies
(`TileGeometry.copies`, `cb._smem_need`), and B2/S/C3 allocates two
of them (in the strip layout, which three copies hold): the one dying
plane lives in the alive plane's ping-pong partner. Kernel C steps
B2/S/C3 by column walkers (`cb._walk_plan`); kernel D by kernel B's
strip walkers (`cb._strip_plan`) in their padded layout, two copies at
the strip pitch between three pads, each step reading its strip's dying
words from the row it overwrites, and moves both planes' tiles in kernel
B's form (`cb._tile_form`).

Wrappers: a CPU tensor runs the plain version; a CUDA tensor launches
the kernel (after device, dtype, shape and contiguity checks) or raises
— there is no fallback. `LAUNCHES` counts the launches of each kernel,
`TILE_LOADS` kernel D's by tile form.
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.rules import GenRule
from gol_tpu_torch.ops import bitgens
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops.bitlife import WORD

#: Launches per kernel. Each wrapper adds one where it launches, and
#: nowhere else; callers reset the counts by assigning 0.
LAUNCHES = {"bitgens_resident": 0, "bitgens_tiled": 0}
#: Kernel D's launches by how the blocks move their tiles
#: (`cb._tile_form`): "bulk" (16-byte row pieces) or "words". One a
#: launch, where the pass picks the form; callers reset the counts by
#: assigning 0.
TILE_LOADS = {"bulk": 0, "words": 0}


def _resident_bytes(rule: GenRule, rows: int, cols: int) -> int:
    """Kernel C's shared memory: C plane copies (alive ping-pong plus
    the C-2 dying slots)."""
    return rule.states * 4 * rows * cols


def fits_cuda_gens(height: int, width: int, rule: GenRule) -> bool:
    """Kernel C eligibility: whole words, and C copies of one packed
    plane within one block's shared memory (512²: C <= 7)."""
    if not bitgens.packable_gens(height, width):
        return False
    return _resident_bytes(rule, height // WORD, width) <= cb.SMEM_BYTES


def fits_cuda_gens_tiled(height: int, width: int, rule: GenRule) -> bool:
    """Kernel D eligibility through the 2-D entry (the stepper's entry
    past kernel C): whole words and a default tile that fits."""
    if not bitgens.packable_gens(height, width):
        return False
    try:
        cb._tiled2d_geometry(height // WORD, width, None, rule.states)
    except ValueError:
        return False
    return True


def _check_planes(planes: torch.Tensor, rule: GenRule) -> None:
    cb._check_cuda(planes, dims=3)
    if planes.shape[0] != rule.states - 1:
        raise ValueError(
            f"{rule} needs {rule.states - 1} planes, got {planes.shape[0]}"
        )


def step_n_packed_gens_cuda_raw(planes: torch.Tensor, n: int,
                                rule: GenRule) -> torch.Tensor:
    """`n` turns, planes in / planes out, one launch of kernel C (every
    plane resident in one cluster's shared memory, `cb._cluster_plan`)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if planes.device.type == "cpu":
        return bitgens.step_n_packed_gens_raw(planes, n, rule)
    _check_planes(planes, rule)
    nplanes, rows, cols = planes.shape
    plan = cb._resident_args(rows, cols, rule.states)
    out = torch.empty_like(planes)
    cb._launch(LAUNCHES, "bitgens_resident", planes, planes.data_ptr(),
               out.data_ptr(), nplanes, rows, cols, n, *cb.rule_bits(rule),
               *plan)
    return out


def _tiled_pass(src: torch.Tensor, dst: torch.Tensor, k: int,
                rule: GenRule, geom: cb.TileGeometry) -> torch.Tensor:
    """One pass of k <= geom.turns turns of kernel D from `src` into
    `dst` (never the same buffer: other tiles read this tile's ghosts
    from `src`), its tiles moved in the form `cb._tile_form` picks (the
    strip walkers run B2/S/C3 alone: two planes, birth {2}, survive
    {})."""
    if not 0 <= k <= geom.turns:
        raise ValueError(f"k={k} outside the light cone 0..{geom.turns}")
    if src.device.type == "cpu":
        return dst.copy_(bitgens.step_n_packed_gens_raw(src, k, rule))
    cb._check_pass(src, dst, lambda t: _check_planes(t, rule))
    nplanes, rows, cols = src.shape
    bits = cb.rule_bits(rule)
    form = cb._tile_form(src, dst, geom, nplanes == 2 and bits == (1 << 2, 0))
    cb._launch(LAUNCHES, "bitgens_tiled", src, src.data_ptr(), dst.data_ptr(),
               nplanes, rows, cols, geom.tile_rows, geom.tile_cols,
               geom.halo, geom.ghost, k, *bits, int(form == "bulk"),
               *cb._strip_plan(geom))
    TILE_LOADS[form] += 1
    return dst


def step_n_packed_gens_tiled_raw(planes: torch.Tensor, n: int,
                                 rule: GenRule,
                                 strip_rows: int | None = None,
                                 halo_words: int | None = None
                                 ) -> torch.Tensor:
    """`n` turns, planes in/out, through kernel D with `strip_rows`-row
    tiles and an h = `halo_words` halo on every plane (32*h turns per
    launch). The overrides keep gol_tpu's checks: strip_rows divides
    the packed row count in multiples of 8, halo_words is in 1..8."""
    _, rows, width = planes.shape
    geom = cb._tile_plan(rows, width, strip_rows, halo_words, rule.states)
    return cb._run_passes(planes, n, geom,
                          lambda s, d, k, g: _tiled_pass(s, d, k, rule, g))


def step_n_packed_gens_tiled2d_raw(planes: torch.Tensor, n: int,
                                   rule: GenRule,
                                   tile_rows: int | None = None
                                   ) -> torch.Tensor:
    """`n` turns, planes in/out, through kernel D with (tile_rows x up
    to TILE_COLS) tiles, a one-word halo and GHOST_COLS ghost columns
    on every plane — 32 turns per launch. Keeps gol_tpu's ValueErrors:
    `tile_rows` divides the packed row count in 8-row units, and no
    tiling fits (here: no tile of 32 columns within shared memory)."""
    _, rows, width = planes.shape
    geom = cb._tiled2d_geometry(rows, width, tile_rows, rule.states)
    return cb._run_passes(planes, n, geom,
                          lambda s, d, k, g: _tiled_pass(s, d, k, rule, g))


def step_n_packed_gens_kernel_raw(planes: torch.Tensor, n: int,
                                  rule: GenRule) -> torch.Tensor:
    """`n` turns, planes in/out, through the kernel the stack's shape
    takes: kernel C when C copies of a plane fit one block's shared
    memory (`fits_cuda_gens`), else kernel D's 2-D entry, which raises
    when no tile of it fits either."""
    _, rows, width = planes.shape
    if fits_cuda_gens(rows * WORD, width, rule):
        return step_n_packed_gens_cuda_raw(planes, n, rule)
    return step_n_packed_gens_tiled2d_raw(planes, n, rule)
