"""Row-strip sharding for the Generations (B/S/C) family — the Life ring
machinery (`halo.py`, `packed_halo.py`) applied to multi-state boards.

The counterpart of `gol_tpu.parallel.gens_halo`. A Generations cell's
next state depends on its own state and on the count of alive (state-1)
neighbours only, so:

- the packed rings hold (C-1, Sw, W) one-hot planes, row-sharded on
  the word-row axis (the plane axis never shards). Deep blocks
  ghost-extend ALL planes by h word-rows (a ghost cell's multi-turn
  evolution needs its age) and step 32·h exact local turns, through the
  plan `gens_local_block_mode` gives: kernel C
  (`cuda_bitgens.step_n_packed_gens_cuda_raw`) for ``whole``, kernel
  D's strip or 2-D entry for ``tiled`` / ``tiled2d``, the plain plane
  step for ``plain`` (CPU only) — `packed_halo`'s planner, with C
  shared-memory copies a tile. A single turn is one turn of the
  (C-1, Sw + 2, W) extended planes, one launch of kernel C (or D's 2-D
  entry) on a CUDA device; it carries every plane's edge word-row where
  gol_tpu's per-turn step sends the alive plane's only — the ghost
  cells' own outputs are discarded, so the shards' results are the
  same;
- the dense rings hold the uint8 state strips (any shard count; the
  balanced split for non-divisors), deep blocks of `halo.dense_deep`
  state rows. They step with the plain state step
  (`generations.step_n_states`) on every device: gol_tpu's dense
  Generations path is XLA code with no Pallas kernel, and this package
  has no dense Generations kernel, exactly as its single-device
  ``generations-1`` backend.

gol_tpu's `halo_step_states` / `_uneven` and `halo_step_packed_gens` /
`_balanced` are `halo.ring_block` at depth 1 for one turn; its
`_gens_ring_stepper` is `halo._ring_stepper` with the family's count,
diff and `alive_mask`.
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.rules import GenRule
from gol_tpu_torch.ops import bitgens, bitlife, generations as gens
from gol_tpu_torch.parallel import halo, partition
from gol_tpu_torch.parallel.packed_halo import (
    balanced_words,
    packable_sharded,
    packable_sharded_uneven,
    packed_step_n,
    plan_local_blocks,
    turn_stepper,
)


def _gens_fetch(ring: halo.Ring, to_levels):
    """`fetch`: a world back to host gray levels through `to_levels`
    (its canonical host array in), diff masks passed through."""

    def fetch(a):
        if isinstance(a, partition.Sharded):
            return to_levels(ring.canonical(a))
        return halo.host_array(a)

    return fetch


def gens_sharded_stepper(rule: GenRule, devices: list, height: int,
                         width: int):
    """Dense sharded Generations: uint8 state strips over a 1-D ring,
    deep blocks of state rows, the alive count summed over the shards.
    Accepts ANY (height, shard-count) pair — non-divisors run the
    balanced split."""
    from gol_tpu_torch.parallel.stepper import _gens_alive_mask

    n = len(devices)
    size, real = halo.balanced_rows(height, n)
    ring = halo.Ring(devices, "gens_ring", "world", (n * size, width), real)
    deep = halo.dense_deep(height, n)

    def local(ext, turns):
        return gens.step_n_states(ext, turns, rule)

    def count_fn(p):
        return gens.alive_count(p)

    def one_turn(world):
        return ring.block(world, 1, lambda e: local(e, 1))

    def changed(old, new):
        return ring.diff(old, new, torch.ne)

    uneven = any(r != size for r in real)
    return halo._ring_stepper(
        f"gens-halo-ring-uneven-{n}" if uneven else f"gens-halo-ring-{n}",
        n,
        put=lambda w: ring.place(gens.states_from_levels(w, rule)),
        fetch=_gens_fetch(ring,
                          lambda s: gens.levels_from_states(s, rule)),
        step_n=halo.dense_step_n(ring, deep, local, count_fn),
        one_turn=one_turn,
        count=lambda w: ring.count(w, count_fn),
        diff=changed,
        mask=changed,
        packed=False,
        alive_mask=_gens_alive_mask,
    )


def packable_gens_sharded(height: int, shards: int) -> bool:
    """Packed gens strips must be whole 32-row words (the packed Life
    ring's geometry)."""
    return packable_sharded(height, shards)


def packable_gens_sharded_uneven(height: int, shards: int) -> bool:
    """Word-granular balanced split for the gens planes (the packed Life
    ring's, applied to the plane stacks)."""
    return packable_sharded_uneven(height, shards)


def gens_local_block_mode(strip_words: int, width: int, rule: GenRule,
                          on_card: bool, force: bool | None = None,
                          max_h: int | None = None) -> tuple:
    """(ghost word-rows h, mode) of a packed Generations ring's deep
    blocks — `packed_halo`'s planner with kernel C for ``whole`` and
    C shared-memory copies of a kernel-D tile."""
    from gol_tpu_torch.ops import cuda_bitgens as cg

    return plan_local_blocks(
        strip_words, width, on_card, force, rule.states,
        lambda h, w: cg.fits_cuda_gens(h, w, rule), max_h)


def _packed_gens_ring(rule: GenRule, devices: list, height: int,
                      width: int, force_local_kernel, name: str):
    """The one constructor of the even and the balanced packed gens ring."""
    from gol_tpu_torch.parallel.stepper import _gens_alive_mask, _planes_xor

    n = len(devices)
    size, real = balanced_words(height, n)
    ring = halo.Ring(devices, "gens_packed_ring", "planes",
                     (rule.states - 1, n * size, width), real)
    on_card = ring.devices[0].type == "cuda"
    plan = gens_local_block_mode(size, width, rule, on_card,
                                 force_local_kernel, max_h=min(real))
    turn = turn_stepper(rule, plan[1])

    def count_fn(planes):
        return bitlife.count_packed(planes[0])

    def one_turn(world):
        return ring.block(world, 1, turn)

    def xor(old, new):
        return ring.diff(old, new, _planes_xor)

    def to_levels(words):
        return gens.levels_from_states(
            bitgens.unpack_states(words, height, rule), rule)

    return halo._ring_stepper(
        name, n,
        put=lambda w: ring.place(bitgens.pack_states(
            gens.states_from_levels(w, rule), rule)),
        fetch=_gens_fetch(ring, to_levels),
        step_n=packed_step_n(ring, plan, rule, count_fn),
        one_turn=one_turn,
        count=lambda w: ring.count(w, count_fn),
        diff=xor,
        mask=lambda old, new: bitlife.unpack(xor(old, new), height) != 0,
        packed=True,
        alive_mask=_gens_alive_mask,
    )


def packed_gens_sharded_stepper(rule: GenRule, devices: list, height: int,
                                width: int,
                                force_local_kernel: bool | None = None):
    """Packed sharded Generations: (C-1, H/32, W) one-hot planes, the
    word-row axis in contiguous strips across `devices`."""
    n = len(devices)
    if not packable_gens_sharded(height, n):
        raise ValueError(
            f"height {height} not packable into {n} whole-word strips"
        )
    return _packed_gens_ring(rule, devices, height, width,
                             force_local_kernel,
                             f"gens-packed-halo-ring-{n}")


def packed_gens_sharded_stepper_uneven(rule: GenRule, devices: list,
                                       height: int, width: int,
                                       force_local_kernel: bool | None = None):
    """Balanced-split packed Generations ring: (C-1, n*Sw, W) planes,
    each shard owning the first `real` word-rows of its strip, padding
    zero (the packed Life ring's balanced split, per plane)."""
    n = len(devices)
    if not packable_gens_sharded_uneven(height, n):
        raise ValueError(
            f"height {height} not balance-packable over {n} shards"
        )
    return _packed_gens_ring(rule, devices, height, width,
                             force_local_kernel,
                             f"gens-packed-halo-ring-uneven-{n}")

