"""Bit-packed row-strip sharding with ring halo exchange — the packed
Life ring.

The counterpart of `gol_tpu.parallel.packed_halo`. Each shard holds a
strip of whole 32-row words (`(Sw, W)` int32, gol_tpu's uint32 bits);
a non-divisor shard count runs the word-granular balanced split
(`balanced_words`: shard i owns the first `real[i]` word-rows of its
Sw-row block, the padding word-row zero).

Communication-avoiding deep blocks: a ghost word-row is 32 complete
rows, so ONE exchange of h edge word-rows buys 32·h exact local turns
of the ghost-extended block (`halo.ring_block`). How a shard steps its
extended block is the LOCAL-BLOCK PLAN `(h, mode)` — the port's own
planner (`local_block_mode`), built on this package's kernel plans
instead of gol_tpu's VMEM budget and Pallas tile plans:

- ``whole``: kernel A (`cuda_bitlife.step_n_packed_cuda_raw`) takes the
  extended block at h = DEEP_WORDS (capped by the strip): one launch a
  block, any turn count in it;
- ``tiled``: kernel B's strip entry (`step_n_packed_tiled_raw`) with
  an h-word halo: one launch of 32·h turns a block;
- ``tiled2d``: kernel B's 2-D entry (`step_n_packed_tiled2d_raw`): h
  launches of 32 turns a block;
- ``plain``: the plain SWAR step (`bitlife.step_n_packed_raw`) with
  one-word ghosts — 32-turn blocks and per-turn steps for the rest, as
  gol_tpu's ``xla`` mode. Only on the CPU: on a CUDA device the
  planner never returns it.

Between tiled and tiled2d (and their depths) `search_local_block_mode`
scores each plan by the useful cell-turns it delivers per microsecond
under a small cost model (`_block_rate`). `force_local_kernel` is
gol_tpu's `force_local_pallas`: None takes the kernel plan on a CUDA
device and ``plain`` on the CPU; True takes the kernel plan everywhere
(on the CPU its wrappers run their plain versions — the counterpart of
`interpret=True`); False takes ``plain``, which a CUDA device refuses.
The remainder of a chunk past whole blocks runs as ONE partial block
at the full depth in the kernel modes, per-turn in ``plain``.

A single turn — `step`, `step_with_diff` and every turn of the diff
scans — is the per-turn halo step: a one-word-row exchange and one
turn of the (Sw + 2, W) block, on a CUDA device one launch of kernel A,
or of kernel B's 2-D entry where A does not take the block
(`cuda_bitlife.step_n_packed_kernel_raw`).

gol_tpu's `halo_step_packed` / `halo_step_packed_balanced` are that
per-turn step (`halo.ring_block` at depth 1), its `deep_block`s
`ring_block` at depth h, and `strip_padding` is `halo.strip_padding`.
`replicate_rows` / `replicate_compact` have no counterpart: the sparse
and compact rows are built on the ring's first device from the
gathered canonical diff, so every reader finds them there.
"""

from __future__ import annotations

import numpy as np
import torch

from gol_tpu_torch.models.rules import GenRule, Rule
from gol_tpu_torch.ops import bitlife
from gol_tpu_torch.ops.bitlife import WORD
from gol_tpu_torch.parallel import halo, partition

#: Ghost slab depth (word-rows per side) of the ``whole`` local blocks:
#: gol_tpu's DEEP_WORDS, 128 local turns an exchange.
DEEP_WORDS = 4
#: Ghost depths the kernel-B plans are searched over (kernel B's halo
#: stops at cuda_bitlife.MAX_HALO_WORDS = 8).
SEARCH_DEPTHS = (1, 2, 4, 8)
#: The planner's cost model: cells kernel B steps a microsecond,
#: counting its ghost frame (a 16384² board's 32-turn pass with its
#: 34 x 320 frames per 32 x 256 tile in the 0.72 ms that chip_smoke.py's
#: `measure` phase reported on an H100: 16384² x 32 x 1.33 / 720 µs),
#: and the fixed cost of a launch and of one exchange (slices, copies
#: and the concatenation of one extended block). A model for ranking
#: plans, not a measurement of any of them.
CELLS_PER_US = 16e6
LAUNCH_US = 4.0
EXCHANGE_US = 10.0


def packable_sharded(height: int, shards: int) -> bool:
    """Each strip must be a whole number of words."""
    return (
        shards > 0
        and height % shards == 0
        and (height // shards) % WORD == 0
    )


def packable_sharded_uneven(height: int, shards: int) -> bool:
    """The word-granular balanced split: every shard owns at least one
    whole word, and the word-rows do not divide the shard count (the
    divisors are the even ring's)."""
    return (
        shards > 1
        and height % WORD == 0
        and (height // WORD) // shards >= 1
        and (height // WORD) % shards != 0
    )


def balanced_words(height: int, n: int) -> tuple:
    """(Sw, real_list) of the word-granular balanced split: every
    shard's physical strip is Sw = ceil(total_words/n) word-rows; shard
    i really owns Sw words iff i < total_words mod n, else Sw-1."""
    return halo.balanced_rows(height // WORD, n)


def _block_rate(strip_words: int, width: int, h: int, mode: str,
                geom) -> float:
    """Useful cell-turns a microsecond of one deep block of kernel B
    under `geom` (the cost model above)."""
    turns = WORD * h
    launches = 1 if mode == "tiled" else -(-turns // geom.turns)
    frame = ((geom.tile_rows + 2 * geom.halo) / geom.tile_rows
             * (geom.tile_cols + 2 * geom.ghost) / geom.tile_cols)
    computed = (strip_words + 2 * h) * WORD * width * turns * frame
    us = computed / CELLS_PER_US + launches * LAUNCH_US + EXCHANGE_US
    return strip_words * WORD * width * turns / us


def search_local_block_mode(strip_words: int, width: int, copies: int,
                            fits_whole, max_h: int | None = None):
    """The best kernel plan (h, mode) of a shard's deep blocks, or None
    when none fits: ``whole`` at h = DEEP_WORDS (capped) when
    `fits_whole(ext_height, width)` takes the extended block, else the
    best-scoring kernel-B plan (`_block_rate`) over SEARCH_DEPTHS, with
    `copies` shared-memory copies of a tile (2 for Life, C for a
    Generations rule). h never passes the strip or `max_h` (every ghost
    comes whole from ONE neighbour)."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    cap = min(strip_words, max_h if max_h is not None else strip_words)
    if cap < 1:
        return None
    h = min(DEEP_WORDS, cap)
    if fits_whole((strip_words + 2 * h) * WORD, width):
        return h, "whole"
    best = None
    for h in SEARCH_DEPTHS:
        if h > min(cap, cb.MAX_HALO_WORDS):
            break
        e = strip_words + 2 * h
        for mode in ("tiled2d", "tiled"):
            try:
                geom = (cb._tiled2d_geometry(e, width, None, copies)
                        if mode == "tiled2d"
                        else cb._tile_plan(e, width, None, h, copies))
            except ValueError:
                continue
            rate = _block_rate(strip_words, width, h, mode, geom)
            if best is None or rate > best[0]:
                best = (rate, h, mode)
    return None if best is None else best[1:]


def plan_local_blocks(strip_words: int, width: int, on_card: bool,
                      force: bool | None, copies: int, fits_whole,
                      max_h: int | None = None) -> tuple:
    """(h, mode) under `force` (see the module docstring); raises for a
    ``plain`` request on a CUDA device and for a block no kernel plan
    takes, naming its shape."""
    if force is False:
        if on_card:
            raise ValueError(
                "force_local_kernel=False asks for plain local blocks, "
                "which run on the CPU only"
            )
        return 1, "plain"
    if not (on_card or force):
        return 1, "plain"
    found = search_local_block_mode(strip_words, width, copies,
                                    fits_whole, max_h)
    if found is None:
        raise ValueError(
            f"ring block of {strip_words} word-rows x {width} columns "
            f"({copies} copies) fits no kernel plan"
        )
    return found


def local_block_mode(strip_words: int, width: int, on_card: bool,
                     force: bool | None = None,
                     max_h: int | None = None) -> tuple:
    """(ghost depth h, mode) of a packed Life ring's deep blocks."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    return plan_local_blocks(strip_words, width, on_card, force, 2,
                             cb.fits_cuda_packed, max_h)


def local_stepper(rule, mode: str, h: int):
    """(ext, turns) -> ext stepped `turns` toroidal turns by the mode's
    entry — kernels A/B for a Life-like rule, C/D for a Generations
    rule; each a CUDA launch on a CUDA tensor, its plain version on a
    CPU one."""
    from gol_tpu_torch.ops import bitgens
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb

    gens = isinstance(rule, GenRule)
    if mode == "plain":
        fn = bitgens.step_n_packed_gens_raw if gens else bitlife.step_n_packed_raw
    elif mode == "whole":
        fn = cg.step_n_packed_gens_cuda_raw if gens else cb.step_n_packed_cuda_raw
    elif mode == "tiled":
        tiled = (cg.step_n_packed_gens_tiled_raw if gens
                 else cb.step_n_packed_tiled_raw)
        return lambda ext, turns: tiled(ext, turns, rule, halo_words=h)
    elif mode == "tiled2d":
        fn = (cg.step_n_packed_gens_tiled2d_raw if gens
              else cb.step_n_packed_tiled2d_raw)
    else:
        raise ValueError(f"unknown local block mode {mode!r}")
    return lambda ext, turns: fn(ext, turns, rule)


def turn_stepper(rule, mode: str):
    """ext -> ext one turn on: the plain step for a ``plain`` plan, else
    the kernel the extended block's shape takes (A/C, else the 2-D entry
    of B/D)."""
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb

    if mode == "plain":
        return lambda ext: local_stepper(rule, "plain", 1)(ext, 1)
    if isinstance(rule, GenRule):
        return lambda ext: cg.step_n_packed_gens_kernel_raw(ext, 1, rule)
    return lambda ext: cb.step_n_packed_kernel_raw(ext, 1, rule)


def packed_step_n(ring: halo.Ring, plan: tuple, rule, count_fn):
    """The packed rings' `step_n` (Life and Generations): k // (32h)
    deep blocks of 32h turns, then the remainder — one partial block at
    depth h in the kernel modes, per-turn steps in ``plain``."""
    h, mode = plan
    local = local_stepper(rule, mode, h)

    def step_n(world, k):
        big, k2 = divmod(max(int(k), 0), WORD * h)
        for _ in range(big):
            world = ring.block(world, h, lambda e: local(e, WORD * h))
        if mode == "plain":
            for _ in range(k2):
                world = ring.block(world, 1, lambda e: local(e, 1))
        elif k2:
            world = ring.block(world, h, lambda e: local(e, k2))
        return world, ring.count(world, count_fn)

    return step_n


def packed_ring_halo_cost(n: int, plan: tuple):
    """Ring-traffic accounting of a packed ring — the `Stepper.halo_cost`
    hook: gol_tpu's formula over the (h, mode) plan `step_n` runs, so
    the priced exchanges are the dispatched ones; bytes are int32
    word-rows (4W per word-row per direction), both directions, summed
    over `n` ring boundaries (all shards; in a multi-process job those
    between processes, `halo.Ring.links`). `per_turn=True` prices the
    single-turn entries and
    the diff scans, one edge word-row a turn."""
    h, mode = plan

    def halo_cost(world, k, per_turn: bool = False) -> dict:
        k = max(int(k), 0)
        w = int(world.shape[-1])
        if per_turn:
            sends, word_rows = 2 * k, 2 * k
        else:
            big, k2 = divmod(k, WORD * h)
            rem, part = (k2, 0) if mode == "plain" else (0, 1 if k2 else 0)
            sends = 2 * (big + part + rem)
            word_rows = 2 * ((big + part) * h + rem)
        return {"exchanges": sends * n, "bytes": word_rows * w * 4 * n}

    return halo_cost


def _packed_ring(rule: Rule, devices: list, height: int, width: int,
                 force_local_kernel, name: str):
    """The one constructor of the even and the balanced packed Life ring."""
    n = len(devices)
    size, real = balanced_words(height, n)
    ring = halo.Ring(devices, "packed_ring", "world", (n * size, width),
                     real)
    on_card = ring.devices[0].type == "cuda"
    plan = local_block_mode(size, width, on_card, force_local_kernel,
                            max_h=min(real))
    turn = turn_stepper(rule, plan[1])

    def one_turn(world):
        return ring.block(world, 1, turn)

    def xor(old, new):
        return ring.diff(old, new, torch.bitwise_xor)

    def fetch(a):
        if isinstance(a, partition.Sharded):
            return bitlife.unpack_np(ring.canonical(a), height)
        return halo.host_array(a)

    return halo._ring_stepper(
        name, n,
        put=lambda w: ring.place(bitlife.pack_np(w)),
        fetch=fetch,
        step_n=packed_step_n(ring, plan, rule, bitlife.count_packed),
        one_turn=one_turn,
        count=lambda w: ring.count(w, bitlife.count_packed),
        diff=xor,
        mask=lambda old, new: bitlife.unpack(xor(old, new), height) != 0,
        packed=True,
        halo_cost=packed_ring_halo_cost(ring.links, plan),
    )


def packed_sharded_stepper(rule: Rule, devices: list, height: int,
                           width: int,
                           force_local_kernel: bool | None = None):
    """Stepper whose world lives packed AND row-sharded: (H/32, W) int32
    in contiguous word-row strips across `devices`, deep blocks stepped
    by the plan `local_block_mode` gives."""
    n = len(devices)
    if not packable_sharded(height, n):
        raise ValueError(
            f"height {height} not packable into {n} whole-word strips"
        )
    return _packed_ring(rule, devices, height, width, force_local_kernel,
                        f"packed-halo-ring-{n}")


def packed_sharded_stepper_uneven(rule: Rule, devices: list, height: int,
                                  width: int,
                                  force_local_kernel: bool | None = None):
    """The balanced-split variant of `packed_sharded_stepper` for
    non-divisor shard counts: (n*Sw, W) packed word-rows, each shard's
    real rows at the top of its strip, padding zero; `put` / `fetch` and
    the diff entries speak the canonical layout. h is capped at the
    shortest shard."""
    n = len(devices)
    if not packable_sharded_uneven(height, n):
        raise ValueError(
            f"height {height} not balance-packable over {n} shards"
        )
    return _packed_ring(rule, devices, height, width, force_local_kernel,
                        f"packed-halo-ring-uneven-{n}")
