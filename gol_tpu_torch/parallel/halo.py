"""Row-strip sharding with ring halo exchange — the dense ring, and the
ring machinery every sharded backend shares.

The counterpart of `gol_tpu.parallel.halo`. The board is split into
contiguous row strips over a 1-D ring of devices (`partition.ring_mesh`;
a device may repeat, so ``[cuda:0] * 4`` is a 4-shard ring on one card,
its shards stepped one after another). gol_tpu steps the strips under
`shard_map` and swaps edges with `lax.ppermute`; here a world is a
`partition.Sharded` — one tensor per shard — and `edge_exchange` slices
each shard's neighbours' edge rows and copies them to its device.

Communication-avoiding deep blocks, as in gol_tpu: exchange `depth`
edge rows once, step the ghost-extended strip `depth` exact turns with
the plain toroidal step (its wrap only corrupts rows whose validity the
one-row-per-turn shrink already wrote off), slice the strip back out.
A per-turn halo step is the same construction at depth 1 for one turn,
so `ring_block` is the one local-step routine of every ring family:

- balanced splits (height not a multiple of the shard count): every
  shard holds S rows, shard i owns the first `real[i]` of them; the
  slab sent down the ring starts at real - depth, the ghost from below
  is spliced in right after the last real row, and padding rows are
  zeroed after the step — gol_tpu's `deep_block_uneven` layout, with
  `real` a Python int per shard instead of a traced `axis_index`;
- the dense ring's ghost-extended strips step through kernel E
  (`ops/cuda_life.step_n_cuda_dense`) on a CUDA device, through its
  plain version (`life.step_n`) on the CPU. The ring's state is the
  {0,255} board, kernel E's own representation, so no bit conversion
  stands between the two.

gol_tpu's `cpu_serializing_sync` keeps at most one ring program in
flight on XLA's CPU runtime, whose concurrent collectives can starve
each other. What it guarantees — a ring dispatch's every shard step
has run before the next dispatch's first — holds here by construction:
a dispatch is a sequence of tensor operations issued from the calling
thread, which the CPU executes in order and a CUDA stream executes in
the order issued (cross-device copies are ordered on both devices' current
streams). There is no collective to rendezvous, so nothing blocks.

The alive count is the sum of the shards' counts on the first device
(`psum`'s counterpart).

gol_tpu's per-turn and deep-block functions are one routine here:
`halo_step_bits` / `halo_step_bits_uneven` are `ring_block` at depth 1
for one turn, `deep_block_uneven` and the deep blocks of
`balanced_deep_step_n` are `ring_block` at depth `deep`, both under
`dense_step_n`; `_sharded_stepper_uneven` is `sharded_stepper` with a
non-divisor shard count (`balanced_rows`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gol_tpu_torch.models.rules import Rule
from gol_tpu_torch.parallel import partition

#: Deep-halo depth cap for the dense ring (gol_tpu's DEEP_ROWS): one
#: K-row exchange buys K exact local turns.
DEEP_ROWS = 16


def ring_perms(n: int) -> tuple[list, list]:
    """(down, up) permutation pairs of the closed n-ring — the single
    definition of ring orientation for every halo path."""
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    return down, up


def edge_exchange(parts: Sequence[torch.Tensor], devices: Sequence,
                  depth: int = 1, real: Optional[Sequence[int]] = None):
    """Each shard's ghost slabs: [(rows owned by the shard above, rows
    owned by the shard below)], `depth` rows each along axis -2, copied
    to the shard's device. Shard i's slab sent down the ring is its
    last `depth` REAL rows (`real[i]`, all its rows by default). Works
    for dense rows, packed word-rows and plane stacks alike."""
    n = len(parts)
    real = [p.shape[-2] for p in parts] if real is None else real
    down, up = ring_perms(n)
    above: list = [None] * n
    below: list = [None] * n
    for src, dst in down:
        above[dst] = parts[src][..., real[src] - depth:real[src], :].to(
            devices[dst])
    for src, dst in up:
        below[dst] = parts[src][..., :depth, :].to(devices[dst])
    return list(zip(above, below))


def ring_block(parts: Sequence[torch.Tensor], devices: Sequence,
               real: Sequence[int], depth: int,
               step_ext: Callable) -> list:
    """One `depth`-row ghost exchange and `step_ext(ext)` on every
    shard's ghost-extended block [above, real rows, below, padding];
    returns the new parts with the padding rows zero. `step_ext` steps
    the block's turns (at most `depth` per ghost row of light cone)."""
    out = []
    for p, r, (above, below) in zip(parts, real,
                                    edge_exchange(parts, devices, depth,
                                                  real)):
        size = p.shape[-2]
        pieces = [above, p[..., :r, :], below]
        if r < size:  # the padding rows, zero, behind the spliced ghost
            pieces.append(p[..., r:, :])
        new = step_ext(torch.cat(pieces, dim=-2))[..., depth:depth + size, :]
        if r < size:
            new = torch.cat([new[..., :r, :],
                             torch.zeros_like(new[..., r:, :])], dim=-2)
        out.append(new.contiguous())
    return out


def ring_sum(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' int32 scalars summed on `device` (`psum`)."""
    return torch.stack([v.to(device) for v in values]).sum(
        dtype=torch.int32)


def strip_padding(arr, size: int, real_list, axis: int = -2):
    """Cut the balanced split's padding out of a padded row axis:
    (..., n*size, ...) -> (..., sum(real), ...), keeping each shard's
    first real_list[i] rows (tensor or numpy alike)."""
    if all(r == size for r in real_list):
        return arr
    index = [slice(None)] * arr.ndim
    parts = []
    for i, real in enumerate(real_list):
        index[axis] = slice(i * size, i * size + real)
        parts.append(arr[tuple(index)])
    if isinstance(arr, torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def host_array(t) -> np.ndarray:
    """A device tensor on the host, int32 words viewed as gol_tpu's
    uint32 (bit for bit)."""
    host = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return host.view(np.uint32) if host.dtype == np.int32 else host


def balanced_rows(total: int, n: int) -> tuple:
    """(S, real_list) of the balanced split of `total` rows over n
    shards: every shard holds S = ceil(total/n) rows, shard i owns S iff
    i < total mod n, else S - 1 (all S when n divides total)."""
    size = -(-total // n)
    rem = total % n
    if rem == 0:
        return size, [size] * n
    return size, [size if i < rem else size - 1 for i in range(n)]


def pad_rows(host: np.ndarray, size: int, real_list, axis: int = -2):
    """The host array's rows laid out as the balanced split holds them:
    shard i's `real_list[i]` rows at the top of its `size`-row block,
    zeros below (the inverse of `strip_padding`)."""
    if all(r == size for r in real_list):
        return host
    shape = list(host.shape)
    shape[axis] = size * len(real_list)
    out = np.zeros(shape, host.dtype)
    src = [slice(None)] * host.ndim
    dst = [slice(None)] * host.ndim
    off = 0
    for i, real in enumerate(real_list):
        src[axis] = slice(off, off + real)
        dst[axis] = slice(i * size, i * size + real)
        out[tuple(dst)] = host[tuple(src)]
        off += real
    return out


class Ring:
    """The placement of one ring world: its mesh and sharding, the
    global (padded) shape, the per-shard rows `size` and owned rows
    `real` along the row axis (-2)."""

    def __init__(self, devices, family: str, array: str, shape: tuple,
                 real: Sequence[int]):
        self.mesh = partition.ring_mesh(devices)
        self.devices = self.mesh.devices
        self.n = len(self.devices)
        self.sharding = partition.table_for(family).sharding(
            self.mesh, array, ndim=len(shape))
        self.shape = tuple(shape)
        self.size = shape[-2] // self.n
        self.real = list(real)

    def place(self, host: np.ndarray) -> partition.Sharded:
        """A host array in the canonical layout -> the padded world."""
        return self.sharding.place(pad_rows(host, self.size, self.real))

    def canonical(self, world: partition.Sharded) -> np.ndarray:
        """The world on the host in the canonical layout (padding cut)."""
        return strip_padding(world.numpy(), self.size, self.real)

    def block(self, world, depth: int, step_ext) -> partition.Sharded:
        return world.replace(ring_block(world.parts, self.devices,
                                        self.real, depth, step_ext))

    def count(self, world, count_fn) -> torch.Tensor:
        return ring_sum([count_fn(p) for p in world.parts], self.devices[0])

    def diff(self, old, new, diff_fn) -> torch.Tensor:
        """`diff_fn` of each shard's old and new block, gathered on the
        first device in the canonical layout."""
        glued = torch.cat([diff_fn(a, b).to(self.devices[0])
                           for a, b in zip(old.parts, new.parts)], dim=-2)
        return strip_padding(glued, self.size, self.real)


def _ring_stepper(name: str, shards: int, put, fetch, step_n, one_turn,
                  count, diff, mask, packed: bool, halo_cost=None,
                  alive_mask=None):
    """Common wiring of every ring constructor: the single-turn entries from
    the per-turn halo step `one_turn`, the diff scans over it (the
    canonical per-turn `diff(old, new)` gathered on the first device, so
    the sparse and compact encodings and `fetch_diffs` need no
    balanced-split awareness), and the Stepper assembly — one
    definition, so the families cannot drift apart here."""
    from gol_tpu_torch.parallel.stepper import (
        Stepper,
        compact_scan_diffs,
        scan_diffs,
        sparse_scan_diffs,
    )

    def step_with_diff(world):
        new = one_turn(world)
        return new, mask(world, new), count(new)

    scan = (one_turn, diff, count)
    return Stepper(
        name=name,
        shards=shards,
        put=put,
        fetch=fetch,
        step=one_turn,
        step_n=step_n,
        step_with_diff=step_with_diff,
        alive_count_async=count,
        alive_mask=alive_mask,
        step_n_with_diffs=scan_diffs(*scan),
        fetch_diffs=host_array,
        packed_diffs=packed,
        step_n_with_diffs_sparse=sparse_scan_diffs(*scan) if packed else None,
        step_n_with_diffs_compact=(compact_scan_diffs(*scan) if packed
                                   else None),
        halo_cost=halo_cost,
    )


def dense_ring_halo_cost(n: int, deep: int):
    """Ring-traffic accounting for a dense ring of `n` shards with deep
    depth `deep` — the `Stepper.halo_cost` hook (gol_tpu's formula over
    the same block plan `step_n` runs; bytes are uint8 rows, both
    directions, summed over all shards). `per_turn=True` prices the
    single-turn entries and the diff scans, which exchange one edge row
    a turn."""

    def halo_cost(world, k, per_turn: bool = False) -> dict:
        k = max(int(k), 0)
        w = int(world.shape[-1])
        if per_turn or deep < 2:
            sends, rows = 2 * k, 2 * k
        else:
            blocks, rem = divmod(k, deep)
            sends = 2 * (blocks + rem)
            rows = 2 * (blocks * deep + rem)
        return {"exchanges": sends * n, "bytes": rows * w * n}

    return halo_cost


def dense_deep(height: int, n: int) -> int:
    """The dense ring's deep-block depth: DEEP_ROWS capped at the
    shortest shard (every ghost comes whole from ONE neighbour)."""
    size, real = balanced_rows(height, n)
    return min(DEEP_ROWS, min(real))


def dense_step_n(ring: Ring, deep: int, local, count_fn):
    """The dense rings' `step_n` (Life and Generations): k // deep deep
    blocks of `deep` turns, then per-turn halo steps; one exchange a
    block. `local(ext, turns)` steps a ghost-extended strip."""

    def step_n(world, k):
        k = max(int(k), 0)
        blocks, rem = divmod(k, deep) if deep >= 2 else (0, k)
        for _ in range(blocks):
            world = ring.block(world, deep, lambda e: local(e, deep))
        for _ in range(rem):
            world = ring.block(world, 1, lambda e: local(e, 1))
        return world, ring.count(world, count_fn)

    return step_n


def sharded_stepper(rule: Rule, devices: list, height: int, width: int):
    """Dense Life ring: the {0,255} uint8 board row-sharded across
    `devices`. Any (height, shard-count) pair is accepted: a non-divisor
    count runs the balanced split (`balanced_rows`), each shard's
    padding row kept dead. Deep blocks of `dense_deep` rows; on a CUDA
    device every local step is kernel E, and a strip kernel E cannot
    plan raises here."""
    from gol_tpu_torch.ops import cuda_life

    n = len(devices)
    size, real = balanced_rows(height, n)
    ring = Ring(devices, "dense_ring", "world", (n * size, width), real)
    deep = dense_deep(height, n)
    if ring.devices[0].type == "cuda":
        for rows in {size + 2 * deep, size + 2}:
            if not cuda_life.fits_cuda_dense(rows, width):
                raise ValueError(
                    f"dense ring strip {rows}x{width} does not fit "
                    "kernel E")

    def local(ext, turns):
        return cuda_life.step_n_cuda_dense(ext, turns, rule)

    def count_fn(p):
        return torch.count_nonzero(p).to(torch.int32)

    def fetch(a):
        if isinstance(a, partition.Sharded):
            return ring.canonical(a)
        return host_array(a)

    def one_turn(world):
        return ring.block(world, 1, lambda e: local(e, 1))

    uneven = any(r != size for r in real)
    return _ring_stepper(
        f"halo-ring-uneven-{n}" if uneven else f"halo-ring-{n}", n,
        put=lambda w: ring.place(np.asarray(w, np.uint8)),
        fetch=fetch,
        step_n=dense_step_n(ring, deep, local, count_fn),
        one_turn=one_turn,
        count=lambda w: ring.count(w, count_fn),
        diff=lambda old, new: ring.diff(old, new, torch.ne),
        mask=lambda old, new: ring.diff(old, new, torch.ne),
        packed=False,
        halo_cost=dense_ring_halo_cost(n, deep),
    )
