"""2-D mesh packed stepping — word-row x word-column sharding with
mesh-axis-generic halo exchange.

The counterpart of `gol_tpu.parallel.mesh2d`. Each mesh cell (r, c) of
a ``rows x cols`` `partition.Mesh` owns an (Hw/rows, W/cols) block of
the (H/32, W) packed board (Generations: every plane's block), and one
turn exchanges

- COLUMN ghosts first: each block takes its left and right neighbours'
  edge columns along ``cols``, giving the (HwL, WL+2) extended block;
- then ROW ghosts: the neighbours' extended blocks' edge word-rows along
  ``rows`` — they already carry the column ghosts, so the CORNER words
  arrive in two hops with no corner exchange.

The (HwL+2, WL+2) block then steps ONE toroidal turn and its interior
is sliced back out: the block's own wrap only touches ghost cells,
which are discarded (the lane-split argument of `ops/lanes.py`, in both
directions). On a CUDA device that turn is one launch of kernel A (a
Generations rule: kernel C), or of kernel B's (D's) 2-D entry where the
block is too big for one block's shared memory
(`cuda_bitlife.step_n_packed_kernel_raw`,
`cuda_bitgens.step_n_packed_gens_kernel_raw`); on the CPU their plain
versions. A Generations block extends every plane (gol_tpu sends the
alive plane only; the ghost cells' outputs are discarded either way).
When a mesh axis has size 1 the neighbour IS the block itself and the
ghost is the toroidal wrap, so ``1xN`` and ``Nx1`` meshes collapse to
rings bit-exactly.

Per-turn exchange only — no deep blocks, as in gol_tpu. Its
`mesh_halo_step_packed` / `_gens` and `_carries` are `mesh_halo_step`
here: the row ghosts feed the kernel's own vertical carries.

The world's spec comes from the partition table (with the operator's
overrides): a dimension left unsplit is whole on every cell of that
mesh axis (the table obeys — a replicated world is legal, just
redundant), and the alive count then sums only one copy of each block.
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.rules import GenRule, Rule
from gol_tpu_torch.ops import bitgens, bitlife, generations as gens
from gol_tpu_torch.ops.bitlife import WORD
from gol_tpu_torch.parallel import halo, partition
from gol_tpu_torch.parallel.partition import AXIS_COLS, AXIS_ROWS


def packable_mesh2d(height: int, width: int, rows: int, cols: int) -> bool:
    """True when the (H/32, W) word grid splits into whole
    (Hw/rows, W/cols) blocks — every shard owns at least one whole
    word-row and one word-column."""
    if height % WORD:
        return False
    hw = height // WORD
    return (hw % rows == 0 and hw >= rows
            and width % cols == 0 and width >= cols)


def _extend(parts, mesh: partition.Mesh) -> list:
    """Every own cell's block extended by one ghost word-row and column
    a side: column ghosts first, then the corner-complete row ghosts;
    None for the cells of other processes. Each round of ghosts is one
    `partition.move`."""
    R, C = mesh.rows, mesh.cols
    cells = range(R * C)

    def routes(src_of, take):
        return [(src_of(i), i, take) for i in cells]

    def left(i):
        return (i // C) * C + (i % C - 1) % C

    def right(i):
        return (i // C) * C + (i % C + 1) % C

    ghosts = partition.move(
        mesh, parts,
        routes(left, lambda p: p[..., -1:])
        + routes(right, lambda p: p[..., :1]))
    cols_ext = [None if parts[i] is None else
                torch.cat([ghosts[i], parts[i], ghosts[R * C + i]], dim=-1)
                for i in cells]
    ghosts = partition.move(
        mesh, cols_ext,
        routes(lambda i: ((i // C - 1) % R) * C + i % C,
               lambda p: p[..., -1:, :])
        + routes(lambda i: ((i // C + 1) % R) * C + i % C,
                 lambda p: p[..., :1, :]))
    return [None if cols_ext[i] is None else
            torch.cat([ghosts[i], cols_ext[i], ghosts[R * C + i]], dim=-2)
            for i in cells]


def mesh_halo_step(parts, mesh: partition.Mesh, turn) -> list:
    """One turn of every own cell's block: extend, step `turn`, slice."""
    return [None if ext is None else turn(ext)[..., 1:-1, 1:-1].contiguous()
            for ext in _extend(parts, mesh)]


def mesh2d_halo_cost(rows: int, cols: int, hw: int, width: int,
                     links: tuple | None = None):
    """Traffic accounting of a rows x cols mesh stepping a (hw, width)
    word board per-turn — the `Stepper.halo_cost` hook, gol_tpu's
    formula: every turn each device sends 2 ghost word-columns (HwL
    words each) and 2 ghost word-rows (WL+2 words each);
    `bytes_per_host` prices the ``rows``-axis traffic ONE mesh row
    emits. `links` = (column ghosts, row ghosts) a turn that the
    counters price: 2·rows·cols each by default; in a multi-process job
    only those that cross processes (`mesh_links`)."""
    col_words = 2 * (hw // rows)
    row_words = 2 * (width // cols + 2)
    cells = rows * cols
    col_links, row_links = links or (2 * cells, 2 * cells)

    def halo_cost(world, k, per_turn: bool = False) -> dict:
        del world, per_turn  # always per-turn
        k = max(int(k), 0)
        return {
            "exchanges": (col_links + row_links) * k,
            "bytes": (col_words * col_links + row_words * row_links)
            * 2 * k,
            "bytes_per_host": row_words * 4 * cols * k,
        }

    return halo_cost


def mesh_links(mesh: partition.Mesh) -> tuple | None:
    """(column, row) ghost slabs a turn that cross processes in a
    multi-process job's mesh; None in one process."""
    if mesh.owners is None:
        return None
    R, C, own = mesh.rows, mesh.cols, mesh.owners
    col = sum(own[r * C + c] != own[r * C + (c + d) % C]
              for r in range(R) for c in range(C) for d in (-1, 1))
    row = sum(own[r * C + c] != own[((r + d) % R) * C + c]
              for r in range(R) for c in range(C) for d in (-1, 1))
    return col, row


def _mesh_stepper(name: str, rule, devices: list, height: int, width: int,
                  rows: int, cols: int, family: str, array: str,
                  rules: str | None, host_state, to_host, count_fn,
                  diff_fn):
    """The one constructor of both mesh families: `host_state(levels)` is the
    global packed state on the host, `to_host(words)` its inverse,
    `count_fn` a block's alive count and `diff_fn(old, new)` a block's
    changed-cell words."""
    from gol_tpu_torch.parallel.packed_halo import turn_stepper
    from gol_tpu_torch.parallel.stepper import _gens_alive_mask

    if not packable_mesh2d(height, width, rows, cols):
        raise ValueError(
            f"grid {height}x{width} not packable over a {rows}x{cols} "
            f"mesh (needs whole word-rows per mesh row and whole "
            f"columns per mesh column)"
        )
    table = partition.table_for(family, rules)
    mesh = partition.mesh2d(devices, rows, cols)
    ndim = 3 if array == "planes" else 2
    sharding = table.sharding(mesh, array, ndim=ndim)
    full = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    if (any(a is not None for a in full[:-2])
            or full[-2] not in (AXIS_ROWS, None)
            or full[-1] not in (AXIS_COLS, None)):
        raise partition.PartitionError(
            f"mesh backend {name!r} splits board rows on {AXIS_ROWS!r} "
            f"and columns on {AXIS_COLS!r}; the table gives {array!r} "
            f"the spec {sharding.spec}"
        )
    diff_sharding = partition.Sharding(mesh, full[-2:])
    # One copy of each block counts: the cells at index 0 of every mesh
    # axis the world is not split on.
    owners = [r * cols + c for r, c in sharding.cells()
              if (full[-2] or r == 0) and (full[-1] or c == 0)]
    turn = turn_stepper(rule, "kernel")

    def one_turn(world):
        return world.replace(mesh_halo_step(world.parts, mesh, turn))

    def count(world):
        return halo.ring_sum([None if world.parts[i] is None
                              else count_fn(world.parts[i])
                              for i in owners], mesh)

    def step_n(world, k):
        for _ in range(max(int(k), 0)):
            world = one_turn(world)
        return world, count(world)

    def diff(old, new):
        parts = [None if a is None else diff_fn(a, b)
                 for a, b in zip(old.parts, new.parts)]
        return diff_sharding.gather(parts, old.shape[-2:])

    def fetch(a):
        if isinstance(a, partition.Sharded):
            return to_host(a.numpy())
        return halo.host_array(a)

    return halo._ring_stepper(
        name, len(devices),
        put=lambda w: sharding.place(host_state(w)),
        fetch=fetch,
        step_n=step_n,
        one_turn=one_turn,
        count=count,
        diff=diff,
        mask=lambda old, new: bitlife.unpack(diff(old, new), height) != 0,
        packed=True,
        halo_cost=mesh2d_halo_cost(rows, cols, height // WORD, width,
                                   mesh_links(mesh)),
        alive_mask=_gens_alive_mask if isinstance(rule, GenRule) else None,
    )


def mesh2d_packed_stepper(rule: Rule, devices: list, height: int,
                          width: int, rows: int, cols: int,
                          rules: str | None = None):
    """Packed Life over a rows x cols device mesh: the (H/32, W) int32
    board in blocks the partition table resolves, per-turn two-axis
    ghost exchange; the full diff surface (dense / sparse / compact
    scans) rides the same per-turn step."""
    return _mesh_stepper(
        f"packed-mesh2d-{rows}x{cols}", rule, devices, height, width,
        rows, cols, "packed_mesh2d", "world", rules,
        host_state=bitlife.pack_np,
        to_host=lambda words: bitlife.unpack_np(words, height),
        count_fn=bitlife.count_packed,
        diff_fn=torch.bitwise_xor,
    )


def mesh2d_packed_gens_stepper(rule: GenRule, devices: list, height: int,
                               width: int, rows: int, cols: int,
                               rules: str | None = None):
    """Packed Generations over a rows x cols mesh: (C-1, H/32, W)
    one-hot planes, the plane axis unsplit, word blocks as the Life
    variant."""
    from gol_tpu_torch.parallel.stepper import _planes_xor

    return _mesh_stepper(
        f"gens-packed-mesh2d-{rows}x{cols}", rule, devices, height, width,
        rows, cols, "gens_mesh2d", "planes", rules,
        host_state=lambda w: bitgens.pack_states(
            gens.states_from_levels(w, rule), rule),
        to_host=lambda words: gens.levels_from_states(
            bitgens.unpack_states(words, height, rule), rule),
        count_fn=lambda planes: bitlife.count_packed(planes[0]),
        diff_fn=_planes_xor,
    )
