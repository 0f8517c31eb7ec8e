"""Packed Game of Life kernels in hand-written CUDA for Hopper.

The counterpart of `gol_tpu.ops.pallas_bitlife`. Every entry point
computes one function — (packed int32 board, n, rule) -> packed board
after n toroidal turns — and is held bit-exact against the plain
version `ops.bitlife.step_n_packed_raw`:

- `step_n_packed_cuda_raw`: kernel A (`bitlife_resident_grid` in
  csrc/bitlife.cu, csrc/grid.cuh) on one board, spread over the card as
  a persistent grid of small tiles (`_grid_plan`, one block an SM at
  most), each stepping its tile and a ghost frame in shared memory for
  rounds of 32 turns; the tiles trade their edges through global memory
  (L2) behind a barrier between rounds. Replaces
  `step_n_packed_pallas_raw`.
- `step_n_packed_batch_cuda_raw`: kernel A (`bitlife_resident`) on a
  (B, rows, cols) stack of boards of one shape, each board resident in
  the shared memory of one thread-block cluster of row slabs
  (`_cluster_plan`), whose blocks exchange their ghost rows every 32
  turns, all in one launch (the grid's z index picks the board): a
  stack fills the card with one cluster a board, and its boards must
  not wait at one barrier. Replaces the `jax.vmap` of the plain packed
  step with which gol_tpu's activity-tiled stepper steps its slab of
  ghost-extended tiles (gol_tpu/parallel/tiled.py), which is no Pallas
  kernel.
- `step_n_packed_tiled_raw` / `step_n_packed_tiled2d_raw`: kernel B
  (`bitlife_tiled`), temporally blocked tiles with ghost word-rows and
  ghost columns, k <= min(32*halo, ghost) turns per launch; B3/S23 is
  stepped by strip walkers (`_strip_plan`), its tiles moved as 16-byte
  row pieces where the shape allows (`_tile_form`), every other rule
  word by word as in kernel A. Replaces
  `step_n_packed_pallas_tiled_raw` and
  `step_n_packed_pallas_tiled2d_raw`; both keep their names and
  override knobs.

The TPU kernels' Mosaic blocking (8-sublane slices, VMEM budgets) is not
carried over; what is kept is the light cone: an h-word vertical halo
keeps a tile interior exact for 32*h turns, g ghost columns for g turns.

Wrappers: a CPU tensor runs the plain version; a CUDA tensor launches
the kernel (after device, dtype, shape and contiguity checks) or raises
— there is no fallback. Outputs are allocated with `torch.empty`, the
launch goes on the current stream, and the launcher's
`cudaGetLastError()` is checked after every launch. `LAUNCHES` counts
the launches of each kernel, `RESIDENT_PLANS` kernel A's by plan,
`TILE_LOADS` kernel B's by tile form.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gol_tpu_torch.models.rules import LIFE, Rule
from gol_tpu_torch.ops import bitlife, rulecomp
from gol_tpu_torch.ops.bitlife import WORD, pack, unpack
from gol_tpu_torch.ops.life import from_bits, to_bits

#: Dynamic shared memory one block may use on the H100 (227 KB).
SMEM_BYTES = 232_448
#: Streaming multiprocessors of the H100: the most blocks of kernel A's
#: grid plan, one an SM (chip_smoke.py checks it against the card's
#: `multi_processor_count`).
SMS = 132
#: The most threads of a block of kernel A's grid plan, and the most
#: words of an extended tile its B3/S23 body steps one a thread
#: (`kGridThreads` in csrc/grid.cuh).
GRID_THREADS = 1024
#: The most column walkers of a block of kernels A, C and E (`kWalkThreads`
#: in csrc/walk.cuh, whose launchers refuse more; their other rules run a
#: fixed 512).
WALK_THREADS = 640
#: Columns of a strip walker's work item, kernels B and D (`kStripCols`
#: in csrc/strip.cuh): one 16-byte shared-memory access a row.
STRIP_COLS = 4
#: The most strip walkers of a block of kernels B and D (`kStripThreads`
#: in csrc/strip.cuh, whose launchers refuse more).
STRIP_THREADS = 640
#: Shortest segment of a strip walker that is not a whole strip, in
#: word-rows (its three-row prologue spread over at least 4).
MIN_STRIP_ROWS = 4
#: The most blocks of kernel A's and C's cluster: the portable cluster
#: size, which every sm_90 card schedules (`kClusterBlocks` in
#: csrc/walk.cuh, whose launchers refuse more).
CLUSTER_BLOCKS = 8
#: Shortest segment of a column walker that is not a whole column, in
#: word-rows (its two-row prologue spread over at least 8).
MIN_SEG_ROWS = 8
#: Default tile of kernel B: 32 word-rows (1024 cells) x 256 columns.
TILE_ROWS = 32
TILE_COLS = 256
#: Turns bought per halo word-row (one bit-row of light cone per turn).
TILE_TURNS = WORD
#: Deepest halo the tiled entry point accepts (gol_tpu's bound).
MAX_HALO_WORDS = 8
#: Ghost columns per side of the 2-D entry point (one turn each).
GHOST_COLS = 32
#: Largest grid height CUDA accepts.
_MAX_GRID_Y = 65_535
#: Most boards of one batched launch of kernel A: CUDA's limit on the
#: grid's z size (`kMaxGridZ` in csrc/walk.cuh, whose launcher refuses
#: more).
MAX_BATCH = 65_535

#: Ghost columns a side of a tile of kernel A's grid plan: one round's
#: light cone (`kGridGhost` in csrc/grid.cuh).
GRID_GHOST = TILE_TURNS
#: Words of a strip a thread of the grid steps (B3/S23): the widest that
#: divides the tile's and the board's widths is taken.
GRID_WIDTHS = (1, 2, 4)

#: The combine forms of `rulecomp.compile_rule`, as kernel arguments.
COMBINE = {"b_subset": 0, "s_subset": 1, "general": 2}

#: Words of the bulk form's alignment and copy in kernels B and D
#: (`kBulkWords` in csrc/strip.cuh): 16 bytes.
BULK_WORDS = 4

#: Launches per kernel. Each wrapper adds one where it launches, and
#: nowhere else; callers reset the counts by assigning 0.
LAUNCHES = {"bitlife_resident": 0, "bitlife_tiled": 0}
#: Kernel A's launches by plan: "grid" (one board, `_grid_plan`) or
#: "cluster" (a stack, one cluster a board, `_cluster_plan`). One a
#: launch; callers reset the counts by assigning 0.
RESIDENT_PLANS = {"grid": 0, "cluster": 0}
#: Kernel B's launches by how the blocks move their tiles (`_tile_form`):
#: "bulk" (16-byte row pieces) or "words". One a launch, where the pass
#: picks the form; callers reset the counts by assigning 0.
TILE_LOADS = {"bulk": 0, "words": 0}


def rule_bits(rule) -> tuple:
    """(birth mask, survive mask) kernel arguments of any B/S or B/S/C
    rule: bit c of a mask is set when count c is in the rule's set."""
    birth = sum(1 << c for c in rule.birth if 0 <= c <= 8)
    survive = sum(1 << c for c in rule.survive if 0 <= c <= 8)
    return birth, survive


#: B3/S23's (birth, survive) masks: the rule kernel B's strip walkers run.
_LIFE_BITS = rule_bits(LIFE)


def rule_args(rule: Rule) -> tuple:
    """(birth mask, survive mask, combine form) kernel arguments."""
    return (*rule_bits(rule), COMBINE[rulecomp.compile_rule(rule).combine])


def _resident_bytes(rows: int, cols: int) -> int:
    return 2 * 4 * rows * cols  # two ping-pong copies of the board


def _cluster_plan(rows: int, cols: int, copies: int) -> tuple:
    """(blocks, slab_rows, halo) of kernel A's or C's cluster on a
    packed board of `rows` word-rows and `cols` columns: `blocks` row
    slabs of `slab_rows` word-rows, each with `halo` ghost word-rows a
    side and every column, `copies` copies of it in one block's shared
    memory. `blocks` is the largest divisor of `rows` up to
    CLUSTER_BLOCKS whose slab fits; `halo` is 1 when there are several
    blocks (a round of 32 turns between exchanges) and 0 for one, whose
    slab is the board and whose wrap is the torus. Every board whose
    `copies` copies fit one block has a plan."""
    for blocks in range(min(CLUSTER_BLOCKS, rows), 0, -1):
        halo = 1 if blocks > 1 else 0
        slab = rows // blocks
        if (rows % blocks == 0
                and copies * 4 * (slab + 2 * halo) * cols <= SMEM_BYTES):
            return blocks, slab, halo
    raise ValueError(
        f"packed board {rows}x{cols} needs {copies * 4 * rows * cols} bytes "
        f"of shared memory for {copies} copies, over the {SMEM_BYTES} one "
        f"block has"
    )


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Kernel A's grid plan of a packed board of `rows` x `cols` words:
    tiles of `tile_rows` word-rows x `tile_cols` columns, ceil-divided
    over the board (the last of a column or row ragged where the size
    does not divide), one block each, every tile with one ghost word-row
    and GRID_GHOST ghost columns a side; B3/S23 steps strips of `width`
    words of the extended tile a thread (1, 2 or 4, dividing the tile's
    and the board's widths), each moved in and out as one access."""

    rows: int
    cols: int
    tile_rows: int
    tile_cols: int
    width: int = 1

    def __post_init__(self):
        if not (1 <= self.tile_rows <= self.rows
                and 1 <= self.tile_cols <= self.cols):
            raise ValueError(f"a {self.tile_rows}x{self.tile_cols} tile "
                             f"does not fit a {self.rows}x{self.cols} board")
        if (self.width not in GRID_WIDTHS
                or self.tile_cols % self.width or self.cols % self.width):
            raise ValueError(f"strips of {self.width} words do not divide "
                             f"{self.tile_cols}-column tiles of a "
                             f"{self.cols}-column board")

    @property
    def tiles_y(self) -> int:
        return -(-self.rows // self.tile_rows)

    @property
    def tiles_x(self) -> int:
        return -(-self.cols // self.tile_cols)

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_x

    @property
    def ext_words(self) -> int:
        """Words of one extended tile: what a block steps a turn."""
        return (self.tile_rows + 2) * (self.tile_cols + 2 * GRID_GHOST)

    @property
    def exact(self) -> bool:
        """Whether the tiles divide the board (no ragged tile)."""
        return (self.rows % self.tile_rows == 0
                and self.cols % self.tile_cols == 0)


@functools.lru_cache(maxsize=None)
def _grid_plan(rows: int, cols: int) -> GridPlan:
    """Kernel A's grid plan of a packed board of `rows` word-rows and
    `cols` columns, from its shape and the card's SM count alone (no
    card needed): the tiles of fewest extended words a block — the work
    a block steps a turn, which bounds the turn — over at most SMS
    blocks; ties go to tiles that divide the board, then to the fewest
    word-rows a tile. Widths are whole 16-byte units (multiples of 4
    words) where the board's width is, and at least GRID_GHOST, so that
    the ghost columns reach only the next tile a side, unless one tile
    takes the whole width. A board with too few word-rows or columns for
    more tiles takes fewer, wider ones; a board of one word-row takes its
    own row as its ghost rows, through the wrap."""
    unit = 4 if cols % 4 == 0 else 1
    widths = {cols} | set(range(-(-min(GRID_GHOST, cols) // unit) * unit,
                                cols, unit))
    best = None
    for tile_rows in range(1, rows + 1):
        tiles_y = -(-rows // tile_rows)
        if tiles_y > SMS:
            continue
        for tile_cols in widths:
            plan = GridPlan(rows, cols, tile_rows, tile_cols)
            if plan.blocks > SMS:
                continue
            key = (plan.ext_words, not plan.exact, tile_rows, -tile_cols)
            if best is None or key < best[0]:
                best = key, plan
    return dataclasses.replace(best[1], width=_strip_width(best[1], 0))


def _strip_width(plan: GridPlan, ptrs: int) -> int:
    """The widest strip that divides `plan`'s tile and board widths and
    to whose bytes the buffers' addresses (OR-ed in `ptrs`) are
    aligned."""
    return max(w for w in GRID_WIDTHS
               if plan.tile_cols % w == plan.cols % w == ptrs % (4 * w) == 0)


def _resident_args(rows: int, cols: int, copies: int) -> tuple:
    """The cluster arguments of kernels A and C: (blocks, slab_rows,
    halo, threads, seg_rows), the walk plan of one slab last (the masks
    forms take their own block size)."""
    blocks, slab_rows, halo = _cluster_plan(rows, cols, copies)
    walk = _walk_plan(TileGeometry(slab_rows, cols, halo, 0, copies))
    return blocks, slab_rows, halo, *walk


def fits_cuda_packed(height: int, width: int) -> bool:
    """Kernel A eligibility: whole words, and two copies of the packed
    board within one block's shared memory (512² is 16 x 512 words,
    64 KiB for both copies) — the cluster's limit, which the grid plan
    keeps, so that one board and a stack of them route alike."""
    if not bitlife.packable(height, width):
        return False
    return _resident_bytes(height // WORD, width) <= SMEM_BYTES


def fits_cuda_packed_tiled(height: int, width: int) -> bool:
    """Kernel B, through either entry point, takes any packed board
    (tiles may be ragged at the board's edge)."""
    return bitlife.packable(height, width)


def _check_cuda(p: torch.Tensor, dims: int = 2) -> None:
    """Device, dtype, shape and contiguity checks of a packed kernel
    input: a `dims`-D int32 tensor on a CUDA device (2-D boards, 3-D
    plane stacks)."""
    if p.device.type != "cuda":
        raise ValueError(f"kernel input must be on a CUDA device, not {p.device}")
    if p.dtype != torch.int32:
        raise TypeError(f"packed board must be int32, got {p.dtype}")
    if p.dim() != dims or min(p.shape) < 1:
        raise ValueError(f"packed board must be {dims}-D, got shape {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("packed board must be contiguous")


def _stream(p: torch.Tensor) -> int:
    return torch.cuda.current_stream(p.device).cuda_stream


def _launch(launches: dict, name: str, like: torch.Tensor, *args,
            entry: str | None = None) -> None:
    """Launch kernel `name` through its C launcher, `<entry>_launch(*args,
    stream)` (`entry` defaults to `name`), on `like`'s device and current
    stream; count it in `launches[name]` and raise if the launcher
    reports a CUDA error."""
    from gol_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(like.device):
        code = getattr(lib, f"{entry or name}_launch")(*args, _stream(like))
        launches[name] += 1
    _build.check(lib, code, entry or name)


def _check_pass(src: torch.Tensor, dst: torch.Tensor, check) -> None:
    """A tiled pass's buffer checks on the card: `check` on each, and a
    separate output of the same shape (other tiles read this tile's
    ghosts from `src`)."""
    check(src)
    check(dst)
    if dst.shape != src.shape or dst.data_ptr() == src.data_ptr():
        raise ValueError("a tiled pass needs a separate output of the same shape")


def step_n_packed_cuda_raw(p: torch.Tensor, n: int,
                           rule: Rule = LIFE) -> torch.Tensor:
    """`n` turns, packed int32 in / packed int32 out, one launch of
    kernel A as the persistent grid of `_grid_plan` (the board spread
    over the card in small tiles, rounds of 32 turns)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if p.device.type == "cpu":
        return bitlife.step_n_packed_raw(p, n, rule)
    _check_cuda(p)
    return _grid_pass(p, n, rule, _grid_plan(*p.shape))


def _grid_pass(p: torch.Tensor, n: int, rule: Rule,
               plan: GridPlan) -> torch.Tensor:
    """One launch of kernel A's grid on the card's board `p` with
    `plan`'s tiles, the grid's barrier between rounds: the output and,
    when n takes more than one round, a scratch board, both allocated
    here; the kernel allocates nothing."""
    rows, cols = p.shape
    out = torch.empty_like(p)
    scratch = None
    ptrs = p.data_ptr() | out.data_ptr()
    if n > TILE_TURNS:
        scratch = torch.empty_like(p)
        ptrs |= scratch.data_ptr()
    if ptrs % (4 * plan.width):
        plan = dataclasses.replace(plan, width=_strip_width(plan, ptrs))
    _launch(LAUNCHES, "bitlife_resident", p, p.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), rows, cols, n,
            *rule_args(rule), plan.tile_rows, plan.tile_cols, plan.width,
            entry="bitlife_resident_grid")
    RESIDENT_PLANS["grid"] += 1
    return out


def step_n_packed_batch_cuda_raw(stack: torch.Tensor, n: int,
                                 rule: Rule = LIFE,
                                 out: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """`n` toroidal turns of each board of a packed int32 (B, rows, cols)
    stack, one launch of kernel A for the whole stack: each board is one
    cluster of `_cluster_plan(rows, cols, 2)`, the grid's z index the
    board, so a batch costs one launch whatever B is (at most
    MAX_BATCH). `out`, when given, is a separate buffer of the stack's
    shape that receives the result (the cluster's blocks read their
    ghost rows from the input while others store)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if stack.dim() != 3 or min(stack.shape) < 1:
        raise ValueError(
            f"a batch must be a non-empty 3-D stack, got {tuple(stack.shape)}")
    if stack.shape[0] > MAX_BATCH:
        raise ValueError(f"a batch of {stack.shape[0]} boards is over the "
                         f"{MAX_BATCH} one launch takes")
    if stack.device.type == "cpu":
        got = bitlife.step_n_packed_raw(stack, n, rule)
        return got if out is None else out.copy_(got)
    _check_cuda(stack, 3)
    if out is None:
        out = torch.empty_like(stack)
    else:
        _check_pass(stack, out, lambda t: _check_cuda(t, 3))
    batch, rows, cols = stack.shape
    plan = _resident_args(rows, cols, 2)
    _launch(LAUNCHES, "bitlife_resident", stack, stack.data_ptr(),
            out.data_ptr(), batch, rows, cols, n, *rule_args(rule), *plan)
    RESIDENT_PLANS["cluster"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """One launch shape of a tiled kernel: the tile interior (word-rows
    x columns), its ghost frame (word-rows and columns per side), and
    the copies of the extended tile held in shared memory (2 for
    kernel B's ping-pong; C for the Generations kernel D)."""

    tile_rows: int
    tile_cols: int
    halo: int
    ghost: int
    copies: int = 2

    @property
    def turns(self) -> int:
        """Turns one full pass may run: the smaller light cone."""
        return min(TILE_TURNS * self.halo, self.ghost)

    @property
    def smem_bytes(self) -> int:
        return (self.copies * 4 * (self.tile_rows + 2 * self.halo)
                * (self.tile_cols + 2 * self.ghost))


def _strip_pitch(geom: TileGeometry) -> int:
    """Row pitch in words of the extended tile of kernels B and D for
    their strip walkers: the width rounded up to whole strips of
    STRIP_COLS."""
    ec = geom.tile_cols + 2 * geom.ghost
    return -(-ec // STRIP_COLS) * STRIP_COLS


def _strip_smem_bytes(geom: TileGeometry) -> int:
    """Shared memory of the strip layout (csrc/strip.cuh): two
    copies of the extended tile at the strip pitch, and three pads of a
    row and a strip each."""
    pitch = _strip_pitch(geom)
    er = geom.tile_rows + 2 * geom.halo
    return 4 * (2 * er * pitch + 3 * (pitch + STRIP_COLS))


def _smem_need(geom: TileGeometry) -> int:
    """Shared memory a block of the tiled kernel takes: kernel B's (two
    copies) the strip layout, which holds its masks form's too; kernel
    D's its `copies` copies, which for B2/S/C3 (three) hold its strip
    layout of two."""
    return _strip_smem_bytes(geom) if geom.copies == 2 else geom.smem_bytes


def _geometry(rows: int, width: int, tile_rows: int, halo: int,
              ghost: int, copies: int = 2) -> TileGeometry:
    """Widest tile (TILE_COLS, halved down to 32 columns) whose `copies`
    shared-memory copies of the ghost-extended tile fit one block
    (`_smem_need`)."""
    tc = min(TILE_COLS, width)
    geom = TileGeometry(tile_rows, tc, halo, ghost, copies)
    while _smem_need(geom) > SMEM_BYTES and tc > 32:
        tc //= 2
        geom = TileGeometry(tile_rows, tc, halo, ghost, copies)
    if _smem_need(geom) > SMEM_BYTES:
        raise ValueError(
            f"a {tile_rows}-row tile with halo {halo} and {ghost} ghost "
            f"columns needs {_smem_need(geom)} bytes of shared memory for "
            f"{copies} copies, over the {SMEM_BYTES} one block has"
        )
    if -(-rows // tile_rows) > _MAX_GRID_Y:
        raise ValueError(f"{rows} word rows need more than {_MAX_GRID_Y} "
                         f"tiles of {tile_rows} rows")
    return geom


def _auto_rows(rows: int) -> int:
    """Default tile height: the largest multiple of 8 up to TILE_ROWS
    that divides the packed row count, else TILE_ROWS (or the whole
    board when it is shorter) with a ragged last tile."""
    for r in range(TILE_ROWS, 7, -8):
        if rows % r == 0:
            return r
    return min(rows, TILE_ROWS)


def _tile_plan(rows: int, width: int, strip_rows: int | None,
               halo_words: int | None, copies: int = 2) -> TileGeometry:
    """The tiled entry point's geometry: `strip_rows` sets the tile
    height, `halo_words` the halo depth h, with 32*h ghost columns so a
    pass runs 32*h turns (the turns per pass of gol_tpu's strip kernel)."""
    if strip_rows is not None and (rows % strip_rows != 0 or strip_rows % 8 != 0):
        raise ValueError(
            f"strip_rows={strip_rows} must divide the packed row count "
            f"{rows} and be a multiple of 8"
        )
    if halo_words is not None and not 1 <= halo_words <= MAX_HALO_WORDS:
        raise ValueError(
            f"halo_words={halo_words} must be in 1..{MAX_HALO_WORDS}"
        )
    h = halo_words or 1
    return _geometry(rows, width, strip_rows or _auto_rows(rows), h,
                     TILE_TURNS * h, copies)


def _walk_plan(geom: TileGeometry) -> tuple:
    """(threads, seg_rows) of the column walkers of kernels A, C and E on
    `geom`'s extended tile: a work item is one column and a segment of
    seg_rows word-rows (the last segment takes the rest). Whole columns
    where they fill the block; else the rows split into as many equal
    segments as fill WALK_THREADS, each at least MIN_SEG_ROWS long. The
    kernel strides the items over `threads`, so any count of items
    runs."""
    er = geom.tile_rows + 2 * geom.halo
    ec = geom.tile_cols + 2 * geom.ghost
    segs = max(1, min(WALK_THREADS // ec, er // MIN_SEG_ROWS))
    while segs > 1 and er - (segs - 1) * -(-er // segs) < MIN_SEG_ROWS:
        segs -= 1
    threads = min(WALK_THREADS, -(-ec * segs // 32) * 32)
    return threads, -(-er // segs)


def _strip_plan(geom: TileGeometry) -> tuple:
    """(threads, segs) of the strip walkers of kernels B and D on
    `geom`'s extended tile at the strip pitch (`_strip_pitch`): a work
    item is one strip of STRIP_COLS columns and one of `segs` segments
    of its word-rows,
    the first er % segs of them one row longer than the rest. The rows
    split into as many segments as fill STRIP_THREADS, each at least
    MIN_STRIP_ROWS long, or whole strips. The kernel strides the items
    over `threads`, so any count of items runs."""
    er = geom.tile_rows + 2 * geom.halo
    strips = _strip_pitch(geom) // STRIP_COLS
    segs = max(1, min(STRIP_THREADS // strips, er // MIN_STRIP_ROWS))
    return min(STRIP_THREADS, -(-strips * segs // 32) * 32), segs


def _tile_form(src: torch.Tensor, dst: torch.Tensor, geom: TileGeometry,
               strips: bool) -> str:
    """How a launch of kernel B or D moves `geom`'s tiles of `src` (each
    plane a board as wide as the last axis) in and its interiors out to
    `dst`: "bulk", as 16-byte pieces of rows, every copy of a block in
    flight together (csrc/strip.cuh), where the rule runs the strip
    walkers (`strips`) and every row of the extended tile is at most two
    pieces of a board row, 16-byte aligned in both memories and whole
    16-byte units long — the board's width, the tile's and the ghost
    columns multiples of BULK_WORDS, the strip pitch within the board's
    width, both buffers 16-byte aligned (the launcher's `gol::bulk_ok`);
    else "words", a word at a time."""
    bulk = (strips and _bulk_shape(src.shape[-1], geom)
            and (src.data_ptr() | dst.data_ptr()) % (4 * BULK_WORDS) == 0)
    return "bulk" if bulk else "words"


@functools.lru_cache(maxsize=None)
def _bulk_shape(cols: int, geom: TileGeometry) -> bool:
    """`_tile_form`'s test of the shape: the widths whole 16-byte units
    and the strip pitch within the board's width. Cached, since every
    launch asks it on the host path that feeds the card."""
    return (cols % BULK_WORDS == geom.tile_cols % BULK_WORDS == 0
            and geom.ghost % BULK_WORDS == 0 and _strip_pitch(geom) <= cols)


def _tiled_pass(src: torch.Tensor, dst: torch.Tensor, k: int, rule: Rule,
                geom: TileGeometry) -> torch.Tensor:
    """One pass of k <= geom.turns turns from `src` into `dst` (never the
    same buffer: other tiles read this tile's ghosts from `src`), its
    tiles moved in the form `_tile_form` picks."""
    if not 0 <= k <= geom.turns:
        raise ValueError(f"k={k} outside the light cone 0..{geom.turns}")
    if src.device.type == "cpu":
        return dst.copy_(bitlife.step_n_packed_raw(src, k, rule))
    _check_pass(src, dst, _check_cuda)
    rows, cols = src.shape
    args = rule_args(rule)
    form = _tile_form(src, dst, geom, args[:2] == _LIFE_BITS)
    _launch(LAUNCHES, "bitlife_tiled", src, src.data_ptr(), dst.data_ptr(),
            rows, cols, geom.tile_rows, geom.tile_cols, geom.halo,
            geom.ghost, k, *args, int(form == "bulk"), *_strip_plan(geom))
    TILE_LOADS[form] += 1
    return dst


def _run_passes(p: torch.Tensor, n: int, geom: TileGeometry,
                one_pass) -> torch.Tensor:
    """⌈n / k⌉ passes of `one_pass(src, dst, k, geom)` (a tiled kernel),
    ping-ponging two buffers (the input is never written); the
    remainder pass keeps only the halo its own light cone needs."""
    if n < 0:
        raise ValueError("n must be >= 0")
    k = geom.turns
    whole, rem = divmod(n, k)
    passes = [(k, geom)] * whole
    if rem:
        h_rem = min(geom.halo, -(-rem // TILE_TURNS))
        passes.append((rem, dataclasses.replace(geom, halo=h_rem)))
    bufs = [torch.empty_like(p) for _ in range(min(len(passes), 2))]
    for i, (turns, g) in enumerate(passes):
        p = one_pass(p, bufs[i % 2], turns, g)
    return p


def step_n_packed_tiled_raw(p: torch.Tensor, n: int, rule: Rule = LIFE,
                            strip_rows: int | None = None,
                            halo_words: int | None = None) -> torch.Tensor:
    """`n` turns, packed in/out, through kernel B with `strip_rows`-row
    tiles and an h = `halo_words` halo (32*h turns per launch). The
    overrides keep gol_tpu's checks: strip_rows divides the packed row
    count in multiples of 8, halo_words is in 1..8."""
    rows, width = p.shape
    return _run_passes(p, n, _tile_plan(rows, width, strip_rows, halo_words),
                       lambda s, d, k, g: _tiled_pass(s, d, k, rule, g))


def _tiled2d_geometry(rows: int, width: int, tile_rows: int | None,
                      copies: int = 2) -> TileGeometry:
    """The 2-D entry points' geometry: (tile_rows x up to TILE_COLS)
    tiles, a one-word halo and GHOST_COLS ghost columns — 32 turns per
    launch. `tile_rows` keeps gol_tpu's check: it divides the packed row
    count in 8-row units."""
    if tile_rows is not None and (rows % tile_rows != 0 or tile_rows % 8 != 0):
        raise ValueError(
            f"tile_rows={tile_rows} must divide {rows} in 8-row units"
        )
    return _geometry(rows, width, tile_rows or _auto_rows(rows), 1,
                     GHOST_COLS, copies)


def step_n_packed_tiled2d_raw(p: torch.Tensor, n: int, rule: Rule = LIFE,
                              tile_rows: int | None = None) -> torch.Tensor:
    """`n` turns, packed in/out, through kernel B with the 2-D entry's
    tiles (`_tiled2d_geometry`)."""
    rows, width = p.shape
    return _run_passes(p, n, _tiled2d_geometry(rows, width, tile_rows),
                       lambda s, d, k, g: _tiled_pass(s, d, k, rule, g))


def step_n_packed_kernel_raw(p: torch.Tensor, n: int,
                              rule: Rule = LIFE) -> torch.Tensor:
    """`n` turns, packed in/out, through the kernel the board's shape
    takes: kernel A when two copies of it fit one block's shared memory
    (`fits_cuda_packed`), else kernel B's 2-D entry — the choice of the
    "cuda-packed" stepper, for ghost-extended blocks of any shape (the
    ring's and mesh's blocks, the lane layout's chunks)."""
    rows, width = p.shape
    if fits_cuda_packed(rows * WORD, width):
        return step_n_packed_cuda_raw(p, n, rule)
    return step_n_packed_tiled2d_raw(p, n, rule)


def kernel_plan(rows: int, width: int) -> tuple:
    """(kernel, blocks) of one launch of `step_n_packed_kernel_raw` on a
    packed board of `rows` word-rows and `width` columns, from the plans
    alone (no card needed): kernel A's grid (`_grid_plan`), or kernel
    B's 2-D grid of tiles (`_tiled2d_geometry`)."""
    if fits_cuda_packed(rows * WORD, width):
        return "bitlife_resident", _grid_plan(rows, width).blocks
    geom = _tiled2d_geometry(rows, width, None)
    return "bitlife_tiled", (-(-rows // geom.tile_rows)
                             * -(-width // geom.tile_cols))


def step_n_cuda_packed(world: torch.Tensor, n: int,
                       rule: Rule = LIFE) -> torch.Tensor:
    """`n` turns on a {0,255} uint8 world via kernel A — drop-in for
    `ops.life.step_n` when `fits_cuda_packed(H, W)`."""
    world = torch.as_tensor(world)
    p = step_n_packed_cuda_raw(pack(to_bits(world)), n, rule)
    return from_bits(unpack(p, world.shape[0]))
