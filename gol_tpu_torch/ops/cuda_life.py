"""Dense Game of Life kernel in hand-written CUDA for Hopper.

The counterpart of `gol_tpu.ops.pallas_life` (`step_n_pallas`, which
keeps the whole board in VMEM for all n turns): `step_n_cuda_dense`
computes n toroidal turns of a uint8 (H, W) world (nonzero = alive)
into a {0,255} one through kernel E (`life_dense` in csrc/life.cu), and
`step_n_counted_cuda_dense` adds the alive count, taken outside the
kernel as gol_tpu takes it outside the Pallas call. The plain version
is `ops.life.step_n`.

What bounds the function on the H100: the board read once and written
once (2 bytes a cell per call, whatever n), and at least 9 integer
instructions per 32-bit word of 4 cells per turn in byte-SIMD form; from
n ≈ 5 turns on, the operations. The kernel is temporally blocked: a
grid of tiles of 4-cell byte-SIMD words, each with a ghost frame of
`halo` rows and `ghost` words a side (`_dense_plan`), runs k ≤
min(halo, 4·ghost) turns in shared memory on the column walkers of
csrc/walk.cuh, so the board makes one device-memory round trip per k
turns; one C call issues all ⌈n/k⌉ passes, so the host crosses into C
once per call. A dense board is 8× the packed one, so kernel A's
resident cluster (8 SMs, boards up to about 0.8 MiB) would neither fill
the card nor take large boards; the tiles do both.

Wrappers: a CPU tensor runs the plain version; a CUDA tensor launches
the kernel (after device, dtype, shape and contiguity checks) or raises
— there is no fallback. `LAUNCHES` counts the launches the C launcher
reports it issued: one a pass, more where a board has more rows of
tiles than one grid holds.
"""

from __future__ import annotations

import ctypes

import torch

from gol_tpu_torch.models.rules import LIFE, Rule
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops import life

#: Turns a pass may run (its ghost rows; ghost words: a quarter, rounded
#: up), with the tile (rows, words) of each: 4·depth rows, and words up
#: to what two copies of the extended tile in one block's shared memory
#: allow, two blocks an SM.
TILES = {8: (32, 32), 16: (64, 128)}
#: Words of a board from which the deeper plan fills the card: 132 SMs'
#: worth of depth-16 tiles (64 × 128 words each).
DEEP_WORDS = 132 * 64 * 128
#: Most cells of a board: `step_n_counted_cuda_dense`'s alive count is
#: int32, as gol_tpu's is.
MAX_CELLS = 2**31 - 1

#: Launches of kernel E. The wrapper adds the launches the C launcher
#: reports, and nowhere else; callers reset the count by assigning 0.
LAUNCHES = {"life_dense": 0}


def _dense_plan(height: int, width: int, depth: int | None = None) -> tuple:
    """(tile_rows, tile_words, halo, ghost, turns, threads, seg_rows) of
    kernel E on an (H, W) board: tiles of TILES[depth] clipped to the
    board, `depth` ghost rows and ⌈depth/4⌉ ghost words a side, `turns`
    = depth turns a pass, and the column walkers' plan of the extended
    tile. The default depth is 16 where the board holds DEEP_WORDS words,
    else 8 (a small board fills more SMs with shallow tiles). Raises
    ValueError for an empty board or one of more than MAX_CELLS cells."""
    if height < 1 or width < 1:
        raise ValueError(f"dense board {height}x{width} is empty")
    if height * width > MAX_CELLS:
        raise ValueError(f"dense board {height}x{width} has more than "
                         f"{MAX_CELLS} cells (its alive count is int32)")
    words = -(-width // 4)
    if depth is None:
        depth = 16 if height * words >= DEEP_WORDS else 8
    rows, cols = TILES[depth]
    tile_rows, tile_words = min(rows, height), min(cols, words)
    halo, ghost = depth, -(-depth // 4)
    geom = cb.TileGeometry(tile_rows, tile_words, halo, ghost)
    if geom.smem_bytes > cb.SMEM_BYTES:
        raise ValueError(f"depth {depth}: {geom.smem_bytes} bytes of shared "
                         f"memory, over the {cb.SMEM_BYTES} one block has")
    return (tile_rows, tile_words, halo, ghost, depth, *cb._walk_plan(geom))


def fits_cuda_dense(height: int, width: int) -> bool:
    """Kernel E takes exactly the boards `_dense_plan` plans."""
    try:
        _dense_plan(height, width)
    except ValueError:
        return False
    return True


def _check_world(world: torch.Tensor) -> None:
    if world.device.type != "cuda":
        raise ValueError(f"kernel input must be on a CUDA device, not {world.device}")
    if world.dtype != torch.uint8:
        raise TypeError(f"dense world must be uint8, got {world.dtype}")
    if world.dim() != 2 or not fits_cuda_dense(*world.shape):
        raise ValueError(f"dense world shape {tuple(world.shape)} does not "
                         "fit kernel E")
    if not world.is_contiguous():
        raise ValueError("dense world must be contiguous")


def _run(world: torch.Tensor, n: int, rule: Rule, plan: tuple) -> torch.Tensor:
    """`n` >= 1 turns of a checked CUDA world through kernel E on `plan`
    (`_dense_plan`'s tuple): one C call, ⌈n / turns⌉ passes alternating
    between two new buffers; `LAUNCHES` adds the launches the call
    reports. A view that does not start on a 4-byte boundary is copied
    first (the kernel reads whole words)."""
    from gol_tpu_torch.ops import _build

    if world.data_ptr() % 4:
        world = world.clone()
    passes = -(-n // plan[4])
    bufs = [torch.empty_like(world) for _ in range(min(passes, 2))]
    lib, launched = _build.load(), ctypes.c_int(0)
    with torch.cuda.device(world.device):
        code = lib.life_dense_launch(
            world.data_ptr(), bufs[0].data_ptr(), bufs[-1].data_ptr(),
            *world.shape, n, *cb.rule_bits(rule), *plan,
            ctypes.byref(launched), cb._stream(world))
        LAUNCHES["life_dense"] += launched.value
    _build.check(lib, code, "life_dense")
    return bufs[(passes - 1) % 2]


def step_n_cuda_dense(world: torch.Tensor, n: int,
                      rule: Rule | str = LIFE) -> torch.Tensor:
    """`n` turns on a {0,255} uint8 world through kernel E (⌈n/k⌉
    passes of k turns, `_dense_plan`) — drop-in for `ops.life.step_n`.
    The input is never written."""
    if n < 0:
        raise ValueError("n must be >= 0")
    world = torch.as_tensor(world)
    rule = life._resolve(rule)
    if world.device.type == "cpu":
        return life.step_n(world, n, rule)
    _check_world(world)
    if n == 0:
        return life.from_bits(life.to_bits(world))
    return _run(world, n, rule, _dense_plan(*world.shape))


def step_n_counted_cuda_dense(world: torch.Tensor, n: int,
                              rule: Rule | str = LIFE):
    """`n` turns plus the alive count (int32 device scalar) — drop-in
    for `ops.life.step_n_counted`; the count is taken outside the
    kernel."""
    new = step_n_cuda_dense(world, n, rule)
    return new, torch.count_nonzero(new).to(torch.int32)
