"""Dense Game of Life kernel in hand-written CUDA for Hopper.

The counterpart of `gol_tpu.ops.pallas_life`: `step_n_cuda_dense`
computes n toroidal turns of a {0,255} uint8 (H, W) world through
kernel E (`life_dense` in csrc/life.cu), one launch per turn ping-
ponging two device buffers, and `step_n_counted_cuda_dense` adds the
alive count, taken outside the kernel as gol_tpu takes it outside the
Pallas call. The plain version is `ops.life.step_n`.

The TPU kernel keeps the whole board in VMEM for all n turns; a dense
512² board does not fit one block's shared memory (256 KiB a copy), so
here the board stays in L2 between launches (csrc/life.cu says why).

Wrappers: a CPU tensor runs the plain version; a CUDA tensor launches
the kernel (after device, dtype, shape and contiguity checks) or raises
— there is no fallback. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.rules import LIFE, Rule
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops import life

#: Threads per block of kernel E (one thread per cell).
THREADS = 256

#: Launches of kernel E. The wrapper adds one where it launches, and
#: nowhere else; callers reset the count by assigning 0.
LAUNCHES = {"life_dense": 0}


def fits_cuda_dense(height: int, width: int) -> bool:
    """Kernel E takes any shape whose cell indices, rounded up to whole
    blocks, stay within the kernel's int32 arithmetic."""
    return height >= 1 and width >= 1 and height * width <= 2**31 - THREADS


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


def step_n_cuda_dense(world: torch.Tensor, n: int,
                      rule: Rule | str = LIFE) -> torch.Tensor:
    """`n` turns on a {0,255} uint8 world: n launches of kernel E —
    drop-in for `ops.life.step_n`. The input is never written."""
    if n < 0:
        raise ValueError("n must be >= 0")
    world = torch.as_tensor(world)
    rule = life._resolve(rule)
    if world.device.type == "cpu":
        return life.step_n(world, n, rule)
    from gol_tpu_torch.ops import _build

    _check_world(world)
    if n == 0:
        return life.from_bits(life.to_bits(world))
    lib = _build.load()
    birth, survive = cb.rule_bits(rule)
    rows, cols = world.shape
    bufs = [torch.empty_like(world) for _ in range(min(n, 2))]
    src = world
    with torch.cuda.device(world.device):
        stream = cb._stream(world)
        for t in range(n):
            dst = bufs[t % 2]
            code = lib.life_dense_launch(
                src.data_ptr(), dst.data_ptr(), rows, cols, birth, survive,
                THREADS, stream,
            )
            LAUNCHES["life_dense"] += 1
            _build.check(lib, code, "life_dense")
            src = dst
    return src


def step_n_counted_cuda_dense(world: torch.Tensor, n: int,
                              rule: Rule | str = LIFE):
    """`n` turns plus the alive count (int32 device scalar) — drop-in
    for `ops.life.step_n_counted`; the count is taken outside the
    kernel."""
    new = step_n_cuda_dense(world, n, rule)
    return new, torch.count_nonzero(new).to(torch.int32)
