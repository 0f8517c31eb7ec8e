"""Stepper — the engine's pluggable execution backend, on one device.

The counterpart of `gol_tpu.parallel.stepper` for a single CUDA (or,
when the caller asks, CPU) device. A `Stepper` is a record of plain
functions on tensors; the engine calls them from its own thread only.
Backends:

- "dense": one byte per cell (`ops/life.py`), plain PyTorch.
- "packed": 32 cells per int32 word, the plain SWAR step
  (`ops/bitlife.py`).
- "cuda-packed": packed state, multi-turn chunks through the
  hand-written CUDA kernels (`ops/cuda_bitlife.py`); single turns and
  the per-turn diff stay on the plain SWAR step, as in gol_tpu.

"auto" picks "cuda-packed" on a CUDA device whenever the board packs,
"packed" on the CPU (the kernels never run off the card), else "dense".

So far the port offers the core entries of the capability table only;
the diff scans and the sharded, tiled and Generations backends are not
ported yet and their entries stay None.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gol_tpu_torch.models.rules import LIFE, GenRule, Rule, get_rule
from gol_tpu_torch.ops import bitlife, life
from gol_tpu_torch.params import BACKENDS, not_yet_ported


@dataclasses.dataclass(frozen=True)
class EntryInfo:
    """One row of the Stepper capability table (`ENTRY_TABLE`) — the
    same names, kinds and opcodes as gol_tpu's table (see there for
    each field's meaning), so consumers derive behaviour from one
    declaration in both packages."""

    name: str
    kind: str
    wrap: Optional[str] = None
    opcode: Optional[int] = None
    args: int = 0
    token: Optional[str] = None
    replay: Optional[str] = None


#: The capability table — one row per Stepper field, in field order.
ENTRY_TABLE: tuple = (
    EntryInfo("put", "core", wrap="put", opcode=0, token="reset",
              replay="put"),
    EntryInfo("fetch", "core", wrap="timed", replay="fetch"),
    EntryInfo("step", "core", wrap="one_turn", opcode=1, token="reset",
              replay="step"),
    EntryInfo("step_n", "core", wrap="step_n", opcode=2, args=1,
              token="reset", replay="step_n"),
    EntryInfo("step_with_diff", "core", wrap="one_turn", opcode=3,
              replay="diff"),
    EntryInfo("alive_count_async", "core", opcode=4, replay="count"),
    EntryInfo("alive_mask", "meta"),
    EntryInfo("step_n_with_diffs", "diff", wrap="diffy", opcode=8,
              args=1, token="dense", replay="dense"),
    EntryInfo("fetch_diffs", "fetch", opcode=9, replay="fetch_diffs"),
    EntryInfo("packed_diffs", "meta"),
    EntryInfo("step_n_with_diffs_sparse", "diff", wrap="diffy",
              opcode=10, args=2, token="sparse", replay="sparse"),
    EntryInfo("step_n_with_diffs_redo", "diff", wrap="diffy",
              opcode=11, args=1, token="redo", replay="redo"),
    EntryInfo("step_n_with_diffs_compact", "diff", wrap="diffy",
              opcode=12, args=2, token="sparse", replay="compact"),
    EntryInfo("fetch_compact_values", "fetch"),
    EntryInfo("halo_cost", "meta"),
    EntryInfo("tiled", "meta"),
)


def entry_info(name: str) -> EntryInfo:
    for e in ENTRY_TABLE:
        if e.name == name:
            return e
    raise KeyError(f"no Stepper entry named {name!r}")


@dataclasses.dataclass
class Stepper:
    """Uniform interface over execution strategies.

    Host worlds are {0,255} uint8 numpy arrays of shape (H, W); `put`
    moves one onto the stepper's device in its state layout, `fetch`
    brings state (or a diff mask) back as numpy. Device functions run
    on the engine thread only: it alone launches work and realizes
    device values (`.item()`), so the stream order is the dispatch
    order."""

    name: str
    shards: int
    put: Callable
    fetch: Callable
    #: world -> world (one turn)
    step: Callable
    #: (world, k) -> (world, count_scalar): k turns + alive count
    step_n: Callable
    #: world -> (world, flipped_mask, count_scalar)
    step_with_diff: Callable
    #: world -> count device scalar
    alive_count_async: Callable
    #: The rest of gol_tpu's table; not offered yet.
    alive_mask: Optional[Callable] = None
    step_n_with_diffs: Optional[Callable] = None
    fetch_diffs: Optional[Callable] = None
    packed_diffs: bool = False
    step_n_with_diffs_sparse: Optional[Callable] = None
    step_n_with_diffs_redo: Optional[Callable] = None
    step_n_with_diffs_compact: Optional[Callable] = None
    fetch_compact_values: Optional[Callable] = None
    halo_cost: Optional[Callable] = None
    tiled: Optional[object] = None

    def alive_count(self, world) -> int:
        return int(self.alive_count_async(world).item())

    def offers(self, entry: str) -> bool:
        """True when this backend provides capability-table entry
        `entry` (unknown names raise)."""
        entry_info(entry)
        value = getattr(self, entry)
        return value is not None and value is not False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller asks for the CPU. Never falls back: without a CUDA device a
    GPU request raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available: gol_tpu_torch runs on the GPU unless "
            "the caller asks for the CPU (device='cpu', --platform cpu)"
        )
    return dev


def _host_tensor(w, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.uint8)).to(device)


def _single_device(rule: Rule, device) -> Stepper:
    """Dense backend: the {0,255} uint8 board is the device state."""
    return Stepper(
        name="single",
        shards=1,
        put=lambda w: _host_tensor(w, device),
        fetch=lambda w: w.cpu().numpy(),
        step=lambda w: life.step(w, rule=rule),
        step_n=lambda w, n: life.step_n_counted(w, int(n), rule=rule),
        step_with_diff=lambda w: life.step_with_diff(w, rule=rule),
        alive_count_async=life.alive_count,
    )


def _packed_state_stepper(name: str, rule: Rule, height: int,
                          step_n_raw, device) -> Stepper:
    """The one constructor of the backends whose device state is the packed
    int32 board (packed on `put`, unpacked only on `fetch`).
    `step_n_raw` is the (packed, n) -> packed multi-turn function; single
    turns and the per-turn diff use the plain SWAR step, as in gol_tpu.
    The count stays plain PyTorch on the device."""
    _pack, _unpack, _fetch = bitlife.make_codec(height)

    def _step_n(p, n):
        p = step_n_raw(p, int(n))
        return p, bitlife.count_packed(p)

    def _step_with_diff(p):
        new = bitlife.step_packed(p, rule)
        # Diff mask unpacked to dense (H, W) bool for cells_from_mask.
        mask = bitlife.unpack(p ^ new, height) != 0
        return new, mask, bitlife.count_packed(new)

    return Stepper(
        name=name,
        shards=1,
        put=lambda w: _pack(_host_tensor(w, device)),
        fetch=_fetch,
        step=lambda p: bitlife.step_packed(p, rule),
        step_n=_step_n,
        step_with_diff=_step_with_diff,
        alive_count_async=bitlife.count_packed,
    )


def _single_device_packed(rule: Rule, height: int, device) -> Stepper:
    """Bit-packed backend: the plain SWAR step, n times."""
    return _packed_state_stepper(
        "single-packed", rule, height,
        lambda p, n: bitlife.step_n_packed_raw(p, n, rule), device,
    )


def _single_device_cuda_packed(rule: Rule, height: int, width: int,
                               device) -> Stepper:
    """Packed backend whose multi-turn chunks run the CUDA kernels:
    kernel A when two copies of the packed board fit one block's shared
    memory, else kernel B through the 2-D entry point (the counterpart
    of gol_tpu's `_single_device_pallas_packed`). Unlike the TPU's, the
    strip and 2-D entries launch kernel B with the same default tiles,
    so there is no third choice."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    if cb.fits_cuda_packed(height, width):
        raw = cb.step_n_packed_cuda_raw
    else:
        raw = cb.step_n_packed_tiled2d_raw
    return _packed_state_stepper(
        "single-cuda-packed", rule, height,
        lambda p, n: raw(p, n, rule), device,
    )


def make_stepper(
    threads: int = 1,
    height: int = 512,
    width: int = 512,
    rule: Rule | str = LIFE,
    device=None,
    backend: str = "auto",
    tile: int = 0,
    mesh: Optional[tuple | str] = None,
    partition_rules: Optional[str] = None,
) -> Stepper:
    """Build the stepper for the request on one device (`device`: None
    means the CUDA card; pass "cpu" to run the plain versions on the
    CPU). `threads` is the reference's shard request; one device holds
    one shard, which never changes results."""
    if backend == "pallas":
        raise not_yet_ported("backend 'pallas'")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if tile:
        raise not_yet_ported("tiled stepping (tile > 0)")
    if mesh is not None:
        raise not_yet_ported("2-D device meshes (mesh)")
    if partition_rules:
        raise not_yet_ported("partition-rule overrides")
    if threads < 1:
        raise ValueError("threads must be >= 1")
    rule = get_rule(rule) if isinstance(rule, str) else rule
    if isinstance(rule, GenRule):
        raise not_yet_ported(f"Generations rule {rule}")
    dev = resolve_device(device)
    packable = bitlife.packable(height, width)
    if backend == "cuda-packed" or (
        backend == "auto" and dev.type == "cuda" and packable
    ):
        if not packable:
            raise ValueError(
                f"grid {height}x{width} does not fit the packed CUDA "
                "kernels (needs whole 32-row words)"
            )
        return _single_device_cuda_packed(rule, height, width, dev)
    if backend == "packed" or (backend == "auto" and packable):
        if not packable:
            raise ValueError(f"grid {height}x{width} is not packable")
        return _single_device_packed(rule, height, dev)
    return _single_device(rule, dev)
