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
- "cuda-dense": the dense board, every step through the hand-written
  CUDA kernel of `ops/cuda_life.py` (gol_tpu's "pallas"); never picked
  by "auto".

"auto" picks "cuda-packed" on a CUDA device whenever the board packs,
"packed" on the CPU (the kernels never run off the card), else "dense".

Generations (B/S/C) rules take backend auto/dense/packed/cuda-packed:
one-hot packed planes (`ops/bitgens.py`, chunks through
`ops/cuda_bitgens.py` for "cuda-packed", and for "auto" on a CUDA
device) or the dense state grid (`ops/generations.py`).

So far the port offers the core entries of the capability table (and
`alive_mask` for Generations) only; the diff scans and the sharded and
tiled backends are not ported yet and their entries stay None.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gol_tpu_torch.models.rules import LIFE, GenRule, Rule, get_rule
from gol_tpu_torch.ops import bitgens, bitlife, generations as gens, life
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


def _single_device_cuda_dense(rule: Rule, device) -> Stepper:
    """Dense backend whose every step runs kernel E (ops/cuda_life.py),
    the counterpart of gol_tpu's `_single_device_pallas`: `step` and
    `step_with_diff` launch it with n = 1, as gol_tpu does. Selectable
    for comparison, not picked by "auto"."""
    from gol_tpu_torch.ops import cuda_life

    def _step_with_diff(w):
        new, count = cuda_life.step_n_counted_cuda_dense(w, 1, rule)
        return new, w != new, count

    return Stepper(
        name="single-cuda-dense",
        shards=1,
        put=lambda w: _host_tensor(w, device),
        fetch=lambda w: w.cpu().numpy(),
        step=lambda w: cuda_life.step_n_cuda_dense(w, 1, rule),
        step_n=lambda w, n: cuda_life.step_n_counted_cuda_dense(
            w, int(n), rule),
        step_with_diff=_step_with_diff,
        alive_count_async=life.alive_count,
    )


def _gens_alive_mask(levels) -> np.ndarray:
    """Alive (state-1) cells of a fetched gray-level world."""
    return np.asarray(levels) == life.ALIVE


def _gens_fetch(to_levels):
    """The Generations steppers' `fetch` (gol_tpu's `_gens_scaffold`):
    device state back to host gray levels through `to_levels`, with bool
    diff masks passed through untranslated."""

    def fetch(arr):
        if arr.dtype == torch.bool:
            return arr.cpu().numpy()
        return to_levels(arr)

    return fetch


def _gens_stepper(rule: GenRule, device) -> Stepper:
    """Generations backend on the dense uint8 state grid
    (ops/generations.py): `put` and `fetch` translate to/from the
    injective gray-level representation the PGM/event layer speaks, so
    snapshots remain complete resumable checkpoints."""
    return Stepper(
        name="generations-1",
        shards=1,
        put=lambda w: _host_tensor(gens.states_from_levels(w, rule), device),
        fetch=_gens_fetch(
            lambda s: gens.levels_from_states(s.cpu().numpy(), rule)),
        step=lambda s: gens.step_states(s, rule),
        step_n=lambda s, k: gens.step_n_counted_states(s, int(k), rule),
        step_with_diff=lambda s: gens.step_with_diff_states(s, rule),
        alive_count_async=gens.alive_count,
        alive_mask=_gens_alive_mask,
    )


def _gens_stepper_packed(rule: GenRule, device, height: int, width: int,
                         kernels: bool) -> Stepper:
    """Packed Generations backend (ops/bitgens.py): one-hot dying-state
    bit-planes, the shared SWAR count on the alive plane, aging as a
    plane rename. With `kernels`, multi-turn chunks run the CUDA
    kernels (ops/cuda_bitgens.py) — kernel C when every plane fits one
    block's shared memory, else kernel D through the 2-D entry — and
    the stepper is "generations-cuda-packed-1"; otherwise the plain
    plane step, "generations-packed-1". Single turns and the per-turn
    diff stay on the plain plane step, as in gol_tpu."""
    raw = bitgens.step_n_packed_gens_raw
    if kernels:
        from gol_tpu_torch.ops import cuda_bitgens as cg

        if cg.fits_cuda_gens(height, width, rule):
            raw = cg.step_n_packed_gens_cuda_raw
        elif cg.fits_cuda_gens_tiled(height, width, rule):
            raw = cg.step_n_packed_gens_tiled2d_raw
        else:
            raise ValueError(
                f"grid {height}x{width} with {rule.states} states does not "
                "fit the packed CUDA Generations kernels"
            )

    def put(w):
        # Packed on the device: the planes of `bitgens.pack_states`.
        states = _host_tensor(gens.states_from_levels(w, rule), device)
        return torch.stack([bitlife.pack(states == s)
                            for s in range(1, rule.states)])

    def to_levels(planes):
        # `bitgens.unpack_states` on the device, then the gray levels.
        states = torch.zeros((height, width), dtype=torch.uint8,
                             device=planes.device)
        for s in range(1, rule.states):
            states = torch.where(bitlife.unpack(planes[s - 1], height) != 0,
                                 s, states)
        return gens.levels_from_states(states.cpu().numpy(), rule)

    def count(planes):
        return bitlife.count_packed(planes[0])

    def _step_n(planes, k):
        planes = raw(planes, int(k), rule)
        return planes, count(planes)

    def _step_with_diff(planes):
        new = bitgens.step_packed_gens(planes, rule)
        changed = planes[0] ^ new[0]
        for i in range(1, planes.shape[0]):
            changed = changed | (planes[i] ^ new[i])
        mask = bitlife.unpack(changed, height) != 0
        return new, mask, count(new)

    return Stepper(
        name="generations-cuda-packed-1" if kernels else "generations-packed-1",
        shards=1,
        put=put,
        fetch=_gens_fetch(to_levels),
        step=lambda planes: bitgens.step_packed_gens(planes, rule),
        step_n=_step_n,
        step_with_diff=_step_with_diff,
        alive_count_async=count,
        alive_mask=_gens_alive_mask,
    )


def _make_gens_stepper(rule: GenRule, height: int, width: int, dev,
                       backend: str) -> Stepper:
    """The single-device part of gol_tpu's GenRule branch of
    `make_stepper` (stepper.py:1432-1501), with "cuda-packed" added."""
    if backend not in ("auto", "dense", "packed", "cuda-packed"):
        raise ValueError(
            f"generations rules support backend auto/dense/packed/"
            f"cuda-packed, not {backend!r}"
        )
    packable = bitgens.packable_gens(height, width)
    if backend in ("packed", "cuda-packed") and not packable:
        raise ValueError(f"grid height {height} is not packable")
    # One-hot planes cost (C-1)/8 bytes per cell vs the dense grid's 1 —
    # memory crosses over at C=9, so "auto" keeps the packed path to
    # rules where it is strictly smaller; higher C stays packed only on
    # explicit request.
    want_packed = backend in ("packed", "cuda-packed") or (
        backend == "auto" and rule.states <= 8
    )
    if want_packed and packable:
        kernels = backend == "cuda-packed" or (
            backend == "auto" and dev.type == "cuda"
        )
        return _gens_stepper_packed(rule, dev, height, width, kernels)
    return _gens_stepper(rule, dev)


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
    dev = resolve_device(device)
    if isinstance(rule, GenRule):
        return _make_gens_stepper(rule, height, width, dev, backend)
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
    if backend == "cuda-dense":
        from gol_tpu_torch.ops.cuda_life import fits_cuda_dense

        if not fits_cuda_dense(height, width):
            raise ValueError(f"grid {height}x{width} does not fit the "
                             "dense CUDA kernel")
        return _single_device_cuda_dense(rule, dev)
    return _single_device(rule, dev)
