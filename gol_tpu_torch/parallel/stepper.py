"""Stepper — the engine's pluggable execution backend, on one device.

The counterpart of `gol_tpu.parallel.stepper` for a single CUDA (or,
when the caller asks, CPU) device. A `Stepper` is a record of plain
functions on tensors; the engine calls them from its own thread only.
Backends:

- "dense": one byte per cell (`ops/life.py`), plain PyTorch.
- "packed": 32 cells per int32 word, the plain SWAR step
  (`ops/bitlife.py`).
- "cuda-packed": packed state, every step through the hand-written
  CUDA kernels (`ops/cuda_bitlife.py`): multi-turn chunks in one call,
  single turns, the per-turn diff and each turn of the diff scans as a
  launch of n = 1.
- "cuda-dense": the dense board, every step through the hand-written
  CUDA kernel of `ops/cuda_life.py` (gol_tpu's "pallas"); never picked
  by "auto".

"auto" picks "cuda-packed" on a CUDA device whenever the board packs,
"packed" on the CPU (the kernels never run off the card), else "dense".

Generations (B/S/C) rules take backend auto/dense/packed/cuda-packed:
one-hot packed planes (`ops/bitgens.py`, chunks through
`ops/cuda_bitgens.py` for "cuda-packed", and for "auto" on a CUDA
device) or the dense state grid (`ops/generations.py`).

Each backend offers exactly the capability set of its gol_tpu
counterpart (`Stepper.capabilities()`): the core entries, `alive_mask`
for Generations, and the diff scans — the dense mask stack on every
backend, and on the packed ones the packed XOR stack with its sparse
and compact encodings (`scan_diffs`, `sparse_scan_diffs`,
`compact_scan_diffs`, decoded on the host by `sparse_decode_rows` and
`compact_decode_rows`). `fetch_diffs`, `step_n_with_diffs_redo` and
`fetch_compact_values` stay None, as on gol_tpu's single-device
backends; the sharded and tiled backends are not ported yet.

`make_stepper` wraps the backend as gol_tpu's does: `instrument_stepper`
(per-entry dispatch counters, host-blocking histograms and spans) unless
metrics are off, then `analysis.invariants.checked_stepper` when the
invariant checker is on.
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


def entries(kind: Optional[str] = None) -> tuple:
    """Capability-table rows, optionally filtered by `kind`."""
    if kind is None:
        return ENTRY_TABLE
    return tuple(e for e in ENTRY_TABLE if e.kind == kind)


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
    #: host levels -> bool mask of ALIVE cells (Generations backends).
    alive_mask: Optional[Callable] = None
    #: (world, k) -> (world, diffs, count_scalar): k turns with the
    #: per-turn flip masks stacked on the device — int32 (k, H/32, W)
    #: packed XOR word-rows (the uint32 words of gol_tpu, bitcast) on
    #: packed backends, bool (k, H, W) on dense ones — shipped to the
    #: host in one transfer per chunk.
    step_n_with_diffs: Optional[Callable] = None
    #: Sharded backends' gather of a diff stack; None here.
    fetch_diffs: Optional[Callable] = None
    #: True when `step_n_with_diffs` rows are packed words.
    packed_diffs: bool = False
    #: (world, k, cap) -> (world, rows, count): one int32 row per turn,
    #: [changed_count, changed-word bitmap (total_words/32), values
    #: (cap)] — `sparse_scan_diffs`' layout, byte for byte gol_tpu's.
    step_n_with_diffs_sparse: Optional[Callable] = None
    #: The sharded backends' explicit overflow redo; None here (the
    #: engine redoes through `step_n_with_diffs`).
    step_n_with_diffs_redo: Optional[Callable] = None
    #: (world, k, total_cap) -> (world, headers, values, count): the
    #: variable-length scan of `compact_scan_diffs` — (k, 1 + nb) int32
    #: [count, bitmap] headers and one (total_cap,) int32 value buffer.
    step_n_with_diffs_compact: Optional[Callable] = None
    #: How the engine fetches a compact chunk's used value prefix; None
    #: means `compact_value_prefix`.
    fetch_compact_values: Optional[Callable] = None
    #: The rest of gol_tpu's table (sharded and tiled backends); not
    #: offered yet.
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

    def capabilities(self) -> tuple:
        """Names of every table entry this backend offers (for the
        bool-valued `packed_diffs` flag, offered means True)."""
        return tuple(e.name for e in ENTRY_TABLE
                     if getattr(self, e.name) not in (None, False))


def _scan(step_fn, state, k: int, emit):
    """Step `state` k turns with `step_fn`, handing each (old, new) pair
    to `emit`; returns the final state. The one loop of the three scan
    builders below: gol_tpu scans inside one XLA program, while here
    each turn is the stepper's own step — on the card one kernel launch
    (a Python loop of plain PyTorch ops would be dozens of launches a
    turn, not one fused program) — followed by the turn's diff, all
    enqueued without a host synchronisation."""
    for _ in range(max(int(k), 0)):
        new = step_fn(state)
        emit(state, new)
        state = new
    return state


def _stacked(rows: list, empty_row: Callable) -> torch.Tensor:
    """The per-turn rows as one (k, ...) tensor; k = 0 gives an empty
    stack shaped like `empty_row()`."""
    if rows:
        return torch.stack(rows)
    row = empty_row()
    return row.new_empty((0, *row.shape))


def scan_diffs(step_fn, diff_fn, count_fn):
    """Build a `step_n_with_diffs`: k turns of `step_fn`, the per-turn
    output `diff_fn(old, new)` stacked on the device, and the alive
    count once on the final state."""

    def step_n_with_diffs(state, k):
        diffs = []
        new = _scan(step_fn, state, k,
                    lambda old, nxt: diffs.append(diff_fn(old, nxt)))
        return (new, _stacked(diffs, lambda: diff_fn(state, state)),
                count_fn(new))

    return step_n_with_diffs


def sparse_bitmap_words(total_words: int) -> int:
    """int32 words in the changed-word bitmap for a diff space of
    `total_words` packed words — the one layout constant the encoder
    and the decoders share."""
    return -(-total_words // 32)


def _bitmap(changed: torch.Tensor) -> torch.Tensor:
    """(total,) bool changed-word flags -> (nb,) int32 bitmap words, bit
    i of word w set when word 32w + i changed. Built in int64 (a sum of
    bit weights up to 2**32 - 1 needs no overflowing shift or sum), then
    narrowed to the two's-complement int32 bit pattern explicitly."""
    total = changed.shape[0]
    nb = sparse_bitmap_words(total)
    bits = torch.zeros(nb * 32, dtype=torch.int64, device=changed.device)
    bits[:total] = changed
    weights = torch.ones(32, dtype=torch.int64, device=changed.device) << (
        torch.arange(32, dtype=torch.int64, device=changed.device))
    words = (bits.view(nb, 32) * weights).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def _ranked_targets(changed: torch.Tensor, base, cap: int) -> torch.Tensor:
    """Scatter targets of a turn's changed words, without a
    data-dependent shape: base + rank (rank = cumsum(changed) - 1) where
    a word changed and the target is below `cap`, else the sink slot
    `cap` (one past the end, sliced off by the caller) — jnp.nonzero's
    first-`cap` truncation and `mode="drop"` in one form."""
    pos = torch.cumsum(changed, 0) - 1 + base
    return torch.where(changed & (pos < cap), pos, cap)


def sparse_decode_rows(host_rows, total_words: int):
    """Decode sparse diff rows (see Stepper.step_n_with_diffs_sparse)
    into flat (total_words,) uint32 word arrays. `host_rows` is the
    fetched (k, 1 + bitmap + cap) stack viewed as uint32. Yields one
    array per turn; raises ValueError on a truncated row (count above
    the cap the row width implies) so callers can fall back to dense
    masks."""
    nb = sparse_bitmap_words(total_words)
    cap = host_rows.shape[1] - 1 - nb
    shifts = np.arange(32, dtype=np.uint32)
    for t in range(host_rows.shape[0]):
        m = int(host_rows[t, 0])
        if m > cap:
            raise ValueError(f"sparse row truncated: {m} > cap {cap}")
        words = np.zeros(nb * 32, np.uint32)
        if m:
            bits = (host_rows[t, 1 : 1 + nb, None] >> shifts) & 1
            words[np.flatnonzero(bits)] = host_rows[t, 1 + nb : 1 + nb + m]
        yield words[:total_words]


def sparse_scan_diffs(step_fn, diff_fn, count_fn):
    """Build a `step_n_with_diffs_sparse`: the per-turn output row is

        [changed_count (1), changed-word BITMAP (total/32), values (cap)]

    as one int32 vector, byte for byte gol_tpu's row. Values are the
    changed words in ascending word index; a count above `cap` marks
    the list truncated to the first `cap`. The unused value slots of a
    row hold d[0], the value of word 0 (gol_tpu pads jnp.nonzero with
    index 0), so the buffer starts filled with it."""

    def row(old, new, cap):
        d = diff_fn(old, new).reshape(-1)
        changed = d != 0
        vals = d[:1].expand(cap + 1).clone()
        vals.scatter_(0, _ranked_targets(changed, 0, cap), d)
        return torch.cat([changed.sum(dtype=torch.int32).reshape(1),
                          _bitmap(changed), vals[:cap]])

    def step_n_with_diffs_sparse(state, k, cap):
        cap = int(cap)
        rows = []
        new = _scan(step_fn, state, k,
                    lambda old, nxt: rows.append(row(old, nxt, cap)))
        return (new, _stacked(rows, lambda: row(state, state, cap)),
                count_fn(new))

    return step_n_with_diffs_sparse


def compact_scan_diffs(step_fn, diff_fn, count_fn):
    """Build a `step_n_with_diffs_compact`: per turn only the [count,
    bitmap] header, while the changed-word VALUES are stream-compacted
    into one shared (total_cap,) int32 buffer — each turn's words at
    offset sum(counts so far) + rank, ascending word index within a
    turn. The offset stays a device scalar, so the host never waits.
    Targets at or past `total_cap` (an overflowing chunk) fall into a
    sink slot that is sliced off: the buffer then holds exactly what
    gol_tpu's `mode="drop"` keeps, and the host detects the overflow
    from the summed counts."""

    def step_n_with_diffs_compact(state, k, total_cap):
        total_cap = int(total_cap)
        buf = torch.zeros(total_cap + 1, dtype=torch.int32,
                          device=state.device)
        headers = []
        off = torch.zeros((), dtype=torch.int64, device=state.device)

        def header(d):
            changed = d != 0
            return changed, torch.cat([
                changed.sum(dtype=torch.int32).reshape(1), _bitmap(changed)])

        def emit(old, new):
            nonlocal off
            d = diff_fn(old, new).reshape(-1)
            changed, head = header(d)
            buf.scatter_(0, _ranked_targets(changed, off, total_cap), d)
            headers.append(head)
            off = off + changed.sum()

        new = _scan(step_fn, state, k, emit)
        return (new,
                _stacked(headers,
                         lambda: header(diff_fn(state, state).reshape(-1))[1]),
                buf[:total_cap], count_fn(new))

    return step_n_with_diffs_compact


def compact_decode_rows(headers, values, total_words: int):
    """Decode a compact chunk (see Stepper.step_n_with_diffs_compact)
    into flat (total_words,) uint32 word arrays. `headers` is the
    fetched (k, 1 + nb) stack viewed as uint32, `values` the
    (>= Σcounts,) uint32 value prefix. Yields one array per turn;
    raises ValueError on any inconsistency — a count disagreeing with
    its bitmap's popcount, or offsets running past the supplied values
    — so callers reject a truncated or corrupt chunk instead of
    mis-attributing words to turns."""
    nb = sparse_bitmap_words(total_words)
    if headers.ndim != 2 or headers.shape[1] != 1 + nb:
        raise ValueError(
            f"compact header shape {headers.shape} != (k, {1 + nb})"
        )
    shifts = np.arange(32, dtype=np.uint32)
    off = 0
    for t in range(headers.shape[0]):
        m = int(headers[t, 0])
        words = np.zeros(nb * 32, np.uint32)
        bits = (headers[t, 1 : 1 + nb, None] >> shifts) & 1
        idx = np.flatnonzero(bits)
        if idx.size != m:
            raise ValueError(
                f"compact turn {t}: bitmap pops {idx.size} words, "
                f"count says {m}"
            )
        if off + m > len(values):
            raise ValueError(
                f"compact chunk truncated: turn {t} needs value words "
                f"{off}..{off + m}, have {len(values)}"
            )
        if m:
            words[idx] = values[off : off + m]
        off += m
        yield words[:total_words]


def compact_value_bucket(total: int) -> int:
    """Fetched-prefix length for `total` used value words: rounded up to
    1/8th-of-a-power-of-two granularity (floor 1024), so a run slices a
    bounded set of lengths (<= 8 per octave) while wasting under 25% of
    the value bytes (gol_tpu's bucket, kept so both fetch the same
    prefix)."""
    if total <= 1024:
        return 1024
    step = 1 << ((total - 1).bit_length() - 3)
    return -(-total // step) * step


def sparse_chunk_from_dense(stack):
    """(k, ...) uint32 (or int32) dense packed diff stack -> the
    per-turn S-sparse chunk triple (counts (k,) int32, changed-word
    bitmaps (k, nb) uint32, values (Σcounts,) uint32 in ascending word
    order per turn) — the layout `compact_scan_diffs` produces on the
    device, built on the host in one vectorized pass."""
    S = np.ascontiguousarray(stack).reshape(stack.shape[0], -1)
    if S.dtype != np.uint32:
        S = S.view(np.uint32)
    k, total = S.shape
    nb = sparse_bitmap_words(total)
    changed = S != 0
    counts = changed.sum(axis=1, dtype=np.int32)
    values = S[changed]
    padded = (changed if nb * 32 == total
              else np.pad(changed, ((0, 0), (0, nb * 32 - total))))
    bitmaps = np.ascontiguousarray(
        np.packbits(padded, axis=1, bitorder="little")
    ).view(np.uint32).reshape(k, nb)
    return counts, bitmaps, values


def compact_value_prefix(values, total: int) -> np.ndarray:
    """Fetch (at least) the first `total` words of a compact chunk's
    value buffer as host uint32: the bucketed slice
    (`compact_value_bucket`), so only this prefix crosses the link."""
    if total <= 0:
        return np.zeros(0, np.uint32)
    n = min(int(values.shape[0]), compact_value_bucket(total))
    head = values[:n]
    if isinstance(head, torch.Tensor):
        head = head.cpu().numpy()
    return np.ascontiguousarray(head).view(np.uint32)


def _planes_xor(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Changed-cell words of a Generations plane stack: the OR over the
    planes of their XORs (a cell changed when any plane's bit did)."""
    changed = old[0] ^ new[0]
    for i in range(1, old.shape[0]):
        changed = changed | (old[i] ^ new[i])
    return changed


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
        step_n_with_diffs=scan_diffs(
            lambda w: life.step(w, rule=rule), torch.ne, life.alive_count),
    )


def _packed_state_stepper(name: str, rule: Rule, height: int,
                          step_n_raw, device) -> Stepper:
    """The one constructor of the backends whose device state is the packed
    int32 board (packed on `put`, unpacked only on `fetch`).
    `step_n_raw` is the (packed, n) -> packed multi-turn function; every
    single turn — `step`, `step_with_diff`, each turn of the diff scans —
    is `step_n_raw` at n = 1, so on the card it is one kernel launch.
    The XOR, the unpack, the count and the encodings stay plain PyTorch
    on the device (gol_tpu's are XLA code)."""
    _pack, _unpack, _fetch = bitlife.make_codec(height)

    def _step(p):
        return step_n_raw(p, 1)

    def _step_n(p, n):
        p = step_n_raw(p, int(n))
        return p, bitlife.count_packed(p)

    def _step_with_diff(p):
        new = _step(p)
        # Diff mask unpacked to dense (H, W) bool for cells_from_mask.
        mask = bitlife.unpack(p ^ new, height) != 0
        return new, mask, bitlife.count_packed(new)

    scan = (_step, torch.bitwise_xor, bitlife.count_packed)
    return Stepper(
        name=name,
        shards=1,
        put=lambda w: _pack(_host_tensor(w, device)),
        fetch=_fetch,
        step=_step,
        step_n=_step_n,
        step_with_diff=_step_with_diff,
        alive_count_async=bitlife.count_packed,
        # Diffs stay packed: the (k, H/32, W) XOR stack is 8x smaller
        # than dense masks on the host link.
        step_n_with_diffs=scan_diffs(*scan),
        packed_diffs=True,
        step_n_with_diffs_sparse=sparse_scan_diffs(*scan),
        step_n_with_diffs_compact=compact_scan_diffs(*scan),
    )


def _single_device_packed(rule: Rule, height: int, device) -> Stepper:
    """Bit-packed backend: the plain SWAR step, n times."""
    return _packed_state_stepper(
        "single-packed", rule, height,
        lambda p, n: bitlife.step_n_packed_raw(p, n, rule), device,
    )


def _single_device_cuda_packed(rule: Rule, height: int, width: int,
                               device) -> Stepper:
    """Packed backend whose every step runs the CUDA kernels — multi-turn
    chunks in one call, single turns and scanned turns at n = 1: kernel
    A when two copies of the packed board fit one block's shared
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
    the counterpart of gol_tpu's `_single_device_pallas`: `step`,
    `step_with_diff` and each turn of the mask scan launch it with
    n = 1 (gol_tpu's scan runs its XLA dense step instead). Selectable
    for comparison, not picked by "auto"."""
    from gol_tpu_torch.ops import cuda_life

    def _step(w):
        return cuda_life.step_n_cuda_dense(w, 1, rule)

    def _step_with_diff(w):
        new, count = cuda_life.step_n_counted_cuda_dense(w, 1, rule)
        return new, w != new, count

    return Stepper(
        name="single-cuda-dense",
        shards=1,
        put=lambda w: _host_tensor(w, device),
        fetch=lambda w: w.cpu().numpy(),
        step=_step,
        step_n=lambda w, n: cuda_life.step_n_counted_cuda_dense(
            w, int(n), rule),
        step_with_diff=_step_with_diff,
        alive_count_async=life.alive_count,
        step_n_with_diffs=scan_diffs(_step, torch.ne, life.alive_count),
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
        step_n_with_diffs=scan_diffs(
            lambda s: gens.step_states(s, rule), torch.ne, gens.alive_count),
    )


def _gens_stepper_packed(rule: GenRule, device, height: int, width: int,
                         kernels: bool) -> Stepper:
    """Packed Generations backend (ops/bitgens.py): one-hot dying-state
    bit-planes, the shared SWAR count on the alive plane, aging as a
    plane rename. With `kernels`, multi-turn chunks run the CUDA
    kernels (ops/cuda_bitgens.py) — kernel C when every plane fits one
    block's shared memory, else kernel D through the 2-D entry — and
    the stepper is "generations-cuda-packed-1"; otherwise the plain
    plane step, "generations-packed-1". Every single turn — `step`,
    `step_with_diff`, each turn of the diff scans over `_planes_xor` —
    is the multi-turn function at n = 1, so on the card one launch of
    kernel C or D."""
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

    def _step(planes):
        return raw(planes, 1, rule)

    def _step_n(planes, k):
        planes = raw(planes, int(k), rule)
        return planes, count(planes)

    def _step_with_diff(planes):
        new = _step(planes)
        mask = bitlife.unpack(_planes_xor(planes, new), height) != 0
        return new, mask, count(new)

    scan = (_step, _planes_xor, count)
    return Stepper(
        name="generations-cuda-packed-1" if kernels else "generations-packed-1",
        shards=1,
        put=put,
        fetch=_gens_fetch(to_levels),
        step=_step,
        step_n=_step_n,
        step_with_diff=_step_with_diff,
        alive_count_async=count,
        alive_mask=_gens_alive_mask,
        step_n_with_diffs=scan_diffs(*scan),
        packed_diffs=True,
        step_n_with_diffs_sparse=sparse_scan_diffs(*scan),
        step_n_with_diffs_compact=compact_scan_diffs(*scan),
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


def instrument_stepper(s: Stepper) -> Stepper:
    """Wrap a Stepper's dispatch entries with gol_tpu_torch.obs counters,
    wall-time histograms and one `stepper.<entry>` span each on
    `obs.tracing` (dataclasses.replace, the checked_stepper pattern) —
    gol_tpu's `instrument_stepper`. Everything here is host-side,
    per-DISPATCH bookkeeping: the wrapped callables receive and return
    the exact same objects, so dispatch-identity invariants and the
    pipelined diff path see nothing new.

    Timing semantics: the histograms record the host-blocking time of
    the dispatch call — true device time on the CPU, and the enqueue
    time of the launches on a CUDA stream (nothing here synchronises);
    the engine's Timeline remains the realizing profiler.

    Halo traffic: the gol_tpu_halo_* series are registered as in
    gol_tpu and stay at zero while the stepper publishes no `halo_cost`
    (every single-device backend). gol_tpu's XLA cost probe has no
    counterpart here."""
    import time

    from gol_tpu_torch import obs
    from gol_tpu_torch.obs import device as obs_device
    from gol_tpu_torch.obs import tracing

    backend = {"backend": s.name}
    dispatches = {}
    seconds = {}
    # The wrap set comes from the capability table: an entry gains
    # instrumentation by declaring a `wrap` shape in ENTRY_TABLE.
    for entry in (e.name for e in ENTRY_TABLE if e.wrap is not None):
        dispatches[entry] = obs.counter(
            "gol_tpu_stepper_dispatches_total",
            "Stepper entry invocations", {**backend, "entry": entry},
        )
        seconds[entry] = obs.histogram(
            "gol_tpu_stepper_dispatch_seconds",
            "Host-blocking seconds per stepper entry call",
            {**backend, "entry": entry},
        )
    halo_exchanges = obs.counter(
        "gol_tpu_halo_exchanges_total",
        "Ring ppermute slab sends dispatched", backend,
    )
    halo_bytes = obs.counter(
        "gol_tpu_halo_bytes_total",
        "Ring halo bytes moved (both directions, all shards)", backend,
    )
    halo_seconds = obs.histogram(
        "gol_tpu_halo_dispatch_seconds",
        "Host-blocking seconds per ring-stepper multi-turn dispatch",
        backend,
    )

    def _charge_halo(world, k, per_turn: bool):
        if s.halo_cost is None:
            return None
        cost = s.halo_cost(world, k, per_turn)
        halo_exchanges.inc(cost["exchanges"])
        halo_bytes.inc(cost["bytes"])
        return cost

    def _span(entry, wall0, dt, cost=None) -> None:
        args = {"halo_bytes": cost["bytes"]} if cost else None
        tracing.add_span(f"stepper.{entry}", "stepper", wall0, dt, args)

    def timed(entry, fn):
        disp, hist = dispatches[entry], seconds[entry]

        def wrapper(*args):
            disp.inc()
            wall0 = time.time()
            t0 = time.perf_counter()
            out = fn(*args)
            dt = time.perf_counter() - t0
            hist.observe(dt)
            _span(entry, wall0, dt)
            return out

        return wrapper

    def step_n(world, k):
        dispatches["step_n"].inc()
        cost = _charge_halo(world, int(k), False)
        wall0 = time.time()
        t0 = time.perf_counter()
        out = s.step_n(world, k)
        dt = time.perf_counter() - t0
        seconds["step_n"].observe(dt)
        if s.halo_cost is not None:
            halo_seconds.observe(dt)
        _span("step_n", wall0, dt, cost)
        # Memory census at the dispatch boundary (rate-limited inside):
        # the watermark tracks every dispatching run.
        obs_device.observe_memory(getattr(world, "device", None))
        return out

    def _diffy(entry, fn):
        def wrapper(world, k, *rest):
            dispatches[entry].inc()
            cost = _charge_halo(world, int(k), True)
            wall0 = time.time()
            t0 = time.perf_counter()
            out = fn(world, k, *rest)
            dt = time.perf_counter() - t0
            seconds[entry].observe(dt)
            _span(entry, wall0, dt, cost)
            obs_device.observe_memory(getattr(world, "device", None))
            return out

        return wrapper

    def _one_turn(entry, fn):
        def wrapper(world):
            dispatches[entry].inc()
            cost = _charge_halo(world, 1, True)
            wall0 = time.time()
            t0 = time.perf_counter()
            out = fn(world)
            dt = time.perf_counter() - t0
            seconds[entry].observe(dt)
            _span(entry, wall0, dt, cost)
            return out

        return wrapper

    # The replace set is DERIVED from the capability table: every entry
    # declaring a `wrap` shape gets that wrapper, absent entries stay
    # None.
    wrappers = {"timed": timed, "one_turn": _one_turn, "diffy": _diffy}
    repl: dict = {"put": timed("put", s.put), "step_n": step_n}
    for e in ENTRY_TABLE:
        if e.wrap is None or e.name in repl:
            continue
        fn = getattr(s, e.name)
        if fn is not None:
            repl[e.name] = wrappers[e.wrap](e.name, fn)
    return dataclasses.replace(s, **repl)


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
    CPU), wrapped as gol_tpu wraps it: with per-dispatch obs
    instrumentation unless GOL_TPU_METRICS=0 (the disabled path builds
    the bare stepper), and with the runtime dispatch-linearity checker
    when GOL_TPU_CHECK_INVARIANTS=1 (cli --check-invariants;
    gol_tpu_torch.analysis.invariants) — host-side identity checks
    only. `threads` is the reference's shard request; one device holds
    one shard, which never changes results."""
    from gol_tpu_torch import obs
    from gol_tpu_torch.analysis.invariants import (
        checked_stepper,
        invariants_enabled,
    )

    s = _make_stepper(threads, height, width, rule, device, backend, tile,
                      mesh, partition_rules)
    if obs.enabled():
        s = instrument_stepper(s)
    if invariants_enabled():
        s = checked_stepper(s)
    return s


def _make_stepper(
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
    """The bare stepper of `make_stepper`."""
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
