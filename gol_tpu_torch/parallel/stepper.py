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
- `tile=T`: the activity-driven tiled backend (`parallel/tiled.py`): a
  host-resident packed universe of T x T macro-tiles, each chunk's
  active ghost-extended tiles stepped as one slab by one launch of the
  batched kernel A; two-state rules only, built before the rule
  dispatch as in gol_tpu.

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
backends; the tiled backend offers `fetch_diffs` (its diff stack is
already on the host) and `tiled`, as gol_tpu's does.

Rings and meshes of shards, as gol_tpu builds them from `threads` and
`devices` (or `mesh`): the packed Life ring (`packed_halo.py`), its
balanced split for non-divisor shard counts, the dense ring
(`halo.py`), the Generations rings (`gens_halo.py`) and the 2-D meshes
(`mesh2d.py`). Their world is a `partition.Sharded` — one tensor per
shard, on its device — and every local step of a shard on a CUDA
device is a launch of kernel A, B, C, D or E (the dense Generations
ring alone steps with the plain state step, as the single-device
dense Generations backend does). They offer gol_tpu's capability sets,
`fetch_diffs` and the Life rings' and meshes' `halo_cost` included. The
device list may repeat a device: ``devices=["cpu"] * 4`` is a 4-shard
ring on the CPU, ``[cuda:0] * 4`` one on a single card.

In a multi-process job (`parallel/multihost.py`) a ring or mesh built
without a device list spans every process's devices, round-robin; the
coordinator's is wrapped by `multihost.spmd_stepper`, which broadcasts
each dispatch's opcode from `ENTRY_TABLE` so the workers replay it on
their shards.

`make_batch_stepper` builds the backend of one session bucket
(`BatchStepper`): S boards of one shape stepped together, each k-turn
chunk of a packable bucket one launch of kernel A's batched entry
(`bucket_route`).

`make_stepper` wraps the backend as gol_tpu's does: `instrument_stepper`
(per-entry dispatch counters, host-blocking histograms and spans) unless
metrics are off, then `analysis.invariants.checked_stepper` when the
invariant checker is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gol_tpu_torch.models.rules import LIFE, GenRule, Rule, get_rule
from gol_tpu_torch.ops import bitgens, bitlife, generations as gens, life
from gol_tpu_torch.params import BACKENDS


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
    #: Host fetch of a diff stack that the stepper builds itself (the
    #: tiled backend's host stack; gol_tpu's sharded gathers); None on
    #: the single-device backends, whose stacks the engine copies.
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
    #: The sharded backends' halo pricing; not offered yet.
    halo_cost: Optional[Callable] = None
    #: The activity plane of the tiled backend (`tiled.TiledStepper`).
    tiled: Optional[object] = None
    #: The kernel every launch of a fused chunk runs, where the board's
    #: shape fixes it (the CUDA packed Life backend); the engine names it
    #: on its `engine.dispatch` chunk spans. None elsewhere.
    kernel: Optional[str] = None

    def alive_count(self, world) -> int:
        return int(self.alive_count_async(world))

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


def _stacked(rows: list, empty_row: Callable, axis: int = 0) -> torch.Tensor:
    """The per-turn rows as one tensor with the turn axis at `axis`
    ((k, ...) for one board, (S, k, ...) for a bucket); k = 0 gives an
    empty stack shaped like `empty_row()`."""
    if rows:
        return torch.stack(rows, dim=axis)
    row = empty_row()
    shape = list(row.shape)
    shape.insert(axis, 0)
    return row.new_empty(shape)


def scan_diffs(step_fn, diff_fn, count_fn, lead: int = 0):
    """Build a `step_n_with_diffs`: k turns of `step_fn`, the per-turn
    output `diff_fn(old, new)` stacked on the device, and the alive
    count once on the final state. `lead` leading axes of the state
    index independent boards (1 for a session bucket's (S, ...) stack,
    gol_tpu's vmap): the turn axis goes after them."""

    def step_n_with_diffs(state, k):
        diffs = []
        new = _scan(step_fn, state, k,
                    lambda old, nxt: diffs.append(diff_fn(old, nxt)))
        return (new, _stacked(diffs, lambda: diff_fn(state, state), lead),
                count_fn(new))

    return step_n_with_diffs


def sparse_bitmap_words(total_words: int) -> int:
    """int32 words in the changed-word bitmap for a diff space of
    `total_words` packed words — the one layout constant the encoder
    and the decoders share."""
    return -(-total_words // 32)


def _bitmap(changed: torch.Tensor) -> torch.Tensor:
    """(..., total) bool changed-word flags -> (..., nb) int32 bitmap
    words, bit i of word w set when word 32w + i changed (one bitmap per
    leading index: a bucket's sessions each get their own). Built in
    int64 (a sum of bit weights up to 2**32 - 1 needs no overflowing
    shift or sum), then narrowed to the two's-complement int32 bit
    pattern explicitly."""
    total = changed.shape[-1]
    lead = changed.shape[:-1]
    nb = sparse_bitmap_words(total)
    bits = torch.zeros((*lead, nb * 32), dtype=torch.int64,
                       device=changed.device)
    bits[..., :total] = changed
    weights = torch.ones(32, dtype=torch.int64, device=changed.device) << (
        torch.arange(32, dtype=torch.int64, device=changed.device))
    words = (bits.view(*lead, nb, 32) * weights).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def _ranked_targets(changed: torch.Tensor, base, cap: int) -> torch.Tensor:
    """Scatter targets of a turn's changed words (along the last dim),
    without a data-dependent shape: base + rank (rank = cumsum(changed)
    - 1) where a word changed and the target is below `cap`, else the
    sink slot `cap` (one past the end, sliced off by the caller) —
    jnp.nonzero's first-`cap` truncation and `mode="drop"` in one form.
    `base` is a scalar, or one offset per leading index."""
    pos = torch.cumsum(changed, -1) - 1 + base
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


def compact_scan_diffs(step_fn, diff_fn, count_fn, lead: int = 0):
    """Build a `step_n_with_diffs_compact`: per turn only the [count,
    bitmap] header, while the changed-word VALUES are stream-compacted
    into one shared (total_cap,) int32 buffer — each turn's words at
    offset sum(counts so far) + rank, ascending word index within a
    turn. The offset stays a device tensor, so the host never waits.
    Targets at or past `total_cap` (an overflowing chunk) fall into a
    sink slot that is sliced off: the buffer then holds exactly what
    gol_tpu's `mode="drop"` keeps, and the host detects the overflow
    from the summed counts.

    `lead` leading axes of the state index independent boards, as in
    `scan_diffs`: each gets its own headers, buffer and offset
    (gol_tpu's vmap of `_compact_scan`), so a bucket's (S, ...) stack
    gives (S, k, 1 + nb) headers and (S, total_cap) values, and one
    session overflowing leaves the others whole."""

    def step_n_with_diffs_compact(state, k, total_cap):
        total_cap = int(total_cap)
        shape = state.shape[:lead]
        buf = torch.zeros((*shape, total_cap + 1), dtype=torch.int32,
                          device=state.device)
        headers = []
        off = torch.zeros((*shape, 1), dtype=torch.int64,
                          device=state.device)

        def header(d):
            changed = d != 0
            return changed, torch.cat([
                changed.sum(dim=-1, dtype=torch.int32, keepdim=True),
                _bitmap(changed)], dim=-1)

        def flat(old, new):
            return diff_fn(old, new).reshape(*shape, -1)

        def emit(old, new):
            nonlocal off
            d = flat(old, new)
            changed, head = header(d)
            buf.scatter_(-1, _ranked_targets(changed, off, total_cap), d)
            headers.append(head)
            off = off + changed.sum(dim=-1, keepdim=True)

        new = _scan(step_fn, state, k, emit)
        return (new,
                _stacked(headers, lambda: header(flat(state, state))[1],
                         lead),
                buf[..., :total_cap], count_fn(new))

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


@dataclasses.dataclass
class BatchStepper:
    """Execution backend of one session BUCKET (gol_tpu_torch.sessions):
    `capacity` boards of one shape and rule stacked on a leading axis —
    int32 (S, H/32, W) packed words when the grid packs, uint8 (S, H, W)
    otherwise — the fields, refusals and `offers()` of gol_tpu's vmapped
    `BatchStepper`, so S tenants share one dispatch.

    How a stack steps on the card is `bucket_route(H, W)`:
    - "resident": packable, and two copies of one board fit a cluster
      plan of kernel A (`cuda_bitlife._cluster_plan`; 256² up to about
      2048²). A k-turn chunk is ONE launch of kernel A's batched entry
      for the whole stack, padding slots included; each turn of the diff
      scans is one launch of n = 1 over the stack, then the XOR with the
      previous stack — k launches a watched chunk, whatever S is.
    - "tiled2d": packable with no cluster plan (4096²: two copies need
      589,824 bytes of shared memory for 8 slabs). Each slot steps through
      kernel B's 2-D entry, one launch per slot per pass.
    - "dense": not packable (H % 32 != 0). Each slot steps through kernel
      E (`cuda_life.step_n_cuda_dense`); a board kernel E cannot plan
      raises when the bucket is built.
    On the CPU the same wrappers run their plain versions (the 3-D stack
    through `bitlife.step_n_packed_raw`, `life.step_n` per slot). No
    route steps a CUDA stack through plain PyTorch.

    Every step writes a NEW stack (a cluster reads its ghost rows from
    the input), so the pre-dispatch stack stays valid until the caller
    drops it — the compact overflow redo restarts from it. `set_one` and
    `clear_one` write the slot in place, on the stack's device and
    current stream, ordered after the launches that read it; the slot
    index is a plain int (nothing is compiled per slot).

    Padding: free slots hold all-zero boards and are stepped like any
    tenant. A zero board stays zero under any rule without birth-on-0,
    which is why the factory rejects B0 rules."""

    name: str
    capacity: int
    height: int
    width: int
    rule: Rule
    packed: bool
    #: packed words per board (0 on the dense route) — the decode space
    #: `compact_decode_rows`/`sparse_decode_rows` need.
    total_words: int
    #: list of `capacity` host (H, W) uint8 boards -> device stack
    put_all: Callable
    #: (stack, slot) -> host (H, W) {0,255} uint8 board
    fetch_one: Callable
    #: (stack, slot, host (H, W) board) -> stack
    set_one: Callable
    #: (stack, slot) -> stack with that slot zeroed
    clear_one: Callable
    #: (stack, k) -> (stack, (S,) int32 per-session alive counts)
    step_n: Callable
    #: (stack, k) -> (stack, per-session diff stacks, counts): int32
    #: (S, k, H/32, W) packed XOR rows when packed (gol_tpu's uint32
    #: words, bitcast), bool (S, k, H, W) masks otherwise — row t of
    #: session s is what the single-board `step_n_with_diffs` gives.
    step_n_with_diffs: Callable
    #: (stack, k, total_cap) -> (stack, (S, k, 1+nb) int32 headers,
    #: (S, total_cap) int32 values, counts): `compact_scan_diffs` per
    #: session — each session its own [count, bitmap] headers, its own
    #: value buffer and offset. None on the dense route.
    step_n_with_diffs_compact: Optional[Callable] = None
    #: () -> census of the stacks stepped so far: {"stacks": [(S, *board
    #: shape, route)]}. gol_tpu reports its jit cache here; this port
    #: compiles nothing per shape, so a warm bucket's census stays put
    #: across create / destroy / checkpoint / park.
    cache_sizes: Optional[Callable] = None

    def offers(self, entry: str) -> bool:
        """Capability probe, sharing ENTRY_TABLE's entry names where a
        bucket field mirrors a Stepper entry (same contract as
        `Stepper.offers`)."""
        entry_info(entry)  # unknown entry names are programming errors
        value = getattr(self, entry, None)
        return value is not None and value is not False


def bucket_route(height: int, width: int) -> str:
    """How the card steps a bucket of (height, width) boards:
    "resident" (one batched launch of kernel A for the stack), "tiled2d"
    (kernel B's 2-D entry per slot) or "dense" (kernel E per slot) — see
    `BatchStepper`."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    if not bitlife.packable(height, width):
        return "dense"
    try:
        cb._cluster_plan(height // bitlife.WORD, width, 2)
    except ValueError:
        return "tiled2d"
    return "resident"


def _bucket_step(route: str, rule: Rule):
    """(stack, n) -> a new stack, every slot n turns on, through the
    route's wrapper (kernel on a CUDA stack, plain version on a CPU one)."""
    from gol_tpu_torch.ops import cuda_bitlife as cb, cuda_life

    if route == "resident":
        return lambda stack, n: cb.step_n_packed_batch_cuda_raw(
            stack, int(n), rule)
    one = (cb.step_n_packed_tiled2d_raw if route == "tiled2d"
           else cuda_life.step_n_cuda_dense)
    return lambda stack, n: torch.stack(
        [one(stack[i], int(n), rule) for i in range(stack.shape[0])])


def make_batch_stepper(capacity: int, height: int, width: int,
                       rule: Rule | str = LIFE, device=None) -> BatchStepper:
    """Build a session bucket's backend on `device` (None: the CUDA
    card; "cpu" for the plain versions): packed SWAR per session when the
    grid packs, dense otherwise, each step routed as `bucket_route`
    says. Two-state rules only, as in gol_tpu."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    rule = get_rule(rule) if isinstance(rule, str) else rule
    if isinstance(rule, GenRule):
        raise ValueError(
            "session buckets are two-state only (multi-state rules "
            "need per-bucket plane stacks — not yet offered)"
        )
    if 0 in rule.birth:
        raise ValueError(
            f"rule {rule} births on 0 neighbours — empty padding slots "
            "would seethe, so B0 rules cannot share a padded bucket"
        )
    if capacity < 1:
        raise ValueError("bucket capacity must be >= 1")
    if capacity > cb.MAX_BATCH:
        raise ValueError(f"bucket capacity {capacity} is over the "
                         f"{cb.MAX_BATCH} boards one launch takes "
                         "(cuda_bitlife.MAX_BATCH)")
    dev = resolve_device(device)
    packed = bitlife.packable(height, width)
    route = bucket_route(height, width)
    if dev.type == "cuda":
        # Plan the route's kernel now: a board it cannot take raises
        # here, never at the first dispatch, and never falls back.
        if route == "tiled2d":
            cb._tiled2d_geometry(height // bitlife.WORD, width, None)
        elif route == "dense":
            from gol_tpu_torch.ops import cuda_life

            cuda_life._dense_plan(height, width)
    stack_step = _bucket_step(route, rule)
    census: set = set()

    def _seen(stack):
        census.add((*stack.shape, route))
        return stack

    if packed:
        def host_one(board):
            return bitlife.pack_np(board).view(np.int32)

        def to_host(one):
            return bitlife.unpack_np(one.view(np.uint32), height)

        def counts(stack):
            return bitlife.popcount(stack).sum(dim=(1, 2), dtype=torch.int32)

        diff1 = torch.bitwise_xor
    else:
        def host_one(board):
            return np.asarray(board, np.uint8)

        def to_host(one):
            return one

        def counts(stack):
            return (stack != 0).sum(dim=(1, 2), dtype=torch.int32)

        diff1 = torch.ne

    def _on_device():
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def put_all(boards):
        if len(boards) != capacity:
            raise ValueError(
                f"put_all needs {capacity} boards, got {len(boards)}"
            )
        host = np.stack([host_one(np.asarray(b)) for b in boards])
        return _seen(torch.from_numpy(host).to(dev))

    def fetch_one(stack, slot):
        return to_host(stack[int(slot)].cpu().numpy())

    def set_one(stack, slot, board):
        b = np.asarray(board)
        if b.shape != (height, width):
            raise ValueError(f"board shape {b.shape} != {(height, width)}")
        with _on_device():
            stack[int(slot)].copy_(torch.from_numpy(host_one(b)).to(dev))
        return stack

    def clear_one(stack, slot):
        with _on_device():
            stack[int(slot)].zero_()
        return stack

    def step_n(stack, k):
        out = _seen(stack_step(stack, max(int(k), 0)))
        return out, counts(out)

    def step1(stack):
        return stack_step(stack, 1)

    scan = (step1, diff1, counts)
    scan_n = scan_diffs(*scan, lead=1)
    compact_n = compact_scan_diffs(*scan, lead=1)

    def step_n_with_diffs(stack, k):
        return scan_n(_seen(stack), k)

    def step_n_with_diffs_compact(stack, k, total_cap):
        return compact_n(_seen(stack), k, total_cap)

    return BatchStepper(
        name=("bucket-packed" if packed else "bucket-dense")
        + f"-{capacity}",
        capacity=capacity,
        height=height,
        width=width,
        rule=rule,
        packed=packed,
        total_words=(height // bitlife.WORD) * width if packed else 0,
        put_all=put_all,
        fetch_one=fetch_one,
        set_one=set_one,
        clear_one=clear_one,
        step_n=step_n,
        step_n_with_diffs=step_n_with_diffs,
        step_n_with_diffs_compact=(step_n_with_diffs_compact if packed
                                   else None),
        cache_sizes=lambda: {"stacks": sorted(census)},
    )


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


def resolve_devices(device=None, devices=None) -> list:
    """The device list a stepper may shard over: `devices` as given (a
    device may repeat), else `[device]` when the caller names one, else
    every CUDA card (`torch.cuda.device_count()`). Each is checked by
    `resolve_device`."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        return devs
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_count(requested: int, height: int, n_devices: int) -> int:
    """Actual shard count for a request: capped by the device count and
    the grid height (a shard must own at least one row), but NOT by
    divisibility — non-dividing counts run the balanced split, so every
    requested device does work."""
    return max(1, min(requested, n_devices, height))


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


def _packed_state_stepper(name: str, height: int, step_n_raw, put, fetch,
                          changed=torch.bitwise_xor, count=None,
                          alive_mask=None, kernel=None) -> Stepper:
    """The one constructor of the single-device backends whose device
    state is packed int32 words (packed on `put`, unpacked only on
    `fetch`): the Life-like board (`_life_codec`) and the Generations
    planes. `step_n_raw` is the (packed, n) -> packed multi-turn
    function; every single turn — `step`, `step_with_diff`, each turn
    of the diff scans — is `step_n_raw` at n = 1, so on the card it is
    one kernel launch. `changed` gives the changed-cell words of two
    states (their XOR; the planes' `_planes_xor`), `count` the alive
    count of one (None: `bitlife.count_packed`, looked up at build),
    `kernel` the kernel `step_n_raw` launches (`Stepper.kernel`).
    The unpack, the count and the encodings stay plain PyTorch on the
    device (gol_tpu's are XLA code)."""
    count = count or bitlife.count_packed

    def _step(p):
        return step_n_raw(p, 1)

    def _step_n(p, n):
        p = step_n_raw(p, int(n))
        return p, count(p)

    def _step_with_diff(p):
        new = _step(p)
        # Diff mask unpacked to dense (H, W) bool for cells_from_mask.
        mask = bitlife.unpack(changed(p, new), height) != 0
        return new, mask, count(new)

    scan = (_step, changed, count)
    return Stepper(
        name=name,
        shards=1,
        put=put,
        fetch=fetch,
        step=_step,
        step_n=_step_n,
        step_with_diff=_step_with_diff,
        alive_count_async=count,
        alive_mask=alive_mask,
        # Diffs stay packed: the (k, H/32, W) XOR stack is 8x smaller
        # than dense masks on the host link.
        step_n_with_diffs=scan_diffs(*scan),
        packed_diffs=True,
        step_n_with_diffs_sparse=sparse_scan_diffs(*scan),
        step_n_with_diffs_compact=compact_scan_diffs(*scan),
        kernel=kernel,
    )


def _life_codec(height: int, device) -> tuple:
    """(put, fetch) of the Life-like packed backends: the {0,255} host
    board packed on `device`, unpacked on fetch (`bitlife.make_codec`)."""
    pack, _unpack, fetch = bitlife.make_codec(height)
    return (lambda w: pack(_host_tensor(w, device))), fetch


def _single_device_packed(rule: Rule, height: int, device,
                          layout: Optional[str] = None) -> Stepper:
    """Bit-packed backend: the plain SWAR step, n times. `layout` selects
    a registered kernel layout of the partition table
    (`partition.LAYOUTS`, e.g. ``lane-coupled``, whose every chunk turn
    is a kernel launch on a CUDA device) for every step — bit-exact
    either way."""
    if layout is not None:
        from gol_tpu_torch.parallel import partition

        raw = partition.get_layout(layout)(rule)
        name = f"single-packed-{layout}"
    else:
        raw = lambda p, n: bitlife.step_n_packed_raw(p, n, rule)  # noqa: E731
        name = "single-packed"
    return _packed_state_stepper(name, height, raw,
                                 *_life_codec(height, device))


def _single_device_cuda_packed(rule: Rule, height: int, width: int,
                               device) -> Stepper:
    """Packed backend whose every step runs the CUDA kernels — multi-turn
    chunks in one call, single turns and scanned turns at n = 1: kernel
    A when two copies of the packed board fit one block's shared
    memory, else kernel B through the 2-D entry point (the counterpart
    of gol_tpu's `_single_device_pallas_packed`). Unlike the TPU's, the
    strip and 2-D entries launch kernel B with the same default tiles,
    so there is no third choice. The board's shape picks the kernel
    (`cuda_bitlife.step_n_packed_kernel_raw`), so the stepper names it
    and sets `gol_tpu_stepper_launch_blocks{kernel}` to the blocks one
    launch occupies (`cuda_bitlife.kernel_plan`) once, here."""
    from gol_tpu_torch import obs
    from gol_tpu_torch.ops import cuda_bitlife as cb

    kernel, blocks = cb.kernel_plan(height // bitlife.WORD, width)
    obs.gauge("gol_tpu_stepper_launch_blocks",
              "Thread blocks one launch of the stepper's kernel occupies, "
              "as the board's shape plans it", {"kernel": kernel}).set(blocks)
    return _packed_state_stepper(
        "single-cuda-packed", height,
        lambda p, n: cb.step_n_packed_kernel_raw(p, n, rule),
        *_life_codec(height, device), kernel=kernel,
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


def _translated(entry: str, fn):
    """A Generations stepper's host translation between gray levels and
    states (`fn`), timed: each call observes
    `gol_tpu_stepper_translate_seconds{entry}` and records a
    `stepper.translate` span, inside the `stepper.put` / `stepper.fetch`
    span of the call that makes it. With metrics off at build
    (GOL_TPU_METRICS=0), `fn` itself."""
    import time

    from gol_tpu_torch import obs
    from gol_tpu_torch.obs import tracing

    if not obs.enabled():
        return fn
    hist = obs.histogram(
        "gol_tpu_stepper_translate_seconds",
        "Host seconds translating a Generations board between gray "
        "levels and states", {"entry": entry})

    def timed(arr):
        wall0 = time.time()
        t0 = time.perf_counter()
        out = fn(arr)
        dt = time.perf_counter() - t0
        hist.observe(dt)
        tracing.add_span("stepper.translate", "stepper", wall0, dt,
                         {"entry": entry})
        return out

    return timed


def _gens_stepper(rule: GenRule, device) -> Stepper:
    """Generations backend on the dense uint8 state grid
    (ops/generations.py): `put` and `fetch` translate to/from the
    injective gray-level representation the PGM/event layer speaks, so
    snapshots remain complete resumable checkpoints."""
    to_states = _translated("put",
                            lambda w: gens.states_from_levels(w, rule))
    to_levels = _translated("fetch",
                            lambda s: gens.levels_from_states(s, rule))
    return Stepper(
        name="generations-1",
        shards=1,
        put=lambda w: _host_tensor(to_states(w), device),
        fetch=_gens_fetch(lambda s: to_levels(s.cpu().numpy())),
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
    plane step, "generations-packed-1". The entries are
    `_packed_state_stepper`'s over the planes, diffs by `_planes_xor`:
    on the card every single turn is one launch of kernel C or D."""
    raw = bitgens.step_n_packed_gens_raw
    if kernels:
        from gol_tpu_torch.ops import cuda_bitgens as cg

        raw = cg.step_n_packed_gens_kernel_raw
        if not (cg.fits_cuda_gens(height, width, rule)
                or cg.fits_cuda_gens_tiled(height, width, rule)):
            raise ValueError(
                f"grid {height}x{width} with {rule.states} states does not "
                "fit the packed CUDA Generations kernels"
            )

    to_states = _translated("put",
                            lambda w: gens.states_from_levels(w, rule))
    levels_of = _translated("fetch",
                            lambda s: gens.levels_from_states(s, rule))

    def put(w):
        # Packed on the device: the planes of `bitgens.pack_states`.
        states = _host_tensor(to_states(w), device)
        return torch.stack([bitlife.pack(states == s)
                            for s in range(1, rule.states)])

    def to_levels(planes):
        # `bitgens.unpack_states` on the device, then the gray levels.
        states = torch.zeros((height, width), dtype=torch.uint8,
                             device=planes.device)
        for s in range(1, rule.states):
            states = torch.where(bitlife.unpack(planes[s - 1], height) != 0,
                                 s, states)
        return levels_of(states.cpu().numpy())

    return _packed_state_stepper(
        "generations-cuda-packed-1" if kernels else "generations-packed-1",
        height, lambda p, n: raw(p, n, rule), put, _gens_fetch(to_levels),
        changed=_planes_xor,
        count=lambda planes: bitlife.count_packed(planes[0]),
        alive_mask=_gens_alive_mask,
    )


def _spmd(s: Stepper, devs: list) -> Stepper:
    """A ring or mesh over `devs`: on the coordinator of a job it spans,
    wrapped to mirror its dispatches to the workers (gol_tpu's rule);
    the workers get the ring itself and replay it
    (`multihost.spmd_worker_loop`)."""
    from gol_tpu_torch.parallel import multihost

    if multihost.is_multiprocess_mesh(devs) and multihost.is_coordinator():
        return multihost.spmd_stepper(s)
    return s


def _make_gens_stepper(rule: GenRule, height: int, width: int, devs: list,
                       threads: int, backend: str) -> Stepper:
    """gol_tpu's GenRule branch of `make_stepper`, with "cuda-packed"
    added for one device: one-hot packed planes on whole-word strips (the
    balanced split for non-divisor shard counts), the dense state ring
    otherwise."""
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
    k = shard_count(threads, height, len(devs))
    if k > 1:
        from gol_tpu_torch.parallel import gens_halo as gh

        if backend == "cuda-packed":
            raise ValueError(f"{backend} backend is single-device only")
        even = gh.packable_gens_sharded(height, k)
        uneven = gh.packable_gens_sharded_uneven(height, k)
        if backend == "packed" and not (even or uneven):
            raise ValueError(
                f"grid height {height} over {k} shards is not packable "
                f"(each shard must own at least one whole 32-row word)"
            )
        if want_packed and even:
            return gh.packed_gens_sharded_stepper(rule, devs[:k], height,
                                                  width)
        if want_packed and uneven:
            return gh.packed_gens_sharded_stepper_uneven(
                rule, devs[:k], height, width)
        return gh.gens_sharded_stepper(rule, devs[:k], height, width)
    dev = devs[0]
    if want_packed and packable:
        kernels = backend == "cuda-packed" or (
            backend == "auto" and dev.type == "cuda"
        )
        return _gens_stepper_packed(rule, dev, height, width, kernels)
    return _gens_stepper(rule, dev)


def _make_ring(rule: Rule, height: int, width: int, devs: list,
               backend: str) -> Stepper:
    """gol_tpu's Life-like ring choice over `devs` (k > 1 shards): the
    packed ring on whole-word strips, its balanced split where the
    word-rows do not divide, the dense ring otherwise ("dense" forces
    it)."""
    from gol_tpu_torch.parallel import halo, packed_halo as ph

    k = len(devs)
    if backend in ("cuda-packed", "cuda-dense"):
        raise ValueError(f"{backend} backend is single-device only")
    even = ph.packable_sharded(height, k)
    uneven = ph.packable_sharded_uneven(height, k)
    if backend == "packed" and not (even or uneven):
        raise ValueError(
            f"grid height {height} over {k} shards is not packable "
            f"(each shard must own at least one whole 32-row word)"
        )
    if backend != "dense" and even:
        return ph.packed_sharded_stepper(rule, devs, height, width)
    if backend != "dense" and uneven:
        return ph.packed_sharded_stepper_uneven(rule, devs, height, width)
    return halo.sharded_stepper(rule, devs, height, width)


def _make_mesh(rule, height: int, width: int, devs: list, backend: str,
               tile: int, rows: int, cols: int,
               partition_rules: Optional[str]) -> Stepper:
    """gol_tpu's mesh branch: an explicit rows x cols mesh selects the
    2-D family (the degenerate 1xN / Nx1 shapes included), packed only,
    exclusive with tiling."""
    from gol_tpu_torch.parallel import mesh2d

    if tile:
        raise ValueError(
            "--mesh and --tile are exclusive (the tiled "
            "backend's dispatch set is its parallelism axis)"
        )
    if backend not in ("auto", "packed"):
        raise ValueError(
            f"mesh backends are packed-only (backend auto/"
            f"packed, not {backend!r})"
        )
    need = rows * cols
    if len(devs) < need:
        raise ValueError(
            f"mesh {rows}x{cols} needs {need} devices, "
            f"have {len(devs)}"
        )
    build = (mesh2d.mesh2d_packed_gens_stepper if isinstance(rule, GenRule)
             else mesh2d.mesh2d_packed_stepper)
    return build(rule, devs[:need], height, width, rows, cols,
                 partition_rules)


def _placed_price(price: dict, world) -> dict:
    """The price of the state `put` placed: a sharded world prices the
    rows it holds, a balanced split's padding included (gol_tpu's XLA
    cost of the padded program does too)."""
    from gol_tpu_torch.parallel.partition import Sharded

    if not isinstance(world, Sharded):
        return price
    rows = world.shape[-2] * (bitlife.WORD if price["layout"] == "packed"
                              else 1)
    return {**price, "height": rows}


def instrument_stepper(s: Stepper, price: Optional[dict] = None) -> Stepper:
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
    gol_tpu and count what the stepper's `halo_cost` prices for each
    dispatch (the Life rings and the meshes); they stay at zero for a
    stepper without one (every single-device backend).

    Cost probe: with `price` (`obs.device.cost_of`'s arguments) and the
    probes enabled (`device.enable_cost_probes`, the CLI's default), the
    FIRST `put` publishes the one-turn "engine.step" price — at put
    time, as gol_tpu probes, so that nothing of it lands inside a
    dispatch's timing.

    No memory census: the code that owns a dispatch boundary takes it
    (the engine, a multi-process worker's replay loop), where it can
    place the census between the card's chunks."""
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

    probed = []
    _timed_put = timed("put", s.put)

    def put(host_world):
        out = _timed_put(host_world)
        if price is not None and not probed \
                and obs_device.cost_probes_enabled():
            probed.append(True)
            obs_device.publish_cost("engine.step", **_placed_price(price,
                                                                  out))
        return out

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
    repl: dict = {"put": put, "step_n": step_n}
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
    devices: Optional[list] = None,
) -> Stepper:
    """Build the stepper for the request, wrapped as gol_tpu wraps it:
    with per-dispatch obs instrumentation unless GOL_TPU_METRICS=0 (the
    disabled path builds the bare stepper), and with the runtime
    dispatch-linearity checker when GOL_TPU_CHECK_INVARIANTS=1 (cli
    --check-invariants; gol_tpu_torch.analysis.invariants) — host-side
    identity checks only.

    Devices (`resolve_devices`): `devices` lists the devices to shard
    over (a device may repeat); else `device` names one ("cpu" runs the
    plain versions on the CPU); else every CUDA card. `threads` is the
    reference's shard request, capped by the device count and the
    height (`shard_count`): on one card, or on the CPU without a device
    list, it is one shard, which never changes results. `mesh` ("RxC"
    or (rows, cols)) selects the 2-D mesh backends (parallel/mesh2d.py,
    --mesh); `partition_rules` is the operator override string of the
    partition table (--partition-rule)."""
    from gol_tpu_torch import obs
    from gol_tpu_torch.analysis.invariants import (
        checked_stepper,
        invariants_enabled,
    )

    s = _make_stepper(threads, height, width, rule, device, backend, tile,
                      mesh, partition_rules, devices)
    if obs.enabled():
        rule = get_rule(rule) if isinstance(rule, str) else rule
        name = s.name.removeprefix("spmd-")
        dense = (name in ("single", "single-cuda-dense", "generations-1")
                 or name.startswith(("halo-ring", "gens-halo-ring")))
        s = instrument_stepper(s, price={
            "height": height, "width": width, "rule": rule,
            "layout": "dense" if dense else "packed"})
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
    devices: Optional[list] = None,
) -> Stepper:
    """The bare stepper of `make_stepper` — gol_tpu's routes: the mesh,
    the tiled backend, the Generations family, the Life-like rings, then
    one device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if threads < 1:
        raise ValueError("threads must be >= 1")
    rule = get_rule(rule) if isinstance(rule, str) else rule
    layout = None
    if partition_rules:
        from gol_tpu_torch.parallel import partition

        # Parse once up front: a bad override string fails the build,
        # not the first dispatch; `layout=NAME` rides to the
        # single-device packed path below.
        _, layout = partition.parse_overrides(partition_rules)
    from gol_tpu_torch.parallel import multihost

    multiprocess = devices is None and multihost.process_count() > 1
    # A job's shards are every process's devices, round-robin so a
    # k-shard prefix spans every process; each process builds the same
    # ring and steps its own shards, and the coordinator's stepper
    # mirrors its dispatches to the workers (multihost.spmd_stepper).
    devs = (multihost.round_robin_devices() if multiprocess
            else resolve_devices(device, devices))
    if mesh is not None:
        from gol_tpu_torch.parallel import partition

        rows, cols = (
            partition.parse_mesh(mesh) if isinstance(mesh, str)
            else (int(mesh[0]), int(mesh[1]))
        )
        if rows * cols > 1:
            return _spmd(_make_mesh(rule, height, width, devs, backend,
                                    tile, rows, cols, partition_rules),
                         devs[:rows * cols])
    if tile:
        if multiprocess:
            raise ValueError(
                "tiled stepping is single-process (the dispatch set is "
                "its parallelism axis; multi-chip composes at the "
                "partition-rule layer, not here)"
            )
        from gol_tpu_torch.parallel.tiled import tiled_stepper

        return tiled_stepper(rule, height, width, tile, device=devs[0])
    k = shard_count(threads, height, len(devs))
    if multiprocess and k < multihost.process_count():
        raise ValueError(
            f"threads={threads} shards cannot span the "
            f"{multihost.process_count()}-process job — every process "
            "must own at least one shard (raise -t or shrink the job)"
        )
    if isinstance(rule, GenRule):
        return _spmd(_make_gens_stepper(rule, height, width, devs, threads,
                                        backend), devs[:k])
    if k > 1:
        return _spmd(_make_ring(rule, height, width, devs[:k], backend),
                     devs[:k])
    dev = devs[0]
    packable = bitlife.packable(height, width)
    if layout is not None and backend in ("auto", "packed") and packable:
        # The operator's kernel layout takes the single-device packed
        # board on either device.
        return _single_device_packed(rule, height, dev, layout=layout)
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
