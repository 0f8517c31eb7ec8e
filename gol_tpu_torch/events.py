"""Typed event protocol — the public contract between engine, tests and
visualiser, re-designed from the reference's `gol/event.go`.

Six concrete event types mirror the reference exactly
(ref: gol/event.go:19-68); stringification rules mirror the reference's
Stringer set so a log consumer prints the same lines the SDL loop would
(ref: gol/event.go:72-131 — CellFlipped/TurnComplete/FinalTurnComplete
stringify to "" and are therefore never logged, ref: sdl/loop.go:44-47).

Turn numbering: `completed_turns` is the number of *fully committed*
turns, 1-based after the first turn — the convention the golden CSV uses
(check/alive/512x512.csv row 1 == after turn 1). The reference's counter
was 0-based-and-racy (ref: gol/distributor.go:94,118,294 vs
gol/event.go:12-14); this framework fixes the race and keeps the
CSV-compatible observable.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np

from gol_tpu_torch.utils.cell import Cell


class State(enum.Enum):
    """Engine execution state (ref: gol/event.go:34-45)."""

    PAUSED = 0
    EXECUTING = 1
    QUITTING = 2

    def __str__(self) -> str:  # ref: gol/event.go:110-121
        return self.name.capitalize()


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event; every event reports how many turns were complete when it
    was emitted (ref: gol/event.go:9-15)."""

    completed_turns: int

    def __str__(self) -> str:
        return ""


@dataclasses.dataclass(frozen=True)
class AliveCellsCount(Event):
    """Periodic telemetry: number of alive cells (ref: gol/event.go:19-22),
    emitted by the ticker every `tick_seconds` (ref: gol/distributor.go:290-295)."""

    cells_count: int = 0

    def __str__(self) -> str:  # ref: gol/event.go:72-75
        return f"{self.cells_count} Cells Alive"


@dataclasses.dataclass(frozen=True)
class ImageOutputComplete(Event):
    """A PGM image write finished (ref: gol/event.go:26-29)."""

    filename: str = ""

    def __str__(self) -> str:  # ref: gol/event.go:78-81
        return f"File {self.filename} output complete"


@dataclasses.dataclass(frozen=True)
class StateChange(Event):
    """Engine switched execution state (ref: gol/event.go:32-45)."""

    new_state: State = State.EXECUTING

    def __str__(self) -> str:  # ref: gol/event.go:84-87
        return f"State change to {self.new_state}"


@dataclasses.dataclass(frozen=True)
class CellFlipped(Event):
    """One cell changed state this turn (ref: gol/event.go:50-53). Emitted
    for every initially-alive cell before turn 1 (ref: gol/distributor.go:72-80)
    and for every cell whose state changed on each committed turn
    (ref: gol/distributor.go:212-220). Never logged (empty string)."""

    cell: Cell = Cell(0, 0)


@dataclasses.dataclass(frozen=True, eq=False)
class FlipBatch(Event):
    """Framework extension (no reference analog): one turn's flipped
    cells as a single (N, 2) int32 array of (x, y) pairs in row-major
    board order — semantically identical to N CellFlipped events.
    Opt-in (`Engine(emit_flip_batches=True)`): the per-cell stream is
    the reference contract, but a watched 512² board flips thousands
    of cells per turn and per-cell Python event objects cap the whole
    watched pipeline at ~30 turns/s; the server, wire and visualiser
    consume batches vectorized instead. Never logged."""

    # np.ndarray (N, 2) int32 of (x, y); the default is a valid empty
    # batch so a payload-less construction cannot poison consumers.
    cells: "object" = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32)
    )
    # Optional (N,) uint8 gray levels of the listed cells (the
    # Generations family's injective PGM levels). None = two-state
    # batch, applied as an XOR; with levels the batch SETS each cell's
    # level — the multi-state visual contract (r5: gray-level gens
    # visualisation, no more forced-headless carve-out).
    levels: "object" = None


@dataclasses.dataclass(frozen=True, eq=False)
class FlipChunk(Event):
    """Framework extension (no reference analog): a whole k-turn diff
    chunk as ONE event — the chunk-granular emit path behind the
    batched wire (ROADMAP item 1). Covers turns
    `first_turn .. completed_turns` inclusive; per-turn changed
    packed words ride in the device compact layout: `counts[t]`
    changed words for turn `first_turn + t`, their positions as the
    changed-word `bitmaps` row (uint32, bit i of word w = packed word
    w*32+i changed — the wire.grid_words convention), and the words'
    XOR `words` masks concatenated across turns in ascending word
    order per turn. Semantically identical to k FlipBatch events each
    followed by its TurnComplete; opt-in
    (`Engine(emit_flip_chunks=True)`) because at 10⁵ turns/s the
    per-turn Python event objects ARE the bottleneck — consumers
    (the wire broadcaster) expand per turn only for peers that still
    need per-turn delivery. Never logged."""

    first_turn: int = 0
    # (k,) int changed-word counts per turn.
    counts: "object" = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    # (k, nb) uint32 changed-word bitmaps, one row per turn.
    bitmaps: "object" = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.uint32)
    )
    # (Σcounts,) uint32 changed-word XOR masks.
    words: "object" = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32)
    )


@dataclasses.dataclass(frozen=True)
class TurnComplete(Event):
    """A turn was committed (ref: gol/event.go:58-60). The visualiser
    renders on this (ref: sdl/loop.go:38-40). Never logged."""


@dataclasses.dataclass(frozen=True)
class FinalTurnComplete(Event):
    """The run finished; carries the complete alive-cell set — the payload
    the golden tests assert on (ref: gol/event.go:65-68, gol_test.go:36-41)."""

    alive: List[Cell] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True, eq=False)
class BoardSync(Event):
    """Framework extension (no reference analog): a full host copy of the
    committed world, emitted by the engine when a controller attaches
    mid-run. Riding the event stream — not a side channel — is what makes
    the attach sync ordered against per-turn CellFlipped diffs: BoardSync
    at turn N is always followed by flips for N+1, never overlapped.
    Plays the role of the reference's commented GetCurrentBoard RPC
    (ref: gol/distributor.go:489-498). Never logged (empty string).

    `token` identifies the requester, so a sync queued for a subscriber
    that vanished before it was serviced is dropped instead of being
    delivered to the next subscriber."""

    world: "object" = None  # np.ndarray (H, W) {0,255}
    token: int = 0
