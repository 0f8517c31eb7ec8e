"""Runtime invariant checker — the port's copy of
`gol_tpu.analysis.invariants`: the protocol orderings the engine and
(later) the distributed plane ASSUME, asserted.

Two monitors, both cheap enough to leave on in tests and opt into in
production via `GOL_TPU_CHECK_INVARIANTS=1` (cli: `--check-invariants`):

- `EventStreamChecker` watches one engine event stream (gol_tpu's
  server wraps its broadcaster loop with it; the port's tests wrap an
  engine's stream) and asserts:
    * FlipBatch/TurnComplete adjacency: flips for turn t are flushed by
      TurnComplete(t) before anything else claims the stream position —
      the ordering distributed/server.py's per-peer flush relies on;
    * no flips buffered across a BoardSync: a sync supersedes any
      batched diff, so an unflushed FlipBatch crossing one would be
      double-applied by XOR consumers (ADVICE #1's corruption mode);
    * monotone committed turns: TurnComplete strictly increases, and no
      FlipBatch/BoardSync rewinds behind the stream position (a stale
      event is a reordering bug upstream, not a display glitch).
- `DispatchLinearityChecker` (via `checked_stepper`) wraps a Stepper
  and asserts the SPMD dispatch contract spmd_stepper documents: every
  dispatch consumes a world a previous dispatch produced, and the
  sparse-overflow redo consumes exactly the sparse call's input — the
  invariant that keeps coordinator and workers stepping the same ring
  state (ADVICE #2's divergence mode).

Violations raise `InvariantViolation` (an AssertionError subclass, so
plain `pytest.raises(AssertionError)` and `assert`-oriented tooling see
them) with a message naming the event/dispatch and both turns involved.

Every violation ALSO increments `gol_tpu_invariant_violations_total`
(labelled by checker) in the process-global metrics registry
(gol_tpu_torch.obs) before raising — so a live `/metrics` endpoint shows a
violation even when the raising thread's traceback only lands in a log,
and a test fails loudly on any nonzero delta.

This module imports neither torch nor the engine (gol_tpu_torch.obs is
pure stdlib): it must be importable from worker processes at zero cost.
Identity is checked through weak references where the world's type
allows one. Torch tensors do, and every tensor-state stepper entry
returns a freshly allocated world (the CUDA wrappers allocate their
outputs), so a stale world can never pass as a new one. The tiled
stepper's `TiledWorld` has `__slots__` and no `__weakref__`, so the
checker holds it strongly; that stepper returns the same handle it was
given, mutated in place, which the identity chain accepts as the output
of the dispatch before.
"""

from __future__ import annotations

import os
import weakref
from collections import deque
from typing import Optional

from gol_tpu_torch import obs

__all__ = [
    "DispatchLinearityChecker",
    "EventStreamChecker",
    "InvariantViolation",
    "checked_stepper",
    "enable",
    "invariants_enabled",
    "violations_total",
]

_VIOLATIONS = {
    kind: obs.counter(
        "gol_tpu_invariant_violations_total",
        "Distributed-protocol invariant violations observed at runtime",
        {"checker": kind},
    ) for kind in ("event-stream", "dispatch-linearity")
}


def violations_total() -> int:
    """Total runtime invariant violations this process has observed —
    the number that must stay 0 across any healthy run (tests assert
    the per-test delta)."""
    return int(sum(c.value for c in _VIOLATIONS.values()))


def _flight_note(checker: str, msg: str) -> None:
    """A violation is flight-recorder material: the black box must
    show protocol breaches in the window before a crash, even when the
    raising thread's traceback only lands in a log."""
    from gol_tpu_torch.obs import flight

    flight.note("invariant.violation", checker=checker, msg=msg)


class InvariantViolation(AssertionError):
    """A distributed-protocol invariant was observed broken."""


def invariants_enabled() -> bool:
    return os.environ.get("GOL_TPU_CHECK_INVARIANTS", "") == "1"


def enable(on: bool = True) -> None:
    """Programmatic switch (the CLI flag and tests use this); the env
    var form is what multi-process jobs inherit."""
    if on:
        os.environ["GOL_TPU_CHECK_INVARIANTS"] = "1"
    else:
        os.environ.pop("GOL_TPU_CHECK_INVARIANTS", None)


class EventStreamChecker:
    """Assert stream-order invariants over one engine event stream.

    `observe(ev)` every event in delivery order; raises
    InvariantViolation on the first breach. Type dispatch is by class
    name so the checker needs no import of gol_tpu_torch.events (and so
    wire-decoded peer-side event objects check the same way)."""

    def __init__(self, source: str = "engine"):
        self.source = source
        self._pending_turn: Optional[int] = None  # unflushed FlipBatch
        self._pending_initial = False  # the pre-loop alive burst
        self._last_tc: Optional[int] = None
        self._sync_turn: Optional[int] = None
        self.observed = 0

    def _fail(self, msg: str) -> None:
        _VIOLATIONS["event-stream"].inc()
        _flight_note("event-stream", f"[{self.source}] {msg}")
        raise InvariantViolation(f"[{self.source}] {msg}")

    def observe(self, ev) -> None:
        self.observed += 1
        kind = type(ev).__name__
        turn = getattr(ev, "completed_turns", None)
        if kind in ("FlipBatch", "CellFlipped"):
            self._on_flips(turn, kind)
        elif kind == "FlipChunk":
            self._on_flip_chunk(getattr(ev, "first_turn", None), turn)
        elif kind == "TurnComplete":
            self._on_turn_complete(turn)
        elif kind == "BoardSync":
            self._on_board_sync(turn)
        elif kind == "FinalTurnComplete":
            if self._last_tc is not None and turn < self._last_tc:
                self._fail(
                    f"FinalTurnComplete at turn {turn} behind the last "
                    f"TurnComplete ({self._last_tc}) — stale final event"
                )

    def _on_flips(self, turn: int, kind: str) -> None:
        if self._sync_turn is not None and turn <= self._sync_turn:
            self._fail(
                f"{kind} for turn {turn} after a BoardSync at turn "
                f"{self._sync_turn} — those flips are already in the "
                "synced board and would be double-applied"
            )
        if self._last_tc is not None and turn <= self._last_tc:
            self._fail(
                f"stale {kind} for turn {turn}: the stream is already "
                f"at TurnComplete {self._last_tc}"
            )
        if self._pending_turn is not None and turn != self._pending_turn:
            if not self._pending_initial:
                self._fail(
                    f"{kind} for turn {turn} while flips for turn "
                    f"{self._pending_turn} are unflushed (no "
                    f"TurnComplete {self._pending_turn} arrived) — the "
                    "older batch would be lost or mis-applied"
                )
        if self._pending_turn is None:
            # The engine's initial alive burst precedes the turn loop
            # and owes no TurnComplete; only the very first batch of a
            # stream (before any TurnComplete) gets that license.
            self._pending_initial = self._last_tc is None
        elif turn != self._pending_turn:
            self._pending_initial = False
        self._pending_turn = turn

    def _on_flip_chunk(self, first_turn, last_turn: int) -> None:
        """A FlipChunk is k (FlipBatch, TurnComplete) pairs emitted
        atomically: it must start exactly one turn past the stream
        position, never rewind behind a sync, and it advances the
        stream to its last turn (so a chunk can never straddle a
        BoardSync — the engine only emits whole chunks between
        dispatch boundaries, where syncs are serviced)."""
        if first_turn is None or last_turn < first_turn:
            self._fail(
                f"malformed FlipChunk: turns {first_turn}..{last_turn}"
            )
        if self._sync_turn is not None and first_turn <= self._sync_turn:
            self._fail(
                f"FlipChunk starting at turn {first_turn} after a "
                f"BoardSync at turn {self._sync_turn} — its leading "
                "turns are already in the synced board"
            )
        if self._last_tc is not None and first_turn <= self._last_tc:
            self._fail(
                f"stale FlipChunk starting at turn {first_turn}: the "
                f"stream is already at TurnComplete {self._last_tc}"
            )
        if self._pending_turn is not None and not self._pending_initial:
            self._fail(
                f"FlipChunk at turns {first_turn}..{last_turn} while "
                f"flips for turn {self._pending_turn} are unflushed"
            )
        self._last_tc = last_turn
        self._pending_turn = None
        self._pending_initial = False

    def _on_turn_complete(self, turn: int) -> None:
        if self._last_tc is not None and turn <= self._last_tc:
            self._fail(
                f"non-monotone TurnComplete: turn {turn} after turn "
                f"{self._last_tc}"
            )
        if self._pending_turn is not None and not self._pending_initial \
                and turn != self._pending_turn:
            self._fail(
                f"TurnComplete {turn} does not flush the pending "
                f"FlipBatch for turn {self._pending_turn} — the "
                "FlipBatch/TurnComplete adjacency the broadcaster "
                "relies on is broken"
            )
        self._last_tc = turn
        self._pending_turn = None
        self._pending_initial = False

    def _on_board_sync(self, turn: int) -> None:
        if self._pending_turn is not None and not self._pending_initial:
            self._fail(
                f"BoardSync at turn {turn} while flips for turn "
                f"{self._pending_turn} are buffered — flips must never "
                "straddle a sync (the sync supersedes them)"
            )
        if self._last_tc is not None and turn < self._last_tc:
            self._fail(
                f"stale BoardSync for turn {turn} behind TurnComplete "
                f"{self._last_tc} — a rewound sync would corrupt every "
                "synced peer"
            )
        self._sync_turn = turn
        self._pending_turn = None
        self._pending_initial = False


def _maybe_weak(obj):
    """Weak reference when the type allows it (torch tensors do), else a
    trivial strong closure (plain numpy arrays in host-only steppers
    don't). Weak on purpose: the checker must observe the dispatch
    chain WITHOUT pinning board-sized device buffers the engine has
    already released — several extra live boards would be a real
    memory cost on budget-sized runs, not the advertised free opt-in."""
    try:
        return weakref.ref(obj)
    except TypeError:
        return lambda: obj


class DispatchLinearityChecker:
    """Assert the stepper dispatch contract: each dispatch consumes a
    world a recent dispatch produced (`put` seeds the chain; the
    pipelined diff path legitimately runs one chunk ahead, so a short
    window of recent outputs is live, not just the newest), and the
    sparse-overflow redo consumes exactly an OUTSTANDING sparse call's
    input. Identity checks through weak references only — nothing
    touches the device and nothing is kept alive by the checker.

    A sparse dispatch's redo window closes two NON-REDO dispatches
    later: the engine consumes chunks in order and chunk N's truncation
    redo always lands before chunk N+2's consume — at most one forward
    dispatch (the pipelined lookahead) can intervene. Redo dispatches
    themselves don't age the window: a burst under the pipelined path
    legitimately redoes chunks N and N+1 back to back (the stale-cap
    double redo distributor._diff_dispatch documents), and counting the
    first redo would retire the second chunk's window early and kill a
    bit-correct run. Beyond that window, a redo against an older sparse
    input is a re-step of already-committed turns and is rejected (the
    false negative a consume-blind checker would let through)."""

    #: Outputs considered live: the current world plus the pipelined
    #: path's one-chunk lookahead (and its redo continuation).
    WINDOW = 4
    #: Non-redo dispatches after which a sparse redo window is closed.
    SPARSE_WINDOW = 2

    def __init__(self, name: str = "stepper"):
        self.name = name
        self._live: deque = deque(maxlen=self.WINDOW)  # weakrefs
        # Outstanding sparse rows: (seq, input_ref, output_ref). The
        # pipelined diff path dispatches one chunk ahead, so TWO sparse
        # chunks can be in flight when the older one turns out
        # truncated — a single slot would false-flag the older redo.
        self._sparse: deque = deque(maxlen=self.WINDOW)
        self._seq = 0

    def _fail(self, msg: str) -> None:
        _VIOLATIONS["dispatch-linearity"].inc()
        _flight_note("dispatch-linearity", f"[{self.name}] {msg}")
        raise InvariantViolation(f"[{self.name}] {msg}")

    def put(self, world) -> None:
        self._live.clear()
        self._live.append(_maybe_weak(world))
        self._sparse.clear()

    def _advance(self, out, redo: bool = False) -> None:
        if not redo:
            self._seq += 1
        if out is not None:
            self._live.append(_maybe_weak(out))
        # Retire sparse pairs whose redo window has closed (or whose
        # input the engine already dropped — a dead ref can never be
        # legally redone).
        while self._sparse and (
            self._sparse[0][0] <= self._seq - self.SPARSE_WINDOW
            or self._sparse[0][1]() is None
        ):
            self._sparse.popleft()

    def dispatch(self, world, out, what: str) -> None:
        """A linear dispatch consuming `world`, producing `out`."""
        live = [r() for r in self._live]
        if any(w is not None for w in live) and all(
                world is not w for w in live if w is not None):
            self._fail(
                f"{what} dispatched on a world no recent dispatch "
                f"produced (id {id(world):#x} not among recent outputs "
                f"{[hex(id(w)) for w in live if w is not None]}) — "
                "coordinator and workers would step divergent ring state"
            )
        self._advance(out)

    def sparse(self, world, out) -> None:
        self.dispatch(world, out, "sparse diff scan")
        self._sparse.append((self._seq, _maybe_weak(world),
                             _maybe_weak(out)))

    def redo(self, world) -> None:
        if not self._sparse:
            self._fail(
                "dense redo dispatched with no sparse scan outstanding"
            )
        for entry in self._sparse:
            if world is entry[1]():
                self._sparse.remove(entry)
                self._advance(None, redo=True)
                return
        self._fail(
            "dense redo must re-step an outstanding sparse scan's exact "
            f"input (got id {id(world):#x}, outstanding inputs "
            f"{[hex(id(e[1]())) for e in self._sparse]})"
        )


def checked_stepper(stepper, name: Optional[str] = None):
    """Wrap a Stepper's dispatch entries with a DispatchLinearityChecker
    (dataclasses.replace, so any Stepper-shaped dataclass works; no
    import of parallel.stepper — this module stays engine-free)."""
    import dataclasses

    chk = DispatchLinearityChecker(name or f"checked-{stepper.name}")
    inner_redo = stepper.step_n_with_diffs_redo or stepper.step_n_with_diffs

    def put(world):
        out = stepper.put(world)
        chk.put(out)
        return out

    def step(world):
        out = stepper.step(world)
        chk.dispatch(world, out, "step")
        return out

    def step_n(world, k):
        out = stepper.step_n(world, k)
        chk.dispatch(world, out[0], "step_n")
        return out

    def step_with_diff(world):
        out = stepper.step_with_diff(world)
        chk.dispatch(world, out[0], "step_with_diff")
        return out

    step_n_with_diffs = None
    if stepper.step_n_with_diffs is not None:
        def step_n_with_diffs(world, k):
            out = stepper.step_n_with_diffs(world, k)
            chk.dispatch(world, out[0], "step_n_with_diffs")
            return out

    step_n_with_diffs_redo = None
    if inner_redo is not None:
        def step_n_with_diffs_redo(world, k):
            chk.redo(world)
            out = inner_redo(world, k)
            chk._live.append(_maybe_weak(out[0]))
            return out

    step_n_with_diffs_sparse = None
    if stepper.step_n_with_diffs_sparse is not None:
        def step_n_with_diffs_sparse(world, k, cap):
            out = stepper.step_n_with_diffs_sparse(world, k, cap)
            chk.sparse(world, out[0])
            return out

    step_n_with_diffs_compact = None
    if stepper.step_n_with_diffs_compact is not None:
        def step_n_with_diffs_compact(world, k, total_cap):
            # Compact chunks carry the same overflow-redo contract as
            # sparse rows (the redo must re-step this exact input), so
            # they register in the same outstanding window.
            out = stepper.step_n_with_diffs_compact(world, k, total_cap)
            chk.sparse(world, out[0])
            return out

    wrapped = dataclasses.replace(
        stepper,
        name=f"checked-{stepper.name}",
        put=put,
        step=step,
        step_n=step_n,
        step_with_diff=step_with_diff,
        step_n_with_diffs=step_n_with_diffs,
        step_n_with_diffs_redo=step_n_with_diffs_redo,
        step_n_with_diffs_sparse=step_n_with_diffs_sparse,
        step_n_with_diffs_compact=step_n_with_diffs_compact,
    )
    wrapped.checker = chk
    return wrapped
