"""The distributor — turn scheduler and event emitter.

The counterpart of `gol_tpu.engine.distributor` (itself a re-design of
the reference's `distributor`, ref: gol/distributor.go:30-209) for a
world that lives on one CUDA device (or the CPU, when the caller asks):

- The *single* engine thread owns the device world, launches all device
  work and realizes device values (`.item()`). Each committed
  (turn, world, count) triple is published atomically, so the ticker
  reads a consistent snapshot without the reference's shared mutex.
- Watched runs step up to `DIFF_CHUNK` turns per dispatch through the
  stepper's diff scans and ship the stacked per-turn flip masks (dense
  masks, packed XOR rows, or once the board is quiet sparse rows and
  compact chunks) to the host in one transfer per chunk, started
  asynchronously into pinned memory so it overlaps the previous
  chunk's event fan-out; the host decodes with NumPy and emits the
  same per-turn stream as one-turn-at-a-time stepping, or one
  `FlipChunk` per chunk for a chunk consumer, and rides proven cycles
  without dispatching. Steppers without diff scans take the per-turn
  path. When no consumer needs diffs, the engine runs `chunk` turns
  per dispatch through the stepper's multi-turn kernel without
  touching the host — the events-off fast path; CUDA launches are
  asynchronous, so the only synchronisations are the realizations
  below, exactly where gol_tpu realizes.
- Control (ticker, keyboard verbs s/q/p/k, pause) interleaves with the
  turn loop between dispatches.

Verb semantics (ref README.md:177-183 and gol/distributor.go:223-280):
  's'  snapshot current world to out/<W>x<H>x<turn>.pgm (async write)
  'q'  snapshot, then stop gracefully (the event stream is closed)
  'p'  pause/resume with StateChange events
  'k'  snapshot + full shutdown

A caller may inject the stepper (an instrumented or invariant-checked
one, say), the IO service and a `utils.trace.Timeline`, which records
one span per dispatch; with a Timeline attached each fused chunk's
count is realized, so its span measures device time — the observer tax
is opt-in, and a run without one adds no synchronisation.

Not ported yet: BoardSync for attached controllers
(`request_board_sync`) and the sharded steppers' `fetch_diffs` / redo
entries.
"""

from __future__ import annotations

import atexit
import contextlib
import queue
import threading
import time
import weakref
from typing import Iterator, Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.analysis.concurrency import lockcheck
from gol_tpu_torch.engine.cycles import CycleDetector
from gol_tpu_torch.events import (
    AliveCellsCount,
    CellFlipped,
    Event,
    FinalTurnComplete,
    FlipBatch,
    FlipChunk,
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)
from gol_tpu_torch.io.service import IOService
from gol_tpu_torch.models.rules import GenRule, get_rule
from gol_tpu_torch.obs import accounting, device, flight, tracing
from gol_tpu_torch.ops import generations
from gol_tpu_torch.ops.bitlife import unpack_np
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel import make_stepper
from gol_tpu_torch.parallel.stepper import (
    compact_decode_rows,
    compact_value_prefix,
    sparse_bitmap_words,
    sparse_chunk_from_dense,
    sparse_decode_rows,
)
from gol_tpu_torch.utils.cell import cells_from_mask, xy_from_mask


def _realize(count) -> int:
    """The one host synchronisation of a device count."""
    return int(count.item()) if hasattr(count, "item") else int(count)


def _start_host_copy(t):
    """Start the device-to-host copy of a diff stack without waiting:
    on a CUDA tensor a `non_blocking` copy into pinned memory (a copy
    into pageable memory would be synchronous) and a CUDA event recorded
    behind it, returned as (pinned host tensor, event); None for a CPU
    tensor, which needs no copy. The caller keeps the device tensor
    referenced until the event has completed."""
    import torch

    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        return None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_array(t, started=None) -> np.ndarray:
    """A fetched diff stack, sparse row stack or compact header stack
    as numpy — from the copy `_start_host_copy` began (waiting on its
    event), else copied now. int32 rows are the bit patterns of
    gol_tpu's uint32 words, so they are viewed as uint32 (no arithmetic
    conversion); bool masks pass through."""
    import torch

    if started is not None:
        host, done = started
        done.synchronize()
        t = host
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    t = np.ascontiguousarray(t)
    return t.view(np.uint32) if t.dtype == np.int32 else t


def _charge_legacy(seconds: float, turns: int) -> None:
    """Accounting plane: the singleton engine serves the anonymous
    `legacy` tier — every dispatch is one tenant's spend."""
    m = accounting.meter()
    if m is not None:
        m.charge(accounting.LEGACY, dispatch_seconds=seconds,
                 flops=m.price_flops("engine.step") * turns,
                 turns=turns)


_CLOSE = object()

#: Turns per dispatch on the device-accumulated diff path: the engine
#: steps up to this many turns per dispatch, stacks the per-turn flip
#: masks on the device and ships the stack in one transfer. Bounded so
#: verbs and pause stay responsive within a chunk's wall time.
DIFF_CHUNK = 256
#: Device-memory ceiling for one diff stack (bytes); caps the chunk on
#: big boards (a dense 16384² bool stack is 256 MB at k=1).
DIFF_STACK_BUDGET = 128 * 1024 * 1024
#: Smallest cap of the sparse encoding (packed backends): a row is a
#: changed-word bitmap (total_words/8 bytes) plus `cap` values (4 bytes
#: each), vs total_words*4 for the full mask.
DIFF_SPARSE_MIN_CAP = 64

# Engines whose thread may still be running. The engine thread is
# non-daemon (see Engine.start), so an abandoned infinite run would pin
# interpreter shutdown forever. Plain atexit fires too late — CPython
# joins non-daemon threads BEFORE atexit callbacks — so this uses
# threading._register_atexit, which runs at the start of
# threading._shutdown.
_live_engines: "weakref.WeakSet" = weakref.WeakSet()


def register_live_engine(engine) -> None:
    """Enroll a device-owning loop in the interpreter-exit stop
    discipline above (duck-typed: `stop()` and `join(timeout)`)."""
    _live_engines.add(engine)


def _stop_live_engines() -> None:
    for engine in list(_live_engines):
        engine.stop()
        engine.join(timeout=30)


try:
    threading._register_atexit(_stop_live_engines)
except AttributeError:  # private API; fall back for exotic interpreters
    atexit.register(_stop_live_engines)


class _EngineMetrics:
    """Handles into the process-global registry, resolved once at
    import. All instrumentation is per DISPATCH — never per turn, never
    per cell, never inside a kernel."""

    def __init__(self):
        kinds = ("chunk", "diff", "diffs", "ride")
        self.dispatches = {
            k: obs.counter(
                "gol_tpu_engine_dispatches_total",
                "Engine device dispatches by path kind",
                {"kind": k},
            ) for k in kinds
        }
        self.turns = {
            k: obs.counter(
                "gol_tpu_engine_turns_total",
                "Turns committed by path kind",
                {"kind": k},
            ) for k in kinds
        }
        # Fused chunks are never realized one by one, so only the diff
        # paths observe a measured wall time.
        self.dispatch_seconds = {
            k: obs.histogram(
                "gol_tpu_engine_dispatch_seconds",
                "Wall seconds per dispatch (diff paths: measured; "
                "fused chunks: only when a Timeline realizes them)",
                {"kind": k},
            ) for k in kinds
        }
        self.host_seconds = obs.histogram(
            "gol_tpu_engine_host_seconds",
            "Host-side decode + event fan-out seconds per diff chunk",
        )
        self.committed_turn = obs.gauge(
            "gol_tpu_engine_committed_turn", "Last committed turn"
        )
        self.alive_cells = obs.gauge(
            "gol_tpu_engine_alive_cells",
            "Alive cells at the last realised (turn, count) pair",
        )
        self.effective_chunk = obs.gauge(
            "gol_tpu_engine_effective_chunk",
            "Turns per fused dispatch actually in use",
        )
        self.queue_depth = obs.gauge(
            "gol_tpu_engine_event_queue_depth",
            "Approximate unconsumed events in the engine's queue",
        )
        self.sparse_chunks = obs.counter(
            "gol_tpu_engine_sparse_chunks_total",
            "Diff chunks shipped with the sparse encoding",
        )
        self.sparse_redos = obs.counter(
            "gol_tpu_engine_sparse_redos_total",
            "Sparse chunks redone densely after a cap overflow",
        )
        self.compact_chunks = obs.counter(
            "gol_tpu_engine_compact_chunks_total",
            "Diff chunks shipped with the variable-length compact "
            "encoding",
        )
        self.compact_bytes = obs.counter(
            "gol_tpu_engine_compact_bytes_total",
            "Host-link bytes fetched for compact diff chunks "
            "(headers + used value prefix)",
        )
        self.compact_ratio = obs.gauge(
            "gol_tpu_engine_compact_ratio",
            "Last compact chunk's fetched bytes over the dense packed "
            "stack's bytes for the same turns",
        )
        self.compact_redos = obs.counter(
            "gol_tpu_engine_compact_redos_total",
            "Compact chunks redone densely after a value-buffer "
            "overflow",
        )
        self.throttle_stalls = obs.counter(
            "gol_tpu_engine_throttle_stalls_total",
            "Times the engine entered the event-backpressure wait",
        )
        self.skipped_turns = obs.counter(
            "gol_tpu_engine_skipped_turns_total",
            "Turns collapsed by the exact cycle fast-forward",
        )


_METRICS = _EngineMetrics()


class EventQueue:
    """The events channel (ref: `events chan gol.Event`, main.go:53).

    Unbounded; iteration ends when the producer closes it (the analog of
    `close(events)`, ref: gol/distributor.go:206)."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._consumed = 0

    def put(self, ev: Event) -> None:
        self._q.put(ev)

    def put_many(self, evs) -> None:
        """Enqueue a whole batch under ONE lock acquisition (the queue
        internals queue.Queue subclassing is built on: mutex / queue /
        not_empty), amortizing the per-put lock handshake."""
        q = self._q
        with q.mutex:
            q.queue.extend(evs)
            q.unfinished_tasks += len(evs)
            q.not_empty.notify_all()

    def get_batch(self, max_n: int = 4096,
                  timeout: Optional[float] = None) -> Optional[list]:
        """Up to `max_n` queued events in one call: blocks for the first
        like `get`, then drains whatever else is already queued under
        one lock. None once the queue is closed and drained;
        `queue.Empty` on a timeout with nothing queued."""
        first = self.get(timeout=timeout)
        if first is None:
            return None
        out = [first]
        q = self._q
        with q.mutex:
            while len(out) < max_n and q.queue:
                item = q.queue[0]
                if item is _CLOSE:
                    break  # keep the sentinel for the next get
                q.queue.popleft()
                out.append(item)
        self._consumed += len(out) - 1
        return out

    def qsize(self) -> int:
        """Approximate backlog — the producer-side backpressure signal."""
        return self._q.qsize()

    @property
    def consumed(self) -> int:
        """Monotone count of events handed to consumers."""
        return self._consumed

    def close(self) -> None:
        self._closed.set()
        self._q.put(_CLOSE)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def get(self, timeout: Optional[float] = None):
        """Next event; None once the queue is closed and drained. A
        `timeout` with no event raises `queue.Empty`."""
        item = self._q.get(timeout=timeout)
        if item is _CLOSE:
            self._q.put(_CLOSE)  # keep the sentinel for other consumers
            return None
        self._consumed += 1
        return item

    def __iter__(self) -> Iterator[Event]:
        while True:
            item = self._q.get()
            if item is _CLOSE:
                self._q.put(_CLOSE)
                return
            self._consumed += 1
            yield item


class Engine:
    """One run of the automaton: load → turn loop → final output.

    `device` picks where the stepper runs when none is passed: None
    means the CUDA card (an error without one), "cpu" the plain versions
    on the CPU."""

    def __init__(
        self,
        params: Params,
        events: Optional[EventQueue] = None,
        keypresses: Optional[queue.Queue] = None,
        *,
        emit_flips: bool = True,
        emit_turns: Optional[bool] = None,
        emit_flip_batches: bool = False,
        emit_flip_chunks: bool = False,
        batch_turns_hint: int = 0,
        initial_world: Optional[np.ndarray] = None,
        start_turn: int = 0,
        io_service: Optional[IOService] = None,
        stepper=None,
        timeline=None,
        cycle_check_seconds: float = 2.0,
        device=None,
    ):
        self.p = params
        self.events = events if events is not None else EventQueue()
        self.keypresses = keypresses
        self.emit_flips = emit_flips
        # Per-turn flips as ONE FlipBatch ndarray event instead of N
        # CellFlipped objects (events.FlipBatch): opt-in for consumers
        # that apply flips vectorized; the per-cell stream stays the
        # reference contract.
        self.emit_flip_batches = emit_flip_batches
        # Whole diff chunks as ONE FlipChunk event (events.FlipChunk)
        # instead of k (FlipBatch, TurnComplete) pairs; engages only
        # where the chunk layout is exact — see _chunk_mode.
        self.emit_flip_chunks = emit_flip_chunks
        #: Turns per diff dispatch a batching watcher asked for. 0 =
        #: none; a positive hint RAISES the DIFF_CHUNK budget so a
        #: watcher that consumes k-turn frames isn't capped at the
        #: interactive chunk size.
        self.batch_turns_hint = batch_turns_hint
        # Per-turn TurnComplete in the fused-chunk path is pure overhead
        # when nothing consumes per-turn granularity. Default: follow
        # emit_flips; emit_turns=True gives per-turn events without flips.
        self.emit_turns = emit_flips if emit_turns is None else emit_turns
        self._initial_world = initial_world
        # Resuming from a checkpoint: the world is `initial_world` as of
        # `start_turn` completed turns.
        if start_turn < 0 or start_turn > params.turns:
            raise ValueError("start_turn must be in [0, turns]")
        self.start_turn = start_turn
        # Stepper before IOService: make_stepper validates (and can raise
        # on) the backend/grid/device combination, and the IO service
        # spawns a live thread that a failed construction would leak.
        self.stepper = stepper or make_stepper(
            threads=params.threads,
            height=params.image_height,
            width=params.image_width,
            rule=params.rule,
            device=device,
            backend=params.backend,
            tile=params.tile,
            mesh=params.mesh,
            partition_rules=params.partition_rules,
        )
        self.io = io_service or IOService(params.image_dir, params.out_dir)
        self._own_io = io_service is None
        # Atomically published (completed_turns, device_world,
        # device_count). ONLY the engine thread launches device work or
        # realises device values; the ticker asks via _requests and the
        # engine services it between dispatches.
        self._committed = (0, None, None)
        self._paused = False
        self._stop_reason: Optional[str] = None
        self._ticker_stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._req_lock = lockcheck.make_lock("Engine._req_lock")
        # Pending cross-thread count requests, each (event, box).
        self._requests: list = []
        # Last (turn, count) pair actually realised together — the
        # always-consistent fallback for timed-out requests.
        self._last_pair = (0, 0)
        self._finished = threading.Event()
        #: Optional utils.trace.Timeline recording one span per dispatch.
        #: Profiling realizes each fused chunk's count so spans measure
        #: true device time, at the cost of serializing the dispatch
        #: pipeline (the observer tax, opt-in).
        self.timeline = timeline
        #: Exception that killed the engine thread, if any.
        self.error: Optional[BaseException] = None
        #: The dispatch chunk actually in use (auto-calibration updates
        #: it when Params.chunk == 0).
        self.effective_chunk = max(params.chunk, 1) if params.chunk else 64
        self._throttle_disabled = False
        # Exact cycle fast-forward (Params.cycle_detect).
        self._cycles = (
            CycleDetector(cycle_check_seconds) if params.cycle_detect
            else None
        )
        self.skipped_turns = 0
        # Gray-level Generations visualisation: with a multi-state rule
        # and batches on, flip batches carry per-cell levels. A CHANGED
        # cell's new state is a pure LUT of its old one — dead that
        # changed was born (1); alive that changed starts dying; dying
        # always ages — so the changed-cell masks alone determine every
        # level once the host tracks a state grid alongside.
        self._gens_levels: Optional[dict] = None
        rule_obj = params.rule
        if isinstance(rule_obj, str):
            rule_obj = get_rule(rule_obj)
        if emit_flip_batches and isinstance(rule_obj, GenRule):
            c = rule_obj.states
            self._gens_levels = {
                "rule": rule_obj,
                "next": np.array(
                    [1] + [(s + 1) % c for s in range(1, c)], np.uint8
                ),
                "lut": generations.levels(rule_obj),
                "states": None,
            }
        # Sparse diff encoding state: None = ship full masks; an int =
        # the changed-word cap for the next sparse/compact chunk. Starts
        # off; the first plain chunk's observed activity enables it.
        self._sparse_cap: Optional[int] = None
        # Cycle RIDING on the watched chunk path: once the detector
        # proves the board periodic and a probe pins a small period m,
        # chunks of whole periods are SYNTHESIZED from the recorded
        # period's diff rows — no device dispatch, turn numbers stay
        # dense. Only with Params.cycle_detect, only in chunk mode.
        self._ride: Optional[dict] = None
        self._ride_probe_due = False
        self._ride_cycles = (
            CycleDetector(min(cycle_check_seconds, 1.0))
            if params.cycle_detect else None
        )
        # In-flight chunk of the pipelined diff path (see
        # _diff_pipeline_step); engine thread only.
        self._pending_diffs: Optional[dict] = None
        # True while a diff chunk's per-turn rows are being emitted.
        self._emitting = False
        self._last_diff_span_end = 0.0

    # --- public api ---

    def start(self) -> "Engine":
        """Run asynchronously (the analog of `go gol.Run(...)`). The
        thread is non-daemon: interpreter shutdown mid-launch would tear
        the CUDA context down under a live frame; `run()`'s finally
        always closes the stream, so waiting for it is bounded."""
        self._thread = threading.Thread(target=self.run, name="gol-engine")
        register_live_engine(self)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Programmatic graceful stop at the next dispatch boundary,
        without the 'q'/'k' snapshot. The stream still closes with
        StateChange{Quitting}."""
        self._stop_reason = self._stop_reason or "stop"
        self._paused = False

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def completed_turns(self) -> int:
        return self._committed[0]

    def alive_count_now(self, timeout: float = 5.0) -> tuple[int, int]:
        """(completed_turns, alive_count) of the last committed world —
        safe from any thread: the engine thread services the request
        between dispatches. On timeout returns the last consistent pair."""
        if not self._finished.is_set():
            ev = threading.Event()
            box: dict = {}
            with self._req_lock:
                self._requests.append((ev, box))
            if ev.wait(timeout):
                return box["turn"], box["count"]
        return self._last_pair

    # --- engine thread ---

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:
            # The stream closes cleanly and the error is kept for
            # callers (the reference log.Fatal's, ref: util/check.go).
            self.error = e
            flight.note("engine.fatal", error=repr(e))
            with contextlib.suppress(Exception):
                flight.dump("engine-exception")
        finally:
            self._ticker_stop.set()
            self._finished.set()
            self._service_requests()  # release any waiting requester
            self.events.close()  # idempotent; unblocks all consumers
            if self._own_io:
                self.io.stop()

    def _run(self) -> None:
        p = self.p
        # World load (ref: gol/distributor.go:38-69).
        if self._initial_world is not None:
            host_world = np.asarray(self._initial_world, np.uint8)
        else:
            host_world = self.io.read(p.input_name)
        if host_world.shape != (p.image_height, p.image_width):
            raise ValueError(
                f"image {p.input_name} has shape {host_world.shape}, "
                f"params say {(p.image_height, p.image_width)}"
            )
        # Seed the consistent (turn, count) pair from the host board and
        # start the ticker BEFORE any device work: the first kernel build
        # happens on this thread at the first chunk, and the first
        # AliveCellsCount must still land within the reference's 5 s
        # watchdog (ref: count_test.go:30-38) — served from this pair
        # until the first dispatch commits.
        self._last_pair = (self.start_turn, int(np.count_nonzero(host_world)))
        _METRICS.alive_cells.set(self._last_pair[1])
        ticker = threading.Thread(target=self._ticker, name="gol-ticker",
                                  daemon=True)
        ticker.start()

        world = self.stepper.put(host_world)

        self._seed_gens_states(host_world)

        # Initial CellFlipped burst for every live cell
        # (ref: gol/distributor.go:72-80); for a Generations rule, the
        # state-1 cells only.
        if self.emit_flips:
            if self._gens_levels is not None:
                # Level mode: the opening batch SETS every nonzero
                # cell's gray level (dying cells included).
                nz = host_world != 0
                self.events.put(FlipBatch(
                    self.start_turn, xy_from_mask(nz), levels=host_world[nz]
                ))
            else:
                mask = self._alive_mask(host_world)
                if self.emit_flip_batches:
                    self.events.put(
                        FlipBatch(self.start_turn, xy_from_mask(mask))
                    )
                else:
                    for cell in cells_from_mask(mask):
                        self.events.put(CellFlipped(self.start_turn, cell))

        self._commit(self.start_turn, world,
                     self.stepper.alive_count_async(world))

        self._autosave_turn = self.start_turn
        self._autosave_time = time.monotonic()

        # Auto-chunk calibration (Params.chunk == 0), as in gol_tpu:
        # starting at 64 turns/dispatch, repeatedly (a) realize once
        # after the first dispatch at the current size so the kernel
        # build stays out of the measurement, (b) time a short window of
        # queued dispatches, (c) grow to a power-of-two chunk worth ~0.1 s
        # at the measured rate. Launches are asynchronous, so the
        # realizations below are the only synchronisations.
        chunk = 64 if p.chunk == 0 else p.chunk
        cal = {"phase": "warm", "since": self.start_turn} if p.chunk == 0 else None
        self.effective_chunk = chunk

        turn = self.start_turn
        while turn < p.turns and self._stop_reason is None:
            self._service_requests()
            self._poll_keys(turn)
            if self._stop_reason is not None:
                break
            if self.emit_flips:
                if self.stepper.offers("step_n_with_diffs"):
                    if self._ride is not None:
                        new_turn = self._ride_step(turn)
                        if new_turn != turn:
                            turn = new_turn
                            world = self._committed[1]
                            continue
                        # Ride abandoned without emitting: fall through
                        # to a real dispatch (the committed world is the
                        # true phase-0 board).
                    elif self._ride_probe_due:
                        self._ride_probe_due = False
                        # The in-flight pipelined chunk (if any) is
                        # superseded: its events were never emitted, so
                        # its turns re-emit from the ride or from a
                        # fresh dispatch off the same committed world.
                        self._pending_diffs = None
                        self._maybe_create_ride(turn)
                        if self._ride is not None:
                            continue
                    if not self.stepper.offers("fetch_diffs"):
                        # Single-device: overlap each chunk's transfer
                        # with the previous chunk's fan-out.
                        turn = self._diff_pipeline_step(turn)
                    else:
                        turn = self._run_diff_chunk(turn)
                    world = self._committed[1]
                    continue
                tick = time.perf_counter()
                new_world, mask, count = self.stepper.step_with_diff(world)
                turn += 1
                host_mask = self.stepper.fetch(mask)
                # fetch(mask) synced the dispatch: the span measures
                # device time, not the host event fan-out below.
                elapsed = time.perf_counter() - tick
                _METRICS.dispatches["diff"].inc()
                _METRICS.turns["diff"].inc()
                _METRICS.dispatch_seconds["diff"].observe(elapsed)
                _charge_legacy(elapsed, 1)
                tracing.add_span("engine.dispatch", "engine",
                                 time.time() - elapsed, elapsed,
                                 {"kind": "diff", "turn": turn, "turns": 1})
                if self.timeline:
                    self.timeline.record(turn, 1, elapsed, "diff")
                self._emit_turn_flips(turn, host_mask)
                world = new_world
                self._commit(turn, world, count)
                self.events.put(TurnComplete(turn))
                self._throttle_events()
                self._maybe_autosave(turn, world)
            else:
                # A consumer leaving mid-pipeline switches paths: the
                # in-flight diff chunk's turns must land first. Any cycle
                # ride is dropped — fused stepping moves the board off
                # the ride's phase anchor.
                self._ride = None
                turn = self._flush_pending_diffs(turn)
                world = self._committed[1]
                if cal is not None and not self.emit_turns:
                    # Calibration only advances on an undisturbed engine.
                    if cal["phase"] == "warm":
                        if turn > cal["since"]:
                            _realize(self._committed[2])  # build + 1st chunk
                            cal = {"phase": "measure", "since": turn,
                                   "t0": time.monotonic(),
                                   "deadline": time.monotonic() + 0.3,
                                   "retries": cal.get("retries", 0)}
                    elif time.monotonic() >= cal["deadline"]:
                        _realize(self._committed[2])  # drain the queue
                        elapsed = time.monotonic() - cal["t0"]
                        retries = cal.get("retries", 0)
                        if elapsed > 1.5:
                            # Disturbed window: re-measure.
                            cal = {"phase": "warm", "since": turn}
                        else:
                            rate = (turn - cal["since"]) / max(elapsed, 1e-6)
                            target = max(64, min(1 << 18, int(rate * 0.1)))
                            new_chunk = 1 << target.bit_length() - 1
                            if new_chunk > chunk:
                                chunk = new_chunk
                                self.effective_chunk = chunk
                                cal = {"phase": "warm", "since": turn}
                            elif chunk == 64 and retries < 3:
                                cal = {"phase": "warm", "since": turn,
                                       "retries": retries + 1}
                            else:
                                cal = None  # converged
                # An attached per-turn consumer caps the dispatch size
                # (bounded TurnComplete bursts, sub-second verb response).
                emit_now = self.emit_turns
                k = min(chunk, 1024 if emit_now else chunk, p.turns - turn)
                if p.autosave_turns > 0:
                    # A dispatch never overshoots the next autosave.
                    k = max(1, min(
                        k, self._autosave_turn + p.autosave_turns - turn
                    ))
                tick = time.perf_counter()
                with device.cause("fused-chunk"):
                    world, count = self.stepper.step_n(world, k)
                device.observe_split(enqueue_s=time.perf_counter() - tick)
                _METRICS.dispatches["chunk"].inc()
                _METRICS.turns["chunk"].inc(k)
                _METRICS.effective_chunk.set(self.effective_chunk)
                _charge_legacy(time.perf_counter() - tick, k)
                if self.timeline:
                    _realize(count)  # spans measure true device time
                    elapsed = time.perf_counter() - tick
                    # The fused path's histogram is fed only under a
                    # Timeline: without the realization above, a wall
                    # timing would measure the asynchronous enqueue.
                    _METRICS.dispatch_seconds["chunk"].observe(elapsed)
                    tracing.add_span("engine.dispatch", "engine",
                                     time.time() - elapsed, elapsed,
                                     {"kind": "chunk", "turn": turn + k,
                                      "turns": k})
                    self.timeline.record(turn + k, k, elapsed, "chunk")
                else:
                    # An instant mark, not a measured span: timing the
                    # chunk would need a realization, the observer tax
                    # this path avoids.
                    tracing.event("engine.dispatch", "engine",
                                  kind="chunk", turn=turn + k, turns=k)
                first = turn + 1
                turn += k
                self._commit(turn, world, count)
                if emit_now:
                    for t in range(first, turn + 1):
                        self.events.put(TurnComplete(t))
                    self._throttle_events()
                self._maybe_autosave(turn, world)
                if self._cycles is not None and not self.emit_turns:
                    m = self._cycles.observe(turn, world)
                    if m:
                        # The board provably equals its state m turns
                        # ago: the remaining turns collapse modulo m.
                        skip = (p.turns - turn) // m * m
                        if skip:
                            turn += skip
                            self.skipped_turns = skip
                            _METRICS.skipped_turns.inc(skip)
                            self._commit(turn, world, count)
                            self._autosave_turn = turn
                            self._cycles = None  # one jump per run

        # An in-flight diff chunk's turns are computed and its events
        # owed — quit verbs land at chunk boundaries.
        turn = self._flush_pending_diffs(turn)
        world = self._committed[1] if self._committed[1] is not None else world

        self._ticker_stop.set()
        self._last_pair = (turn, _realize(self._committed[2]))
        _METRICS.alive_cells.set(self._last_pair[1])
        self._service_requests()

        if self._stop_reason == "stop":
            self.events.put(StateChange(turn, State.QUITTING))
            self.events.close()
            return

        if self._stop_reason in ("q", "k"):
            # Snapshot-and-stop (ref: gol/distributor.go:244-261, with a
            # clean close instead of os.Exit(0)).
            self._write_snapshot(turn, world, wait=True)
            self.io.check_idle()
            self.events.put(StateChange(turn, State.QUITTING))
            self.events.close()
            return

        # Normal completion (ref: gol/distributor.go:180-206).
        self._write_snapshot(turn, world, wait=True)
        self.events.put(
            FinalTurnComplete(
                turn,
                cells_from_mask(self._alive_mask(self.stepper.fetch(world))),
            )
        )
        self.io.check_idle()
        self.events.put(StateChange(turn, State.QUITTING))
        self.events.close()

    def _run_diff_chunk(self, turn: int) -> int:
        """One unpipelined dispatch of the device-accumulated diff path:
        step up to DIFF_CHUNK turns, ship the stacked per-turn flip masks
        in one transfer, expand them on the host with NumPy and emit the
        *identical* per-turn CellFlipped/TurnComplete stream the one-turn
        path produces (ref contract: gol/distributor.go:212-220).
        Returns the new completed-turn count.

        Once a plain chunk shows the board changes few enough words per
        turn, packed steppers ship COMPACT chunks — per-turn [count,
        bitmap] headers plus one shared value buffer fetched only up to
        the summed count — or, without the compact entry, fixed-width
        sparse rows. Both adapt the cap to observed activity; an
        overflow is detected from the counts and the chunk is redone
        densely, so the stream is identical on every path."""
        return self._diff_consume(turn, self._diff_dispatch(turn))

    def _diff_pipeline_step(self, turn: int) -> int:
        """One iteration of the PIPELINED diff path (single-device
        steppers): dispatch the next chunk — its device work and its
        host transfer (started asynchronously into pinned memory)
        overlap the expansion and event fan-out of the chunk dispatched
        on the previous iteration — then consume that previous chunk.
        Chunk N's events are always emitted, and N committed, before any
        of chunk N+1's; `_run`'s epilogue consumes a still-pending chunk
        when the loop exits."""
        ahead = self._pending_diffs["k"] if self._pending_diffs else 0
        nxt = turn + ahead
        new_pending = (
            self._diff_dispatch(nxt) if nxt < self.p.turns else None
        )
        if self._pending_diffs is not None:
            turn = self._diff_consume(turn, self._pending_diffs)
        self._pending_diffs = new_pending
        return turn

    def _flush_pending_diffs(self, turn: int) -> int:
        """Consume the in-flight diff chunk, if any (loop exit)."""
        if self._pending_diffs is not None:
            turn = self._diff_consume(turn, self._pending_diffs)
            self._pending_diffs = None
        return turn

    #: Longest exact period the watched cycle ride will record (one
    #: period of S-sparse diff rows on the host plus the phase-0 device
    #: world).
    RIDE_MAX_PERIOD = 1024

    def _maybe_create_ride(self, turn: int) -> None:
        """Pin an exact small period and record one period's diffs. The
        anchor walk (CycleDetector) already PROVED the committed world
        equals an earlier state; this probe walks forward in doubling
        segments recording the per-turn diff rows, and finds the
        smallest period on the host: world(t) == world(0) exactly when
        the XOR of the recorded diffs S[1..t] cancels. Failure (no
        period within RIDE_MAX_PERIOD) backs the next probe off
        exponentially, and the run continues stepping for real."""
        world, count = self._committed[1], self._committed[2]
        if (world is None or not self._chunk_mode()
                or self._ride_cycles is None):
            return
        segs = []
        cur = world
        q = 0
        step = 2
        m = None
        while q + step <= self.RIDE_MAX_PERIOD:
            with device.cause("cycle-probe"):
                nxt, diffs, _c = self.stepper.step_n_with_diffs(cur, step)
            segs.append(
                self._fetch_diffs(diffs).reshape(step, -1).view(np.uint32)
            )
            cur = nxt
            q += step
            stack = np.concatenate(segs, axis=0)
            prefix = np.bitwise_xor.accumulate(stack, axis=0)
            zero = np.flatnonzero(~prefix.any(axis=1))
            if zero.size:
                m = int(zero[0]) + 1
                break
            step = q  # segments 2, 2, 4, 8, ... — cumulative doubling
        if m is None:
            self._ride_cycles.interval = min(
                self._ride_cycles.interval * 2, 300.0
            )
            tracing.event("engine.ride_probe_failed", "engine",
                          turn=turn, walked=q)
            return
        counts, bitmaps, words = sparse_chunk_from_dense(stack[:m])
        # Whole periods per synthesized chunk, tiled up to the chunk
        # budget (Params.chunk still paces the ride), one period at
        # least.
        budget = self._diff_chunk_budget()
        if self.p.chunk > 0:
            budget = min(budget, self.p.chunk)
        r = max(1, budget // m)
        self._ride = {
            "m": m, "r": r, "world": world, "count": count,
            "wpp": int(counts.sum()),
            "counts": np.tile(counts, r),
            "bitmaps": np.tile(bitmaps, (r, 1)),
            "words": np.tile(words, r),
        }
        tracing.event("engine.ride_start", "engine", turn=turn,
                      period=m, tile=r)
        flight.note("engine.ride_start", turn=turn, period=m)

    def _ride_step(self, turn: int) -> int:
        """Emit one synthesized chunk of whole proven periods: no device
        dispatch, the committed world stays the REAL phase-0 board.
        Returns `turn` unchanged when the ride must stand down (consumer
        mix changed, or fewer than one period of turns remains — the
        tail steps for real)."""
        ride = self._ride
        m = ride["m"]
        r = min(ride["r"], (self.p.turns - turn) // m)
        if r <= 0 or not self._chunk_mode():
            self._ride = None
            return turn
        k = r * m
        self.events.put(FlipChunk(
            turn + k, first_turn=turn + 1,
            counts=ride["counts"][:k],
            bitmaps=ride["bitmaps"][:k],
            words=ride["words"][:ride["wpp"] * r],
        ))
        _METRICS.dispatches["ride"].inc()
        _METRICS.turns["ride"].inc(k)
        tracing.event("engine.dispatch", "engine", kind="ride",
                      turn=turn + k, turns=k)
        self._commit(turn + k, ride["world"], ride["count"])
        turn += k
        self._throttle_events()
        self._maybe_autosave(turn, ride["world"])
        return turn

    def _diff_dispatch(self, turn: int) -> dict:
        """Dispatch one diff chunk starting after `turn` completed turns
        and start its host transfer; no host-blocking work.

        On the pipelined path dispatch runs one chunk AHEAD of consume,
        so the knobs it reads are a chunk stale: the sparse cap may
        already be doomed (a burst costs up to two dense redos), and the
        autosave anchor is projected forward to the boundary the
        in-flight chunk will land on."""
        p = self.p
        pipelined = self._pending_diffs is not None or (
            not self.stepper.offers("fetch_diffs")
        )
        k = min(self._diff_chunk_budget(), self._diff_chunk_cap(pipelined),
                p.turns - turn)
        if p.chunk > 0:
            k = min(k, p.chunk)
        if p.autosave_turns > 0:
            # Never overshoot the autosave boundary, against the
            # projected anchor.
            anchor = self._autosave_turn
            if turn > anchor:
                anchor += (turn - anchor) // p.autosave_turns * p.autosave_turns
            k = min(k, max(1, anchor + p.autosave_turns - turn))
        world = self._committed[1] if turn == self._committed[0] else None
        if world is None:
            # Pipelined dispatch continues from the not-yet-committed
            # world of the in-flight chunk.
            world = self._pending_diffs["new_world"]
        pending = {"k": k, "world_before": world, "sparse_cap": None,
                   "compact_cap": None, "tick": time.perf_counter()}
        with device.cause("diff-chunk"):
            if (self._sparse_cap is not None
                    and self.stepper.offers("step_n_with_diffs_compact")):
                # Variable-length compact chunk: the fetch pays for
                # headers + actual activity, not the cap.
                total_cap = self._compact_total_cap(k)
                pending["compact_cap"] = total_cap
                _METRICS.compact_chunks.inc()
                new_world, buf, values, count = (
                    self.stepper.step_n_with_diffs_compact(world, k,
                                                           total_cap)
                )
                # The value buffer is NOT copied eagerly: the used prefix
                # is unknown until the headers land. Only the header
                # stack overlaps the fan-out.
                pending["values"] = values
            elif self._sparse_cap is not None:
                pending["sparse_cap"] = self._sparse_cap
                _METRICS.sparse_chunks.inc()
                new_world, buf, count = (
                    self.stepper.step_n_with_diffs_sparse(
                        world, k, self._sparse_cap
                    )
                )
            else:
                new_world, buf, count = self.stepper.step_n_with_diffs(
                    world, k
                )
        pending["copy"] = _start_host_copy(buf)
        # Host overhead to get the dispatch in flight — the `enqueue`
        # leg of the device-vs-host split.
        pending["enqueue_s"] = time.perf_counter() - pending["tick"]
        pending.update(new_world=new_world, buf=buf, count=count)
        return pending

    def _diff_chunk_budget(self) -> int:
        """Turns per diff dispatch before the memory cap: DIFF_CHUNK,
        RAISED to a batching watcher's max-k (batch_turns_hint)."""
        return max(DIFF_CHUNK, self.batch_turns_hint)

    def _compact_total_cap(self, k: int) -> int:
        """Value-buffer size for the next compact chunk: the most turns
        a chunk can carry times the per-turn activity cap the sparse
        adaptation maintains (2x headroom over the observed peak), sized
        from the CHUNK BUDGET rather than this dispatch's `k`, so a
        tail- or autosave-clipped chunk keeps the full chunk's absolute
        burst headroom."""
        budget = min(self._diff_chunk_budget(), self._diff_chunk_cap(False))
        if self.p.chunk > 0:
            budget = min(budget, self.p.chunk)
        return max(budget, k) * self._sparse_cap

    def _diff_chunk_cap(self, pipelined: bool) -> int:
        """Max diff-chunk turns the device stack budget allows, from the
        per-turn diff representation: packed word-row diffs are H*W/8
        bytes, dense bool masks H*W. Pipelined dispatch keeps two stacks
        alive, so it halves the budget."""
        p = self.p
        budget = DIFF_STACK_BUDGET // (2 if pipelined else 1)
        per_turn = p.image_height * p.image_width
        if self.stepper.offers("packed_diffs"):
            per_turn //= 8
        return max(1, budget // max(per_turn, 1))

    def _chunk_mode(self) -> bool:
        """True when diff chunks should emit as ONE FlipChunk event: a
        chunk consumer asked for it AND the per-turn diff layout is the
        packed vertical-word grid. Gens level streams, dense-mask
        backends and ragged heights keep the per-turn path."""
        return (self.emit_flip_chunks and self.emit_flip_batches
                and self._gens_levels is None
                and self.stepper.offers("packed_diffs")
                and self.p.image_height % 32 == 0)

    def _diff_consume(self, turn: int, pending: dict) -> int:
        """Materialize one dispatched diff chunk: decode (with the
        overflow dense redo), commit, emit, autosave.

        The chunk's final turn/world are committed BEFORE its per-turn
        events are emitted, so `completed_turns` can run up to a chunk
        ahead of what consumers have drained; the event stream itself is
        identical to the per-turn path. With a chunk consumer attached
        (_chunk_mode) the whole chunk emits as ONE FlipChunk event in the
        device's S-sparse layout."""
        k = pending["k"]
        new_world, count = pending["new_world"], pending["count"]
        chunk_mode = self._chunk_mode()
        rows = None
        chunk = None
        encoded = (pending["sparse_cap"] is not None
                   or pending["compact_cap"] is not None)
        if pending["compact_cap"] is not None:
            got = (self._chunk_from_compact(pending) if chunk_mode
                   else self._decode_compact(pending))
            if got is None:  # Σ counts burst past the value buffer
                _METRICS.compact_redos.inc()
                tracing.event("engine.compact_redo", "engine",
                              turn=turn + k,
                              total_cap=pending["compact_cap"])
                flight.note("engine.compact_redo", turn=turn + k)
        elif pending["sparse_cap"] is not None:
            got = (self._chunk_from_sparse(pending) if chunk_mode
                   else self._decode_sparse(pending))
            if got is None:  # truncated: the board burst past the cap
                _METRICS.sparse_redos.inc()
                tracing.event("engine.sparse_redo", "engine",
                              turn=turn + k, cap=pending["sparse_cap"])
                flight.note("engine.sparse_redo", turn=turn + k)
        else:
            got = None
        if chunk_mode:
            chunk = got
        else:
            rows = got
        if encoded and rows is None and chunk is None:
            self._sparse_cap = None
            # Redo from the exact input of the truncated chunk through
            # the explicit redo entry where a stepper has one, else the
            # ordinary dense scan (bit-identical to the discarded
            # encoded result).
            redo = (self.stepper.step_n_with_diffs_redo
                    or self.stepper.step_n_with_diffs)
            with device.cause("diff-redo"):
                new_world, diffs, count = redo(pending["world_before"], k)
        if rows is None and chunk is None:
            sync0 = time.perf_counter()
            if encoded:
                host_diffs = self._fetch_diffs(diffs)
            else:
                host_diffs = self._fetch_diffs(pending["buf"],
                                               pending["copy"])
            t_host = time.perf_counter()
            pending["sync_s"] = (pending.get("sync_s", 0.0)
                                 + t_host - sync0)
            if chunk_mode and host_diffs.dtype == np.uint32:
                chunk = sparse_chunk_from_dense(host_diffs)
                if self.stepper.offers("step_n_with_diffs_sparse"):
                    counts_c = chunk[0]
                    self._adapt_sparse_cap(
                        int(counts_c.max()) if counts_c.size else 0
                    )
            else:
                rows = [host_diffs[i] for i in range(k)]
                self._observe_diff_activity(rows)
            pending["host_extra_s"] = (pending.get("host_extra_s", 0.0)
                                       + time.perf_counter() - t_host)
        # Pipelined spans overlap at dispatch time; clamping each span's
        # start to the previous span's end keeps them disjoint.
        now = time.perf_counter()
        start = max(pending["tick"], self._last_diff_span_end)
        self._last_diff_span_end = now
        _METRICS.dispatches["diffs"].inc()
        _METRICS.turns["diffs"].inc(k)
        _METRICS.dispatch_seconds["diffs"].observe(now - start)
        _charge_legacy(now - start, k)
        tracing.add_span(
            "engine.dispatch", "engine",
            time.time() - (now - start), now - start,
            {"kind": "diffs", "turn": turn + k, "turns": k},
        )
        if self.timeline:
            self.timeline.record(turn + k, k, now - start, "diffs")
        self._commit(turn + k, new_world, count)
        if chunk is not None:
            # Chunk-granular emission: the whole decoded stack as ONE
            # event, no per-turn Python objects.
            emit_tick = time.perf_counter()
            counts_c, bitmaps_c, words_c = chunk
            self.events.put(FlipChunk(
                turn + k, first_turn=turn + 1, counts=counts_c,
                bitmaps=bitmaps_c, words=words_c,
            ))
            emit_dt = time.perf_counter() - emit_tick
            _METRICS.host_seconds.observe(emit_dt)
            tracing.add_span("engine.emit", "engine",
                             time.time() - emit_dt, emit_dt,
                             {"turns": k, "turn": turn + k, "chunk": 1})
            device.observe_split(
                pending.get("enqueue_s"), pending.get("sync_s"),
                emit_dt + pending.get("host_extra_s", 0.0),
            )
            turn += k
            self._throttle_events()
            self._maybe_autosave(turn, new_world)
            if (self._ride_cycles is not None and self._ride is None
                    and self.p.autosave_turns <= 0
                    and self._ride_cycles.observe(turn, new_world)
                    is not None):
                # The anchor walk proved the board revisits an earlier
                # state: probe for a period at the next loop boundary
                # (never mid-consume — the pipeline may hold a chunk).
                self._ride_probe_due = True
            return turn
        self._emitting = True
        emit_tick = time.perf_counter()
        try:
            for i, row in enumerate(rows):
                t = turn + 1 + i
                self._emit_turn_flips(t, self._diff_mask(row))
                self.events.put(TurnComplete(t))
                if (i & 31) == 31:
                    # Backpressure per ~32 turns, not per chunk; verbs
                    # serviced here stamp `t`, the last emitted turn.
                    self._throttle_events(t)
        finally:
            self._emitting = False
            emit_dt = time.perf_counter() - emit_tick
            _METRICS.host_seconds.observe(emit_dt)
            tracing.add_span("engine.emit", "engine",
                             time.time() - emit_dt, emit_dt,
                             {"turns": k, "turn": turn + k})
            # The split of this dispatch: enqueue (the dispatch call
            # returning), sync (the fetched buffers materialising =
            # device work + transfer), host (row decode, accumulated in
            # host_extra_s, plus the fan-out above).
            device.observe_split(
                pending.get("enqueue_s"), pending.get("sync_s"),
                emit_dt + pending.get("host_extra_s", 0.0),
            )
        turn += k
        self._throttle_events()
        self._maybe_autosave(turn, new_world)
        return turn

    def _fetch_diffs(self, diffs, started=None) -> np.ndarray:
        """A diff stack on the host: the stepper's own `fetch_diffs`
        where it has one (sharded steppers gather), else the copy
        `_start_host_copy` began, or one made now."""
        if self.stepper.fetch_diffs is not None:
            return np.asarray(self.stepper.fetch_diffs(diffs))
        return _host_array(diffs, started)

    def _fetch_rows(self, pending: dict) -> np.ndarray:
        """A dispatched chunk's sparse rows or compact headers on the
        host as uint32, with the sync leg of the split."""
        sync0 = time.perf_counter()
        host = _host_array(pending["buf"], pending["copy"])
        pending["sync_s"] = time.perf_counter() - sync0
        return host

    def _decode_sparse(self, pending: dict):
        """Sparse rows of a dispatched chunk -> dense word rows, or None
        when any row was truncated (cap overflow)."""
        cap = pending["sparse_cap"]
        host = self._fetch_rows(pending)
        t_host = time.perf_counter()
        counts = host[:, 0]
        max_m = int(counts.max()) if counts.size else 0
        if max_m > cap:
            return None
        hw, w = self.p.image_height // 32, self.p.image_width
        rows = [
            words.reshape(hw, w)
            for words in sparse_decode_rows(host, hw * w)
        ]
        self._adapt_sparse_cap(max_m)
        # Decode is HOST work: the split's host leg, not its sync.
        pending["host_extra_s"] = time.perf_counter() - t_host
        return rows

    def _fetch_compact(self, pending: dict):
        """A dispatched compact chunk's header stack and used value
        prefix: (header, vals, total), with the sync-split and link-cost
        accounting, or None when the summed counts overran the value
        buffer (its dropped writes must not be trusted)."""
        header = self._fetch_rows(pending)
        total = int(header[:, 0].sum())
        if total > pending["compact_cap"]:
            return None
        fetch_vals = (self.stepper.fetch_compact_values
                      or compact_value_prefix)
        sync0 = time.perf_counter()
        vals = np.asarray(fetch_vals(pending["values"], total))
        if vals.dtype != np.uint32:
            vals = np.ascontiguousarray(vals).view(np.uint32)
        pending["sync_s"] += time.perf_counter() - sync0
        # Actual link cost: the header stack plus the (bucketed) value
        # prefix that was really fetched.
        nbytes = header.nbytes + vals.nbytes
        _METRICS.compact_bytes.inc(nbytes)
        dense = pending["k"] * (self.p.image_height // 32) \
            * self.p.image_width * 4
        if dense:
            _METRICS.compact_ratio.set(round(nbytes / dense, 5))
        return header, vals, total

    def _decode_compact(self, pending: dict):
        """Compact chunk -> dense word rows, or None on overflow."""
        got = self._fetch_compact(pending)
        if got is None:
            return None
        header, vals, _total = got
        t_host = time.perf_counter()
        counts = header[:, 0]
        hw, w = self.p.image_height // 32, self.p.image_width
        rows = [
            words.reshape(hw, w)
            for words in compact_decode_rows(header, vals, hw * w)
        ]
        self._adapt_sparse_cap(int(counts.max()) if counts.size else 0)
        pending["host_extra_s"] = time.perf_counter() - t_host
        return rows

    def _chunk_from_compact(self, pending: dict):
        """Compact chunk -> the (counts, bitmaps, values) S-sparse triple
        a FlipChunk carries, or None on overflow: the device layout IS
        the chunk layout, so this is slices only."""
        got = self._fetch_compact(pending)
        if got is None:
            return None
        header, vals, total = got
        t_host = time.perf_counter()
        counts = header[:, 0].astype(np.int64)
        self._adapt_sparse_cap(int(counts.max()) if counts.size else 0)
        pending["host_extra_s"] = time.perf_counter() - t_host
        return counts, header[:, 1:], vals[:total]

    def _chunk_from_sparse(self, pending: dict):
        """Fixed-width sparse rows -> the FlipChunk S-sparse triple, or
        None when any row was truncated (cap overflow)."""
        cap = pending["sparse_cap"]
        host = self._fetch_rows(pending)
        t_host = time.perf_counter()
        counts = host[:, 0].astype(np.int64)
        if counts.size and int(counts.max()) > cap:
            return None
        hw, w = self.p.image_height // 32, self.p.image_width
        nb = sparse_bitmap_words(hw * w)
        bitmaps = host[:, 1:1 + nb]
        parts = [host[t, 1 + nb:1 + nb + int(m)]
                 for t, m in enumerate(counts) if m]
        values = (np.concatenate(parts) if parts
                  else np.zeros(0, np.uint32))
        self._adapt_sparse_cap(int(counts.max()) if counts.size else 0)
        pending["host_extra_s"] = time.perf_counter() - t_host
        return counts, bitmaps, values

    def _sparse_cap_ceiling(self) -> int:
        total_words = (self.p.image_height // 32) * self.p.image_width
        return total_words // 2

    def _observe_diff_activity(self, rows) -> None:
        """After a plain packed chunk: enable the sparse encoding when
        the observed peak changed-word count fits a worthwhile cap."""
        if not self.stepper.offers("step_n_with_diffs_sparse"):
            return
        if not rows or rows[0].dtype != np.uint32:
            return  # dense-mask backends stay on the plain path
        max_words = max(int(np.count_nonzero(r)) for r in rows)
        self._adapt_sparse_cap(max_words)

    def _adapt_sparse_cap(self, max_words: int) -> None:
        """Set the next chunk's cap to a power of two with 2x headroom
        over the observed peak, clamped to the ceiling (rounded down to
        a power of two). Enabling requires the peak to clear the ceiling
        with 2x margin; shrinking needs the peak to fall to a quarter of
        the cap, so an oscillating peak cannot flip-flop it."""
        prev = self._sparse_cap
        ceiling = self._sparse_cap_ceiling()
        if ceiling < DIFF_SPARSE_MIN_CAP or 2 * max_words > ceiling:
            self._sparse_cap = None
        else:
            want = (
                max(DIFF_SPARSE_MIN_CAP,
                    1 << (2 * max_words - 1).bit_length())
                if max_words
                else DIFF_SPARSE_MIN_CAP
            )
            self._sparse_cap = min(want, 1 << (ceiling.bit_length() - 1))
        if self._sparse_cap != prev:
            tracing.event("engine.sparse_cap", "engine",
                          cap=self._sparse_cap, peak=max_words)

    def _seed_gens_states(self, host_levels) -> None:
        """(Re)anchor the level-mode state grid to a known gray board."""
        if self._gens_levels is not None:
            self._gens_levels["states"] = generations.states_from_levels(
                np.asarray(host_levels), self._gens_levels["rule"]
            )

    def _emit_turn_flips(self, t: int, mask) -> None:
        """One turn's flip events from a dense changed mask, in the
        consumer's negotiated form: level batches (multi-state), plain
        batches, or per-cell CellFlipped (the reference contract)."""
        if self._gens_levels is not None:
            g = self._gens_levels
            m = np.asarray(mask) != 0
            states = g["states"]
            states[m] = g["next"][states[m]]
            self.events.put(
                FlipBatch(t, xy_from_mask(m), levels=g["lut"][states[m]])
            )
        elif self.emit_flip_batches:
            self.events.put(FlipBatch(t, xy_from_mask(mask)))
        else:
            for cell in cells_from_mask(mask):
                self.events.put(CellFlipped(t, cell))

    def _diff_mask(self, diff) -> np.ndarray:
        """One turn's diff row as a dense mask — packed uint32 word-rows
        are unpacked, dense bool masks pass through."""
        if diff.dtype == np.uint32:
            return unpack_np(diff, self.p.image_height)
        return diff

    def _diff_cells(self, diff) -> list:
        """Flipped Cells of one turn's diff row."""
        return cells_from_mask(self._diff_mask(diff))

    # --- services ---

    def _alive_mask(self, host_world):
        """Alive-cell mask of a fetched (gray-level) world for event
        payloads: nonzero for two-state rules, the stepper's own notion
        for Generations backends, where dying cells are nonzero grays."""
        if self.stepper.offers("alive_mask"):
            return self.stepper.alive_mask(host_world)
        return host_world

    def _commit(self, turn: int, world, count) -> None:
        self._committed = (turn, world, count)
        _METRICS.committed_turn.set(turn)
        # The flight recorder's last note is within one dispatch chunk
        # of the committed turn — this line is that contract.
        flight.note("engine.commit", turn=turn)

    def _service_requests(self) -> None:
        """Engine thread: answer all pending count requests by realising
        the committed count (a copy of a result the step already
        computed — no new device work)."""
        with self._req_lock:
            reqs, self._requests = self._requests, []
        if not reqs:
            return
        turn, _, count = self._committed
        if count is not None:
            self._last_pair = (turn, _realize(count))
            _METRICS.alive_cells.set(self._last_pair[1])
        for ev, box in reqs:
            box["turn"], box["count"] = self._last_pair
            ev.set()

    def _ticker(self) -> None:
        """AliveCellsCount every tick (ref: gol/distributor.go:283-302) —
        as a *requester*: the engine thread does the device reads. On a
        short timeout it falls back to the last consistent pair (the
        turn-0 count until the first dispatch commits), which keeps the
        reference's 5 s first-report contract through a cold kernel
        build. The first wait is capped at 1 s."""
        wait = min(self.p.tick_seconds, 1.0)
        while not self._ticker_stop.wait(wait):
            wait = self.p.tick_seconds
            if self._paused:
                # No counts while paused (ref: gol/distributor.go:291-294).
                continue
            timeout = min(0.5, self.p.tick_seconds / 2)
            turn, count = self.alive_count_now(timeout=timeout)
            if not self._ticker_stop.is_set():
                self.events.put(AliveCellsCount(turn, count))

    def _poll_keys(self, turn: int) -> None:
        if self.keypresses is None:
            return
        while True:
            try:
                key = self.keypresses.get_nowait()
            except queue.Empty:
                return
            self._handle_key(key, turn)
            if self._paused and not self._emitting:
                # Block on further keys while paused
                # (ref: gol/distributor.go:264-277), still servicing
                # count requests — but not mid-chunk-emission, as in
                # gol_tpu: the chunk's rows finish first.
                while self._paused and self._stop_reason is None:
                    self._service_requests()
                    try:
                        key = self.keypresses.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    self._handle_key(key, turn)

    def _handle_key(self, key: str, turn: int) -> None:
        if key == "s":
            turn_now, world, _ = self._committed
            self._write_snapshot(turn_now, world)
        elif key in ("q", "k"):
            self._stop_reason = key
            self._paused = False
        elif key == "p":
            self._paused = not self._paused
            # The reference's pause prints (ref: gol/distributor.go:264-277).
            print(turn if self._paused else "Continuing")
            self.events.put(
                StateChange(turn, State.PAUSED if self._paused else State.EXECUTING)
            )

    def _throttle_events(self, turn: Optional[int] = None) -> None:
        """Producer-side backpressure: when a consumer lags far behind,
        wait for the backlog to drain before dispatching more turns
        (the reference's 1000-slot channel, ref: main.go:53). A backlog
        with no consumption for 5 s disarms the throttle for the rest of
        the run (a library caller may never drain the queue). `turn`
        stamps any StateChange a serviced verb emits; callers throttling
        mid-emit pass the last turn whose events are out (the committed
        turn may be a whole chunk ahead of the stream)."""
        if self._throttle_disabled:
            return
        at = self._committed[0] if turn is None else turn
        _METRICS.queue_depth.set(self.events.qsize())
        stalled_since = None
        throttled = False
        last_consumed = self.events.consumed
        # Chunk events are k-turn ARRAYS, not per-turn objects, so the
        # depth limit drops to a few dozen chunks.
        limit = 32 if self._chunk_mode() else 10_000
        while (
            self.events.qsize() > limit
            and self._stop_reason is None
            and not self.events.closed
        ):
            if not throttled:
                throttled = True
                _METRICS.throttle_stalls.inc()
            self._service_requests()
            self._poll_keys(at)
            time.sleep(0.005)
            consumed = self.events.consumed
            if consumed != last_consumed:
                last_consumed = consumed
                stalled_since = None
            elif stalled_since is None:
                stalled_since = time.monotonic()
            elif time.monotonic() - stalled_since > 5.0:
                self._throttle_disabled = True
                return

    def _maybe_autosave(self, turn: int, world) -> None:
        """Periodic auto-checkpoint between dispatches, by completed
        turns and/or wall seconds; the final turn is skipped — normal
        completion writes it anyway."""
        p = self.p
        if (p.autosave_turns <= 0 and p.autosave_seconds <= 0) or turn >= p.turns:
            return
        due = (
            p.autosave_turns > 0 and turn - self._autosave_turn >= p.autosave_turns
        ) or (
            p.autosave_seconds > 0
            and time.monotonic() - self._autosave_time >= p.autosave_seconds
        )
        if not due:
            return
        self._autosave_turn = turn
        self._autosave_time = time.monotonic()
        self._write_snapshot(turn, world)

    def _write_snapshot(self, turn: int, world, wait: bool = False) -> None:
        """Write out/<W>x<H>x<turn>.pgm and emit ImageOutputComplete once
        the bytes land (ref: gol/distributor.go:229-241)."""
        name = self.p.output_name(turn)
        host = self.stepper.fetch(world)
        done = threading.Event()

        def on_complete(n: str, exc: Optional[BaseException]) -> None:
            if exc is None:
                self.events.put(ImageOutputComplete(turn, n))
            done.set()

        self.io.write(name, host, on_complete)
        if wait:
            done.wait(timeout=30)


def run(
    params: Params,
    keypresses: Optional[queue.Queue] = None,
    events: Optional[EventQueue] = None,
    device=None,
    **engine_kwargs,
) -> EventQueue:
    """Start the engine and return its event queue — the public entry
    point mirroring `gol.Run(p, events, keyPresses)`
    (ref: gol/gol.go:12-41). Runs on the CUDA card unless
    `device="cpu"`."""
    engine = Engine(params, events=events, keypresses=keypresses,
                    device=device, **engine_kwargs)
    engine.start()
    return engine.events
