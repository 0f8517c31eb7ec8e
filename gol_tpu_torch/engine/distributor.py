"""The distributor — turn scheduler and event emitter.

The counterpart of `gol_tpu.engine.distributor` (itself a re-design of
the reference's `distributor`, ref: gol/distributor.go:30-209) for a
world that lives on one CUDA device (or the CPU, when the caller asks):

- The *single* engine thread owns the device world, launches all device
  work and realizes device values (`.item()`). Each committed
  (turn, world, count) triple is published atomically, so the ticker
  reads a consistent snapshot without the reference's shared mutex.
- Per-turn CellFlipped diffs are computed on the device as masks and
  shipped to the host in one transfer per turn. When no consumer needs
  diffs, the engine runs `chunk` turns per dispatch through the
  stepper's multi-turn kernel without touching the host — the
  events-off fast path; CUDA launches are asynchronous, so the only
  synchronisations are the realizations below, exactly where gol_tpu
  realizes.
- Control (ticker, keyboard verbs s/q/p/k, pause) interleaves with the
  turn loop between dispatches.

Verb semantics (ref README.md:177-183 and gol/distributor.go:223-280):
  's'  snapshot current world to out/<W>x<H>x<turn>.pgm (async write)
  'q'  snapshot, then stop gracefully (the event stream is closed)
  'p'  pause/resume with StateChange events
  'k'  snapshot + full shutdown

Not ported yet: gol_tpu's device-accumulated diff-chunk pipeline
(dense / sparse / compact chunks, FlipChunk emission, cycle riding),
flip batches and Generations level-mode flip batches, BoardSync for attached
controllers, and injected steppers, IO services and timelines. The
steppers here offer no diff scans, so a watched run takes the per-turn
path — the path gol_tpu takes for any backend without
`step_n_with_diffs`.
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
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)
from gol_tpu_torch.io.service import IOService
from gol_tpu_torch.obs import accounting, device, flight, tracing
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel import make_stepper
from gol_tpu_torch.utils.cell import cells_from_mask


def _realize(count) -> int:
    """The one host synchronisation of a device count."""
    return int(count.item()) if hasattr(count, "item") else int(count)


def _charge_legacy(seconds: float, turns: int) -> None:
    """Accounting plane: the singleton engine serves the anonymous
    `legacy` tier — every dispatch is one tenant's spend."""
    m = accounting.meter()
    if m is not None:
        m.charge(accounting.LEGACY, dispatch_seconds=seconds,
                 flops=m.price_flops("engine.step") * turns,
                 turns=turns)


_CLOSE = object()

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
        kinds = ("chunk", "diff")
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
        # Fused chunks are never realized one by one, so only the
        # per-turn diff dispatch has a measured wall time.
        self.diff_seconds = obs.histogram(
            "gol_tpu_engine_dispatch_seconds",
            "Wall seconds per per-turn diff dispatch",
            {"kind": "diff"},
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
        initial_world: Optional[np.ndarray] = None,
        start_turn: int = 0,
        cycle_check_seconds: float = 2.0,
        device=None,
    ):
        self.p = params
        self.events = events if events is not None else EventQueue()
        self.keypresses = keypresses
        self.emit_flips = emit_flips
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
        self.stepper = make_stepper(
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
        self.io = IOService(params.image_dir, params.out_dir)
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

        # Initial CellFlipped burst for every live cell
        # (ref: gol/distributor.go:72-80); for a Generations rule, the
        # state-1 cells only.
        if self.emit_flips:
            for cell in cells_from_mask(self._alive_mask(host_world)):
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
                tick = time.perf_counter()
                new_world, mask, count = self.stepper.step_with_diff(world)
                turn += 1
                host_mask = self.stepper.fetch(mask)
                # fetch(mask) synced the dispatch: the span measures
                # device time, not the host event fan-out below.
                elapsed = time.perf_counter() - tick
                _METRICS.dispatches["diff"].inc()
                _METRICS.turns["diff"].inc()
                _METRICS.diff_seconds.observe(elapsed)
                _charge_legacy(elapsed, 1)
                tracing.add_span("engine.dispatch", "engine",
                                 time.time() - elapsed, elapsed,
                                 {"kind": "diff", "turn": turn, "turns": 1})
                for cell in cells_from_mask(host_mask):
                    self.events.put(CellFlipped(turn, cell))
                world = new_world
                self._commit(turn, world, count)
                self.events.put(TurnComplete(turn))
                self._throttle_events()
                self._maybe_autosave(turn, world)
            else:
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
                # An instant mark, not a measured span: timing the chunk
                # would need a realization, the observer tax this path
                # avoids.
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
            if self._paused:
                # Block on further keys while paused
                # (ref: gol/distributor.go:264-277), still servicing
                # count requests.
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

    def _throttle_events(self) -> None:
        """Producer-side backpressure: when a consumer lags far behind,
        wait for the backlog to drain before dispatching more turns
        (the reference's 1000-slot channel, ref: main.go:53). A backlog
        with no consumption for 5 s disarms the throttle for the rest of
        the run (a library caller may never drain the queue)."""
        if self._throttle_disabled:
            return
        at = self._committed[0]
        _METRICS.queue_depth.set(self.events.qsize())
        stalled_since = None
        throttled = False
        last_consumed = self.events.consumed
        while (
            self.events.qsize() > 10_000
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
