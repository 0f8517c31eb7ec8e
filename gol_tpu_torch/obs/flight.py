"""Flight recorder — the crash-surviving black box.

A crashed or evicted process takes its in-memory Timeline and tracer
ring with it; the metrics endpoint dies with the HTTP thread. This
module is the part that SURVIVES the failure it describes: a bounded
process-global ring of recent lifecycle notes (dispatch commits,
reconnects, evictions, invariant violations, redo decisions) plus, at
dump time, the recent tracer spans, the metric deltas since the
recorder was armed, and a caller-provided state snapshot (the engine's
`health()`), written CRASH-ATOMICALLY (`atomic_write_text` — temp file,
fsync, rename) so a dump interrupted by the very failure it records
never leaves a truncated artifact.

Dump triggers (wired by the layers themselves + the CLI):

- SIGTERM               cli.py installs a handler that dumps, then
                        raises KeyboardInterrupt for graceful teardown
- fatal engine error    engine/distributor.py's run() catch-all
- peer eviction         distributed/server.py's heartbeat judge
- reconnect exhaustion  distributed/client.py's ConnectionLost path

Live access: the `/flightrecorder` endpoint on `MetricsServer` serves
`payload()` — the same content the dump would have, for a process that
is still alive.

Enablement follows the registry (`GOL_TPU_METRICS=0` /
`obs.set_enabled(False)`): notes no-op behind one flag read, the ring
is allocated lazily on the first note, and `dump()` writes nothing.
File dumps additionally require a configured directory (`configure`) —
library embedders that never call it get the in-memory ring and the
live endpoint but no surprise files on disk.

Pure stdlib on purpose: `analysis.invariants` notes its violations
here and must stay importable from worker processes at zero cost.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Optional

import importlib

from gol_tpu_torch.obs.registry import REGISTRY, atomic_write_text

# Live module object — see the twin note in tracing.py (the package
# __init__ shadows the submodule attribute with a function).
_registry = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = [
    "FLIGHT",
    "FlightRecorder",
    "configure",
    "dump",
    "install_sigterm_handler",
    "note",
    "payload",
    "set_state_provider",
]

#: Ring capacity. Notes are per lifecycle event / per dispatch chunk
#: (≤ kHz), so 4096 entries hold minutes of recent history in well
#: under a MB.
DEFAULT_CAPACITY = 4096

#: Newest tracer records embedded in a dump. Bounded on purpose: a
#: dump can run on latency-sensitive threads (the server's heartbeat
#: judge on eviction, the SIGTERM handler), and serializing + fsyncing
#: the tracer's full 64k ring there would stall beacons for the write;
#: the recent tail is what a post-mortem reads anyway.
SPAN_TAIL = 2048


class FlightRecorder:
    """Bounded note ring + crash-atomic dumps. One process-global
    instance (`FLIGHT`); tests may build private ones."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: "Optional[collections.deque]" = None
        self._recorded = 0
        self._dir: Optional[str] = None
        #: Counter/gauge values when the recorder was armed — dumps
        #: report the DELTA, so a post-mortem shows what this run did,
        #: not what the process accumulated before `configure`.
        self._baseline: dict = {}
        #: Zero-arg callable returning a JSON-able state snapshot
        #: (Engine.health / EngineServer.health) — captured at dump
        #: time so the artifact pins the committed turn it died at.
        self._state: Optional[Callable[[], dict]] = None
        self._dump_lock = threading.Lock()
        #: Paths of dumps this process wrote (latest last).
        self.dumps: list = []

    # -- writers --

    def note(self, kind: str, **fields) -> None:
        """Record one lifecycle note. Host-side, bounded, GIL-atomic
        append — safe from any thread, no-op when disabled."""
        if not _registry._ENABLED:
            return
        ring = self._ring
        if ring is None:
            ring = self._ring = collections.deque(maxlen=self.capacity)
        self._recorded += 1
        ring.append((time.time(), kind, fields or None))

    # -- configuration --

    def configure(self, directory: Optional[str] = None, *,
                  state: Optional[Callable[[], dict]] = None) -> None:
        """Arm the recorder: where file dumps go (None keeps them off),
        what state snapshot to capture at dump time, and the metric
        baseline deltas are measured from."""
        if directory is not None:
            self._dir = os.fspath(directory)
        if state is not None:
            self._state = state
        if _registry._ENABLED:
            self._baseline = {
                _series_key(m): m.snapshot_value()
                for m in REGISTRY.metrics()
            }

    def set_state_provider(self, state: Callable[[], dict]) -> None:
        self._state = state

    # -- readers / dumps --

    @property
    def entries(self) -> list:
        return list(self._ring) if self._ring is not None else []

    @property
    def dropped(self) -> int:
        retained = len(self._ring) if self._ring is not None else 0
        return max(0, self._recorded - retained)

    def clear(self) -> None:
        """Tests: drop notes, dumps and the baseline."""
        self._ring = None
        self._recorded = 0
        self._baseline = {}
        self.dumps = []

    def _metric_deltas(self) -> dict:
        """Counters as deltas vs the armed baseline, gauges as current
        values, histograms as count deltas — the 'what did THIS run
        do' view a post-mortem wants."""
        out = {}
        for m in REGISTRY.metrics():
            key = _series_key(m)
            now = m.snapshot_value()
            base = self._baseline.get(key)
            if m.kind == "counter":
                out[key] = now - (base if isinstance(base, float) else 0.0)
            elif m.kind == "gauge":
                out[key] = now
            else:  # histogram: the count tells the rate story
                base_n = base["count"] if isinstance(base, dict) else 0
                out[key + ":count"] = now["count"] - base_n
        return out

    def payload(self, reason: Optional[str] = None) -> dict:
        """The black box content as one JSON-able dict — shared by the
        live `/flightrecorder` endpoint (reason None) and file dumps."""
        if not _registry._ENABLED:
            return {"enabled": False,
                    "reason": "metrics/tracing disabled "
                              "(GOL_TPU_METRICS=0 or set_enabled(False))"}
        from gol_tpu_torch.obs.tracing import TRACER

        state = None
        if self._state is not None:
            try:
                state = dict(self._state())
            except Exception as e:  # a broken probe must not kill a dump
                state = {"status": "error", "error": repr(e)}
        return {
            "enabled": True,
            "reason": reason,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "process_label": TRACER.process_label,
            "clock_offset_seconds": TRACER.clock_offset_seconds,
            "state": state,
            "entries": [
                {"ts": ts, "kind": kind, **(fields or {})}
                for ts, kind, fields in self.entries
            ],
            "dropped": self.dropped,
            "metric_deltas": self._metric_deltas(),
            "spans": TRACER.chrome_trace(limit=SPAN_TAIL)["traceEvents"],
        }

    def dump(self, reason: str, path=None) -> Optional[str]:
        """Write the black box crash-atomically. `path` overrides the
        configured directory; with neither (or disabled), no file is
        written and None returns — safe to call unconditionally from
        failure paths."""
        if not _registry._ENABLED:
            return None
        if path is None:
            if self._dir is None:
                return None
            # The configured directory is usually --out, which the
            # engine only creates at its first snapshot — a dump must
            # not fail because the run died before checkpointing.
            try:
                os.makedirs(self._dir, exist_ok=True)
            except OSError:
                return None
            path = os.path.join(
                self._dir, f"flightrecorder-{os.getpid()}.json"
            )
        path = os.fspath(path)
        # Serialized: SIGTERM-during-eviction must not interleave two
        # writers onto one temp file set.
        with self._dump_lock:
            self.note("flight.dump", reason=reason)
            atomic_write_text(
                path, json.dumps(self.payload(reason), indent=1)
            )
            self.dumps.append(path)
        return path


def _series_key(m) -> str:
    """The registry's own Prometheus series spelling (shared escaping
    included) — baseline/delta keys must line up byte-for-byte with
    `Registry.snapshot()` keys."""
    return f"{m.name}{_registry._fmt_labels(m.labels)}"


#: The process-global black box every gol_tpu layer notes into.
FLIGHT = FlightRecorder()


def note(kind: str, **fields) -> None:
    FLIGHT.note(kind, **fields)


def configure(directory: Optional[str] = None, *,
              state: Optional[Callable[[], dict]] = None) -> None:
    FLIGHT.configure(directory, state=state)


def set_state_provider(state: Callable[[], dict]) -> None:
    FLIGHT.set_state_provider(state)


def payload(reason: Optional[str] = None) -> dict:
    return FLIGHT.payload(reason)


def dump(reason: str, path=None) -> Optional[str]:
    return FLIGHT.dump(reason, path)


_SIGTERM_INSTALLED = False


def install_sigterm_handler() -> bool:
    """Dump the black box the instant SIGTERM lands, then raise
    KeyboardInterrupt so the process's ordinary graceful-shutdown path
    (the CLI catches it around every run mode) still executes. Main
    thread only (signal module contract) and idempotent (in-process
    callers — tests — invoke the CLI repeatedly; handlers must not
    chain onto themselves); returns False where a handler cannot be
    installed instead of breaking embedders."""
    global _SIGTERM_INSTALLED
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False
    if _SIGTERM_INSTALLED:
        return True
    prev = signal.getsignal(signal.SIGTERM)

    def _on_sigterm(signum, frame):
        FLIGHT.dump("sigterm")
        if callable(prev) and prev not in (
            signal.SIG_IGN, signal.SIG_DFL, signal.default_int_handler
        ):
            prev(signum, frame)
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # non-main thread race / exotic host
        return False
    _SIGTERM_INSTALLED = True
    return True
