"""Named-span tracer — one timeline for the whole session (the port's
copy of `gol_tpu.obs.tracing`).

`utils/trace.py`'s Timeline records ONE kind of span (engine dispatches)
for ONE consumer (the profiling harness). This module is the general
form: any layer records named spans and instant events into a bounded
process-global ring, and the whole ring exports as Chrome-trace JSON
(the `chrome://tracing` / Perfetto format — the stand-in for the
reference's `go tool trace` artifact, but spanning every hop of a
distributed session instead of one process's goroutines).

Record shape (host-side, wall-anchored):

- a SPAN is (name, cat, ts, dur, tid, args) — `ts` is `time.time()` at
  enter (so two processes' dumps share a timebase up to clock offset),
  `dur` measured with `perf_counter` deltas;
- an EVENT is the same minus `dur` (Chrome "instant" phase) — used for
  per-turn wire correlation (`turn.emit` / `turn.apply`) and lifecycle
  marks (reconnects, evictions, clock sync).

Design constraints, matching `obs.registry`:

- **Pure stdlib** — the flight recorder and the analysis layer must be
  able to feed/read this with zero dependency cost.
- **Single-writer-per-thread ring.** Appends are one `deque.append`
  (atomic under the GIL, the Timeline argument); readers snapshot.
  Past `capacity` the OLDEST records are evicted; `dropped` counts the
  truncation.
- **Zero-cost when disabled.** The tracer follows the registry's
  enablement (`GOL_TPU_METRICS=0` / `obs.set_enabled(False)`): every
  record call returns behind one flag read, `span()` hands back a
  shared null context manager, and the ring itself is allocated lazily
  on the first record — a disabled process never allocates it at all.
- **Never inside a kernel.** Spans mark host-side dispatches and
  frames, never per cell.

Cross-process correlation: the distributed handshake's clock probe
estimates this process's wall-clock offset to its server peer;
`set_clock_offset` stores it and the export carries it in `metadata`,
so two processes' dumps can be put on one timebase (`python -m
gol_tpu_torch.obs.report merge` does that).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

import importlib

from gol_tpu_torch.obs.registry import atomic_write_text

# The live module object (the package __init__ rebinds the attribute
# `gol_tpu_torch.obs.registry` to its same-named convenience FUNCTION, so an
# `import ... as` spelling would grab that instead): every record call
# reads `_registry._ENABLED` — the one switch `set_enabled` flips.
_registry = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = [
    "DEVICE_TID",
    "TRACER",
    "Tracer",
    "add_span",
    "clock_offset",
    "event",
    "set_clock_offset",
    "set_metadata",
    "set_process_label",
    "span",
    "trace_payload",
]

#: Ring capacity: ~64k records keep the recent minutes of a busy
#: distributed session (a watched 512² run records a handful of spans
#: per turn) in a few MB of tuples.
DEFAULT_CAPACITY = 65_536

#: The thread id of the `device` track: spans of work on the card (the
#: engine's fused chunks, timed by CUDA events) rather than of a host
#: thread. No thread's `threading.get_ident()` is this small.
DEVICE_TID = 1


class _NullSpan:
    """The disabled-path context manager — one shared instance, no
    allocation per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: anchors wall time at enter, measures dur with
    perf_counter, records itself on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_wall", "_tick")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._wall = time.time()
        self._tick = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add_span(
            self._name, self._cat, self._wall,
            time.perf_counter() - self._tick, self._args,
        )
        return False


class Tracer:
    """Bounded ring of spans/events with Chrome-trace export.

    One process-global instance (`TRACER`) serves the whole package;
    tests may build private ones. All mutation paths check the
    registry's live enablement flag, so `obs.set_enabled(False)` (or
    `GOL_TPU_METRICS=0` at import) silences this plane too.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        #: Allocated on the FIRST record — a disabled process never
        #: pays for the ring (satellite contract: no ring allocations
        #: on the hot path with metrics off).
        self._ring: "Optional[collections.deque]" = None
        self._recorded = 0
        #: Wall-clock offset (seconds) to the session's reference
        #: timebase (the server peer): server_time ≈ local_time +
        #: offset. None until a clock probe measured it.
        self.clock_offset_seconds: Optional[float] = None
        #: Human label for this process in merged timelines
        #: ("serve" / "connect" / "local" — the CLI sets it).
        self.process_label: str = ""
        #: Extra metadata keys carried verbatim in the export (e.g.
        #: the device plane's profile-capture directory) — merged
        #: reports surface them next to the timeline.
        self.extra_metadata: dict = {}
        #: Thread id -> the name of the newest thread that recorded
        #: under it ("device" for DEVICE_TID), kept past the thread's
        #: end so an export after the run can still label its track.
        self.thread_names: dict = {DEVICE_TID: "device"}
        self._local = threading.local()

    # -- writers (hot path) --

    def _rec(self, record) -> None:
        ring = self._ring
        if ring is None:
            # Lazy, idempotent: two racing first-writers both build a
            # deque; the losing one's record lands in the winner's ring
            # on its next append at worst — bounded-loss, lock-free.
            ring = self._ring = collections.deque(maxlen=self.capacity)
        if not hasattr(self._local, "named"):
            # A thread's first record names its id (ids are reused, so
            # the newest thread under an id names it).
            self._local.named = True
            self.thread_names[threading.get_ident()] = (
                threading.current_thread().name)
        self._recorded += 1
        ring.append(record)

    def add_span(self, name: str, cat: str, ts: float, dur: float,
                 args: Optional[dict] = None,
                 tid: Optional[int] = None) -> None:
        """Record one completed span: `ts` wall seconds at start,
        `dur` seconds, on the calling thread's track or on `tid`'s
        (DEVICE_TID: the card's). For callers that already measured
        (the engine's dispatch bookkeeping) — `span()` is the measuring
        form."""
        if not _registry._ENABLED:
            return
        self._rec(("X", name, cat, ts, dur,
                   threading.get_ident() if tid is None else tid,
                   args or None))

    def add_event(self, name: str, cat: str, ts: Optional[float] = None,
                  args: Optional[dict] = None) -> None:
        if not _registry._ENABLED:
            return
        self._rec(("i", name, cat,
                   time.time() if ts is None else ts, 0.0,
                   threading.get_ident(), args or None))

    def span(self, name: str, cat: str = "", **args):
        """Context manager recording one span around the enclosed
        block. Returns a shared null manager when tracing is off."""
        if not _registry._ENABLED:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def event(self, name: str, cat: str = "", **args) -> None:
        self.add_event(name, cat, None, args or None)

    # -- readers --

    @property
    def records(self) -> list:
        return list(self._ring) if self._ring is not None else []

    @property
    def recorded(self) -> int:
        return self._recorded

    @property
    def dropped(self) -> int:
        retained = len(self._ring) if self._ring is not None else 0
        return max(0, self._recorded - retained)

    def clear(self) -> None:
        """Drop every record (tests); totals reset too."""
        self._ring = None
        self._recorded = 0

    def chrome_trace(self, limit: Optional[int] = None) -> dict:
        """The ring as a Chrome-trace dict: `traceEvents` (ts/dur in
        MICROseconds, per the format) plus `metadata` carrying the
        process identity and the measured clock offset — everything
        `gol_tpu.obs.report merge` needs to join two processes' dumps
        onto one corrected timebase. `limit` keeps only the newest N
        records (the flight recorder embeds a bounded tail, not the
        whole 64k ring)."""
        pid = os.getpid()
        events = []
        tids = set()
        records = self.records
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        for ph, name, cat, ts, dur, tid, args in records:
            tids.add(tid)
            ev = {"name": name, "cat": cat or "gol", "ph": ph,
                  "ts": round(ts * 1e6, 1), "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 1)
            else:
                ev["s"] = "p"  # instant scope: process
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        if self.process_label:
            events.insert(0, {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": self.process_label},
            })
        return {
            "traceEvents": events,
            "metadata": {
                "pid": pid,
                "process_label": self.process_label,
                "clock_offset_seconds": self.clock_offset_seconds,
                "recorded": self._recorded,
                "dropped": self.dropped,
                "dumped_at": time.time(),
                **self.extra_metadata,
            },
        }

    def dump(self, path) -> None:
        """Crash-safe Chrome-trace JSON (atomic_write_text)."""
        atomic_write_text(path, json.dumps(self.chrome_trace()))


#: The process-global tracer every gol_tpu layer records into.
TRACER = Tracer()


def span(name: str, cat: str = "", **args):
    return TRACER.span(name, cat, **args)


def event(name: str, cat: str = "", **args) -> None:
    TRACER.add_event(name, cat, None, args or None)


def add_span(name: str, cat: str, ts: float, dur: float,
             args: Optional[dict] = None, tid: Optional[int] = None) -> None:
    TRACER.add_span(name, cat, ts, dur, args, tid)


def set_clock_offset(offset_seconds: float) -> None:
    """Record the measured wall-clock offset to the session's reference
    timebase (server_time - local_time, from the handshake probe)."""
    TRACER.clock_offset_seconds = float(offset_seconds)


def clock_offset() -> Optional[float]:
    return TRACER.clock_offset_seconds


def set_process_label(label: str) -> None:
    TRACER.process_label = str(label)


def set_metadata(key: str, value) -> None:
    """Attach one JSON-able key to the export metadata (e.g. the
    --profile-dir capture path, so merged reports can link it)."""
    TRACER.extra_metadata[str(key)] = value


def trace_payload() -> dict:
    """The `/trace` endpoint body: the recent span window as a Chrome
    trace, or an EXPLICIT disabled payload when the plane is off (a
    scraper must be able to tell "disabled" from "idle")."""
    if not _registry._ENABLED:
        return {"enabled": False,
                "reason": "metrics/tracing disabled "
                          "(GOL_TPU_METRICS=0 or set_enabled(False))"}
    out = TRACER.chrome_trace()
    out["enabled"] = True
    return out
