"""Tracing & profiling — the port's copy of `gol_tpu.utils.trace`, the
analog of the reference's runtime/trace harness (ref:
trace_test.go:12-29, artifact trace.out, inspected with `go tool trace`
per README.md:89).

Two complementary layers:

- `device_trace(dir)`: a `torch.profiler` capture of the enclosed
  block — host operators and, on a CUDA device, the card's kernels and
  copies — exported into `dir` as a Chrome trace (view with Perfetto
  or chrome://tracing instead of `go tool trace`).
- `Timeline`: a lock-free host-side span recorder the engine feeds one
  record per device dispatch (chunk of turns). Where the Go trace shows
  goroutine spawn/steal patterns of the per-turn worker farm
  (ref: gol/distributor.go:116-173), this shows the engine's dispatch
  cadence: turns per chunk, dispatch wall time, turns/sec — queryable
  in-process and dumpable to JSON for offline analysis.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import Iterator, Optional

from gol_tpu_torch.obs import atomic_write_text


@contextlib.contextmanager
def device_trace(trace_dir: str) -> Iterator[None]:
    """Capture a device profile for the enclosed block (trace.out
    analog): `trace_dir/trace-<pid>.json`, with CUDA activity when a
    card is present."""
    from gol_tpu_torch.obs.device import profiler

    with profiler() as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace-{os.getpid()}.json"))


@dataclasses.dataclass(frozen=True)
class Span:
    """One engine dispatch: `turns` turns committed ending at `turn`."""

    turn: int
    turns: int
    seconds: float
    kind: str  # "chunk" (fused), "diff" (per-turn) or "diffs" (diff chunk)

    @property
    def turns_per_sec(self) -> float:
        return self.turns / self.seconds if self.seconds > 0 else float("inf")


class Timeline:
    """Per-dispatch span RING. Appends are single-writer (engine thread);
    reads take a snapshot copy, so no lock is needed (the reference's
    ticker read its turn counter unlocked and raced, SURVEY.md §2; here
    the deque append is atomic under the GIL and readers never mutate).

    Past `capacity` the OLDEST spans are evicted — a long run keeps the
    recent window instead of silently freezing at the run's first
    `capacity` dispatches (the old drop-at-capacity behavior meant an
    infinite-run profile showed only its warm-up). `summary()` reports
    `dropped` so a truncated window is always visible, and the totals
    keep counting every recorded span, evicted or not."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=capacity
        )
        self._t0 = time.perf_counter()
        # Running totals over EVERY recorded span (eviction is a memory
        # bound, not an accounting one).
        self._recorded = 0
        self._total_turns = 0
        self._total_seconds = 0.0

    # -- engine side --

    def record(self, turn: int, turns: int, seconds: float, kind: str) -> None:
        self._recorded += 1
        self._total_turns += turns
        self._total_seconds += seconds
        self._spans.append(Span(turn, turns, seconds, kind))

    # -- reader side --

    @property
    def spans(self) -> list[Span]:
        return list(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring (recorded minus retained)."""
        return max(0, self._recorded - len(self._spans))

    def summary(self) -> dict:
        total_turns = self._total_turns
        total_s = self._total_seconds
        return {
            "dispatches": self._recorded,
            "retained": len(self._spans),
            "dropped": self.dropped,
            "turns": total_turns,
            "busy_seconds": round(total_s, 6),
            "wall_seconds": round(time.perf_counter() - self._t0, 6),
            "turns_per_sec": round(total_turns / total_s, 1) if total_s else None,
        }

    def dump(self, path: str) -> None:
        # Crash-safe (temp file + rename): a killed engine never leaves
        # a truncated timeline artifact behind.
        atomic_write_text(
            path,
            json.dumps(
                {"summary": self.summary(),
                 "spans": [dataclasses.asdict(s) for s in self.spans]},
            ),
        )


def profile_run(params, trace_dir: Optional[str] = None, **engine_kwargs):
    """Run one engine to completion under a Timeline (and optionally a
    device trace), returning (engine, timeline) — the TestTrace analog
    as a library call (ref: trace_test.go:12-29)."""
    from gol_tpu_torch.engine.distributor import Engine

    timeline = Timeline()
    engine = Engine(params, timeline=timeline, **engine_kwargs)
    ctx = device_trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with ctx:
        engine.run()
    return engine, timeline
