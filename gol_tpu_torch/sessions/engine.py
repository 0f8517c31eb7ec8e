"""SessionEngine — the bucketed dispatch loop.

One thread owns every bucket's device state (the single-device-owner
discipline of `engine.distributor.Engine`, applied across tenants):
it services cross-thread session verbs between dispatches, then steps
each occupied bucket — one dispatch per bucket per round (on the
card one launch of kernel A for a packable bucket's chunk) — and
demuxes the per-session diff rows to attached sinks. Torch's current
device and stream are per thread; every launch names the stack's own
device, so this thread needs no device of its own.

Chunking: watched buckets run short chunks (verb latency and flip
delivery stay interactive); unwatched buckets run long fused chunks
(dispatch overhead amortizes — the whole point of the layer).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from gol_tpu_torch.obs import flight
from gol_tpu_torch.sessions.manager import SessionManager


class SessionEngine:
    #: Turns per dispatch while any session in the bucket has a
    #: watcher (short: events are decoded + fanned out per chunk).
    WATCHED_CHUNK = 16
    #: Turns per dispatch for unwatched buckets.
    IDLE_CHUNK = 256

    def __init__(self, manager: SessionManager, *,
                 watched_chunk: Optional[int] = None,
                 idle_chunk: Optional[int] = None):
        self.manager = manager
        self.watched_chunk = watched_chunk or self.WATCHED_CHUNK
        self.idle_chunk = idle_chunk or self.IDLE_CHUNK
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def start(self) -> "SessionEngine":
        # Non-daemon for the same reason Engine is: interpreter
        # shutdown mid-dispatch tears down CUDA under a live frame. The
        # interpreter-exit stop hook in engine.distributor bounds the
        # wait (register_live_engine duck-types stop()/join()).
        from gol_tpu_torch.engine.distributor import register_live_engine

        self.manager._engine = self
        self._thread = threading.Thread(target=self._run,
                                        name="gol-sessions")
        register_live_engine(self)
        self._thread.start()
        return self

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def is_engine_thread(self) -> bool:
        """True on the dispatching thread itself — verbs issued from
        sink callbacks (e.g. a server dropping a dead peer mid-demux)
        must run inline, not enqueue-and-wait on themselves."""
        return threading.current_thread() is self._thread

    def stop(self) -> None:
        self._stop.set()
        self.manager._kick.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def health(self) -> dict:
        info = self.manager.health()
        if self.error is not None:
            info["status"] = "error"
            info["error"] = repr(self.error)
        return info

    # --- engine thread ---

    def _run(self) -> None:
        m = self.manager
        try:
            while not self._stop.is_set():
                m._service_requests()
                if self._stop.is_set():
                    break
                # Hibernation sweep (docs/SESSIONS.md): sessions idle
                # past the park policy checkpoint and free their slot
                # — the fleet is mostly asleep, and the engine only
                # rounds over buckets with resident tenants.
                m.park_idle()
                did = False
                with m._lock:
                    buckets = [b for b in m._buckets.values() if b.live]
                for b in buckets:
                    # Any watcher — flips or turn-events only — gets
                    # the short interactive chunk; the dispatch path
                    # (diffs vs fused) is flip_watched's call. When
                    # EVERY watcher on the bucket is a BATCHING one
                    # (negotiated hello "batch"), the chunk rises to
                    # the smallest negotiated max-k: they consume
                    # whole k-turn frames, so pinning them at the
                    # interactive size would cap throughput at
                    # 16-turn hops (the chunk-pinning fix) —
                    # while one per-turn watcher anywhere in the
                    # lockstep bucket keeps the interactive pacing
                    # (see _Bucket.batch_hint).
                    k = (max(self.watched_chunk, b.batch_hint())
                         if b.watched() else self.idle_chunk)
                    with m._lock:
                        if b.live:
                            m._dispatch_bucket(b, k)
                            did = True
                    # Verbs posted mid-round land between bucket
                    # dispatches, not after the whole sweep.
                    m._service_requests()
                    if self._stop.is_set():
                        break
                if not did:
                    m._kick.wait(0.05)
                    m._kick.clear()
        except BaseException as e:
            self.error = e
            flight.note("sessions.fatal", error=repr(e))
            import contextlib

            with contextlib.suppress(Exception):
                flight.dump("sessions-exception")
            raise
        finally:
            # Release any requester still waiting: their verbs run
            # inline once running() is False.
            self._stop.set()
            m._service_requests()
            time.sleep(0)  # let waiters observe the events
