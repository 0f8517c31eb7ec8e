"""Selectors-based writer event loop — thousands of sockets per thread.

The thread-per-connection writer the servers shipped with (one daemon
thread + one `queue.Queue` per attached peer) is the wrong shape for a
broadcast tier: at relay-scale peer counts the per-thread stacks alone
dwarf the payloads, and the scheduler burns CPU context-switching
writers that are each asleep 99% of the time. This module is the
replacement: a `WriterPool` owns a few event-loop threads, each running
a `selectors` loop over every socket assigned to it — a peer costs one
registry entry and a bounded byte queue, not a thread.

Contract (what `distributed.server._Conn` builds on):

- `register(sock, on_error)` -> `PoolHandle`; the pool sends on a
  NON-BLOCKING duplicate of the socket's fd, so the caller's reader
  thread keeps its own read deadline on the original socket object
  untouched (CPython socket timeouts are object-level emulation over
  an fd that is already O_NONBLOCK whenever a timeout is set).
- `PoolHandle.enqueue(framed)` queues one fully-framed wire payload;
  bounded in FRAMES (the unit the degradation thresholds —
  high-water / LOW_WATER / drain deadline — are expressed in) and in
  BYTES (the new hard cap a byte-queue needs: 1024 tiny heartbeats
  are not 1024 board rasters). Overflow raises `PoolFull` without
  ever blocking the caller — exactly the old queue.Full contract.
- `enqueue(front=True)` jumps the backlog (the clock-probe echo: its
  whole value is a prompt turnaround) while still riding the same
  socket serialization — frames never interleave.
- A peer's socket error fires `on_error(handle)` from the loop thread
  (the old writer-thread death path); a wedged peer never blocks the
  loop — `send()` on the non-blocking duplicate returns EWOULDBLOCK
  and the selector simply stops polling it until writable.
- `request_finish()` + `join()` reproduce the old drain-then-exit
  sentinel: everything already queued is flushed, then `finished`
  sets and the fd leaves the selector.

Fault injection (gol_tpu_torch.testing.faults) is honored per FRAME: when
the registered socket is a `FaultySocket`, the pool consults the
active plan exactly once per frame at first-byte time — the same
"one sendall per frame" accounting the threaded writers had, so
seeded chaos scenarios replay unchanged across the refactor.

Observability: `gol_tpu_writer_pool_busy_seconds_total` accumulates
the wall time loop threads spend actually servicing sends — the
CPU-proxy the relay smoke asserts stays flat as observers double
(encode-once + byte-copy fan-out means added observers cost queue
pushes, not re-encodes).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import selectors
import socket
import threading
import time
from typing import Callable, Optional

from gol_tpu_torch import obs
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["PoolFull", "PoolHandle", "WriterPool"]


class PoolFull(Exception):
    """The peer's bounded queue (frames or bytes) is full — the caller
    declares the peer dead, never blocks (the old queue.Full path)."""


class _PoolMetrics:
    def __init__(self):
        self.busy_seconds = obs.counter(
            "gol_tpu_writer_pool_busy_seconds_total",
            "Wall seconds pool threads spent actively servicing sends "
            "(the serving plane's CPU proxy — flat per added observer "
            "under encode-once fan-out)",
        )
        self.frames = obs.counter(
            "gol_tpu_writer_pool_frames_total",
            "Wire frames fully transmitted by pool threads",
        )
        self.sockets = obs.gauge(
            "gol_tpu_writer_pool_sockets",
            "Sockets currently registered across all writer pools",
        )


_METRICS = _PoolMetrics()


class PoolHandle:
    """One registered peer: bounded byte queue + selector membership.
    Queue mutations run under `_lock` (short, never across a send);
    only the owning loop thread consumes."""

    def __init__(self, loop: "_Loop", sock, on_error,
                 max_frames: int, max_bytes: int):
        self._loop = loop
        self._sock = sock  # the caller's socket (fault wrapper included)
        # Non-blocking duplicate for sends: the reader keeps its own
        # timeout semantics on the original object, the pool gets
        # EWOULDBLOCK instead of a 30s emulated block on a full buffer.
        self._wsock = socket.socket(fileno=os.dup(sock.fileno()))
        self._wsock.settimeout(0)
        self._fault = sock if _is_faulty(sock) else None
        self._on_error = on_error
        self.max_frames = max_frames
        self.max_bytes = max_bytes
        self._lock = lockcheck.make_lock("PoolHandle._lock")
        self._q: "collections.deque[bytes]" = collections.deque()
        #: The frame currently transmitting lives OUTSIDE the deque
        #: (popped into this slot by the loop thread): a concurrent
        #: enqueue(front=True) may then appendleft safely — it can
        #: neither interleave into the in-flight frame nor be popped
        #: in its place when that frame completes. Counts include it.
        self._sending: Optional[bytes] = None
        self._send_off = 0
        self._fault_done = False  # plan consulted for `_sending` yet?
        self._frames = 0
        self._bytes = 0
        self._armed = False    # registered for EVENT_WRITE (loop thread)
        self._arming = False   # an arm command is in flight
        self._dead = False
        self._finishing = False
        self.finished = threading.Event()

    # --- caller side ---

    def enqueue(self, payload: bytes, front: bool = False) -> None:
        """Queue one framed payload. Raises BrokenPipeError once the
        peer is dead, PoolFull when either bound is exceeded."""
        need_arm = False
        with self._lock:
            if self._dead:
                raise BrokenPipeError("peer is gone")
            if (self._frames >= self.max_frames
                    or self._bytes + len(payload) > self.max_bytes):
                raise PoolFull(
                    f"{self._frames} frames / {self._bytes} bytes queued"
                )
            if front:
                # Next after whatever is mid-wire (`_sending` is out
                # of the deque) — prompt, never interleaved.
                self._q.appendleft(payload)
            else:
                self._q.append(payload)
            self._frames += 1
            self._bytes += len(payload)
            if not self._armed and not self._arming:
                self._arming = True
                need_arm = True
        if need_arm:
            self._loop.post(self._arm)

    def qsize(self) -> int:
        """Frames pending — the unit the degradation thresholds use."""
        return self._frames

    def pending_bytes(self) -> int:
        return self._bytes

    @property
    def dead(self) -> bool:
        return self._dead

    def request_finish(self) -> None:
        """Flush everything already queued, then set `finished` and
        leave the selector (the old writer-exit sentinel)."""
        need_arm = False
        with self._lock:
            self._finishing = True
            if not self._armed and not self._arming:
                self._arming = True
                need_arm = True
        if need_arm:
            # The arm command notices finishing+empty and tears down
            # (closing the duplicate fd) — an empty queue must not
            # leave the dup fd leaked behind a set `finished`.
            self._loop.post(self._arm)

    def join(self, timeout: Optional[float] = None) -> None:
        self.finished.wait(timeout)

    def kill(self) -> None:
        """Tear the peer out of the pool immediately (socket closing);
        queued frames are dropped. Idempotent, any thread."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
        self._loop.post(self._teardown)

    # --- loop side ---

    def _arm(self) -> None:
        """Loop thread: join the selector's write set (or finish a
        peer whose queue is already drained)."""
        with self._lock:
            self._arming = False
            idle = not self._q and self._sending is None
            if self._dead or (self._finishing and idle):
                done = True
            elif self._armed or idle:
                return
            else:
                self._armed = True
                done = False
        if done:
            self._teardown()
            return
        try:
            self._loop.sel.register(self._wsock, selectors.EVENT_WRITE,
                                    self)
        except (ValueError, KeyError, OSError):
            self._error()

    def _disarm(self) -> None:
        with self._lock:
            if not self._armed:
                return
            self._armed = False
        try:
            self._loop.sel.unregister(self._wsock)
        except (ValueError, KeyError, OSError):
            pass

    def _release_locked(self) -> None:
        """Caller holds `_lock`: final state — mark dead, close the
        duplicate fd (loop-thread-safe: never while armed)."""
        self._dead = True
        self._q.clear()
        self._sending = None
        self._send_off = 0
        self._frames = 0
        self._bytes = 0
        self.finished.set()

    def _teardown(self) -> None:
        self._disarm()
        with self._lock:
            self._release_locked()
        try:
            self._wsock.close()
        except OSError:
            pass
        self._loop.forget(self)

    def _error(self) -> None:
        self._teardown()
        cb = self._on_error
        if cb is not None:
            self._on_error = None  # fire once
            cb(self)

    def _service(self) -> None:
        """Loop thread: push bytes until drained or EWOULDBLOCK. The
        in-flight frame is POPPED into `_sending` before any byte
        moves, so concurrent front-enqueues can never displace it (a
        peek-then-pop here once lost a clock echo and duplicated the
        head frame — caught by the pool-order test)."""
        finishing = False
        while True:
            with self._lock:
                if self._dead:
                    break
                if self._sending is None:
                    if not self._q:
                        self._armed = False
                        finishing = self._finishing
                        break
                    self._sending = self._q.popleft()
                    self._send_off = 0
                    self._fault_done = False
                head = self._sending
                off = self._send_off
            if not self._fault_done and self._fault is not None:
                # Exactly once per FRAME — a zero-byte EWOULDBLOCK on
                # the first attempt must not burn the next frame's
                # seeded rule on re-entry (off would still be 0).
                self._fault_done = True
                verdict = _apply_send_fault(self._fault, self._wsock,
                                            head)
                if verdict == "drop":
                    self._finish_frame(len(head), count=False)
                    continue
                if verdict == "dup":
                    with self._lock:
                        self._q.appendleft(head)
                        self._frames += 1
                        self._bytes += len(head)
                    # fall through: transmit (twice, via the duplicate)
                elif verdict == "error":
                    self._error()
                    return
            try:
                n = self._wsock.send(
                    memoryview(head)[off:] if off else head
                )
            except (BlockingIOError, InterruptedError):
                return  # stays armed; selector will call back
            except OSError:
                self._error()
                return
            if off + n >= len(head):
                self._finish_frame(len(head))
            else:
                with self._lock:
                    self._send_off = off + n
        # Drained (or died): leave the write set.
        try:
            self._loop.sel.unregister(self._wsock)
        except (ValueError, KeyError, OSError):
            pass
        if self._dead:
            self._teardown()
        elif finishing:
            self._teardown()

    def _finish_frame(self, size: int, count: bool = True) -> None:
        """Loop thread: the `_sending` frame fully left (or was
        fault-dropped) — release its slot and its share of the
        bounds."""
        with self._lock:
            self._sending = None
            self._send_off = 0
            self._frames -= 1
            self._bytes -= size
        if count:
            _METRICS.frames.inc()
            tracing.event("wire.send", "wire", bytes=size)


def _is_faulty(sock) -> bool:
    from gol_tpu_torch.testing.faults import FaultySocket

    return isinstance(sock, FaultySocket)


def _apply_send_fault(fsock, wsock, frame: bytes) -> Optional[str]:
    """Consult the seeded plan once per frame — the threaded writers'
    'one sendall per frame' accounting, reproduced on the pool.
    Returns 'drop' / 'dup' / 'error' / None (send normally)."""
    rule = fsock._plan.next_fault(fsock._role, "send")
    if rule is None:
        return None
    if rule.kind == "delay":
        time.sleep(rule.arg)
        return None
    if rule.kind == "drop":
        return "drop"
    if rule.kind == "dup":
        return "dup"
    # reset / partial: the frame dies mid-wire. `partial` pushes half
    # the frame first (best-effort, non-blocking) so the peer sees a
    # torn stream, like the threaded path did.
    if rule.kind == "partial":
        try:
            wsock.send(frame[: max(1, len(frame) // 2)])
        except OSError:
            pass
    fsock._hard_reset()
    return "error"


class _Loop(threading.Thread):
    """One selector thread: a wake pipe for cross-thread commands plus
    every armed peer socket."""

    def __init__(self, name: str):
        super().__init__(name=name, daemon=True)
        self.sel = selectors.DefaultSelector()
        self._rwake, self._wwake = os.pipe()
        os.set_blocking(self._rwake, False)
        os.set_blocking(self._wwake, False)
        self.sel.register(self._rwake, selectors.EVENT_READ, None)
        self._cmds: "collections.deque[Callable[[], None]]" = \
            collections.deque()
        self._stopping = threading.Event()
        #: Peers assigned to this loop (armed or not) — sized gauges
        #: and close() teardown read it.
        self.peers: "set[PoolHandle]" = set()
        self._peers_lock = lockcheck.make_lock("_Loop._peers_lock")

    def adopt(self, handle: PoolHandle) -> None:
        with self._peers_lock:
            self.peers.add(handle)

    def forget(self, handle: PoolHandle) -> None:
        with self._peers_lock:
            self.peers.discard(handle)
        _METRICS.sockets.set(_total_sockets())

    def post(self, fn: Callable[[], None]) -> None:
        self._cmds.append(fn)
        self.wake()

    def wake(self) -> None:
        try:
            os.write(self._wwake, b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wake is already pending

    def stop(self) -> None:
        self._stopping.set()
        self.wake()

    def run(self) -> None:
        while not self._stopping.is_set():
            try:
                events = self.sel.select(timeout=0.5)
            except OSError:
                events = []
            t0 = time.perf_counter()
            while self._cmds:
                try:
                    self._cmds.popleft()()
                except Exception:  # a peer's error path must not kill
                    pass           # every OTHER peer's writer
            for key, _ in events:
                if key.data is None:
                    try:
                        os.read(self._rwake, 4096)
                    except (BlockingIOError, OSError):
                        pass
                    continue
                try:
                    key.data._service()
                except Exception:
                    # A peer's error path must not kill every OTHER
                    # peer's writer.
                    with contextlib.suppress(Exception):
                        key.data._error()
            dt = time.perf_counter() - t0
            if events or self._cmds:
                _METRICS.busy_seconds.inc(dt)
        # Teardown: every peer leaves with its duplicate fd closed.
        with self._peers_lock:
            peers = list(self.peers)
        for p in peers:
            p._teardown()
        self.sel.close()
        for fd in (self._rwake, self._wwake):
            try:
                os.close(fd)
            except OSError:
                pass


#: Registered-socket census across every live pool in the process
#: (the gauge is process-global; pools are per server/relay).
_POOLS: "list[WriterPool]" = []
_POOLS_LOCK = lockcheck.make_lock("writerpool:_POOLS_LOCK")


def _total_sockets() -> int:
    with _POOLS_LOCK:
        pools = list(_POOLS)
    return sum(p.sockets() for p in pools)


class WriterPool:
    """N selector loops; peers are assigned round-robin at register."""

    #: Default per-peer byte bound: enough for a full 8192² board
    #: raster plus headroom — the hard stop a frame-count bound alone
    #: cannot provide (1024 queued rasters would be gigabytes).
    MAX_BYTES = 256 << 20

    def __init__(self, threads: int = 2, name: str = "gol-writer-pool"):
        self._loops = [
            _Loop(f"{name}-{i}") for i in range(max(1, int(threads)))
        ]
        for lp in self._loops:
            lp.start()
        self._rr = itertools.count()
        self._closed = False
        with _POOLS_LOCK:
            _POOLS.append(self)

    @property
    def threads(self) -> int:
        return len(self._loops)

    def register(self, sock, on_error=None, *,
                 max_frames: int = 1024,
                 max_bytes: Optional[int] = None) -> PoolHandle:
        if self._closed:
            raise RuntimeError("writer pool is closed")
        loop = self._loops[next(self._rr) % len(self._loops)]
        handle = PoolHandle(loop, sock, on_error, max_frames,
                            max_bytes if max_bytes is not None
                            else self.MAX_BYTES)
        loop.adopt(handle)
        _METRICS.sockets.set(_total_sockets())
        return handle

    def sockets(self) -> int:
        return sum(len(lp.peers) for lp in self._loops)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with _POOLS_LOCK:
            if self in _POOLS:
                _POOLS.remove(self)
        for lp in self._loops:
            lp.stop()
        for lp in self._loops:
            lp.join(timeout=5)
        _METRICS.sockets.set(_total_sockets())
