"""Engine server — the card-side half of the distributed split (the
port of `gol_tpu.distributed.server`'s one-engine `EngineServer`, with
the same wire, verbs, metric names and defaults).

The reference spec's topology is controller ⇄ engine over the network,
with the engine running headless "on AWS" and controllers attaching and
detaching at will (ref: README.md:157-233; the committed code has only
dead stubs, ref: gol/distributor.go:44-52,459-530). This server is that
capability, working:

- owns the Engine (device turn loop) and keeps it evolving whether or
  not a controller is attached — the fault story's first half
  (SURVEY.md §5: "engine keeps evolving without a controller");
- accepts ONE DRIVING controller at a time over TCP, plus any number
  of read-only OBSERVERS (hello role:"observe" — multi-observer
  serving: the broadcaster already fans out one event stream, and only
  steering verbs need arbitration); on attach each peer gets a full
  board sync (the role of the commented GetCurrentBoard RPC,
  ref: gol/distributor.go:489-498) and then the event stream;
- per-turn CellFlipped diffs are streamed only while a controller that
  asked for them is attached (`hello.want_flips`) — flips-off engines
  run the chunked fast path, so a detached engine pays zero event tax;
- verbs: 'p'/'s' forwarded to the engine; 'q' detaches the controller
  and the engine lives on (ref: README.md:182); 'k' shuts the whole
  system down after a final snapshot (ref: README.md:183);
- `resume_from` boots the engine from an out/<W>x<H>x<T>.pgm snapshot,
  continuing at turn T — PGM-out + PGM-in checkpoint/resume
  (SURVEY.md §5);
- liveness (docs/RESILIENCE.md): a heartbeat thread beacons every
  attached peer whose stream has idled past `heartbeat_secs` (so a
  client behind a cold first dispatch still sees a live link), and evicts
  hb-capable peers that stop answering — the failure detector the
  30s send timeout alone could never be (a dead-but-open peer that
  never receives anything would hold its slot forever).

The engine steps on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, `--platform cpu`); without a card the constructor
raises. Only the engine thread touches the device: the accept, reader,
heartbeat and broadcaster threads read host state (`Engine.health`,
queue depths) and the host boards that `BoardSync` events carry.

`SessionServer` (the `--sessions` mode) serves many named sessions the
same way: a `SessionManager` whose buckets live on the card (one launch
of kernel A a packable bucket's chunk) and the `SessionEngine` thread
that alone touches them; `--record` tapes each session for the seek verb
and the replay server (`gol_tpu_torch.replay`).
"""

from __future__ import annotations

import contextlib
import hmac
import itertools
import json
import logging
import queue
import socket
import threading
import time
from typing import Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.checkpoint import snapshot_turn
from gol_tpu_torch.obs import accounting, flight, tracing
from gol_tpu_torch.obs.freshness import ServerFreshness
from gol_tpu_torch.distributed import wire
from gol_tpu_torch.relay.writerpool import PoolFull, WriterPool
from gol_tpu_torch.engine.distributor import Engine
from gol_tpu_torch.events import (
    BoardSync,
    CellFlipped,
    FinalTurnComplete,
    FlipBatch,
    FlipChunk,
    TurnComplete,
)
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.params import Params
from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["EngineServer", "SessionServer", "encode_batch_frames",
           "snapshot_turn"]

log = logging.getLogger(__name__)


class _ServerMetrics:
    """Registry handles for the serving plane (gol_tpu_torch.obs) — resolved
    once; all increments are host-side, per connection event or per
    wire frame (never per cell). Catalog: docs/OBSERVABILITY.md."""

    def __init__(self):
        self.accepts = obs.counter(
            "gol_tpu_server_accepts_total", "TCP connections accepted"
        )
        self.rejects = {
            r: obs.counter(
                "gol_tpu_server_rejects_total",
                "Attaches rejected by reason", {"reason": r},
            ) for r in ("bad-hello", "unauthorized", "busy",
                        "at-capacity", "draining")
        }
        self.attaches = {
            r: obs.counter(
                "gol_tpu_server_attaches_total",
                "Peers attached by role", {"role": r},
            ) for r in ("drive", "observe")
        }
        self.detaches = obs.counter(
            "gol_tpu_server_detaches_total", "Peers detached (any cause)"
        )
        self.events = obs.counter(
            "gol_tpu_server_broadcast_events_total",
            "Engine events consumed by the broadcaster",
        )
        self.frames = obs.counter(
            "gol_tpu_server_frames_total", "Wire frames enqueued to peers"
        )
        self.frame_bytes = obs.counter(
            "gol_tpu_server_frame_bytes_total",
            "Wire payload bytes enqueued to peers (pre-framing)",
        )
        self.queue_depth = obs.gauge(
            "gol_tpu_server_writer_queue_depth",
            "Deepest per-peer writer queue at the last flush",
        )
        self.overflows = obs.counter(
            "gol_tpu_server_queue_overflows_total",
            "Peers evicted after staying wedged past the drain deadline",
        )
        self.degradations = obs.counter(
            "gol_tpu_server_degradations_total",
            "Peers entering degraded (frame-shedding) mode at the "
            "writer-queue high-water mark",
        )
        self.recoveries = obs.counter(
            "gol_tpu_server_degraded_recoveries_total",
            "Degraded peers resynced via a coalesced BoardSync after "
            "their queue drained",
        )
        self.shed_frames = obs.counter(
            "gol_tpu_server_shed_frames_total",
            "Stream frames shed instead of enqueued to degraded peers",
        )
        self.peers = obs.gauge(
            "gol_tpu_server_peers", "Currently attached peers"
        )
        self.heartbeats = obs.counter(
            "gol_tpu_server_heartbeats_total",
            "Liveness beacons sent into idle peer streams",
        )
        self.batch_turns = obs.histogram(
            "gol_tpu_server_batch_turns",
            "Turns carried per encoded k-turn flip-batch wire frame "
            "(hello \"batch\" peers)",
        )
        self.evicted = obs.counter(
            "gol_tpu_server_peer_evicted_total",
            "Peers evicted for missing the heartbeat deadline",
        )
        self.chunks = obs.counter(
            "gol_tpu_server_broadcast_chunks_total",
            "k-turn FlipChunk events fanned out by the broadcaster",
        )
        self.chunk_encodes = obs.counter(
            "gol_tpu_server_chunk_encodes_total",
            "FBATCH encode passes (one per chunk per distinct "
            "negotiated max-k — encode-once fan-out means this tracks "
            "chunks, not chunks x peers; the relay smoke's gate)",
        )


_METRICS = _ServerMetrics()


#: Labeled children the per-peer lag family exposes before collapsing
#: the rest into an {peer="other"} aggregate — at relay-scale peer
#: counts one labeled series per connection would be a scrape-payload
#: and registry-cardinality problem, and nobody reads the 400th-worst
#: peer's lag anyway.
PEER_LAG_TOPK = 16


def _lag_family() -> "obs.TopKGauge":
    return obs.registry().topk_gauge(
        "gol_tpu_server_peer_lag_frames",
        "Writer-queue depth (frames behind) per attached peer — "
        "bounded exposition: top-K worst labeled, the rest one "
        "'other' aggregate; children evicted at detach",
        label="peer", cap=PEER_LAG_TOPK,
    )


class _LagHandle:
    """Per-connection view onto the bounded lag family: .set() like
    the old per-peer Gauge, so every call site is unchanged."""

    __slots__ = ("_family", "_child")

    def __init__(self, family, child: str):
        self._family = family
        self._child = child

    def set(self, v: float) -> None:
        self._family.set_child(self._child, v)

    def remove(self) -> None:
        self._family.remove_child(self._child)


#: Every per-peer labeled family is declared to the shared
#: entity-eviction helper (obs.registry): teardown calls ONE
#: `evict_entity("peer", token)` instead of remembering each family,
#: so a new per-peer series added later inherits eviction by
#: declaring itself here-adjacent rather than patching every detach
#: path (the bounded-cardinality audit, docs/OBSERVABILITY.md).
obs.track_entity_series("peer", "gol_tpu_server_peer_lag_frames",
                        topk=True)


def install_lag_gauge(conn: "_Conn") -> None:
    """Per-peer backpressure visibility: how many frames behind this
    peer's writer queue is. Bounded-cardinality discipline: children
    key on the connection token inside ONE TopKGauge entry (top-K
    worst labeled + an 'other' aggregate), and `remove_lag_gauge`
    evicts the child at detach, so both the registry and the
    exposition stay bounded under churn."""
    conn.lag_metric = _LagHandle(_lag_family(), str(conn.token))


def remove_lag_gauge(conn: "_Conn") -> None:
    if conn.lag_metric is not None:
        obs.evict_entity("peer", conn.token)
    conn.lag_metric = None


def _forget_peer_usage(conn: "_Conn") -> None:
    """Evict a detached peer's usage series (accounting plane). Only
    peer-scoped principals go: a session-attached connection bills to
    its TENANT, whose usage outlives any one socket — the manager
    forgets it at destroy/park."""
    m = accounting.meter()
    if m is not None and conn.principal.startswith("peer:"):
        m.forget(conn.principal)


class _Conn:
    """One attached controller: socket + send lock + subscription mode."""

    _next_token = itertools.count(1).__next__  # only the accept thread draws

    #: Writer-flush budget for interactive paths that finish ONE peer
    #: (the 'q' detach ack) rather than draining the whole set — the
    #: same order as DRAIN_TIMEOUT, not the old 30s that let a single
    #: wedged writer stall a detach for half a minute.
    FINISH_TIMEOUT = 5.0
    #: Per-direction socket deadline. Sends: a stalled-but-open
    #: controller (SIGSTOP, dead network path) fills its TCP window and
    #: would otherwise block the writer's sendall forever. Reads: the
    #: reader wakes at this cadence (an idle expiry at a frame boundary
    #: is clean — see wire.recv_msg) instead of blocking unboundedly,
    #: so every blocking read in this package carries a deadline (the
    #: blocking-io-timeout analysis check). Deliberately NOT the (much
    #: shorter) eviction deadline: eviction is the heartbeat thread's
    #: judgement from the last_rx clock — a tight deadline here would
    #: also bound sends and could kill a slow-but-alive peer mid
    #: board-sync.
    IO_TIMEOUT = 30.0

    #: Writer-queue depth at which a peer is DEGRADED (stream frames
    #: shed, coalesce-to-BoardSync on drain) instead of declared dead
    #: (docs/RESILIENCE.md "Overload & degradation"). Well under
    #: QUEUE_DEPTH so control frames (the coalesced sync, byes) always
    #: have room while a peer is shedding.
    HIGH_WATER = 256
    #: Queue depth at/below which a degraded peer counts as drained:
    #: the broadcaster coalesces everything it missed into one fresh
    #: BoardSync (synced_turn-gated, so nothing double-applies).
    LOW_WATER = 8

    #: Seconds a degraded peer may stay wedged (queue above LOW_WATER)
    #: before it is evicted — the only overflow-eviction left; a peer
    #: that drains inside the deadline is resynced instead.
    DRAIN_SECS = 10.0

    #: Hard cap on a peer's outbound queue, in frames — the control
    #: plane's headroom above high_water lives under it (see _enqueue).
    QUEUE_DEPTH = 1024

    def __init__(self, sock: socket.socket, want_flips: bool,
                 compact: bool = False, binary: bool = False,
                 levels: bool = False, role: str = "drive",
                 hb: bool = False, delta: bool = False,
                 batch: int = 0,
                 io_timeout: Optional[float] = None,
                 high_water: Optional[int] = None,
                 drain_secs: Optional[float] = None,
                 pool: Optional[WriterPool] = None):
        #: "drive" (exclusive slot, verbs accepted) or "observe"
        #: (read-only: BoardSync + events, verbs rejected) —
        #: multi-observer serving.
        self.role = role
        self.sock = sock
        sock.settimeout(io_timeout if io_timeout is not None
                        else self.IO_TIMEOUT)
        #: Peer advertised heartbeat support in its hello: it answers
        #: our beacons with {"t":"hb"} pongs, so silence past the
        #: eviction deadline means the peer is dead, not just quiet —
        #: only such peers are ever evicted (a legacy controller that
        #: sends one verb an hour keeps its slot, as before).
        self.hb = hb
        now = time.monotonic()
        #: Last byte received from / enqueued to this peer, and how
        #: many beacons went unanswered since last_rx — the liveness
        #: state the heartbeat thread reads (GIL-atomic scalar writes;
        #: reader and heartbeat threads never lock against each other).
        self.last_rx = now
        self.last_tx = now
        self.hb_unanswered = 0
        self.want_flips = want_flips
        #: Peer advertised the zlib'd-int32 flips encoding in its hello;
        #: older controllers get legacy JSON pair lists (the skew the
        #: serve/connect split exists for runs both ways).
        self.compact = compact
        #: Peer advertised raw binary frames (tag + header + zlib) for
        #: the bulk plane — flips, board syncs, final alive sets ride
        #: without the base64-inside-JSON inflation (~33% on a
        #: link-bound watched run).
        self.binary = binary
        #: Peer advertised the delta-of-sparse flips frames: each
        #: two-state turn rides as changed-word XOR masks with the
        #: changed-word bitmap delta'd against the previous sent turn
        #: (wire.delta_flips_to_frame). Binary-only; `delta_prev` is
        #: the chain state — the bitmap of the last SENT turn, reset to
        #: None at every BoardSync so reattach/resync restarts the
        #: chain on both ends.
        self.delta = delta and binary
        self.delta_prev = None
        #: Negotiated k-turn batch frames (hello "batch"): the
        #: clamped max turns one _TAG_FBATCH frame may carry to this
        #: peer, 0 = per-turn frames. Binary-only, like delta, and
        #: flips-only — a flip-less watcher can never receive a batch
        #: frame, so honoring its "batch" key would flip the engine
        #: into chunk emission (and burstier delivery for everyone)
        #: for nothing. Batch frames are SELF-CONTAINED (the turn-axis
        #: delta chain never crosses a frame), so no chain state lives
        #: here.
        self.batch = batch if (binary and want_flips) else 0
        #: Peer can apply per-cell gray levels (multi-state batches,
        #: Without it, level batches downgrade to plain flips —
        #: a peer without levels must keep receiving frames it understands
        #: rather than ignorable unknown tags (a silently frozen
        #: display).
        self.levels = levels
        #: Matches this connection to the BoardSync it requested.
        self.token = _Conn._next_token()
        #: Accounting principal every resource this conn spends is
        #: attributed to (gol_tpu_torch.obs.accounting): peer-token by
        #: default; the SessionServer re-points it at the session id
        #: once the peer attaches one.
        self.principal = f"peer:{self.token}"
        # No events flow until this connection's BoardSync has been sent:
        # a controller's first message is always the board state, never a
        # TurnComplete it has no context for.
        self.synced = False
        #: Turn of the BoardSync this peer last received. Buffered flips
        #: for any turn <= this are ALREADY IN the synced board — the
        #: broadcaster must not flush them to this peer, or an XOR
        #: consumer double-applies them (the multi-peer
        #: rewrite dropped the old 'flips = []' reset, and a global
        #: reset would be wrong now anyway — OTHER synced peers are
        #: still owed those flips).
        self.synced_turn = -1
        self._lock = lockcheck.make_lock("_Conn._lock")
        # Outbound frames ride a bounded per-connection queue: on the
        # WRITER POOL (gol_tpu_torch.relay.writerpool — the default for both
        # servers and the relay tier: thousands of non-blocking
        # sockets per event-loop thread) when `pool` is given, else
        # drained by this connection's own writer thread (the legacy
        # embedder path). Either way the broadcaster fans out wait-
        # free: a single wedged peer (SIGSTOP, blackholed path) can
        # only fill its own bounded queue, never stall another peer's
        # stream, and a peer more than QUEUE_DEPTH frames behind is
        # declared dead without blocking anyone.
        QUEUE_DEPTH = self.QUEUE_DEPTH
        self._pool = pool
        self._handle = None  # PoolHandle once start_writer ran (pooled)
        self._out: "queue.Queue[bytes | None]" = queue.Queue(QUEUE_DEPTH)
        self._dead = threading.Event()
        self._writer: Optional[threading.Thread] = None
        #: Slow-consumer degradation state (docs/RESILIENCE.md
        #: "Overload & degradation"): once the writer queue crosses
        #: `high_water`, stream frames (flips, turn events, beacons)
        #: are SHED wait-free instead of killing the peer; when the
        #: queue drains to LOW_WATER the server coalesces the missed
        #: backlog into one BoardSync, and only a peer still wedged
        #: past the server's drain deadline is evicted.
        # Clamped both ways: at least one frame of band above
        # LOW_WATER (a mark at/below the drain level would re-enter
        # degradation the instant it recovers — a permanent
        # degrade/resync thrash loop sending a full BoardSync per
        # turn), and 64 frames of control-plane headroom under the
        # queue's hard cap.
        self.high_water = max(
            self.LOW_WATER + 1,
            min(QUEUE_DEPTH - 64,
                high_water if high_water is not None
                else self.HIGH_WATER),
        )
        self.drain_secs = (drain_secs if drain_secs is not None
                           else self.DRAIN_SECS)
        self.degraded = False
        self.degraded_since = 0.0
        #: One drain-deadline eviction = ONE overflow count, whichever
        #: side (broadcaster's offer_stream or the heartbeat judge)
        #: notices first — bench_compare gates on this counter moving
        #: off zero, so a double-counted eviction skews the gate. Own
        #: lock: `_lock` is held across blocking socket writes, and the
        #: tally must stay wait-free for the broadcaster.
        self._ovf_counted = False
        self._ovf_lock = lockcheck.make_lock("_Conn._ovf_lock")
        #: A coalescing BoardSync has been requested/enqueued for this
        #: peer and has not arrived yet — don't request another.
        self.resync_pending = False
        #: Replay-plane scrub state (gol_tpu_torch.replay, docs/REPLAY.md):
        #: a peer parked at a seek position. While set, the live /
        #: broadcast stream is withheld (frames past the seeked board
        #: would XOR garbage onto it); {"t":"seek","turn":"live"}
        #: resyncs and clears it. `seek_gate` orders the toggle + the
        #: served historical frames against concurrent stream sends
        #: (RLock: the drain-recovery path resyncs from inside a gated
        #: callback).
        self.scrub = False
        self.seek_gate = lockcheck.make_rlock("_Conn.seek_gate")
        #: Per-peer lag gauge (label evicted at detach) — installed by
        #: the server once the peer is attached.
        self.lag_metric = None
        #: Freshness plane (gol_tpu_torch.obs.freshness): the last turn
        #: WRITTEN to this peer — stamped at every successful stream
        #: send/sync, read by the owning server's ServerFreshness
        #: sweep to turn "peer is at turn T" into seconds of turn age.
        #: Shed frames deliberately do not advance it: a degraded
        #: peer's growing age IS the signal the alert plane watches.
        self.fresh_turn = -1

    def note_written(self, turn: int) -> None:
        """Advance the freshness stamp (monotone)."""
        if turn > self.fresh_turn:
            self.fresh_turn = turn

    def mark_degraded(self) -> None:
        if self.degraded:
            return
        self.degraded = True
        self.degraded_since = time.monotonic()
        self.resync_pending = False
        _METRICS.degradations.inc()
        log.warning(
            "peer %d writer queue crossed high-water (%d frames): "
            "degrading (shedding stream frames, will coalesce to a "
            "BoardSync on drain)", self.token, self.high_water,
        )
        tracing.event("server.degrade", "lifecycle", role=self.role,
                      token=self.token, queued=self.queued())
        flight.note("server.degrade", role=self.role, token=self.token)

    def mark_recovered(self) -> None:
        """A coalescing BoardSync just went out: the peer's stream is
        whole again (synced_turn gates anything still in flight)."""
        if not self.degraded:
            return
        self.degraded = False
        self.resync_pending = False
        _METRICS.recoveries.inc()
        tracing.event("server.degrade_recovered", "lifecycle",
                      role=self.role, token=self.token)
        flight.note("server.degrade_recovered", token=self.token)

    def offer_stream(self) -> bool:
        """Gate ONE stream-plane frame (flips, turn events, beacons):
        True = send it, False = shed it (the peer is degraded — the
        coalescing BoardSync will make it whole on drain). Called
        BEFORE encoding, so a shed frame never advances per-peer
        encoder state (a delta peer's chain must only move on frames
        that actually ship). Degradation entry happens here, wait-free,
        on the broadcaster's thread; a degraded peer still wedged
        (queue above LOW_WATER) past `drain_secs` is the one overflow
        case left — declared dead exactly like the old queue-full
        death, without ever blocking the broadcaster."""
        if not self.writer_started:
            return True  # pre-attach: nothing to shed yet
        if not self.degraded:
            if self.queued() < self.high_water:
                return True
            self.mark_degraded()
        _METRICS.shed_frames.inc()
        if (time.monotonic() - self.degraded_since > self.drain_secs
                and self.queued() > self.LOW_WATER):
            self._dead.set()
            if self.count_overflow():
                _METRICS.overflows.inc()
            raise wire.WireError(
                "peer wedged past the drain deadline"
            )
        return False

    def count_overflow(self) -> bool:
        """Test-and-set the overflow tally for this peer: True exactly
        once, however many threads (broadcaster, heartbeat judge)
        declare the same drain-deadline eviction."""
        with self._ovf_lock:
            if self._ovf_counted:
                return False
            self._ovf_counted = True
            return True

    def drained(self) -> bool:
        """A degraded peer whose writer queue has drained to LOW_WATER
        is ready for its coalescing BoardSync."""
        return (self.degraded and not self.resync_pending
                and self.queued() <= self.LOW_WATER)

    @property
    def writer_started(self) -> bool:
        """Post-handshake: frames queue instead of sending directly
        (the old `_writer is not None` test, pool-aware)."""
        return self._writer is not None or self._handle is not None

    def queued(self) -> int:
        """Frames pending in this peer's writer queue — the number the
        degradation thresholds (high_water / LOW_WATER) gate on,
        whichever backend drains it."""
        if self._handle is not None:
            return self._handle.qsize()
        return self._out.qsize()

    def _wrap(self, payload: bytes) -> bytes:
        """Frame one payload for this peer's transport (the writer
        pool queues fully-framed bytes). The WS gateway's conns
        override this with RFC-6455 binary framing."""
        return wire.frame_bytes(payload)

    def _send_now(self, payload: bytes) -> None:
        """Blocking direct send on the caller's thread (pre-attach
        handshake replies only) — transport-framed, serialized against
        everything else by `_lock`. Emits the same per-frame
        `wire.send` mark as every other send path, so handshake
        replies don't vanish from merged timelines."""
        with self._lock:
            self.sock.sendall(self._wrap(payload))
        tracing.event("wire.send", "wire", bytes=len(payload))

    def start_writer(self, on_error) -> None:
        """Begin queue-drained sending; `on_error(conn)` fires (from
        the pool's loop thread, or the legacy writer thread) when the
        peer's socket fails."""
        if self._pool is not None:
            try:
                self._handle = self._pool.register(
                    self.sock,
                    on_error=lambda _h: (self._dead.set(),
                                         on_error(self)),
                    max_frames=self.QUEUE_DEPTH,
                )
            except RuntimeError:
                # Pool already closed (attach racing shutdown): the
                # peer is as dead as its server — surface the wire
                # error the accept paths already handle.
                self._dead.set()
                raise wire.WireError("writer pool is closed") from None
            return
        self._writer = threading.Thread(
            target=self._write_loop, args=(on_error,),
            name="gol-conn-writer", daemon=True,
        )
        self._writer.start()

    def _write_loop(self, on_error) -> None:
        while True:
            payload = self._out.get()
            if payload is None:
                return
            try:
                with self._lock:
                    wire.send_frame(self.sock, payload)
            except (wire.WireError, OSError):
                self._dead.set()
                on_error(self)
                return

    def _enqueue(self, payload: bytes) -> None:
        """Queue one frame for the writer. The stream plane gates
        itself through `offer_stream` FIRST, so a degraded peer only
        sees control frames (handshake replies, the coalescing
        BoardSync, farewells) here — those always enqueue, and
        high_water sits well under QUEUE_DEPTH precisely so they have
        room. A peer so far gone that even the control plane overflows
        the full QUEUE_DEPTH is declared dead."""
        if self._dead.is_set():
            raise wire.WireError("peer is gone")
        self.last_tx = time.monotonic()
        _METRICS.frames.inc()
        _METRICS.frame_bytes.inc(len(payload))
        # Accounting plane: wire bytes attributed at the ONE choke
        # point every tier's sends pass through (EngineServer,
        # SessionServer, relay, WS conns all enqueue here).
        accounting.charge(self.principal, wire_bytes=len(payload))
        if not self.writer_started:
            # Pre-attach (handshake replies): direct, no queue yet.
            self._send_now(payload)
            return
        if self._handle is not None:
            try:
                self._handle.enqueue(self._wrap(payload))
            except BrokenPipeError:
                self._dead.set()
                raise wire.WireError("peer is gone") from None
            except PoolFull:
                # Even the shedding headroom is gone (control frames
                # past the full queue bound): declare the peer dead
                # without ever blocking the broadcaster.
                self._dead.set()
                if self.count_overflow():
                    _METRICS.overflows.inc()
                raise wire.WireError("peer send queue overflow") \
                    from None
            return
        try:
            self._out.put_nowait(payload)
        except queue.Full:
            self._dead.set()
            if self.count_overflow():
                _METRICS.overflows.inc()
            raise wire.WireError("peer send queue overflow") from None

    def send(self, msg: dict) -> None:
        self._enqueue(json.dumps(msg, separators=(",", ":")).encode())

    def send_direct(self, msg: dict) -> None:
        """Send NOW, bypassing the writer queue (still serialized with
        it — the queue's writer holds the same per-frame lock, so
        frames never interleave). For the clock-probe echo ONLY: its
        whole value is a prompt turnaround, and queueing it behind a
        burst of flip frames would smuggle the backlog delay into the
        client's RTT/offset estimate. Stream-ordering-sensitive
        messages must keep using send()."""
        payload = json.dumps(msg, separators=(",", ":")).encode()
        _METRICS.frames.inc()
        _METRICS.frame_bytes.inc(len(payload))
        accounting.charge(self.principal, wire_bytes=len(payload))
        if self._handle is not None:
            # Pool mode: jump the backlog instead of bypassing the
            # queue — the pool serializes the socket, so a true bypass
            # could interleave into a frame mid-send. Front placement
            # keeps the turnaround prompt (nothing queued overtakes
            # it), which is the whole point of the probe echo.
            with contextlib.suppress(BrokenPipeError, PoolFull):
                self._handle.enqueue(self._wrap(payload), front=True)
            return
        with self._lock:
            wire.send_frame(self.sock, payload)

    def send_raw(self, payload: bytes) -> None:
        self._enqueue(payload)

    def request_finish(self) -> None:
        """Enqueue the writer's exit sentinel without waiting — the
        writer drains everything already queued (including a farewell)
        and then exits. Pair with `join_writer`; `_drain_conns` fans
        the sentinels out to every peer FIRST so wedged writers drain
        concurrently instead of serializing shutdown."""
        if self._handle is not None:
            self._handle.request_finish()
            return
        if self._writer is None:
            return
        with contextlib.suppress(queue.Full):
            self._out.put_nowait(None)

    def join_writer(self, timeout: float) -> None:
        if self._handle is not None:
            self._handle.join(timeout)
        elif self._writer is not None:
            self._writer.join(timeout)

    def finish(self, timeout: Optional[float] = None) -> None:
        """Flush the outbound queue (writer drains everything already
        enqueued — including a farewell — then exits on the sentinel)
        before the caller closes the socket. A direct farewell would
        OVERTAKE queued stream events (the client stops at bye/detached,
        losing its FinalTurnComplete). The default budget is
        FINISH_TIMEOUT: interactive paths that bypass _drain_conns
        (the 'q' detach ack) must not stall half a minute behind one
        wedged writer."""
        self.request_finish()
        self.join_writer(self.FINISH_TIMEOUT if timeout is None else timeout)

    def close(self) -> None:
        self._dead.set()
        if self._handle is not None:
            self._handle.kill()
        with contextlib.suppress(queue.Full):
            self._out.put_nowait(None)  # release the legacy writer
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.sock.close()


def publish_listen_addr(address) -> None:
    """One info-style gauge naming this process's serving address —
    how `obs.console` joins a relay's `upstream` label to the endpoint
    actually scraped, so the fan-out tree renders from metrics alone."""
    obs.gauge(
        "gol_tpu_server_listen_addr",
        "Serving address of this process (info gauge, value 1)",
        {"addr": f"{address[0]}:{address[1]}"},
    ).set(1)


def _clamp_batch(hello: dict, cap: int) -> int:
    """The peer's hello "batch" max-k request, clamped to the server's
    --batch-turns ceiling AND the wire frame's own hard turn cap —
    an operator cap above FBATCH_MAX_TURNS must never let the server
    negotiate frames its peer's parser is required to reject.
    Hostile/non-integer values read as 0 (no batching) — the request
    is an optimization, never an error."""
    if cap <= 0:
        return 0
    req = hello.get("batch")
    if isinstance(req, bool) or not isinstance(req, int):
        return 0
    return max(0, min(req, cap, wire.FBATCH_MAX_TURNS))


def _encode_and_send_flips(conn: _Conn, turn: int, flips, flips_levels,
                           width: int, height: int,
                           delta_words=None) -> None:
    """One turn's flips in `conn`'s negotiated encoding — the single
    encode both the singleton broadcaster and the per-session sinks
    (SessionServer) share, so the session layer feeds the wire
    encodings unchanged. `delta_words` is a pre-built (bitmap, words)
    pair when the caller amortized the encode across delta peers."""
    lv = flips_levels if conn.levels else None
    if conn.delta and lv is None:
        # Delta-of-sparse: changed-word masks with the bitmap
        # delta'd against this peer's previous sent turn — on a
        # settled board the recurring active words XOR to near
        # nothing and zlib collapses the bitmap term. Level batches
        # keep the LFLIPS frame (levels are not XOR state).
        bitmap, words = (delta_words if delta_words is not None
                         else wire.coords_to_words(flips, width, height))
        prev = conn.delta_prev
        conn.delta_prev = bitmap
        conn.send_raw(wire.delta_flips_to_frame(
            turn, bitmap if prev is None else bitmap ^ prev, words
        ))
    elif conn.binary:
        conn.send_raw(
            wire.level_flips_to_frame(turn, flips, lv)
            if lv is not None
            else wire.flips_to_frame(turn, flips)
        )
    elif conn.compact:
        conn.send(wire.flips_to_msg(turn, flips, levels=lv))
    else:
        # Legacy JSON peers are two-state; levels are dropped
        # (they could not apply them anyway).
        conn.send({"t": "flips", "turn": turn,
                   "cells": np.asarray(flips).tolist()})


class EngineServer:
    """Serve one engine run to at-most-one controller at a time.
    `engine_kwargs` go to the `Engine` (`device="cpu"` for the CPU)."""

    def __init__(
        self,
        params: Params,
        host: str = "127.0.0.1",
        port: int = 8030,
        *,
        resume_from: Optional[str] = None,
        secret: Optional[str] = None,
        heartbeat_secs: float = 2.0,
        evict_secs: Optional[float] = None,
        max_peers: Optional[int] = None,
        high_water: Optional[int] = None,
        drain_secs: Optional[float] = None,
        retry_after_secs: float = 1.0,
        batch_turns: int = 1024,
        writer_pool_threads: int = 2,
        **engine_kwargs,
    ):
        self.params = params
        #: Server-side ceiling on a peer's hello "batch" request (the
        #: max turns one flip-batch frame may carry; CLI
        #: --batch-turns). 0 disables batch negotiation entirely —
        #: every peer gets per-turn frames.
        self.batch_turns = max(0, batch_turns)
        #: Admission budget (docs/RESILIENCE.md "Overload &
        #: degradation"): attaches past this many live peers are
        #: rejected "at-capacity" WITH a retry_after hint, instead of
        #: accepted into a serving plane that can no longer keep up.
        #: None = unbounded (legacy).
        self.max_peers = max_peers
        self.high_water = high_water
        self.drain_secs = drain_secs
        #: The hint every load rejection ("busy", "at-capacity")
        #: carries: seconds the peer should wait before re-dialing —
        #: the client's backoff honors it instead of guessing.
        self.retry_after_secs = max(0.0, retry_after_secs)
        #: Liveness cadence (docs/RESILIENCE.md): beacons ride idle
        #: gaps in each peer's stream every `heartbeat_secs`; an
        #: hb-capable peer silent past `evict_secs` (default 3 beacon
        #: intervals) with unanswered beacons outstanding is evicted.
        #: 0 disables the whole plane (legacy behavior).
        self.heartbeat_secs = max(0.0, heartbeat_secs)
        self.evict_secs = (
            evict_secs if evict_secs is not None
            else 3.0 * self.heartbeat_secs
        )
        #: Shared-secret attach token. When set, a hello whose "secret"
        #: does not match is rejected and logged — the board state and
        #: the 'k' kill verb are not for any peer that can reach the
        #: port (the reference's open :8030 listener,
        #: ref: gol/distributor.go:49-52, is a flaw to beat, not match).
        self._secret = secret
        if resume_from is not None:
            engine_kwargs.setdefault("initial_world", read_pgm(resume_from))
            engine_kwargs.setdefault("start_turn", snapshot_turn(resume_from))
        # Crash-restart visibility: the turn this process booted from
        # (0 on a fresh start) — the smoke harness and operators read
        # it to confirm a --resume actually resumed.
        from gol_tpu_torch.checkpoint import record_resume_turn

        record_resume_turn(engine_kwargs.get("start_turn", 0))
        self._keys: queue.Queue = queue.Queue()
        # Flips ride as per-turn FlipBatch arrays: the broadcaster and
        # the wire consume them vectorized — per-cell Python event
        # objects capped the whole watched pipeline at ~30 turns/s.
        self.engine = Engine(
            params, keypresses=self._keys, emit_flips=False,
            emit_flip_batches=True, **engine_kwargs
        )
        try:
            self._listener = socket.create_server((host, port))
        except OSError:
            if self.engine._own_io:  # the never-started engine's IO thread
                self.engine.io.stop()
            raise
        self.address = self._listener.getsockname()
        #: Selector-based writer event loop (gol_tpu_torch.relay.writerpool):
        #: every attached peer's outbound frames ride one of these few
        #: threads — thousands of sockets per thread instead of one
        #: writer thread per connection. 0 restores the legacy
        #: thread-per-connection writers. Built after the engine and the
        #: listener, so a constructor that raises leaves no thread.
        self.pool = (WriterPool(writer_pool_threads, "gol-srv-writer")
                     if writer_pool_threads > 0 else None)
        publish_listen_addr(self.address)
        #: Freshness plane (docs/OBSERVABILITY.md "Freshness plane"):
        #: per-peer turn age vs the engine's committed turn, sampled
        #: by the broadcaster's per-turn housekeeping and the
        #: heartbeat sweep (rate-limited inside).
        self.freshness = ServerFreshness("engine")
        self._conn: Optional[_Conn] = None
        #: Read-only observers fanned out from the same event stream —
        #: the controller ⇄ broker ⇄ workers topology's natural "one
        #: driver plus N watchers" shape (ref: README.md:201-207 keeps
        #: the DRIVER singular; nothing about watching is exclusive).
        self._observers: "list[_Conn]" = []
        self._conn_lock = lockcheck.make_lock("EngineServer._conn_lock")
        self._shutdown = threading.Event()
        self.done = threading.Event()
        self._threads: list[threading.Thread] = []

    # --- lifecycle ---

    def start(self) -> "EngineServer":
        self.engine.start()
        loops = [(self._accept_loop, "gol-accept"),
                 (self._broadcast_loop, "gol-broadcast")]
        if self.heartbeat_secs > 0:
            loops.append((self._heartbeat_loop, "gol-heartbeat"))
        for fn, name in loops:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, *, stop_engine: bool = True) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        if stop_engine:
            self.engine.stop()
        with contextlib.suppress(OSError):
            # SHUT_RDWR first: on Linux, close() alone does NOT wake a
            # thread parked in accept() — the zombie accept holds the
            # LISTEN socket alive and the port stays bound, so an
            # in-process restart on the same address gets EADDRINUSE.
            self._listener.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._listener.close()
        self._drain_conns()
        self.engine.join(timeout=60)
        if self.pool is not None:
            self.pool.close()
        # A dead server's last worst-age reading must not stay glued
        # to the registry (fleet AGE columns and max() alert rules
        # read the family).
        self.freshness.close()
        self.done.set()

    #: Per-peer writer-drain budget at teardown. Writers drain
    #: CONCURRENTLY (every sentinel is enqueued before any join), so
    #: run-end with a driver plus several wedged observers costs at
    #: most ~this once, not 30s per stuck peer.
    DRAIN_TIMEOUT = 5.0

    def _drain_conns(self) -> None:
        """Collect-and-clear every attached connection under the lock,
        then farewell + close each — the one teardown used by
        shutdown() and the broadcast epilogue. Phase 1 enqueues every
        peer's farewell and exit sentinel (non-blocking); phase 2 joins
        the writers, which have all been draining in parallel since
        phase 1, with a short per-peer timeout."""
        with self._conn_lock:
            conns = list(self._observers)
            if self._conn is not None:
                conns.append(self._conn)
            self._conn = None
            self._observers = []
        for conn in conns:
            with contextlib.suppress(Exception):
                conn.send({"t": "bye"})
            conn.request_finish()
        deadline = time.monotonic() + self.DRAIN_TIMEOUT
        for conn in conns:
            conn.join_writer(max(0.1, deadline - time.monotonic()))
            conn.close()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def health(self) -> dict:
        """Liveness snapshot for /healthz: the engine's health plus the
        serving plane (host-side state only — probe-hammer safe)."""
        info = self.engine.health()
        with self._conn_lock:
            info["peers"] = len(self._observers) + (
                1 if self._conn is not None else 0
            )
            info["driver_attached"] = self._conn is not None
        info["address"] = list(self.address)
        if self._shutdown.is_set() and info["status"] == "ok":
            info["status"] = "shutting-down"
        return info

    # --- accept path ---

    #: A connected peer gets this long to produce its hello. Without a
    #: deadline, one silent TCP connect wedges the (single) accept
    #: thread forever — no further peer could ever attach.
    HELLO_TIMEOUT = 10.0

    def _accept_loop(self) -> None:
        from gol_tpu_torch.testing import faults

        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            # Deterministic fault injection (GOL_TPU_FAULTS) — a
            # passthrough unless a plan names the server role.
            sock = faults.wrap("server", sock)
            _METRICS.accepts.inc()
            try:
                sock.settimeout(self.HELLO_TIMEOUT)
                # Control-only receive: an unauthenticated peer must
                # never make the server inflate a bulk zlib payload.
                hello = wire.recv_msg(sock, allow_binary=False)
                if not hello or hello.get("t") != "hello":
                    raise wire.WireError(f"bad hello: {hello!r}")
            except (wire.WireError, OSError, ValueError) as e:
                log.warning("rejecting connection from %s: %s", addr, e)
                _METRICS.rejects["bad-hello"].inc()
                sock.close()
                continue

            # Compare as UTF-8 bytes: compare_digest on str raises
            # TypeError for non-ASCII input, and the secret here is
            # attacker-controlled — a unicode probe must be a clean
            # rejection, not a dead accept thread.
            if self._secret is not None and not hmac.compare_digest(
                str(hello.get("secret", "")).encode("utf-8", "replace"),
                self._secret.encode("utf-8", "replace"),
            ):
                log.warning(
                    "rejecting unauthenticated attach from %s", addr
                )
                _METRICS.rejects["unauthorized"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(
                        sock, {"t": "error", "reason": "unauthorized"}
                    )
                sock.close()
                continue

            if (self.max_peers is not None
                    and self._peer_count() >= self.max_peers):
                # Admission control: a full house sheds the attach at
                # the door, WITH a when-to-come-back hint — an
                # unbounded observer pile-up is how the serving plane
                # stops keeping up for everyone already attached.
                _METRICS.rejects["at-capacity"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(sock, {
                        "t": "error", "reason": "at-capacity",
                        "retry_after": self.retry_after_secs,
                    })
                sock.close()
                continue
            role = ("observe" if hello.get("role") == "observe"
                    else "drive")
            # Heartbeat negotiation: the peer advertises support, we
            # confirm the cadence in the attach-ack; only hb peers are
            # ever evicted for silence.
            hb = bool(hello.get("hb", False)) and self.heartbeat_secs > 0
            conn = _Conn(sock, bool(hello.get("want_flips", False)),
                         compact=bool(hello.get("compact", False)),
                         binary=bool(hello.get("binary", False)),
                         levels=bool(hello.get("levels", False)),
                         role=role, hb=hb,
                         delta=bool(hello.get("delta", False)),
                         batch=_clamp_batch(hello, self.batch_turns),
                         high_water=self.high_water,
                         drain_secs=self.drain_secs,
                         pool=self.pool)
            if role == "observe":
                # Observers fan out freely — only the DRIVER slot is
                # exclusive (its verbs steer the run).
                with self._conn_lock:
                    self._observers.append(conn)
                busy = False
            else:
                with self._conn_lock:
                    if self._conn is not None:
                        busy = True
                    else:
                        self._conn, busy = conn, False
            if busy:
                # One DRIVER at a time (the reference's controller is
                # singular too, ref: README.md:201-207). The hint lets
                # a waiting driver back off for exactly as long as the
                # server believes the slot needs, not a blind guess.
                _METRICS.rejects["busy"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(sock, {
                        "t": "error", "reason": "busy",
                        "retry_after": self.retry_after_secs,
                    })
                sock.close()
                continue
            _METRICS.attaches[role].inc()
            _METRICS.peers.set(self._peer_count())
            install_lag_gauge(conn)

            # Immediate ack: the controller's handshake timeout covers
            # the first reply, and the BoardSync only arrives once the
            # engine services the attach between dispatches — on a cold
            # TPU that can be a 40s compile away. The ack lands within
            # ms so attaches never time out behind a dispatch (clients
            # ignore unknown message kinds, so old ones are unaffected).
            # Clock-probe negotiation (docs/OBSERVABILITY.md): the ack
            # advertises that this server echoes {"t":"clk"} probes
            # with its wall clock, so the peer can estimate the
            # emit-stamp offset instead of documenting the skew. Legacy
            # peers ignore the unknown key.
            ack = {"t": "attach-ack", "clock": True, "depth": 0}
            if conn.batch:
                # Confirm the clamped max-k, so the peer knows the
                # granularity its frames will arrive at.
                ack["batch"] = conn.batch
            if hb:
                # The client arms its own miss-detector from this: a
                # server that stays silent past a few multiples of
                # hb_secs is dead, and reconnecting is correct.
                ack["hb_secs"] = self.heartbeat_secs
            try:
                conn.send(ack)
            except (wire.WireError, OSError):
                self._detach(conn)
                continue
            try:
                conn.start_writer(self._detach)
            except wire.WireError:
                self._detach(conn)
                continue
            tracing.event("server.attach", "lifecycle", role=role,
                          token=conn.token)
            flight.note("server.attach", role=role, token=conn.token)
            self._attach(conn)
            threading.Thread(
                target=self._reader_loop, args=(conn,),
                name="gol-conn-reader", daemon=True,
            ).start()

    def _attach(self, conn: _Conn) -> None:
        """Ask the engine to publish a BoardSync (and, if wanted, start
        per-turn flips) at its next dispatch boundary. Both ride the
        event stream, so the broadcaster delivers them in turn order —
        no side-channel race between the sync and newer diffs.

        Per-turn TurnComplete events flow whenever ANY controller is
        attached (flips or not — a headless controller still follows
        progress, ref: sdl/loop.go:44-47 prints per-event); a detached
        engine emits none and runs full-size fused chunks."""
        self.engine.emit_turns = True
        if conn.batch:
            # A batching watcher: diff chunks emit as whole FlipChunk
            # events, and the dispatch chunk budget scales to the
            # negotiated max-k (so chunks are not pinned at the
            # interactive size).
            self.engine.emit_flip_chunks = True
            self.engine.batch_turns_hint = max(
                self.engine.batch_turns_hint, conn.batch
            )
        self.engine.request_board_sync(
            enable_flips=conn.want_flips, token=conn.token
        )

    def _peer_count(self) -> int:
        with self._conn_lock:
            return len(self._observers) + (1 if self._conn is not None else 0)

    def _release(self, conn: _Conn) -> None:
        """Free the connection's slot (driver or observer) without
        closing the socket, re-deriving the engine flags from whoever
        remains attached."""
        removed = False
        with self._conn_lock:
            if self._conn is conn:
                self._conn = None
                removed = True
            elif conn in self._observers:
                self._observers.remove(conn)
                removed = True
            self._set_flags_locked()
            remaining = len(self._observers) + (
                1 if self._conn is not None else 0
            )
        if removed:  # idempotent under the detach/close double-call
            _METRICS.detaches.inc()
            remove_lag_gauge(conn)
            self.freshness.forget(conn.token)
            _forget_peer_usage(conn)
            tracing.event("server.detach", "lifecycle", role=conn.role,
                          token=conn.token)
            flight.note("server.detach", role=conn.role, token=conn.token)
        _METRICS.peers.set(remaining)

    def _detach(self, conn: _Conn) -> None:
        self._release(conn)
        conn.close()

    def _set_flags_locked(self) -> None:
        """Engine flag refresh — call with _conn_lock held: per-turn
        events flow while ANY connection is attached, flips while any
        attached connection wants them."""
        conns = list(self._observers)
        if self._conn is not None:
            conns.append(self._conn)
        self.engine.emit_flips = any(c.want_flips for c in conns)
        self.engine.emit_turns = bool(conns)
        self.engine.emit_flip_chunks = any(c.batch for c in conns)
        self.engine.batch_turns_hint = max(
            (c.batch for c in conns), default=0
        )

    def _all_conns(self) -> "list[_Conn]":
        with self._conn_lock:
            conns = list(self._observers)
            if self._conn is not None:
                conns.append(self._conn)
        return conns

    def _refresh_flips(self) -> None:
        """Re-derive engine.emit_flips/emit_turns from the currently
        attached connections, atomically against attach/detach — the
        single writer discipline that keeps broadcaster-side corrections
        from racing a concurrent _detach or a fresh attach."""
        with self._conn_lock:
            self._set_flags_locked()

    # --- controller → engine ---

    def _reader_loop(self, conn: _Conn) -> None:
        while True:
            try:
                # Controllers only ever send JSON control messages.
                msg = wire.recv_msg(conn.sock, allow_binary=False)
            except TimeoutError:
                # Idle expiry at a frame boundary (wire.recv_msg): not
                # a failure — the heartbeat thread owns the eviction
                # verdict; this loop just wakes at the deadline cadence
                # instead of blocking unboundedly.
                if conn._dead.is_set():
                    self._detach(conn)
                    return
                continue
            except (wire.WireError, OSError):
                msg = None
            if msg is None:  # controller went away (crash or close)
                self._detach(conn)
                return
            # ANY inbound byte proves the peer alive — heartbeat pongs
            # exist precisely to generate this refresh on idle links.
            conn.last_rx = time.monotonic()
            conn.hb_unanswered = 0
            if msg.get("t") == "clk":
                # Clock probe: echo the peer's t0 with our wall clock,
                # immediately and queue-free (send_direct) — the reply
                # delay IS the measurement error. The probe is
                # observer-safe: it steers nothing.
                with contextlib.suppress(wire.WireError, OSError):
                    conn.send_direct({"t": "clk", "t0": msg.get("t0"),
                                      "ts": time.time()})
                continue
            if msg.get("t") != "key":
                continue
            key = msg.get("key")
            if conn.role == "observe" and key != "q":
                # Observers are read-only: steering verbs are rejected
                # (the driver slot exists precisely to arbitrate them);
                # 'q' below only detaches the observer itself.
                with contextlib.suppress(Exception):
                    conn.send({"t": "error", "reason": "observer"})
                continue
            if key in ("p", "s"):
                self._keys.put(key)
            elif key == "q":
                # Detach only — the engine keeps evolving
                # (ref: README.md:182). The slot is freed BEFORE the
                # ack: a controller that reattaches the moment
                # `detach()` returns must never bounce off its own
                # stale registration ("busy" race, seen under load).
                self._release(conn)
                with contextlib.suppress(Exception):
                    conn.send({"t": "detached"})
                conn.finish()
                conn.close()
                return
            elif key == "k":
                # Global shutdown with a final snapshot (ref: README.md:183).
                self._keys.put("k")
                return  # broadcaster sends the tail + bye, then shutdown

    # --- liveness (docs/RESILIENCE.md) ---

    #: Beacons that must go unanswered (on top of the evict_secs
    #: silence) before a peer is evicted — eviction requires PROBED
    #: silence, so a peer that is merely quiet behind a busy outbound
    #: stream (no idle gap → no beacons sent) is never judged by a
    #: clock nothing refreshed.
    HB_MISS_LIMIT = 3

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, self.heartbeat_secs / 2.0)
        while not self._shutdown.wait(interval):
            now = time.monotonic()
            turn = self.engine.completed_turns
            conns = self._all_conns()
            # Freshness sweep off the liveness cadence: a degraded or
            # idle peer's turn age keeps moving even when the
            # broadcaster has nothing to fan out.
            self.freshness.sample((c, None) for c in conns)
            # Accounting sweep on the same cadence: a peer's writer
            # backlog occupies event-queue memory whether or not the
            # broadcaster is emitting — queued frames × sweep interval
            # is the frame-seconds each principal held.
            _meter = accounting.meter()
            if _meter is not None:
                for c in conns:
                    q = c.queued()
                    if q:
                        _meter.charge(c.principal,
                                      queue_frame_seconds=q * interval)
            for conn in conns:
                if not conn.writer_started:
                    # Mid-handshake: the attach-ack (which carries the
                    # hb cadence and must be the peer's FIRST message)
                    # is sent before start_writer — never overtake it.
                    continue
                if conn.degraded:
                    # The degradation plane owns a degraded peer's
                    # verdict: no beacons into a backlogged queue, and
                    # no hb-eviction racing the drain deadline (a
                    # stalled reader can't answer beacons precisely
                    # while it is the peer degradation exists to keep
                    # alive). Drained → coalescing resync (also checked
                    # per turn by the broadcaster; this covers paused/
                    # idle engines); wedged past drain_secs → the one
                    # overflow-eviction left.
                    if conn.drained():
                        conn.resync_pending = True
                        self.engine.request_board_sync(
                            enable_flips=conn.want_flips,
                            token=conn.token,
                        )
                    elif (now - conn.degraded_since > conn.drain_secs
                          and conn.queued() > conn.LOW_WATER):
                        log.warning(
                            "evicting peer %d: wedged %.1fs past the "
                            "drain deadline (%d frames queued)",
                            conn.token, now - conn.degraded_since,
                            conn.queued(),
                        )
                        if conn.count_overflow():
                            _METRICS.overflows.inc()
                            flight.note("server.drain_evict",
                                        token=conn.token)
                        self._detach(conn)
                    continue
                if (conn.hb and conn.hb_unanswered >= self.HB_MISS_LIMIT
                        and now - conn.last_rx > self.evict_secs):
                    log.warning(
                        "evicting unresponsive peer (silent %.1fs, %d "
                        "beacons unanswered)", now - conn.last_rx,
                        conn.hb_unanswered,
                    )
                    _METRICS.evicted.inc()
                    tracing.event("server.evict", "lifecycle",
                                  role=conn.role, token=conn.token,
                                  silent_s=round(now - conn.last_rx, 3))
                    flight.note("server.evict", role=conn.role,
                                token=conn.token,
                                silent_s=round(now - conn.last_rx, 3))
                    self._detach(conn)
                    # An eviction is the black-box moment for the peer
                    # that just vanished: snapshot the recent history
                    # (crash-atomic, no-op without a configured dir) so
                    # the post-mortem exists even if whatever killed
                    # the peer takes this process down next.
                    flight.dump("peer-eviction")
                    # An eviction is instability evidence: nudge an
                    # immediate checkpoint (engine 's' verb, async +
                    # crash-atomic) so a restart after whatever killed
                    # the peer loses at most the heartbeat deadline,
                    # not a full autosave interval.
                    if (self.params.autosave_turns > 0
                            or self.params.autosave_seconds > 0):
                        self._keys.put("s")
                    continue
                if now - conn.last_tx >= self.heartbeat_secs:
                    try:
                        if conn.binary:
                            conn.send_raw(wire.heartbeat_to_frame(turn))
                        else:
                            conn.send({"t": "hb", "turn": turn})
                    except (wire.WireError, OSError):
                        self._detach(conn)
                        continue
                    _METRICS.heartbeats.inc()
                    if conn.hb:
                        conn.hb_unanswered += 1

    # --- engine → controller ---

    def _delta_words(self, flips):
        """The peer-INDEPENDENT half of the delta-of-sparse encode —
        one (bitmap, words) build per flushed turn, shared by every
        delta peer (only the XOR against each peer's chain state and
        the zlib are per-connection; re-encoding per observer would be
        redundant hot-path CPU in the single broadcaster thread)."""
        return wire.coords_to_words(
            flips, self.params.image_width, self.params.image_height
        )

    def _send_flips(self, conn: _Conn, turn: int, flips,
                    flips_levels, delta_words=None) -> None:
        """One turn's batched flips in this connection's negotiated
        encoding (binary frame / compact JSON / legacy pairs; levels
        ride only to peers that advertised the capability).
        `delta_words` is the shared per-turn (bitmap, words) pair for
        delta peers (see _delta_words)."""
        m = accounting.meter()
        t0 = time.perf_counter() if m is not None else 0.0
        with tracing.span("wire.encode_flips", "wire", turn=turn):
            _encode_and_send_flips(
                conn, turn, flips, flips_levels,
                self.params.image_width, self.params.image_height,
                delta_words,
            )
        if m is not None:
            # Host encode tax at the wire.encode span boundary — attributed
            # to the peer whose negotiated encoding we just paid for.
            m.charge(conn.principal,
                     host_seconds=time.perf_counter() - t0)

    def _send_stream_event(self, conn: _Conn, ev) -> None:
        """One post-sync event in this connection's encoding.

        TurnComplete messages carry a `ts` wall-clock stamp taken at
        enqueue: the client measures emit→apply lag against it — the
        first END-TO-END (cross-process) latency signal the system has
        (gol_tpu_client_turn_latency_seconds). Peers that predate the
        field ignore it (unknown JSON keys pass through); clocks are
        shared on a same-host pair and NTP-close across hosts — skew
        bounds are documented in docs/OBSERVABILITY.md."""
        if conn.binary and isinstance(ev, FinalTurnComplete):
            conn.send_raw(wire.final_to_frame(ev.completed_turns, ev.alive))
        else:
            msg = wire.event_to_msg(ev)
            if isinstance(ev, TurnComplete):
                msg["ts"] = time.time()
            conn.send(msg)

    def _broadcast_chunk(self, ev: FlipChunk, conns) -> None:
        """Fan one k-turn FlipChunk out: batch peers get ONE encoded
        frame (shared per distinct negotiated max-k — encode runs
        once, before any per-peer state moves), per-turn peers get the
        expanded flips/TurnComplete stream they always got (expansion
        also computed at most once per chunk). The per-turn
        housekeeping the TurnComplete branch used to do — lag gauges,
        drain-resync checks, the wire-correlation mark — runs per
        chunk here; shedding (offer_stream) gates whole batches."""
        k = len(ev.counts)
        last = ev.completed_turns
        _METRICS.chunks.inc()
        self.freshness.note_commit(last)
        depth = 0
        for c in conns:
            q = c.queued()
            depth = max(depth, q)
            if c.lag_metric is not None:
                c.lag_metric.set(q)
            if c.drained():
                c.resync_pending = True
                self.engine.request_board_sync(
                    enable_flips=c.want_flips, token=c.token
                )
        _METRICS.queue_depth.set(depth)
        self.freshness.sample((c, None) for c in conns)
        tracing.event("turn.emit", "wire", turn=last, batch=k)
        ts = time.time()
        enc: dict = {}
        expanded = None
        for conn in conns:
            if not conn.synced or last <= conn.synced_turn:
                continue
            try:
                if not conn.offer_stream():
                    continue
                if conn.batch and conn.want_flips:
                    frames = enc.get(conn.batch)
                    if frames is None:
                        with tracing.span("wire.encode_batch", "wire",
                                          turn=last, turns=k):
                            frames = encode_batch_frames(
                                ev.counts, ev.bitmaps, ev.words,
                                ev.first_turn, self.params.image_width,
                                self.params.image_height, conn.batch,
                                ts,
                            )
                        enc[conn.batch] = frames
                    for f in frames:
                        conn.send_raw(f)
                else:
                    if expanded is None:
                        expanded = self._expand_chunk(ev)
                    self._send_chunk_expanded(conn, ev, expanded, ts)
                conn.note_written(last)
            except (wire.WireError, OSError):
                self._detach(conn)

    def _expand_chunk(self, ev: FlipChunk):
        """Per-turn (coords, bitmap, words) triples of one chunk, for
        peers still on per-turn frames — None entries for flip-less
        turns. Built once per chunk, shared across such peers."""
        W, H = self.params.image_width, self.params.image_height
        counts = np.asarray(ev.counts, np.int64)
        offs = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        out = []
        for t in range(len(counts)):
            if not counts[t]:
                out.append(None)
                continue
            words = ev.words[offs[t]:offs[t + 1]]
            bm = np.asarray(ev.bitmaps[t], np.uint32)
            out.append((wire.words_to_coords(bm, words, W, H), bm, words))
        return out

    def _send_chunk_expanded(self, conn: _Conn, ev: FlipChunk,
                             expanded, ts: float) -> None:
        """One chunk to one per-turn peer: exactly the flips-then-
        TurnComplete stream the per-turn emit path produced, turn by
        turn (synced_turn still gates per turn — a chunk may straddle
        this peer's sync)."""
        W, H = self.params.image_width, self.params.image_height
        for t, entry in enumerate(expanded):
            turn = ev.first_turn + t
            if turn <= conn.synced_turn:
                continue
            if entry is not None and conn.want_flips:
                coords, bm, words = entry
                with tracing.span("wire.encode_flips", "wire",
                                  turn=turn):
                    _encode_and_send_flips(conn, turn, coords, None,
                                           W, H, (bm, words))
            conn.send({"t": "ev", "k": "turn", "turn": turn, "ts": ts})

    def _broadcast_loop(self) -> None:
        """Single consumer of the engine's event stream, fanning out to
        the driver and every observer (multi-observer serving); each
        turn's flips become one wire message per interested connection
        — from a FlipBatch array directly (the engine's vectorized
        form) or by batching a CellFlipped burst (engines injected with
        the per-cell contract)."""
        # Opt-in stream monitor (gol_tpu_torch.analysis.invariants): asserts
        # the orderings this loop RELIES on — FlipBatch/TurnComplete
        # adjacency, no flips straddling a BoardSync, monotone turns —
        # so an engine emission change breaks a test instead of
        # XOR-corrupting an attached peer.
        from gol_tpu_torch.analysis.invariants import (
            EventStreamChecker,
            invariants_enabled,
        )

        checker = (EventStreamChecker("server-broadcast")
                   if invariants_enabled() else None)
        try:
            self._broadcast_events(checker)
        except Exception:
            # A violated invariant (or any broadcaster bug) must not
            # leave a zombie server: full teardown, then let the
            # exception surface in the thread log.
            self.shutdown()
            raise
        # Engine stream closed: the run is over (final turn, 'k', or stop).
        self._drain_conns()
        self.shutdown(stop_engine=False)

    def _broadcast_events(self, checker) -> None:
        flips: "list | object" = []
        flips_levels = None  # (N,) gray levels of a multi-state batch
        flips_turn = 0
        for ev in self.engine.events:
            if checker is not None:
                checker.observe(ev)
            _METRICS.events.inc()
            conns = self._all_conns()
            if isinstance(ev, FlipBatch):
                if len(ev.cells) and any(c.want_flips for c in conns):
                    flips_turn = ev.completed_turns
                    flips = ev.cells
                    flips_levels = getattr(ev, "levels", None)
                continue
            if isinstance(ev, CellFlipped):
                if any(c.want_flips for c in conns):
                    flips_turn = ev.completed_turns
                    if not isinstance(flips, list):
                        # Mixed batch/per-cell stream: the stale batch
                        # AND its levels both reset (a leftover levels
                        # array would fail the flush's length check).
                        flips = []
                        flips_levels = None
                    flips.append([ev.cell.x, ev.cell.y])
                continue
            if isinstance(ev, FlipChunk):
                # The chunk-granular stream (batching watchers
                # attached): k turns in one event — ONE wire frame per
                # batch peer, per-turn expansion only for peers that
                # still consume per-turn frames.
                if conns:
                    self._broadcast_chunk(ev, conns)
                continue
            if not conns:
                flips = []
                flips_levels = None
                if isinstance(ev, BoardSync):
                    # Sync requested by a connection that vanished: drop
                    # the stale enable_flips so a watcher-less engine
                    # pays zero diff tax (re-derived under the lock — a
                    # new connection may have just attached).
                    self._refresh_flips()
                continue
            if isinstance(ev, BoardSync):
                target = next(
                    (c for c in conns if c.token == ev.token), None
                )
                if target is None:
                    # Sync for a connection that vanished before it was
                    # serviced; re-derive the subscription from the
                    # CURRENT connections (by want_flips alone — their
                    # own syncs may still be queued behind this one).
                    self._refresh_flips()
                    continue
                try:
                    if target.binary:
                        target.send_raw(wire.board_to_frame(
                            ev.completed_turns, ev.world, ev.token
                        ))
                    else:
                        target.send(wire.board_to_msg(
                            ev.completed_turns, ev.world, ev.token
                        ))
                    target.synced = True
                    # The synced board already contains every flip up
                    # to its turn: record it so a flush of flips
                    # buffered BEFORE this sync skips this peer (other
                    # peers are still owed them). Today the engine
                    # never emits a BoardSync between a FlipBatch and
                    # its TurnComplete — the checker above asserts that
                    # — but the broadcaster no longer depends on it.
                    target.synced_turn = ev.completed_turns
                    # A synced raster is the freshest possible write:
                    # everything up to its turn is inside it.
                    target.note_written(ev.completed_turns)
                    # The synced raster restarts the delta-of-sparse
                    # chain: the client resets its own prev bitmap on
                    # the board message, so the next flips frame must
                    # carry the full bitmap again.
                    target.delta_prev = None
                    # If this sync was the degradation plane's
                    # coalescing resync, the peer's stream is whole
                    # again: everything it shed is inside this raster.
                    target.mark_recovered()
                except (wire.WireError, OSError):
                    self._detach(target)
                continue
            flush = len(flips) and isinstance(ev, TurnComplete)
            if isinstance(ev, TurnComplete):
                # Backpressure visibility: per-peer lag gauges plus the
                # deepest writer queue (one qsize sweep per turn, not
                # per frame — a lagging peer shows up here long before
                # any eviction), and the drain check that turns a
                # recovered slow consumer's backlog into ONE coalesced
                # BoardSync at the engine's next dispatch boundary.
                depth = 0
                for c in conns:
                    q = c.queued()
                    depth = max(depth, q)
                    if c.lag_metric is not None:
                        c.lag_metric.set(q)
                    if c.drained():
                        c.resync_pending = True
                        self.engine.request_board_sync(
                            enable_flips=c.want_flips, token=c.token
                        )
                _METRICS.queue_depth.set(depth)
                self.freshness.note_commit(ev.completed_turns)
                self.freshness.sample((c, None) for c in conns)
                # The SERVER half of the per-turn wire correlation: one
                # instant mark per broadcast turn, carrying the turn
                # number — `report merge` pairs it with the client's
                # `turn.apply` on the offset-corrected timebase.
                tracing.event("turn.emit", "wire",
                              turn=ev.completed_turns)
            delta_words = None
            if flush and flips_levels is None and any(
                    c.delta and c.synced and c.want_flips
                    and flips_turn > c.synced_turn for c in conns):
                # One shared encode per flushed turn for every delta
                # peer (the XOR/zlib stay per-connection).
                delta_words = self._delta_words(flips)
            for conn in conns:
                if not conn.synced:
                    continue  # pre-sync events are not this peer's
                try:
                    # The per-turn stream plane is SHEDDABLE: a peer
                    # past its high-water mark silently misses flips
                    # and turn events here and is made whole by the
                    # coalescing BoardSync once its queue drains.
                    # FinalTurnComplete is the run's result — once per
                    # run, control-plane, never shed. The gate runs
                    # BEFORE any encode, so a shed frame never
                    # advances this peer's delta chain.
                    if not isinstance(ev, FinalTurnComplete) \
                            and not conn.offer_stream():
                        continue
                    if flush and conn.want_flips \
                            and flips_turn > conn.synced_turn:
                        self._send_flips(conn, flips_turn, flips,
                                         flips_levels, delta_words)
                    self._send_stream_event(conn, ev)
                    if isinstance(ev, (TurnComplete, FinalTurnComplete)):
                        conn.note_written(ev.completed_turns)
                except (wire.WireError, OSError):
                    self._detach(conn)
            if flush:
                flips = []
                flips_levels = None


def encode_batch_frames(counts, bitmaps, words, first_turn: int,
                        width: int, height: int, bsize: int,
                        ts: float) -> "list[bytes]":
    """One chunk's _TAG_FBATCH frames for a peer whose negotiated
    max-k is `bsize`: the chunk splits into ceil(k/bsize) independent
    frames (each self-contained — `wire.chunk_deltas` re-bases the
    turn-axis delta at every segment start). Shared by the singleton
    broadcaster and the per-session sinks; observes the per-frame
    batch-size histogram."""
    total, nb = wire.grid_words(width, height)
    _METRICS.chunk_encodes.inc()
    k = len(counts)
    frames = []
    for a in range(0, k, bsize):
        b = min(a + bsize, k)
        dc, dbm, dw = wire.chunk_deltas(counts, bitmaps, words,
                                        a, b, total)
        frames.append(wire.flip_batch_to_frame(
            first_turn + a, nb, dc, dbm, dw, ts
        ))
        _METRICS.batch_turns.observe(b - a)
    return frames


class _SessionSink:
    """gol_tpu_torch.sessions.Sink feeding one attached connection: board
    syncs, per-turn flips in the connection's negotiated encoding, and
    ts-stamped TurnComplete messages — the per-session twin of the
    singleton broadcaster. Callbacks run on the SessionEngine thread
    and only ever ENQUEUE to the connection's writer (never block);
    a dead peer raises out of the callback, which detaches this sink
    from the manager, and the server drops the connection."""

    def __init__(self, server: "SessionServer", conn: _Conn, sid: str,
                 width: int, height: int):
        self._server = server
        self._conn = conn
        self.sid = sid
        self._width = width
        self._height = height

    @property
    def want_flips(self) -> bool:
        return self._conn.want_flips

    @property
    def batch_turns(self) -> int:
        """Negotiated k-turn chunk consumption (hello "batch"): a
        positive value makes the manager hand this sink whole chunks
        via on_flip_chunk and scale the bucket's dispatch chunk."""
        return self._conn.batch if self._conn.want_flips else 0

    def on_flip_chunk(self, sid: str, first_turn: int, counts,
                      bitmaps, words) -> None:
        """One dispatched chunk for this session as _TAG_FBATCH
        frame(s) — the per-session twin of the singleton broadcaster's
        chunk fan-out: per-chunk housekeeping, shedding at batch
        granularity, encode gated after offer_stream. Stream sends run
        under the peer's seek_gate: a peer parked at a seek position
        (conn.scrub — gol_tpu_torch.replay) is withheld the live stream, and
        the gate orders that decision against a concurrent seek's
        historical frames."""
        conn = self._conn
        if conn.lag_metric is not None:
            conn.lag_metric.set(conn.queued())
        k = len(counts)
        last = first_turn + k - 1
        self._server.freshness.note_commit(last, key=sid)
        with conn.seek_gate:
            if conn.scrub:
                return
            if conn.drained():
                conn.resync_pending = True
                mgr = self._server.manager
                self.on_sync(sid, mgr.peek_turn(sid),
                             mgr._fetch_board(sid))
                return
            if not conn.synced or last <= conn.synced_turn:
                return
            try:
                if not conn.offer_stream():
                    return
                tracing.event("turn.emit", "wire", turn=last,
                              session=sid, batch=k)
                m = accounting.meter()
                t0 = time.perf_counter() if m is not None else 0.0
                with tracing.span("wire.encode_batch", "wire", turn=last,
                                  session=sid, turns=k):
                    frames = encode_batch_frames(
                        counts, bitmaps, words, first_turn,
                        self._width, self._height, conn.batch,
                        time.time(),
                    )
                if m is not None:
                    # Host encode tax, attributed to the session this
                    # sink serves (conn.principal == sid here).
                    m.charge(conn.principal,
                             host_seconds=time.perf_counter() - t0)
                for f in frames:
                    conn.send_raw(f)
                conn.note_written(last)
            except (wire.WireError, OSError):
                self._server._drop_conn(conn, detach_sink=False)
                raise

    def on_sync(self, sid: str, turn: int, board) -> None:
        conn = self._conn
        with conn.seek_gate:
            if conn.scrub:
                return  # parked at a seek: no live resyncs either
            try:
                if conn.binary:
                    conn.send_raw(
                        wire.board_to_frame(turn, board, conn.token)
                    )
                else:
                    conn.send(wire.board_to_msg(turn, board, conn.token))
            except (wire.WireError, OSError):
                self._server._drop_conn(conn, detach_sink=False)
                raise
            conn.synced = True
            conn.synced_turn = turn
            conn.note_written(turn)
            conn.delta_prev = None
            # A degradation-coalesced resync makes the peer whole:
            # every frame it shed is inside this raster, and
            # synced_turn now gates anything still buffered.
            conn.mark_recovered()

    def on_flips(self, sid: str, turn: int, coords) -> None:
        conn = self._conn
        with conn.seek_gate:
            if conn.scrub:
                return
            if not conn.synced or turn <= conn.synced_turn:
                return
            try:
                # Sheddable stream plane: gate BEFORE encoding so a
                # shed frame never advances this peer's delta chain.
                if not conn.offer_stream():
                    return
                m = accounting.meter()
                t0 = time.perf_counter() if m is not None else 0.0
                with tracing.span("wire.encode_flips", "wire", turn=turn,
                                  session=sid):
                    _encode_and_send_flips(conn, turn, coords, None,
                                           self._width, self._height)
                if m is not None:
                    m.charge(conn.principal,
                             host_seconds=time.perf_counter() - t0)
            except (wire.WireError, OSError):
                self._server._drop_conn(conn, detach_sink=False)
                raise

    def on_turn(self, sid: str, turn: int) -> None:
        conn = self._conn
        if conn.lag_metric is not None:
            conn.lag_metric.set(conn.queued())
        self._server.freshness.note_commit(turn, key=sid)
        with conn.seek_gate:
            if conn.scrub:
                return
            if conn.drained():
                # Degraded peer drained inside the deadline: coalesce
                # the missed backlog into ONE fresh BoardSync. We are
                # on the engine thread (the device owner), after this
                # chunk's commit — the stack and `peek_turn` agree,
                # and stamping the sync with the POST-chunk turn gates
                # off the rest of this chunk's already-decoded
                # callbacks (they are inside the raster being sent;
                # re-applying would XOR-corrupt).
                conn.resync_pending = True
                mgr = self._server.manager
                self.on_sync(sid, mgr.peek_turn(sid),
                             mgr._fetch_board(sid))
                return
            if not conn.synced or turn <= conn.synced_turn:
                return
            try:
                if not conn.offer_stream():
                    return
                tracing.event("turn.emit", "wire", turn=turn, session=sid)
                conn.send({"t": "ev", "k": "turn", "turn": turn,
                           "ts": time.time()})
                conn.note_written(turn)
            except (wire.WireError, OSError):
                self._server._drop_conn(conn, detach_sink=False)
                raise

    def on_close(self, sid: str, reason: str) -> None:
        conn = self._conn
        with contextlib.suppress(Exception):
            conn.send({"t": "bye"})
        # Drain (bounded) BEFORE closing the socket: the bye must reach
        # the peer so a destroy-while-attached ends its stream cleanly
        # instead of looking like a crashed server and triggering the
        # client's reconnect storm against a session that is gone.
        conn.finish(timeout=2.0)
        self._server._drop_conn(conn, detach_sink=False)


class _SeekTarget:
    """Session-plane adapter for gol_tpu_torch.replay.serve_seek: the
    recording's log dir, the peer's own seek_gate as the ordering
    lock (historical frames vs the live sink's sends), and the
    engine-thread live rejoin."""

    def __init__(self, server: "SessionServer", sid: str,
                 sink: _SessionSink, conn: _Conn, root: str):
        self._server = server
        self.sid = sid
        self._sink = sink
        self._conn = conn
        self.root = root
        self.lock = conn.seek_gate

    def resync_live(self, conn: _Conn) -> None:
        def _prepare():
            with conn.seek_gate:
                conn.scrub = False

        # Engine-thread verb: scrub clears and the fresh BoardSync
        # lands between dispatches, so the next chunk is contiguous
        # with the synced raster.
        self._server.manager.resync(self.sid, self._sink,
                                    prepare=_prepare)


class SessionServer:
    """The multi-tenant serving surface (gol_tpu_torch.sessions; CLI
    `--serve --sessions`): a SessionManager + SessionEngine behind the
    same wire protocol as EngineServer, with the one-board singleton
    replaced by session multiplexing —

    - hello gains a `session` field: peers attach to a NAMED session
      (driver slot exclusive per session, observers fan out); a hello
      without one is a CONTROL peer that only speaks session verbs;
    - `{"t":"session","op":...}` verbs (create / destroy / list /
      checkpoint) from any authenticated peer, answered with
      `{"t":"session-r", ...}`;
    - per-session checkpoints under out/sessions/<id>/ compose with
      `--resume latest` (resume=True restores every session);
    - heartbeats/eviction, the clock probe, binary/delta flip frames
      and the shared-secret gate work exactly as on EngineServer —
      the peer-side protocol is unchanged above the hello.

    `device` is the buckets' device: None for the CUDA card (the
    constructor raises without one, leaving no thread), "cpu" for the
    plain versions."""

    HELLO_TIMEOUT = EngineServer.HELLO_TIMEOUT
    DRAIN_TIMEOUT = EngineServer.DRAIN_TIMEOUT
    HB_MISS_LIMIT = EngineServer.HB_MISS_LIMIT

    def __init__(
        self,
        params: Params,
        host: str = "127.0.0.1",
        port: int = 8030,
        *,
        secret: Optional[str] = None,
        heartbeat_secs: float = 2.0,
        evict_secs: Optional[float] = None,
        resume: bool = False,
        bucket_capacity: int = 16,
        watched_chunk: Optional[int] = None,
        idle_chunk: Optional[int] = None,
        max_peers: Optional[int] = None,
        max_sessions: Optional[int] = None,
        high_water: Optional[int] = None,
        drain_secs: Optional[float] = None,
        retry_after_secs: float = 1.0,
        batch_turns: int = 1024,
        writer_pool_threads: int = 2,
        park_idle_secs: Optional[float] = None,
        record: bool = False,
        keyframe_turns: int = 256,
        record_max_bytes: Optional[int] = None,
        device=None,
    ):
        from gol_tpu_torch.sessions import SessionEngine, SessionManager

        self.params = params
        self.batch_turns = max(0, batch_turns)
        self.heartbeat_secs = max(0.0, heartbeat_secs)
        self.evict_secs = (
            evict_secs if evict_secs is not None
            else 3.0 * self.heartbeat_secs
        )
        self._secret = secret
        #: Admission budgets + rejection hint — the EngineServer
        #: contract (docs/RESILIENCE.md "Overload & degradation"),
        #: plus a session-count budget the manager enforces at create.
        self.max_peers = max_peers
        self.high_water = high_water
        self.drain_secs = drain_secs
        self.retry_after_secs = max(0.0, retry_after_secs)
        self.manager = SessionManager(
            out_dir=params.out_dir,
            default_rule=params.rule,
            bucket_capacity=bucket_capacity,
            autosave_turns=params.autosave_turns,
            max_sessions=max_sessions,
            park_idle_secs=park_idle_secs,
            device=device,
        )
        #: Idempotency replay window (docs/SESSIONS.md "Idempotent
        #: verbs"): request-id -> the successful session-r reply it
        #: produced, bounded FIFO. A retried verb whose first attempt
        #: DID land (the reply was lost to a reconnect) replays the
        #: recorded answer instead of re-executing — a retried create
        #: never double-creates, a retried destroy never errors.
        self._replay: "dict[str, dict]" = {}  # insertion-ordered FIFO
        self._replay_lock = lockcheck.make_lock("SessionServer._replay_lock")
        #: Replay-plane recording (gol_tpu_torch.replay, docs/REPLAY.md):
        #: with `record`, every live session gets an ephemeral
        #: RecorderSink taping its encoded wire stream into
        #: out/sessions/<sid>/replay/, and the `seek` verb serves
        #: time-travel from those logs.
        self.record = bool(record)
        self.keyframe_turns = max(1, int(keyframe_turns))
        self.record_max_bytes = record_max_bytes
        self._recorders: "dict[str, object]" = {}
        self._recorder_lock = lockcheck.make_lock(
            "SessionServer._recorder_lock")
        if self.record:
            # Recording state rides the session.json sidecar (the
            # checkpoint crash-consistency story covers it), and the
            # recorder factory makes EVERY create — wire verb, resume,
            # rehydration — tape from its first turn (a resumed
            # session's fresh keyframe also CUTS any stale future
            # segments a dead incarnation recorded past its last
            # checkpoint: SegmentLog.start_segment). Import the plane
            # now so the first create doesn't pay module-import
            # latency inside an engine verb.
            import gol_tpu_torch.replay.recorder  # noqa: F401

            self.manager.record_meta = {
                "keyframe_turns": self.keyframe_turns,
            }
            self.manager.recorder_factory = self._make_recorder
        #: Sessions restored from out/sessions/ at boot (
        #: `--resume latest`, composed per session).
        self.resumed = self.manager.resume_all() if resume else 0
        self.engine = SessionEngine(self.manager,
                                    watched_chunk=watched_chunk,
                                    idle_chunk=idle_chunk)
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        publish_listen_addr(self.address)
        #: The same writer event loop EngineServer rides: session peers'
        #: frames drain through a few selector threads, not one thread
        #: per connection. Built after the manager (which raises
        #: without a card) and the listener, so a constructor that
        #: raises leaves no thread.
        self.pool = (WriterPool(writer_pool_threads, "gol-sess-writer")
                     if writer_pool_threads > 0 else None)
        #: Freshness plane: per-peer turn age against each SESSION's
        #: own committed turn (clocks keyed by sid — one stalled
        #: session can never age another session's watchers).
        self.freshness = ServerFreshness("session")
        self._conn_lock = lockcheck.make_lock("SessionServer._conn_lock")
        self._conns: "list[_Conn]" = []
        #: sid -> driving connection (one driver per session).
        self._drivers: "dict[str, _Conn]" = {}
        #: conn -> (sid, sink) for session-attached peers.
        self._sinks: "dict[_Conn, tuple[str, _SessionSink]]" = {}
        self._shutdown = threading.Event()
        self.done = threading.Event()
        self._threads: "list[threading.Thread]" = []
        #: Drain verb (control plane): once set, every live
        #: session has a fresh checkpoint on disk and NEW session
        #: attaches are refused — the safe prelude to a rolling
        #: restart with `--resume latest`. Plain bool, GIL-atomic:
        #: read on the accept path, written by the verb.
        self.draining = False

    # --- lifecycle ---

    def start(self) -> "SessionServer":
        self.engine.start()
        loops = [(self._accept_loop, "gol-sess-accept")]
        if self.heartbeat_secs > 0:
            loops.append((self._heartbeat_loop, "gol-sess-heartbeat"))
        for fn, name in loops:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        if self._shutdown.is_set():
            self.done.wait(timeout=1.0)
            return
        self._shutdown.set()
        with contextlib.suppress(OSError):
            # SHUT_RDWR first: on Linux, close() alone does NOT wake a
            # thread parked in accept() — the zombie accept holds the
            # LISTEN socket alive and the port stays bound, so an
            # in-process restart on the same address gets EADDRINUSE.
            self._listener.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._listener.close()
        # Close sinks through the manager first (each attached peer
        # gets its bye in-stream), then stop the dispatch loop.
        with contextlib.suppress(Exception):
            self.manager.close()
        self.engine.stop()
        self.engine.join(timeout=30)
        with self._conn_lock:
            conns, self._conns = list(self._conns), []
            self._drivers.clear()
            self._sinks.clear()
        for conn in conns:
            with contextlib.suppress(Exception):
                conn.send({"t": "bye"})
            conn.request_finish()
        deadline = time.monotonic() + self.DRAIN_TIMEOUT
        for conn in conns:
            conn.join_writer(max(0.1, deadline - time.monotonic()))
            conn.close()
        if self.pool is not None:
            self.pool.close()
        self.freshness.close()
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def health(self) -> dict:
        info = self.engine.health()
        with self._conn_lock:
            info["peers"] = len(self._conns)
        info["address"] = list(self.address)
        if self.draining:
            info["draining"] = True
        if self._shutdown.is_set() and info.get("status") == "ok":
            info["status"] = "shutting-down"
        return info

    # --- accept path ---

    def _accept_loop(self) -> None:
        from gol_tpu_torch.testing import faults

        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            sock = faults.wrap("server", sock)
            _METRICS.accepts.inc()
            try:
                sock.settimeout(self.HELLO_TIMEOUT)
                hello = wire.recv_msg(sock, allow_binary=False)
                if not hello or hello.get("t") != "hello":
                    raise wire.WireError(f"bad hello: {hello!r}")
            except (wire.WireError, OSError, ValueError) as e:
                log.warning("rejecting connection from %s: %s", addr, e)
                _METRICS.rejects["bad-hello"].inc()
                sock.close()
                continue
            if self._secret is not None and not hmac.compare_digest(
                str(hello.get("secret", "")).encode("utf-8", "replace"),
                self._secret.encode("utf-8", "replace"),
            ):
                log.warning("rejecting unauthenticated attach from %s",
                            addr)
                _METRICS.rejects["unauthorized"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(
                        sock, {"t": "error", "reason": "unauthorized"}
                    )
                sock.close()
                continue
            self._admit(sock, hello)

    def _admit(self, sock: socket.socket, hello: dict) -> None:
        from gol_tpu_torch.sessions import SessionError, valid_session_id

        if (self.max_peers is not None
                and len(self._conns) >= self.max_peers):
            # Admission control (docs/RESILIENCE.md): a full house
            # sheds the attach at the door with a when-to-come-back
            # hint the client backoff honors.
            _METRICS.rejects["at-capacity"].inc()
            with contextlib.suppress(Exception):
                wire.send_msg(sock, {
                    "t": "error", "reason": "at-capacity",
                    "retry_after": self.retry_after_secs,
                })
            sock.close()
            return
        role = ("observe" if hello.get("role") == "observe" else "drive")
        sid = hello.get("session")
        if sid is not None and self.draining:
            # A drained server is about to restart (control plane
            # roll): session attaches bounce with a come-back hint —
            # the client backoff rides the restart gap and resumes
            # through BoardSync on the fresh incarnation. Bare control
            # connections stay admitted (operators still list/verb).
            _METRICS.rejects["draining"].inc()
            with contextlib.suppress(Exception):
                wire.send_msg(sock, {
                    "t": "error", "reason": "draining",
                    "retry_after": self.retry_after_secs,
                })
            sock.close()
            return
        if sid is not None and (
            not valid_session_id(sid) or not self.manager.known(sid)
        ):
            with contextlib.suppress(Exception):
                wire.send_msg(
                    sock, {"t": "error", "reason": "unknown-session"}
                )
            sock.close()
            return
        hb = bool(hello.get("hb", False)) and self.heartbeat_secs > 0
        conn = _Conn(sock, bool(hello.get("want_flips", False)),
                     compact=bool(hello.get("compact", False)),
                     binary=bool(hello.get("binary", False)),
                     levels=bool(hello.get("levels", False)),
                     role=role, hb=hb,
                     delta=bool(hello.get("delta", False)),
                     batch=_clamp_batch(hello, self.batch_turns),
                     high_water=self.high_water,
                     drain_secs=self.drain_secs,
                     pool=self.pool)
        if sid is not None:
            # Session-attached peers bill to their TENANT, not the
            # transient socket: everything this connection moves or
            # occupies joins the session's usage record (the same
            # principal the manager charges dispatch shares to).
            conn.principal = sid
        if sid is not None and role == "drive":
            with self._conn_lock:
                busy = sid in self._drivers
                if not busy:
                    self._drivers[sid] = conn
            if busy:
                _METRICS.rejects["busy"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(sock, {
                        "t": "error", "reason": "busy",
                        "retry_after": self.retry_after_secs,
                    })
                sock.close()
                return
        with self._conn_lock:
            self._conns.append(conn)
            _METRICS.peers.set(len(self._conns))
        _METRICS.attaches[role].inc()
        install_lag_gauge(conn)
        ack = {"t": "attach-ack", "clock": True, "sessions": True,
               "depth": 0}
        if conn.batch:
            ack["batch"] = conn.batch
        if sid is not None:
            ack["session"] = sid
        if hb:
            ack["hb_secs"] = self.heartbeat_secs
        try:
            conn.send(ack)
        except (wire.WireError, OSError):
            self._drop_conn(conn)
            return
        try:
            conn.start_writer(self._drop_conn)
        except wire.WireError:
            self._drop_conn(conn)
            return
        tracing.event("server.attach", "lifecycle", role=role,
                      token=conn.token, session=sid)
        flight.note("server.attach", role=role, token=conn.token,
                    session=sid)
        # Reader BEFORE the sink attach: manager.attach blocks on the
        # engine thread (a cold bucket's first dispatch can hold it for tens of
        # seconds), and heartbeat pongs arriving in that window must
        # be READ or the liveness judge evicts a perfectly live peer —
        # beacons were already flowing (the writer is up), so the
        # pongs are already coming back.
        threading.Thread(
            target=self._reader_loop, args=(conn,),
            name="gol-sess-reader", daemon=True,
        ).start()
        if sid is not None:
            geom = self.manager.peek_geometry(sid) or (0, 0)
            sink = _SessionSink(self, conn, sid, geom[0] or 0,
                                geom[1] or 0)
            # Register the sink BEFORE the (possibly slow) attach: a
            # peer that sends a seek verb the instant its board sync
            # lands must find its session mapping, not race the
            # registration into a spurious "not-recorded". Every
            # failure path below goes through _drop_conn, which pops
            # the entry (and detaches the sink OUTSIDE _conn_lock —
            # manager.detach blocks on the engine verb queue, and the
            # engine thread may simultaneously be tearing a sink down
            # through on_close -> _drop_conn, which needs _conn_lock:
            # holding it across the verb deadlocks the serving plane,
            # seen live as a ~60s stall).
            with self._conn_lock:
                gone = conn not in self._conns
                if not gone:
                    self._sinks[conn] = (sid, sink)
            if gone:  # reader dropped the peer before we got here
                return
            try:
                # A parked session rehydrates inside attach — the
                # board sync below then carries the revived state
                # (docs/SESSIONS.md "Hibernation").
                self.manager.attach(sid, sink)
            except (wire.WireError, OSError):
                # The peer died during its own board sync: its slot is
                # already released (on_sync drops the conn); the accept
                # thread must survive.
                self._drop_conn(conn)
                return
            except (SessionError, TimeoutError) as e:
                # Destroyed between the hello check and the attach —
                # or a rehydration the resident budget refused: the
                # real reason (with a retry hint on transient ones)
                # lets the client back off instead of giving up.
                reason = (str(e) if isinstance(e, SessionError)
                          else "busy")
                err = {"t": "error", "reason": reason}
                if reason in ("max-sessions", "busy"):
                    err["retry_after"] = self.retry_after_secs
                with contextlib.suppress(Exception):
                    conn.send(err)
                self._drop_conn(conn)
                return
            undo = False
            with self._conn_lock:
                if conn not in self._conns:
                    # The reader dropped the peer ('q', death) while we
                    # were attaching; _drop_conn already popped _sinks
                    # — undo the manager-side attach it could not have
                    # seen yet.
                    undo = True
            if undo:
                with contextlib.suppress(Exception):
                    self.manager.detach(sid, sink)

    # --- replay-plane recording + seek (gol_tpu_torch.replay) ---

    def _make_recorder(self, sid: str, width: int, height: int):
        """The manager's recorder factory (called from inside _create,
        on the owner thread): one RecorderSink per live session,
        taping into out/sessions/<sid>/replay/. Returns None when the
        session already has one (re-entrant resume paths)."""
        import os

        from gol_tpu_torch.checkpoint import session_checkpoint_dir
        from gol_tpu_torch.replay.log import SegmentLog, replay_dir
        from gol_tpu_torch.replay.recorder import RecorderSink

        with self._recorder_lock:
            if sid in self._recorders:
                return None
            d = replay_dir(os.path.join(
                session_checkpoint_dir(self.manager.out_dir), sid
            ))
            try:
                rec = RecorderSink(
                    self.manager, sid, width, height,
                    SegmentLog(d, keyframe_turns=self.keyframe_turns,
                               max_bytes=self.record_max_bytes),
                    on_closed=self._recorder_closed,
                )
            except OSError:
                log.exception("recorder for session %r failed to open",
                              sid)
                return None
            self._recorders[sid] = rec
        return rec

    def _recorder_closed(self, sid: str, reason: str) -> None:
        with self._recorder_lock:
            self._recorders.pop(sid, None)

    def _handle_seek(self, conn: _Conn, msg: dict) -> None:
        """One `{"t":"seek"}` verb on the session plane: time-travel
        served from the session's recording under the idempotent-rid
        rules (gol_tpu_torch.replay.serve_seek — the shared implementation;
        the reply is sent AFTER the frames, as the completion
        marker)."""
        from gol_tpu_torch.replay.server import serve_seek

        with self._conn_lock:
            entry = self._sinks.get(conn)
        target = None
        if entry is not None:
            sid, sink = entry
            with self._recorder_lock:
                rec = self._recorders.get(sid)
            if rec is not None:
                target = _SeekTarget(self, sid, sink, conn,
                                     rec.log.root)
        try:
            reply = serve_seek(conn, msg, target,
                               replay_lookup=self._replay_lookup,
                               replay_record=self._replay_record)
        except (wire.WireError, OSError):
            self._drop_conn(conn)
            return
        with contextlib.suppress(wire.WireError, OSError):
            conn.send(reply)

    def _drop_conn(self, conn: _Conn, detach_sink: bool = True) -> None:
        """Remove one peer everywhere (idempotent; any thread). With
        `detach_sink` the manager-side sink is detached too — callbacks
        already running inside the manager pass False (the manager is
        removing the sink itself)."""
        with self._conn_lock:
            removed = conn in self._conns
            if removed:
                self._conns.remove(conn)
            entry = self._sinks.pop(conn, None)
            for sid, c in list(self._drivers.items()):
                if c is conn:
                    del self._drivers[sid]
            _METRICS.peers.set(len(self._conns))
        if removed:
            _METRICS.detaches.inc()
            remove_lag_gauge(conn)
            self.freshness.forget(conn.token)
            _forget_peer_usage(conn)
            tracing.event("server.detach", "lifecycle", role=conn.role,
                          token=conn.token)
        if entry is not None and detach_sink and not self._shutdown.is_set():
            sid, sink = entry
            with contextlib.suppress(Exception):
                self.manager.detach(sid, sink)
        conn.close()

    # --- peer → server ---

    def _reader_loop(self, conn: _Conn) -> None:
        while True:
            try:
                msg = wire.recv_msg(conn.sock, allow_binary=False)
            except TimeoutError:
                if conn._dead.is_set():
                    self._drop_conn(conn)
                    return
                continue
            except (wire.WireError, OSError):
                msg = None
            if msg is None:
                self._drop_conn(conn)
                return
            conn.last_rx = time.monotonic()
            conn.hb_unanswered = 0
            t = msg.get("t")
            if t == "clk":
                with contextlib.suppress(wire.WireError, OSError):
                    conn.send_direct({"t": "clk", "t0": msg.get("t0"),
                                      "ts": time.time()})
                continue
            if t == "session":
                self._handle_session_op(conn, msg)
                continue
            if t == "seek":
                # Time-travel verb (gol_tpu_torch.replay): read-only, so
                # observers may scrub too.
                self._handle_seek(conn, msg)
                continue
            if t != "key":
                continue
            if not self._handle_key(conn, msg.get("key")):
                return

    def _handle_key(self, conn: _Conn, key) -> bool:
        """Session-mode verb routing; False ends the reader loop."""
        with self._conn_lock:
            entry = self._sinks.get(conn)
        if key == "q":
            if entry is not None:
                sid, sink = entry
                with contextlib.suppress(Exception):
                    self.manager.detach(sid, sink)
            self._release_slot(conn)
            with contextlib.suppress(Exception):
                conn.send({"t": "detached"})
            conn.finish()
            self._drop_conn(conn, detach_sink=False)
            return False
        if key == "s" and entry is not None and conn.role == "drive":
            # The snapshot verb, scoped to this peer's session.
            from gol_tpu_torch.sessions import SessionError

            with contextlib.suppress(SessionError, TimeoutError):
                self.manager.checkpoint(entry[0])
            return True
        with contextlib.suppress(Exception):
            conn.send({"t": "error",
                       "reason": ("observer" if conn.role == "observe"
                                  else "unsupported")})
        return True

    def _release_slot(self, conn: _Conn) -> None:
        with self._conn_lock:
            self._sinks.pop(conn, None)
            for sid, c in list(self._drivers.items()):
                if c is conn:
                    del self._drivers[sid]

    #: Bounded replay window for idempotent verbs: enough rids for
    #: hundreds of in-flight retries across reconnects; old entries
    #: age out FIFO (a retry arriving after 512 newer verbs falls back
    #: to the state-based idempotency checks, which are still exact).
    REPLAY_WINDOW = 512

    def _replay_lookup(self, rid: str) -> Optional[dict]:
        with self._replay_lock:
            return self._replay.get(rid)

    def _replay_record(self, rid: str, reply: dict) -> None:
        with self._replay_lock:
            self._replay[rid] = reply
            while len(self._replay) > self.REPLAY_WINDOW:
                del self._replay[next(iter(self._replay))]

    def _idempotent_outcome(self, op, msg: dict, reason: str,
                            reply: dict) -> bool:
        """State-based idempotency for RETRIED verbs (rid present):
        when the failure reason says the operation's effect is already
        in place, answer ok instead of erroring the retry. This is the
        layer that survives a server restart (the replay window does
        not): a create that committed before a SIGKILL answers
        `exists` after `--resume latest`, and an identical-recipe
        retry must read that as success, not a duplicate."""
        if op == "destroy" and reason == "unknown-session":
            # Destroyed by the first attempt (or by anyone): the
            # desired end state — absence — holds.
            reply.update(ok=True, id=msg.get("id"), replayed=True)
            return True
        if op == "park" and reason == "parked":
            # Parked by the first attempt (or the idle sweep): the
            # desired end state — hibernated — holds.
            reply.update(
                ok=True, id=msg.get("id"),
                turn=self.manager.peek_turn(msg.get("id")),
                replayed=True,
            )
            return True
        if op == "adopt" and reason == "exists":
            # A retried adopt whose first attempt landed (or a
            # controller resume re-issuing a committed migration leg):
            # success iff the resident/parked session matches the
            # SOURCE sidecar's geometry+rule — a pre-existing
            # different session under the same id stays a real
            # duplicate.
            import os as _os

            from gol_tpu_torch.checkpoint import session_checkpoint_dir

            sid = msg.get("id")
            info = next(
                (i for i in self.manager.list_sessions()
                 if i["id"] == sid), None)
            if info is None:
                return False
            try:
                with open(_os.path.join(
                    session_checkpoint_dir(str(msg.get("source"))),
                    sid, "session.json",
                )) as f:
                    side = json.load(f)
                same = (
                    info.get("width") == int(side["width"])
                    and info.get("height") == int(side["height"])
                    and str(info.get("rule")) == str(side.get("rule"))
                )
            except (OSError, ValueError, KeyError, TypeError):
                return False
            if not same:
                return False
            reply.update(ok=True, session=info, replayed=True)
            return True
        if op == "create" and reason == "exists":
            from gol_tpu_torch.models.rules import get_rule

            sid = msg.get("id")
            s = self.manager.get(sid)
            if s is None:
                # The first attempt's create may have landed and been
                # hibernated by the idle sweep before the retry
                # arrived: an IDENTICAL recipe — seed/density
                # included, exactly the live compare below — still
                # reads as success; anything else is a real duplicate.
                meta = self.manager.parked_meta(sid)
                if meta is None:
                    return False
                try:
                    want_rule = (self.manager.default_rule
                                 if msg.get("rule") is None
                                 else get_rule(msg["rule"]))
                    same = (
                        meta.get("width") == msg.get("width")
                        and meta.get("height") == msg.get("height")
                        and str(meta.get("rule")) == str(want_rule)
                        and meta.get("seed") == msg.get("seed")
                        and (meta.get("seed") is None
                             or meta.get("density")
                             == float(msg.get("density", 0.25)))
                    )
                except (ValueError, TypeError):
                    return False
                if not same:
                    return False
                info = next(
                    (i for i in self.manager.list_sessions()
                     if i["id"] == sid), None)
                reply.update(ok=True, session=info, replayed=True)
                return True
            b = s.bucket
            try:
                want_rule = (self.manager.default_rule
                             if msg.get("rule") is None
                             else get_rule(msg["rule"]))
                same = (
                    b.width == msg.get("width")
                    and b.height == msg.get("height")
                    and str(b.rule) == str(want_rule)
                    and s.seed == msg.get("seed")
                    and (s.seed is None
                         or s.density == float(msg.get("density", 0.25)))
                )
            except (ValueError, TypeError):
                return False
            if not same:
                return False  # a REAL duplicate id, not a retry
            reply.update(ok=True, session=s.info(), replayed=True)
            return True
        return False

    def _handle_session_op(self, conn: _Conn, msg: dict) -> None:
        """One `{"t":"session"}` verb; every outcome is an in-stream
        `session-r` reply — a malformed request must never kill the
        reader or wedge the peer waiting. Verbs stamped with a client
        request id (`rid`) are idempotent: a completed verb's reply is
        replayed from the bounded window, and state-based checks make
        retried creates/destroys converge even when the window (or the
        whole process) has been lost in between."""
        from gol_tpu_torch.sessions import SessionError

        op = msg.get("op")
        rid = msg.get("rid")
        if not (isinstance(rid, str) and 0 < len(rid) <= 128):
            rid = None  # absent or hostile: plain one-shot semantics
        if rid is not None:
            cached = self._replay_lookup(rid)
            if cached is not None:
                with contextlib.suppress(wire.WireError, OSError):
                    conn.send(cached)
                return
        reply = {"t": "session-r", "op": op}
        if rid is not None:
            reply["rid"] = rid
        try:
            if op == "create":
                density = msg.get("density", 0.25)
                info = self.manager.create(
                    msg.get("id"),
                    width=msg.get("width"), height=msg.get("height"),
                    rule=msg.get("rule"), seed=msg.get("seed"),
                    density=float(density),
                )
                reply.update(ok=True, session=info)
            elif op == "destroy":
                self.manager.destroy(msg.get("id"))
                # Evict the destroyed session's freshness clock (the
                # bounded-cardinality discipline: clocks key on sid
                # and must not accumulate under create/destroy churn).
                self.freshness.drop_key(msg.get("id"))
                reply.update(ok=True, id=msg.get("id"))
            elif op == "list":
                reply.update(ok=True,
                             sessions=self.manager.list_sessions())
            elif op == "checkpoint":
                r = self.manager.checkpoint(msg.get("id"))
                reply.update(ok=True, id=msg.get("id"), **r)
            elif op == "park":
                r = self.manager.park(msg.get("id"))
                reply.update(ok=True, **r)
            elif op == "adopt":
                # Control-plane migration : materialize a
                # session parked under ANOTHER engine's out tree. The
                # manager re-checkpoints locally before this acks.
                info = self.manager.adopt(msg.get("id"),
                                          msg.get("source"))
                reply.update(ok=True, session=info)
            elif op == "drain":
                n = self._drain()
                reply.update(ok=True, checkpointed=n, draining=True)
            else:
                reply.update(ok=False, reason="unknown-op")
        except SessionError as e:
            reason = str(e)
            if not (rid is not None
                    and self._idempotent_outcome(op, msg, reason, reply)):
                reply.update(ok=False, reason=reason)
                if reason == "max-sessions":
                    # Over-budget is transient by design: tell the
                    # storm when to come back instead of letting it
                    # hammer a full house.
                    reply["retry_after"] = self.retry_after_secs
        except (TypeError, ValueError, KeyError):
            reply.update(ok=False, reason="bad-request")
        except TimeoutError:
            reply.update(ok=False, reason="busy",
                         retry_after=self.retry_after_secs)
        except OSError:
            # Manifest/tombstone/checkpoint writes hit the filesystem:
            # a full or read-only disk must answer the verb (the
            # effect may or may not have committed — the rid retry
            # discipline handles that), never kill the reader thread
            # and leak a conn that consumes an admission slot forever.
            log.exception("session verb %r failed on I/O", op)
            reply.update(ok=False, reason="io-error")
        if rid is not None and reply.get("ok"):
            self._replay_record(rid, reply)
        with contextlib.suppress(wire.WireError, OSError):
            conn.send(reply)

    def _drain(self) -> int:
        """The roll verb's first half (control plane):
        checkpoint every RESIDENT session crash-atomically and flip
        the draining flag so new session attaches bounce with a
        retry hint. After this acks, a SIGTERM + `--resume latest`
        restart loses nothing — parked sessions already sit on their
        hibernation snapshots. Idempotent by construction: a retried
        drain re-checkpoints (same turn, same bytes) and stays
        draining. Returns the number checkpointed."""
        from gol_tpu_torch.sessions import SessionError

        self.draining = True
        n = 0
        for info in self.manager.list_sessions():
            if info.get("parked"):
                continue
            with contextlib.suppress(SessionError, TimeoutError,
                                     OSError):
                self.manager.checkpoint(info["id"])
                n += 1
        tracing.event("server.drain", "lifecycle", checkpointed=n)
        flight.note("server.drain", checkpointed=n)
        return n

    # --- liveness (the EngineServer discipline, per session) ---

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, self.heartbeat_secs / 2.0)
        while not self._shutdown.wait(interval):
            now = time.monotonic()
            with self._conn_lock:
                conns = list(self._conns)
                sids = dict((c, s[0]) for c, s in self._sinks.items())
            # Freshness sweep: session-attached peers age against
            # THEIR session's clock; control peers (no sink) are not
            # stream consumers and are skipped.
            self.freshness.sample(
                (c, sids[c]) for c in conns if c in sids
            )
            # Accounting sweep (same rationale as the EngineServer's):
            # writer-queue occupancy in frame-seconds per principal.
            _meter = accounting.meter()
            if _meter is not None:
                for c in conns:
                    q = c.queued()
                    if q:
                        _meter.charge(c.principal,
                                      queue_frame_seconds=q * interval)
            for conn in conns:
                if not conn.writer_started:
                    continue
                if conn.degraded:
                    # Degradation owns this peer's verdict (the
                    # EngineServer discipline): no beacons into a
                    # backlogged queue, no hb-eviction racing the
                    # drain deadline. Drain-resync happens on the
                    # engine thread (the sink's on_turn — it needs the
                    # device); this loop only enforces the deadline.
                    if (now - conn.degraded_since > conn.drain_secs
                            and conn.queued() > conn.LOW_WATER):
                        log.warning(
                            "evicting session peer %d: wedged %.1fs "
                            "past the drain deadline", conn.token,
                            now - conn.degraded_since,
                        )
                        if conn.count_overflow():
                            _METRICS.overflows.inc()
                            flight.note("server.drain_evict",
                                        token=conn.token)
                        self._drop_conn(conn)
                    continue
                if (conn.hb and conn.hb_unanswered >= self.HB_MISS_LIMIT
                        and now - conn.last_rx > self.evict_secs):
                    log.warning(
                        "evicting unresponsive session peer (silent "
                        "%.1fs)", now - conn.last_rx,
                    )
                    _METRICS.evicted.inc()
                    tracing.event("server.evict", "lifecycle",
                                  role=conn.role, token=conn.token)
                    flight.note("server.evict", role=conn.role,
                                token=conn.token)
                    self._drop_conn(conn)
                    flight.dump("peer-eviction")
                    continue
                if now - conn.last_tx >= self.heartbeat_secs:
                    # peek_turn, NOT manager.get: the manager lock is
                    # held across whole bucket dispatches (cold
                    # first dispatches included) and a beacon that waits on it
                    # defeats its own purpose — liveness must stay
                    # engine-loop independent (docs/RESILIENCE.md).
                    turn = self.manager.peek_turn(sids.get(conn, ""))
                    try:
                        if conn.binary:
                            conn.send_raw(wire.heartbeat_to_frame(turn))
                        else:
                            conn.send({"t": "hb", "turn": turn})
                    except (wire.WireError, OSError):
                        self._drop_conn(conn)
                        continue
                    _METRICS.heartbeats.inc()
                    if conn.hb:
                        conn.hb_unanswered += 1
