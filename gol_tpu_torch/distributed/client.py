"""Controller client — the local half of the distributed split.

Connects to an `EngineServer`, replays the attach-time board sync as an
initial CellFlipped burst (exactly how the engine announces a freshly
loaded world, ref: gol/distributor.go:72-80), then exposes the remote
event stream as a local `EventQueue` — so the visualiser loop, shadow
boards and tests all work unchanged against a remote engine. Keyboard
verbs go the other way with `send_key` (ref: sdl/loop.go:18-27).

Detach/reattach (ref: README.md:182): `send_key('q')` — the server acks
with "detached", the local stream closes, the remote engine keeps
evolving; a new Controller can attach later and board-sync.

Resilience (docs/RESILIENCE.md): the reader is SUPERVISED. On a socket
failure — reset, EOF without a goodbye, or a missed heartbeat deadline
— it re-dials with exponential backoff + deterministic jitter, repeats
the handshake, and resumes through the ordinary BoardSync catch-up: the
client tracks the board it has handed downstream (applying each flip
batch to its shadow raster), so the reattach sync's XOR diff is exactly
the correction between what consumers have and where the engine is —
missed flips are never replayed, present ones never doubled, and
`synced_turn` gating drops any flip the synced board already contains.
When reconnection is disabled or exhausted the client parts with an
explicit `ConnectionLost` state (`lost` event, `state == "lost"`)
rather than an indistinguishable closed stream.

Observability (docs/OBSERVABILITY.md): the attach handshake runs a
clock probe against servers that advertise it — the min-RTT offset
sample corrects the emit→apply turn-latency histogram onto the
server's timebase, is exported as gol_tpu_client_clock_offset_seconds,
and rides the tracer's dump metadata so `gol_tpu.obs.report merge` can
join this side's spans with the server's on one timeline. Link
lifecycle (link_down / reconnected / board_sync / lost) lands on the
same timeline and in the flight recorder; reconnect exhaustion dumps
the black box.
"""

from __future__ import annotations

import contextlib
import logging
import random
import socket
import threading
import time
import uuid
from typing import Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.distributed import wire
from gol_tpu_torch.obs import flight, tracing
from gol_tpu_torch.obs.freshness import ClientFreshness, sane_lag
from gol_tpu_torch.engine.distributor import EventQueue
from gol_tpu_torch.events import CellFlipped, FlipBatch, TurnComplete
from gol_tpu_torch.utils.cell import Cell, cells_from_mask, xy_from_mask
from gol_tpu_torch.analysis.concurrency import lockcheck

log = logging.getLogger(__name__)


class _ClientMetrics:
    """Registry handles for the controller plane (gol_tpu_torch.obs): one
    observation per wire message, host-side only. `turn_latency` is the
    END-TO-END signal — broadcaster-enqueue (the server's `ts` stamp on
    TurnComplete) to applied-on-this-client — the first cross-process
    latency the system can see. Same-host pairs share a clock; across
    hosts the number includes NTP skew (docs/OBSERVABILITY.md)."""

    def __init__(self):
        self.turn_latency = obs.histogram(
            "gol_tpu_client_turn_latency_seconds",
            "Server TurnComplete emit -> applied on this client",
        )
        self.apply_seconds = obs.histogram(
            "gol_tpu_client_apply_seconds",
            "Decode-and-apply seconds per server message",
        )
        self.batch_latency = obs.histogram(
            "gol_tpu_client_batch_latency_seconds",
            "Batch-frame emit on the server -> whole k-turn batch "
            "applied here (PER-BATCH stamping, deliberately not fed "
            "into turn_latency — docs/OBSERVABILITY.md \"Batch "
            "latency semantics\")",
        )
        self.messages = {
            t: obs.counter(
                "gol_tpu_client_messages_total",
                "Server messages handled by kind", {"kind": t},
            ) for t in ("board", "flips", "dflips", "fbatch", "ev",
                        "other")
        }
        self.reconnects = obs.counter(
            "gol_tpu_client_reconnects_total",
            "Successful re-dial + re-handshake + resync cycles",
        )
        self.hb_miss = obs.counter(
            "gol_tpu_client_heartbeat_miss_total",
            "Read deadlines expired without a frame (liveness misses)",
        )
        self.lost = obs.counter(
            "gol_tpu_client_connection_lost_total",
            "Links declared permanently lost (reconnect off/exhausted)",
        )
        self.clock_offset = obs.gauge(
            "gol_tpu_client_clock_offset_seconds",
            "Handshake-estimated wall-clock offset to the server "
            "(server_time - client_time; min-RTT probe sample)",
        )
        self.turn_age = obs.gauge(
            "gol_tpu_client_turn_age_seconds",
            "Seconds this client's APPLIED turn lags the server's "
            "committed head (freshness plane: head learned from "
            "stamped events and heartbeat beacons on the corrected "
            "clock — what an observer actually experiences)",
        )


_METRICS = _ClientMetrics()


#: Ceiling on any server-supplied retry_after hint, seconds. A
#: malformed or hostile hint (negative, NaN, "a year") must never be
#: able to park a client forever — absurd values clamp into this range
#: and non-numeric ones are ignored (plain backoff applies).
RETRY_AFTER_CAP = 30.0


def sanitize_retry_after(value) -> "float | None":
    """The server's when-to-come-back hint, made safe to sleep on:
    a finite number clamped to [0, RETRY_AFTER_CAP], else None."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    v = float(value)
    if v != v or v in (float("inf"), float("-inf")):
        return None
    return min(max(v, 0.0), RETRY_AFTER_CAP)


class ServerBusyError(ConnectionError):
    """The engine already has a controller attached (or admission
    control shed this attach). `retry_after` carries the server's
    sanitized when-to-come-back hint in seconds, or None when the
    rejection had no (usable) hint."""

    def __init__(self, reason: str, retry_after: "float | None" = None):
        super().__init__(reason)
        self.retry_after = retry_after


class UnauthorizedError(ConnectionError):
    """The engine requires a shared secret this controller lacks."""


class UnknownSessionError(ConnectionError):
    """The named session does not exist on the session server."""


class ConnectionLost(ConnectionError):
    """The link died and reconnection was disabled or exhausted."""


class Controller:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8030,
        *,
        want_flips: bool = True,
        timeout: float = 30.0,
        secret: "str | None" = None,
        batch: bool = False,
        batch_turns: "int | None" = None,
        batch_flip_events: bool = True,
        binary: bool = True,
        levels: bool = False,
        delta: bool = True,
        observe: bool = False,
        session: "str | None" = None,
        reconnect: bool = True,
        max_reconnects: Optional[int] = None,
        reconnect_window: float = 30.0,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        reconnect_seed: Optional[int] = None,
    ):
        #: batch=True delivers each turn's flips as ONE events.FlipBatch
        #: ndarray instead of per-cell CellFlipped objects — the form
        #: vectorized consumers (the visualiser) apply directly; at
        #: thousands of flips/turn the per-cell expansion alone caps a
        #: watched run at ~30 turns/s. Default stays per-cell (the
        #: reference event contract).
        self._batch = batch
        #: batch_turns=k requests k-TURN WIRE FRAMES (hello "batch",
        #: the batch frame): the server ships one _TAG_FBATCH frame per dispatch
        #: chunk instead of per-turn frames, and this client applies
        #: each frame with one vectorized XOR pass over the shadow
        #: raster — the ~300 -> 10⁵+ turns/s watched-path fix. The
        #: server clamps the request to its own --batch-turns cap;
        #: servers that predate the frame ignore the key and keep
        #: sending per-turn frames, which this client still handles.
        self._batch_turns = int(batch_turns) if batch_turns else 0
        #: With batch frames, per-turn FlipBatch/CellFlipped events
        #: are RECONSTRUCTED from the deltas (exact, but per-turn
        #: Python cost). batch_flip_events=False skips them — consumers
        #: read per-turn TurnComplete events plus the always-current
        #: `board` raster instead (the high-rate watching mode: a
        #: display renders from `board` at its own frame rate).
        self._batch_flip_events = batch_flip_events
        #: levels=True (multi-state rules): board syncs replay as
        #: level-setting batches and flips messages carrying levels
        #: surface them on the FlipBatch — pair with a level-mode board.
        self._levels = levels
        self.events = EventQueue()
        #: Board state as of the last flip handed downstream — starts
        #: as the attach sync's raster and tracks every applied batch,
        #: so a reattach sync can diff against what consumers actually
        #: have (None until the first sync arrives).
        self.board: Optional[np.ndarray] = None
        #: Completed turns as of the last board sync.
        self.sync_turn: int = 0
        #: Gate against double-apply: flips for turns <= this are
        #: already inside the synced board and are dropped (the client
        #: twin of the server's per-peer synced_turn gate).
        self.synced_turn: int = -1
        #: Set once the attach-time BoardSync has been applied.
        self.synced = threading.Event()
        self.detached = threading.Event()
        #: Set when the link is PERMANENTLY gone (reconnect disabled,
        #: window/attempts exhausted, or a policy rejection on
        #: re-handshake) — the explicit state `wait_sync`/`detach`
        #: return against instead of silently timing out.
        self.lost = threading.Event()
        #: Successful reconnect cycles this controller has survived.
        self.reconnects = 0
        self._send_lock = lockcheck.make_lock("Controller._send_lock")
        self._closing = threading.Event()
        self._reconnecting = threading.Event()
        self._host, self._port = host, port
        self._timeout = timeout
        self._reconnect_enabled = reconnect
        self._max_reconnects = max_reconnects
        self._window = reconnect_window
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        #: Deterministic jitter: a seeded PRNG makes a reconnect
        #: schedule replayable in tests (and across a fleet, seeds
        #: should differ so backed-off clients do not re-dial in
        #: lockstep).
        self._rng = random.Random(reconnect_seed)
        #: Heartbeat cadence the server confirmed in its attach-ack
        #: (0 = none negotiated; the read deadline stays unarmed).
        self._hb_secs = 0.0
        #: Clock-offset estimate to the server (seconds; server_time ≈
        #: client_time + offset), measured by the handshake ping/pong
        #: probe when the server advertises "clock" in its attach-ack.
        #: None until a probe run completes (legacy servers never echo,
        #: so it simply stays None and the latency math falls back to
        #: the raw cross-host subtraction, as before).
        self.clock_offset: Optional[float] = None
        self._clk_samples: "list[tuple[float, float]]" = []
        self._clk_left = 0
        self._clk_last_send = 0.0
        #: Delta-of-sparse flips chain state: the changed-word
        #: bitmap of the last applied delta frame, reset at every
        #: board sync (the server resets its twin when it sends one).
        self._delta_prev: Optional[np.ndarray] = None
        #: Freshness plane (gol_tpu_torch.obs.freshness): applied-turn age
        #: against the server's committed head — the head clock learns
        #: from stamped turn events/batch frames (emit stamps mapped
        #: onto the local clock via the clock-probe offset) and heartbeat
        #: beacons; `turn_age()` is the live reading the canary
        #: publishes.
        self.freshness = ClientFreshness()
        hello = {"t": "hello", "want_flips": want_flips,
                 "compact": True, "binary": bool(binary),
                 "levels": bool(levels), "hb": True, "clock": True,
                 # Delta frames carry no levels, so level mode keeps
                 # the LFLIPS encoding (negotiated OFF here).
                 "delta": bool(delta) and bool(binary) and not levels}
        if self._batch_turns > 0 and binary and not levels and want_flips:
            # k-turn batch frames (binary-only, two-state only — the
            # same constraints as delta frames — and only when flips
            # are actually subscribed: the server ignores a flip-less
            # "batch" anyway, so don't even advertise it).
            hello["batch"] = self._batch_turns
        if observe:
            # Read-only attach (multi-observer serving): the
            # driver slot stays free, steering verbs are rejected
            # by the server; 'q' still detaches this observer.
            hello["role"] = "observe"
        if session is not None:
            # Multi-tenant attach (gol_tpu.sessions): watch/drive the
            # NAMED session on a `--serve --sessions` server. The rest
            # of the protocol — board sync, flips, reconnect-and-resync
            # — is unchanged; a reconnect re-handshakes with the same
            # session id, so supervision composes. (A pre-sessions
            # server ignores the unknown key and serves its singleton.)
            hello["session"] = session
        self.session = session
        if secret is not None:
            hello["secret"] = secret
        self._hello = hello
        #: Seek verb state (gol_tpu.replay, docs/REPLAY.md): the last
        #: `seek-r` reply and its arrival event — one outstanding seek
        #: at a time (the verb is a user-interaction, not a stream).
        self._seek_reply: Optional[dict] = None
        self._seek_done = threading.Event()
        self._seek_lock = lockcheck.make_lock("Controller._seek_lock")
        self._rid_n = 0
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._sock, first = self._dial()
        self._arm_read_deadline()
        self._reader = threading.Thread(
            target=self._reader_loop, args=(first,), name="gol-ctl-reader",
            daemon=True,
        )
        self._reader.start()

    # --- link lifecycle ---

    def _dial(self) -> "tuple[socket.socket, Optional[dict]]":
        """One connect + handshake: returns the live socket and the
        server's first reply (normally the attach-ack, whose hb_secs
        arms the liveness deadline). Raises Unauthorized/ServerBusy on
        policy rejections, ConnectionError on everything else. The
        `timeout` covers the whole handshake — a wedged server must
        not hang the caller; streaming afterwards runs under the
        heartbeat deadline instead (see _arm_read_deadline)."""
        from gol_tpu_torch.testing import faults

        sock = faults.wrap("client", socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        ))
        # The handshake deadline (already set by create_connection;
        # re-applied on the wrapper so the discipline is explicit) —
        # replaced by the heartbeat deadline once the caller installs
        # the socket and calls _arm_read_deadline.
        sock.settimeout(self._timeout)
        try:
            wire.send_msg(sock, self._hello)
            first = wire.recv_msg(sock)
        except (TimeoutError, wire.WireError, OSError) as e:
            with contextlib.suppress(OSError):
                sock.close()
            raise ConnectionError(
                f"handshake with {self._host}:{self._port} failed: {e}"
            ) from None
        if first is not None and first.get("t") == "error":
            with contextlib.suppress(OSError):
                sock.close()
            reason = first.get("reason", "rejected")
            if reason == "unauthorized":
                raise UnauthorizedError(reason)
            if reason == "unknown-session":
                raise UnknownSessionError(reason)
            # Load rejections ("busy", "at-capacity") carry the
            # server's retry_after hint — sanitized here once, so
            # every consumer sleeps on a bounded number or not at all.
            raise ServerBusyError(
                reason, sanitize_retry_after(first.get("retry_after"))
            )
        sock.settimeout(None)
        if first is not None and first.get("t") == "attach-ack":
            self._hb_secs = float(first.get("hb_secs", 0) or 0)
        return sock, first

    def _arm_read_deadline(self) -> None:
        """Three missed heartbeat intervals with zero frames = the
        server is gone (docs/RESILIENCE.md). Servers that negotiated
        no heartbeats keep the legacy unbounded read — evicting a
        healthy-but-quiet legacy server would be worse than blocking."""
        deadline = 3.0 * self._hb_secs if self._hb_secs > 0 else None
        self._sock.settimeout(deadline)

    @property
    def state(self) -> str:
        """One-word link state: connected / reconnecting / detached /
        lost / closed — `lost` is the ConnectionLost outcome callers
        used to have to infer from a timed-out False."""
        if self.lost.is_set():
            return "lost"
        if self.detached.is_set():
            return "detached"
        if self.events.closed or self._closing.is_set():
            return "closed"
        if self._reconnecting.is_set():
            return "reconnecting"
        return "connected"

    def send_key(self, key: str) -> None:
        """Forward a keyboard verb (p/s/q/k) to the engine. Callable from
        any thread (stdin pump + visualiser share one controller).
        Raises ConnectionLost once the link is permanently gone."""
        if key not in ("p", "s", "q", "k"):
            raise ValueError(f"unknown verb {key!r}")
        if self.lost.is_set():
            raise ConnectionLost(
                f"link to {self._host}:{self._port} is gone"
            )
        with self._send_lock:
            wire.send_msg(self._sock, {"t": "key", "key": key})

    def seek(self, turn, timeout: float = 30.0,
             rid: "str | None" = None) -> dict:
        """Time-travel (gol_tpu.replay, docs/REPLAY.md): ask a
        recording-backed server to rewind this stream to `turn` (an
        int, or the literal "live" to rejoin the present). The server
        answers with the nearest <= turn keyframe's BoardSync plus the
        recorded FBATCH suffix — both ride the ORDINARY apply path, so
        `self.board` simply becomes the historical raster — followed
        by the `seek-r` completion reply this method returns (ok +
        landed turn, or ok=False with a reason). The verb is
        idempotent under rid replay; pass `rid` to retry a specific
        attempt. Raises TimeoutError when no reply arrives in time."""
        if rid is None:
            self._rid_n += 1
            rid = f"{self._rid_prefix}-seek-{self._rid_n}"
        with self._seek_lock:
            self._seek_reply = None
            self._seek_done.clear()
            with self._send_lock:
                wire.send_msg(self._sock,
                              {"t": "seek", "turn": turn, "rid": rid})
            deadline = time.monotonic() + timeout
            while not self._seek_done.wait(0.05):
                if self.lost.is_set() or self.events.closed \
                        or time.monotonic() > deadline:
                    break
            reply = self._seek_reply
        if reply is None:
            raise TimeoutError("no seek-r reply from the server")
        return reply

    def turn_age(self) -> float:
        """Live applied-turn age in seconds (freshness plane): how far
        this client's applied board lags the server's committed head —
        0.0 while current (or before anything is known), growing in
        real time while behind a live stream. The canary publishes
        exactly this reading."""
        return self.freshness.age()

    def wait_sync(self, timeout: float = 60.0) -> bool:
        """Block until the attach-time board sync has been applied.
        Returns False IMMEDIATELY once the stream closed or the link
        was declared lost — never waits out the timeout against a dead
        connection (check `state` to tell "lost" from "run over")."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.synced.wait(0.05):
                return True
            if self.lost.is_set() or self.events.closed:
                return self.synced.is_set()
        return self.synced.is_set()

    def detach(self, timeout: float = 30.0) -> bool:
        """'q': detach from the engine, leaving it running. Returns
        immediately (False) when the link is already dead instead of
        sleeping out the timeout waiting for an ack that cannot come."""
        if self.lost.is_set() or self.events.closed:
            return self.detached.is_set()
        try:
            self.send_key("q")
        except (OSError, ConnectionError):
            return self.detached.is_set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.detached.wait(0.05):
                return True
            if self.lost.is_set() or self.events.closed:
                return self.detached.is_set()
        return self.detached.is_set()

    def close(self) -> None:
        self._closing.set()
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._sock.close()
        self.events.close()

    # --- reader ---

    #: Clock probes per (re)attach: enough samples for the min-RTT
    #: filter to dodge a scheduling hiccup, few enough to finish within
    #: the first seconds of a session.
    CLOCK_PROBES = 8

    #: A probe whose echo is this stale gets re-sent (from the next
    #: inbound message) instead of stalling the run forever — one
    #: dropped echo must not leave clock_offset unmeasured all session.
    CLOCK_PROBE_RETRY_SECS = 2.0

    def _send_clk(self) -> None:
        """One clock probe: the server echoes t0 back with its own
        wall clock (queue-free), and the reply's RTT bounds the offset
        error. Failures are ignored — the link supervisor owns socket
        death, and an unmeasured offset just stays None."""
        self._clk_last_send = time.monotonic()
        with contextlib.suppress(OSError, ConnectionError, wire.WireError):
            with self._send_lock:
                wire.send_msg(self._sock, {"t": "clk", "t0": time.time()})

    def _handle(self, msg: dict) -> bool:
        """Apply one server message; False ends the stream (metrics:
        one counter + one apply-seconds observation per message, and
        the emit→apply lag for stamped TurnCompletes)."""
        t0 = time.perf_counter()
        wall0 = time.time()
        applied = False
        try:
            ret = self._handle_inner(msg)
            applied = True
            return ret
        finally:
            t = msg.get("t")
            dt = time.perf_counter() - t0
            _METRICS.messages.get(t, _METRICS.messages["other"]).inc()
            _METRICS.apply_seconds.observe(dt)
            tracing.add_span("client.apply", "client", wall0, dt,
                             {"t": t})
            if (self._clk_left > 0 and t != "clk"
                    and time.monotonic() - self._clk_last_send
                    > self.CLOCK_PROBE_RETRY_SECS):
                # A probe's echo went missing (dropped frame, or the
                # send itself failed silently): re-fire on the next
                # inbound traffic rather than stalling the run with
                # clock_offset forever unmeasured. Stream-idle links
                # retry off the heartbeat cadence at worst.
                self._send_clk()
            # Everything below requires `applied`: a message that
            # FAILED to apply (WireError out of the handler, which is
            # propagating right now — no `return` here, it would
            # swallow it) must not feed the latency histograms or the
            # MONOTONE freshness clocks — a rejected frame carrying a
            # plausible-but-absurd turn (< 2^62) would wedge turn_age
            # at 0 for the process lifetime, blinding the very canary
            # this plane exists for.
            if applied and t == "fbatch":
                # Per-BATCH latency: emit-of-batch (the frame's one ts
                # stamp) -> whole batch applied. A separate histogram
                # on purpose: feeding per-batch readings into the
                # per-turn series would silently change its semantics
                # under bench_compare.
                # The emit stamp crossed the wire: sane_lag is the ONE
                # validation before it reaches a histogram — a
                # hostile/absurd ts (negative epoch, 1e18, NaN) is
                # dropped, never observed (the relay hop's rule,
                # applied at the leaf too; wire-fuzz-pinned).
                off = self.clock_offset or 0.0
                lag = sane_lag(msg.get("ts"), time.time() + off)
                if lag is not None:
                    _METRICS.batch_latency.observe(lag)
                # Binary frames guarantee these fields (parse-time
                # validation); a hostile JSON "fbatch" does not, and a
                # KeyError out of this finally block kills the reader.
                try:
                    last = int(msg["first_turn"]) + int(msg["k"]) - 1
                except (KeyError, TypeError, ValueError):
                    last = -1  # dropped by the sane_turn guards below
                # Freshness: the frame's last turn was committed at
                # ~(now - lag) on the LOCAL clock, and this apply just
                # caught the client up to it.
                self.freshness.note_head(
                    last, None if lag is None else time.time() - lag
                )
                self.freshness.note_applied(last)
                _METRICS.turn_age.set(round(self.freshness.age(), 6))
                tracing.event(
                    "turn.apply", "wire", turn=last,
                    batch=msg.get("k"),
                    lag_s=None if lag is None else round(lag, 6),
                )
            if applied and t == "hb":
                # Beacons carry the committed head turn precisely so
                # an idle or lagging client can still measure its own
                # staleness — the head clock advances, the applied
                # turn does not, and the age gauge tells the truth.
                self.freshness.note_head(msg.get("turn"))
                _METRICS.turn_age.set(round(self.freshness.age(), 6))
            if applied and t == "board":
                self.freshness.note_head(msg.get("turn"))
                self.freshness.note_applied(msg.get("turn"))
                _METRICS.turn_age.set(round(self.freshness.age(), 6))
            if applied and t == "ev" and msg.get("k") == "turn" \
                    and "ts" not in msg:
                # Legacy unstamped servers: the turn event itself is
                # the freshest head evidence there is.
                self.freshness.note_head(msg.get("turn"))
                self.freshness.note_applied(msg.get("turn"))
                _METRICS.turn_age.set(round(self.freshness.age(), 6))
            if applied and t == "ev" and msg.get("k") == "turn" \
                    and "ts" in msg:
                # The handshake-estimated offset moves this reading
                # onto the SERVER's timebase (server_now ≈ client_now
                # + offset); legacy servers leave the offset None and
                # the raw subtraction stands. sane_lag clamps sub-zero
                # readings (clock granularity, not time travel) and
                # DROPS hostile stamps — a JSON peer can put anything
                # in "ts", and "abc" used to raise out of this finally
                # block and kill the reader thread.
                off = self.clock_offset or 0.0
                lag = sane_lag(msg.get("ts"), time.time() + off)
                if lag is not None:
                    _METRICS.turn_latency.observe(lag)
                self.freshness.note_head(
                    msg.get("turn"),
                    None if lag is None else time.time() - lag,
                )
                self.freshness.note_applied(msg.get("turn"))
                _METRICS.turn_age.set(round(self.freshness.age(), 6))
                # The CLIENT half of the per-turn wire correlation
                # (pairs with the server's `turn.emit` in merged
                # timelines).
                tracing.event(
                    "turn.apply", "wire", turn=msg.get("turn"),
                    lag_s=None if lag is None else round(lag, 6),
                )

    def _handle_inner(self, msg: dict) -> bool:
        t = msg.get("t")
        if t == "attach-ack":
            # Start the clock-probe run on servers that echo probes
            # (negotiated via the ack's "clock"; re-measured after
            # every reconnect — the offset can drift with the peer).
            if msg.get("clock"):
                self._clk_samples = []
                self._clk_left = self.CLOCK_PROBES
                self._send_clk()
            return True
        if t == "clk":
            if self._clk_left <= 0:
                # Stray echo after the run finalized (a retry raced a
                # late original): the offset is published and latencies
                # were observed against it — never re-finalize or
                # duplicate the clock_sync lifecycle marks.
                return True
            t1 = time.time()
            try:
                pt0, ts = float(msg["t0"]), float(msg["ts"])
            except (KeyError, TypeError, ValueError):
                return True  # malformed echo: drop the sample
            rtt = max(0.0, t1 - pt0)
            # NTP-style midpoint estimate: the server stamped somewhere
            # inside [t0, t1]; assuming the midpoint bounds the error
            # by RTT/2, and keeping the MIN-RTT sample makes that bound
            # the tightest the link offered.
            self._clk_samples.append((rtt, ts - (pt0 + t1) / 2.0))
            self._clk_left -= 1
            if self._clk_left > 0:
                self._send_clk()
            else:
                rtt, off = min(self._clk_samples)
                if abs(off) <= rtt / 2.0:
                    # Zero lies inside the estimate's own error bound
                    # (±RTT/2): the clocks are indistinguishable from
                    # synchronized, and "correcting" by the residual
                    # would INJECT up to RTT/2 of noise — enough to
                    # reorder emit→apply pairs on a same-host run whose
                    # true latency is microseconds. Snap to the only
                    # value the measurement actually supports. Real
                    # cross-host skew (≫ RTT/2) always survives this.
                    off = 0.0
                self.clock_offset = off
                tracing.set_clock_offset(off)
                _METRICS.clock_offset.set(off)
                tracing.event("client.clock_sync", "lifecycle",
                              offset_s=round(off, 6),
                              rtt_s=round(rtt, 6))
                flight.note("client.clock_sync", offset_s=round(off, 6),
                            rtt_s=round(rtt, 6))
            return True
        if t == "board":
            self.sync_turn, board = wire.msg_to_board(msg)
            # Replay as a flip burst + a render tick so any attached
            # visualiser shows the synced board immediately. Flips are
            # XOR for consumers, so the burst is the *difference* from
            # the board as consumers currently have it (self.board
            # tracks every batch handed downstream) — which is what
            # makes a RECONNECT sync converge without replaying missed
            # flips or doubling delivered ones. Level mode compares
            # gray grids directly and SETS the changed cells' levels
            # instead (no rule needed: the raster IS the level grid).
            prev = self.board
            board = np.array(board, dtype=np.uint8)  # writable tracker
            if self._levels:
                diff = board != (np.zeros_like(board) if prev is None else prev)
                self.board = board
                self.events.put(FlipBatch(
                    self.sync_turn, xy_from_mask(diff), levels=board[diff]
                ))
            else:
                diff = (board != 0 if prev is None
                        else (board != 0) ^ (prev != 0))
                self.board = board
                if self._batch:
                    self.events.put(
                        FlipBatch(self.sync_turn, xy_from_mask(diff))
                    )
                else:
                    for cell in cells_from_mask(diff):
                        self.events.put(CellFlipped(self.sync_turn, cell))
            self.events.put(TurnComplete(self.sync_turn))
            self.synced_turn = self.sync_turn
            self._delta_prev = None  # delta chain restarts at a sync
            was_synced = self.synced.is_set()
            self.synced.set()
            # Lifecycle mark: a re-sync after a reconnect is the gap's
            # closing edge on the merged timeline (the opening edge is
            # client.link_down).
            tracing.event("client.board_sync", "lifecycle",
                          turn=self.sync_turn, resync=was_synced)
            flight.note("client.board_sync", turn=self.sync_turn,
                        resync=was_synced)
            return True
        if t == "dflips":
            # Delta-of-sparse flips: XOR the bitmap delta against
            # the chain state FIRST — the chain must advance even for
            # a frame the synced_turn gate then drops, or every later
            # frame would decode against a stale bitmap.
            if self.board is None:
                raise wire.WireError(
                    "delta-flips frame before any board sync"
                )
            h, w = self.board.shape
            _, nb = wire.grid_words(w, h)
            if len(msg["dbitmap"]) != nb:
                raise wire.WireError(
                    f"delta-flips bitmap of {len(msg['dbitmap'])} words, "
                    f"board needs {nb}"
                )
            prev = (self._delta_prev if self._delta_prev is not None
                    else np.zeros(nb, np.uint32))
            bitmap = msg["dbitmap"] ^ prev
            self._delta_prev = bitmap
            turn = msg["turn"]
            if turn <= self.synced_turn:
                return True
            coords = wire.words_to_coords(bitmap, msg["dwords"], w, h)
            self._track_flips(coords, None)
            if self._batch:
                self.events.put(FlipBatch(turn, coords))
            else:
                for x, y in coords:
                    self.events.put(CellFlipped(turn, Cell(int(x), int(y))))
            return True
        if t == "fbatch":
            self._apply_fbatch(msg)
            return True
        if t == "flips":
            turn, coords = wire.msg_flips_array(msg)
            lv = wire.msg_flips_levels(msg) if self._levels else None
            if lv is not None and len(lv) != len(coords):
                raise wire.WireError(
                    f"{len(coords)} cells vs {len(lv)} levels"
                )
            if turn <= self.synced_turn:
                # Already inside the synced raster (the server's gate
                # makes this unreachable in practice; kept as the
                # client's own no-double-apply guarantee).
                return True
            self._track_flips(coords, lv)
            if self._batch:
                self.events.put(FlipBatch(turn, coords, levels=lv))
            else:
                for x, y in coords:
                    self.events.put(CellFlipped(turn, Cell(int(x), int(y))))
            return True
        if t == "hb":
            # Liveness beacon: answer with a pong — the server's
            # idle-eviction clock runs on these.
            with contextlib.suppress(OSError, ConnectionError,
                                     wire.WireError):
                with self._send_lock:
                    wire.send_msg(self._sock, {"t": "hb"})
            return True
        if t == "ev":
            for ev in wire.msg_to_events(msg):
                self.events.put(ev)
            return True
        if t == "seek-r":
            # Completion marker of a seek (the frames preceded it in
            # stream order, already applied above).
            self._seek_reply = msg
            self._seek_done.set()
            return True
        if t == "detached":
            self.detached.set()
            return False
        if t == "bye":
            return False
        return True  # unknown message kinds are ignored (forward compat)

    def _apply_fbatch(self, msg: dict) -> None:
        """Apply one k-turn batch frame (wire _TAG_FBATCH, already
        validated structurally at parse). The shadow raster advances
        in ONE vectorized XOR pass: turn i's flips ride as
        D[i] = S[i] XOR S[i-1] (D[0] = S[0]; frames self-contained),
        so the net board change over applied turns t0..k-1 is the XOR
        of exactly the D rows appearing an ODD number of times in
        Σ_{t>=t0} S[t] — D[j] appears (k - max(j, t0)) times. On a
        settled board (every turn's flips identical) every D row past
        the first is empty and the whole apply is a few hundred words.

        `synced_turn` gates per TURN, not per frame: a batch
        straddling a reconnect resync applies only its suffix — the
        gated prefix is already inside the synced raster (bit-exact,
        pinned by the fuzz suite's scripted-server test)."""
        if self.board is None:
            raise wire.WireError("batch frame before any board sync")
        # apply_fbatch_raster validates/coerces every field first (a
        # hostile JSON "fbatch" surfaces as WireError there); past it,
        # these plain conversions cannot fail.
        t0 = apply_fbatch_raster(self.board, msg, self.synced_turn)
        k, first = int(msg["k"]), int(msg["first_turn"])
        if t0 >= k:
            return  # whole batch already inside the synced raster
        if not self._batch_flip_events:
            # The high-rate watching mode (the 10⁵ turns/s path):
            # per-turn TurnComplete only — none of the reconstruction
            # state below is needed here.
            self.events.put_many(
                [TurnComplete(first + t) for t in range(t0, k)]
            )
            return
        # Exact per-turn surfacing: reconstruct each turn's flip set
        # from the delta chain (the slow-but-faithful mode; identical
        # to the unbatched event stream, pinned by test). asarray, not
        # .astype: a JSON-carried batch holds plain lists here.
        counts = np.asarray(msg["counts"], np.int64)
        total, nb = wire.grid_words(self.board.shape[1],
                                    self.board.shape[0])
        dbm = np.asarray(msg["dbitmaps"], np.uint32).reshape(-1, nb)
        dwords = np.asarray(msg["dwords"], np.uint32)
        w, h = self.board.shape[1], self.board.shape[0]
        evs: list = []
        cur = np.zeros(total, np.uint32)
        bi = 0
        off = 0
        for t in range(k):
            m = int(counts[t])
            if m:
                idx = wire._bitmap_indices(dbm[bi])
                bi += 1
                cur[idx] ^= dwords[off:off + m]
                off += m
            turn = first + t
            if turn <= self.synced_turn:
                continue
            nzw = np.flatnonzero(cur)
            if nzw.size:
                coords = wire.words_to_coords(
                    wire._indices_to_bitmap(nzw, nb), cur[nzw], w, h
                )
                if self._batch:
                    evs.append(FlipBatch(turn, coords))
                else:
                    evs.extend(
                        CellFlipped(turn, Cell(int(cx), int(cy)))
                        for cx, cy in coords
                    )
            evs.append(TurnComplete(turn))
        self.events.put_many(evs)

    def _track_flips(self, coords, levels) -> None:
        """Mirror one delivered flip batch onto the shadow raster, so
        the NEXT board sync diffs against what consumers actually have
        (see _handle_inner's board branch)."""
        if self.board is None or len(coords) == 0:
            return
        xy = np.asarray(coords).reshape(-1, 2)
        if levels is not None:
            self.board[xy[:, 1], xy[:, 0]] = levels
        else:
            self.board[xy[:, 1], xy[:, 0]] ^= np.uint8(255)

    def _reader_loop(self, first: Optional[dict]) -> None:
        msg = first
        while True:
            reason = None
            try:
                while True:
                    if msg is not None and not self._handle(msg):
                        self.close()  # clean stream end: bye/detached
                        return
                    msg = wire.recv_msg(self._sock)
                    if msg is None:
                        raise wire.WireError(
                            "server closed the stream without a goodbye"
                        )
            except TimeoutError:
                # Zero frames for 3 heartbeat intervals: the server
                # (or the path to it) is gone.
                _METRICS.hb_miss.inc()
                reason = "heartbeat deadline expired"
            except (wire.WireError, OSError) as e:
                reason = str(e) or type(e).__name__
            msg = None
            if self._closing.is_set() or self.detached.is_set():
                self.close()
                return
            tracing.event("client.link_down", "lifecycle", reason=reason)
            flight.note("client.link_down", reason=reason)
            msg = self._try_reconnect(reason)
            if msg is None:
                self._mark_lost(reason)
                return

    def _try_reconnect(self, reason: str) -> Optional[dict]:
        """Supervision: re-dial with exponential backoff + jitter until
        the window/attempt budget runs out. Returns the new link's
        first message on success (the reader continues with it), None
        when the caller should declare the link lost."""
        if (not self._reconnect_enabled or self._closing.is_set()
                or self.detached.is_set()):
            return None
        log.warning("link to %s:%d failed (%s) — reconnecting",
                    self._host, self._port, reason)
        with contextlib.suppress(OSError):
            self._sock.close()
        self._reconnecting.set()
        try:
            deadline = time.monotonic() + self._window
            attempt = 0
            hint: "float | None" = None
            while (self._max_reconnects is None
                   or attempt < self._max_reconnects):
                if hint is not None:
                    # Admission control told us WHEN to come back
                    # (busy / at-capacity retry_after): honor the
                    # server's number instead of blind exponential
                    # guessing — light jitter only, so a shed fleet
                    # still doesn't re-dial in lockstep.
                    delay = hint * (0.9 + 0.2 * self._rng.random())
                    hint = None
                else:
                    delay = min(self._backoff_cap,
                                self._backoff_base * (2 ** min(attempt, 20)))
                    delay *= 0.5 + self._rng.random()  # jitter: [0.5x, 1.5x)
                if time.monotonic() + delay >= deadline:
                    return None
                if self._closing.wait(delay):
                    return None
                attempt += 1
                try:
                    sock, msg = self._dial()
                except (UnauthorizedError, UnknownSessionError):
                    # Policy rejections — and a session that no longer
                    # exists (destroyed while we were down) — cannot be
                    # retried into existence.
                    return None
                except ServerBusyError as e:
                    # Our dead slot may not be released server-side
                    # yet (or the house is full) — exactly what the
                    # backoff exists to wait out; a retry_after hint
                    # replaces the next guess.
                    hint = e.retry_after
                    continue
                except (ConnectionError, OSError):
                    continue
                if msg is None:
                    with contextlib.suppress(OSError):
                        sock.close()
                    continue
                self._sock = sock
                self._arm_read_deadline()
                self.reconnects += 1
                _METRICS.reconnects.inc()
                tracing.event("client.reconnected", "lifecycle",
                              attempt=attempt)
                flight.note("client.reconnected", attempt=attempt)
                log.warning(
                    "reconnected to %s:%d on attempt %d — resyncing "
                    "via BoardSync", self._host, self._port, attempt,
                )
                return msg
            return None
        finally:
            self._reconnecting.clear()

    def _mark_lost(self, reason: str) -> None:
        log.warning("connection to %s:%d lost permanently (%s)",
                    self._host, self._port, reason)
        self.lost.set()
        _METRICS.lost.inc()
        tracing.event("client.lost", "lifecycle", reason=reason)
        flight.note("client.lost", reason=reason)
        # Reconnect exhaustion is this side's black-box moment: dump
        # the recent history crash-atomically (no-op without a
        # configured directory) before the caller tears down.
        flight.dump("connection-lost")
        self.close()


def apply_fbatch_raster(board: np.ndarray, msg: dict,
                        floor_turn: int) -> int:
    """Advance a shadow raster by one parsed _TAG_FBATCH frame in ONE
    vectorized XOR pass, applying only turns PAST `floor_turn` (frames
    are self-contained, so a frame straddling a resync applies just
    its suffix — the gated prefix is already inside the synced
    raster). Turn i's flips ride as D[i] = S[i] XOR S[i-1] (D[0] =
    S[0]), so the net change over applied turns t0..k-1 is the XOR of
    exactly the D rows appearing an ODD number of times in
    Σ_{t>=t0} S[t] — D[j] appears (k - max(j, t0)) times. Shared by
    the Controller and the relay tier (whose shadow is what new
    downstream observers board-sync from). Returns t0, the first
    applied row index (>= k when the whole frame was gated off);
    raises WireError on any frame/board inconsistency."""
    h, w = board.shape
    total, nb = wire.grid_words(w, h)
    try:
        # Binary frames are parse-validated upstream; a hostile JSON
        # "fbatch" reaches here with arbitrary fields, and anything
        # escaping as KeyError/AttributeError would kill reader
        # threads whose handlers expect WireError/OSError only.
        msg_nb = int(msg["nb"])
        counts = np.asarray(msg["counts"], np.int64)
        k, first = int(msg["k"]), int(msg["first_turn"])
        dbm = np.asarray(msg["dbitmaps"], np.uint32).reshape(-1, nb)
        dwords = np.asarray(msg["dwords"], np.uint32)
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise wire.WireError(f"malformed batch message: {e}") from None
    if msg_nb != nb:
        raise wire.WireError(
            f"batch bitmap rows of {msg_nb} words, this board "
            f"needs {nb}"
        )
    if total % 32 and dbm.size and np.any(
            dbm[:, -1] >> np.uint32(total % 32)):
        raise wire.WireError("batch bitmap bit outside the board grid")
    t0 = max(0, floor_turn - first + 1)
    if t0 >= k:
        return t0  # whole batch already inside the synced raster
    nzt = np.flatnonzero(counts)  # turns with a nonzero delta row
    offs = np.zeros(len(nzt) + 1, np.int64)
    np.cumsum(counts[nzt], out=offs[1:])
    reps = k - np.maximum(nzt, t0)
    sel = np.flatnonzero((reps > 0) & (reps % 2 == 1))
    if sel.size:
        acc = np.zeros(total, np.uint32)
        for i in sel:
            idx = wire._bitmap_indices(dbm[i])
            acc[idx] ^= dwords[offs[i]:offs[i + 1]]
        fw = np.flatnonzero(acc)
        if fw.size:
            bits = (acc[fw, None]
                    >> np.arange(32, dtype=np.uint32)) & 1
            rr, bb = np.nonzero(bits)
            x = fw[rr] % w
            y = (fw[rr] // w) * 32 + bb
            if y.size and int(y.max()) >= h:
                raise wire.WireError(
                    "batch mask bit past the board height"
                )
            board[y, x] ^= np.uint8(255)
    return t0


#: The name the coursework spec uses for this half of the split.
EngineClient = Controller


class SessionControl:
    """Blocking verb client for a `--serve --sessions` server
    (gol_tpu_torch.sessions): create / destroy / list / checkpoint over the
    session wire protocol. One control connection, synchronous RPCs —
    the management half; watching a session is `Controller(session=id)`.

    Verbs are IDEMPOTENT and supervised (docs/SESSIONS.md "Idempotent
    verbs"): every create/destroy/checkpoint is stamped with a
    client-generated request id (`rid`) and retried with
    deadline+backoff across link failures — the control link is
    re-dialed and re-handshaken, and the SAME rid rides every retry,
    so the server's replay window (plus its state-based fallbacks)
    makes an at-least-once verb exactly-once in effect: a retried
    create never double-creates, a retried destroy never errors. Load
    rejections (`busy`, `max-sessions`) carry a `retry_after` hint the
    retry loop honors instead of blind exponential backoff. `list` is
    read-only and simply re-executed. `retry_window=0` restores
    one-shot fail-fast semantics.

    Not thread-safe by design (one outstanding RPC at a time). The
    control link deliberately does NOT negotiate heartbeats: with no
    reader between verbs, answering beacons can't be guaranteed, and an
    hb peer silent past the eviction window would be dropped mid-idle
    — as a legacy peer (the heartbeat-less scheme) it is never evicted, so arbitrary
    idle gaps between verbs are safe. Beacons the server sends anyway
    are answered inline mid-RPC and drained at the next verb."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8030, *,
                 secret: "str | None" = None, timeout: float = 30.0,
                 retry_window: float = 30.0,
                 retry_seed: "int | None" = None):
        self._host, self._port = host, port
        self._secret = secret
        self._timeout = timeout
        self._window = max(0.0, retry_window)
        #: Seeded jitter: a chaos scenario replays its retry schedule.
        self._rng = random.Random(retry_seed)
        #: rid prefix unique across processes AND restarts — a client
        #: that crashed mid-verb and restarted must never collide with
        #: its previous incarnation's window entries.
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._rid_n = 0
        self._sock: "socket.socket | None" = None
        self._connect()

    def _connect(self) -> None:
        from gol_tpu_torch.testing import faults

        self._sock = faults.wrap("client", socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        ))
        self._sock.settimeout(self._timeout)
        hello = {"t": "hello", "sessions": True}
        if self._secret is not None:
            hello["secret"] = self._secret
        try:
            wire.send_msg(self._sock, hello)
            first = wire.recv_msg(self._sock, allow_binary=False)
        except (TimeoutError, wire.WireError, OSError) as e:
            self.close()
            raise ConnectionError(
                f"session-control handshake with {self._host}:"
                f"{self._port} failed: {e}"
            ) from None
        if first is None or first.get("t") == "error":
            reason = (first or {}).get("reason", "rejected")
            self.close()
            if reason == "unauthorized":
                raise UnauthorizedError(reason)
            if reason in ("busy", "at-capacity"):
                raise ServerBusyError(
                    reason,
                    sanitize_retry_after(first.get("retry_after")),
                )
            raise ConnectionError(reason)
        if not first.get("sessions"):
            self.close()
            raise ConnectionError(
                "server does not speak the session protocol "
                "(start it with --serve --sessions)"
            )

    def _next_rid(self) -> str:
        self._rid_n += 1
        return f"{self._rid_prefix}-{self._rid_n}"

    def _rpc(self, msg: dict) -> dict:
        wire.send_msg(self._sock, msg)
        deadline = time.monotonic() + self._timeout
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("session verb timed out")
            reply = wire.recv_msg(self._sock, allow_binary=False)
            if reply is None:
                raise ConnectionError("server closed the control link")
            t = reply.get("t")
            if t == "hb":
                with contextlib.suppress(OSError, wire.WireError):
                    wire.send_msg(self._sock, {"t": "hb"})
                continue
            if t == "session-r" and reply.get("op") == msg.get("op"):
                if ("rid" in msg and reply.get("rid") is not None
                        and reply["rid"] != msg["rid"]):
                    continue  # a predecessor's late reply, not ours
                return reply
            # clk echoes / future kinds: ignorable (forward compat).

    #: Transient reply reasons the retry loop waits out (everything
    #: else — unknown-session, bad-rule, exists — is a real answer).
    _TRANSIENT = ("busy", "max-sessions", "at-capacity")

    def _checked(self, msg: dict, idempotent: bool = False) -> dict:
        """One verb, supervised: re-dial + resend (same rid) on link
        failures, wait out transient rejections honoring retry_after,
        raise the first durable error. With `idempotent=False` (list)
        the verb is still retried — re-executing a read is safe."""
        from gol_tpu_torch.sessions.manager import SessionError

        if idempotent and self._window > 0:
            msg = {**msg, "rid": self._next_rid()}
        deadline = time.monotonic() + self._window
        attempt = 0
        hint: "float | None" = None
        while True:
            try:
                if self._sock is None:
                    self._connect()
                reply = self._rpc(msg)
            except UnauthorizedError:
                raise
            except (TimeoutError, ConnectionError, wire.WireError,
                    OSError) as e:
                # Link-level failure: the verb may or may not have
                # landed — exactly what the rid exists for. Tear the
                # link down and retry the SAME message.
                if isinstance(e, ServerBusyError):
                    hint = e.retry_after
                self.close()
                self._sock = None
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"session verb {msg.get('op')!r} failed after "
                        f"{self._window:.0f}s of retries: {e}"
                    ) from None
            else:
                if reply.get("ok"):
                    return reply
                reason = reply.get("reason", "rejected")
                if (reason not in self._TRANSIENT
                        or time.monotonic() >= deadline):
                    raise SessionError(reason)
                hint = sanitize_retry_after(reply.get("retry_after"))
            if hint is not None:
                delay = hint * (0.9 + 0.2 * self._rng.random())
                hint = None
            else:
                delay = min(1.0, 0.05 * (2 ** min(attempt, 10)))
                delay *= 0.5 + self._rng.random()
            attempt += 1
            time.sleep(min(delay, max(0.0,
                                      deadline - time.monotonic())))

    def create(self, sid: str, *, width: int, height: int,
               rule: "str | None" = None, seed: "int | None" = None,
               density: float = 0.25) -> dict:
        msg = {"t": "session", "op": "create", "id": sid,
               "width": width, "height": height, "density": density}
        if rule is not None:
            msg["rule"] = rule
        if seed is not None:
            msg["seed"] = seed
        return self._checked(msg, idempotent=True)["session"]

    def destroy(self, sid: str) -> None:
        self._checked({"t": "session", "op": "destroy", "id": sid},
                      idempotent=True)

    def list(self) -> list:
        return self._checked({"t": "session", "op": "list"})["sessions"]

    def checkpoint(self, sid: str) -> dict:
        r = self._checked({"t": "session", "op": "checkpoint", "id": sid},
                          idempotent=True)
        return {"path": r.get("path"), "turn": r.get("turn")}

    def park(self, sid: str) -> dict:
        """Hibernate a session (docs/SESSIONS.md "Hibernation"):
        checkpoint + free its device slot; the next attach (a
        Controller with session=sid) rehydrates it bit-exactly.
        Idempotent under retry — a rid-retried park whose first
        attempt landed answers ok."""
        r = self._checked({"t": "session", "op": "park", "id": sid},
                          idempotent=True)
        return {"id": r.get("id"), "turn": r.get("turn")}

    def adopt(self, sid: str, source: str) -> dict:
        """Materialize a session hibernated under ANOTHER engine's
        out tree (control-plane migration): the server reads
        `source`'s sidecar + latest snapshot, creates the session
        resident at the snapshot turn, and re-checkpoints into its
        OWN tree before acking. Idempotent under retry: an adopt
        whose first attempt landed answers ok on the rid re-send."""
        r = self._checked(
            {"t": "session", "op": "adopt", "id": sid,
             "source": source},
            idempotent=True,
        )
        return r["session"]

    def drain(self) -> dict:
        """Checkpoint every resident session and stop admitting new
        session attaches — the safe prelude to a rolling restart with
        `--resume latest` (control plane). Idempotent: a
        retried drain re-checkpoints and stays draining."""
        r = self._checked({"t": "session", "op": "drain"},
                          idempotent=True)
        return {"checkpointed": r.get("checkpointed"),
                "draining": bool(r.get("draining"))}

    def close(self) -> None:
        if self._sock is None:
            return
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._sock.close()

    def __enter__(self) -> "SessionControl":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
