"""ReplayServer — a recorded run served as bytes, zero engine dispatches.

The CDN-shaped answer to viral traffic : N observers
of a popular RECORDED board cost file reads and queue pushes, never a
stepper dispatch — this process does not own a device, does not import
a stepper, and `gol_tpu_engine_dispatches_total` does not exist on its
/metrics (the replay bench lane and scripts/replay_smoke.sh gate on
exactly that).

It is the relay tier with a directory for an upstream: the same wire
protocol (hello/secret/attach-ack, heartbeats + idle eviction, the
degradation machinery on the writer pool's queues), the same
zero-re-encode forwarding (`_Conn.send_raw` on the VERBATIM payloads
the recorder wrote), and it composes under the relay tree — a
`--relay` node attaches to a replay server exactly as it would to a
live root, so one recording fans out to 10⁵ browsers through the same
broadcast tiers.

Per recording, one PUMP thread walks the segment log and broadcasts
each record to the attached observers, paced by the recorded wall-
clock deltas (the run replays at the speed it happened) or by
`--replay-rate R` turns/s (0 = flat out). Observers attaching
mid-stream catch up from the current segment's keyframe; `{"t":"seek",
"turn":T}` rewinds ONE observer to the nearest <= T keyframe plus the
FBATCH suffix (the same apply path), parks it there (`scrub`), and
`{"t":"seek","turn":"live"}` rejoins the broadcast position.
"""

from __future__ import annotations

import contextlib
import hmac
import logging
import socket
import threading
import time
from typing import Optional

from gol_tpu_torch import obs
from gol_tpu_torch.distributed import wire
from gol_tpu_torch.distributed.server import (
    _Conn,
    _METRICS as _SRV,
    _clamp_batch,
    install_lag_gauge,
    publish_listen_addr,
    remove_lag_gauge,
)
from gol_tpu_torch.obs import flight, tracing
from gol_tpu_torch.obs.freshness import ServerFreshness
from gol_tpu_torch.relay.writerpool import WriterPool
from gol_tpu_torch.replay.log import (
    fbatch_span,
    find_recordings,
    read_records,
    scan_segments,
    seek_frames,
)
from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["ReplayServer"]

log = logging.getLogger(__name__)


class _ReplayMetrics:
    def __init__(self):
        self.recordings = obs.gauge(
            "gol_tpu_replay_recordings",
            "Recordings this replay server is serving (the series "
            "obs.console keys replay rows on)",
        )
        self.serves = obs.counter(
            "gol_tpu_replay_serves_total",
            "Observer attaches served from recordings",
        )
        self.seeks = obs.counter(
            "gol_tpu_replay_seeks_total",
            "Seek verbs answered (live rejoins included)",
        )
        self.turns = obs.counter(
            "gol_tpu_replay_turns_total",
            "Recorded turns pumped through the broadcast position "
            "(feeds the console's turns/s)",
        )
        self.position = obs.gauge(
            "gol_tpu_replay_position_turn",
            "Deepest broadcast position across recordings (the "
            "console's TURN column for replay rows)",
        )
        self.frames = obs.counter(
            "gol_tpu_replay_forwarded_frames_total",
            "Recorded frames enqueued to observers (verbatim bytes, "
            "zero re-encode)",
        )
        self.bytes = obs.counter(
            "gol_tpu_replay_forwarded_bytes_total",
            "Recorded payload bytes enqueued to observers",
        )


_METRICS = _ReplayMetrics()

#: Ceiling on one recorded inter-frame gap honored by timestamp
#: pacing — a recording that idled for an hour (parked session,
#: paused engine) replays the pause as a beat, not an hour.
PACE_GAP_CAP = 5.0


class _Recording:
    """One recording's broadcast state: the pump's position, the
    current segment's payloads (what a mid-stream attach catches up
    from), and the attached observers. `lock` orders catch-up/seek
    serving against the pump's broadcasts — an observer can never see
    a frame from before its own BoardSync."""

    def __init__(self, sid: str, root: str):
        self.sid = sid
        self.root = root
        self.lock = lockcheck.make_lock("_Recording.lock")
        self.conns: "list[_Conn]" = []
        #: Current segment's payloads, keyframe first.
        self.catchup: "list[bytes]" = []
        self.keyframe_turn = -1
        self.turn = -1
        self.started = False
        self.finished = False


class ReplayServer:
    """Serve the recordings under `path` (a sessions root, a session
    dir, or a bare replay dir — log.find_recordings) on the ordinary
    wire protocol, with zero engine dispatches."""

    HELLO_TIMEOUT = 10.0
    DRAIN_TIMEOUT = 5.0
    HB_MISS_LIMIT = 3
    REPLAY_WINDOW = 512  # rid replay entries (the SessionServer bound)

    def __init__(
        self,
        path: str,
        host: str = "127.0.0.1",
        port: int = 8030,
        *,
        secret: Optional[str] = None,
        replay_rate: Optional[float] = None,
        heartbeat_secs: float = 2.0,
        evict_secs: Optional[float] = None,
        max_peers: Optional[int] = None,
        high_water: Optional[int] = None,
        drain_secs: Optional[float] = None,
        retry_after_secs: float = 1.0,
        batch_turns: int = 1024,
        writer_pool_threads: int = 2,
        pump_paused: bool = False,
    ):
        recs = find_recordings(path)
        if not recs:
            raise ValueError(f"no recordings under {path!r} "
                             "(expected seg-*.glog segment logs)")
        self.path = path
        self._recordings = {
            sid: _Recording(sid, root) for sid, root in sorted(recs.items())
        }
        _METRICS.recordings.set(len(self._recordings))
        #: None = pace by recorded timestamps; > 0 = turns/s; 0 = flat
        #: out (bench/smoke mode).
        self.replay_rate = replay_rate
        self._secret = secret
        self.max_peers = max_peers
        self.high_water = high_water
        self.drain_secs = drain_secs
        self.retry_after_secs = max(0.0, retry_after_secs)
        self.batch_turns = max(0, batch_turns)
        self.heartbeat_secs = max(0.0, heartbeat_secs)
        self.evict_secs = (evict_secs if evict_secs is not None
                           else 3.0 * self.heartbeat_secs)
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        publish_listen_addr(self.address)
        #: Freshness plane: observers age against their recording's
        #: PUMP position (clocks keyed by sid) — a replay tier serves
        #: the same turn-age SLO a live tier does.
        self.freshness = ServerFreshness("replay")
        self.pool = (WriterPool(writer_pool_threads, "gol-replay-writer")
                     if writer_pool_threads > 0 else None)
        self._conn_lock = lockcheck.make_lock("ReplayServer._conn_lock")
        self._conns: "list[_Conn]" = []
        self._by_conn: "dict[_Conn, _Recording]" = {}
        self._replay: "dict[str, dict]" = {}
        self._replay_lock = lockcheck.make_lock("ReplayServer._replay_lock")
        #: Pumps gate on this before their first record — normally
        #: open; `pump_paused=True` holds playback until
        #: `release_pumps()` so an embedder (the bench lane) can
        #: attach a whole observer fleet before a flat-out
        #: (`replay_rate=0`) run starts.
        self._pump_hold = threading.Event()
        if not pump_paused:
            self._pump_hold.set()
        self._shutdown = threading.Event()
        self.done = threading.Event()
        self._threads: "list[threading.Thread]" = []

    # --- lifecycle ---

    def start(self) -> "ReplayServer":
        loops = [(self._accept_loop, "gol-replay-accept")]
        if self.heartbeat_secs > 0:
            loops.append((self._heartbeat_loop, "gol-replay-heartbeat"))
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
            # SHUT_RDWR first (the servers' zombie-accept note).
            self._listener.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._listener.close()
        with self._conn_lock:
            conns, self._conns = list(self._conns), []
            self._by_conn.clear()
        for rec in self._recordings.values():
            with rec.lock:
                rec.conns = []
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
        with self._conn_lock:
            peers = len(self._conns)
        return {
            "status": ("shutting-down" if self._shutdown.is_set()
                       else "ok"),
            "role": "replay",
            "recordings": len(self._recordings),
            "peers": peers,
            "turn": max((r.turn for r in self._recordings.values()),
                        default=-1),
            "address": list(self.address),
        }

    # --- accept path (the SessionServer shape, minus the engine) ---

    def _accept_loop(self) -> None:
        from gol_tpu_torch.testing import faults

        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            sock = faults.wrap("server", sock)
            _SRV.accepts.inc()
            try:
                sock.settimeout(self.HELLO_TIMEOUT)
                hello = wire.recv_msg(sock, allow_binary=False)
                if not hello or hello.get("t") != "hello":
                    raise wire.WireError(f"bad hello: {hello!r}")
            except (wire.WireError, OSError, ValueError) as e:
                log.warning("replay rejecting connection from %s: %s",
                            addr, e)
                _SRV.rejects["bad-hello"].inc()
                sock.close()
                continue
            if self._secret is not None and not hmac.compare_digest(
                str(hello.get("secret", "")).encode("utf-8", "replace"),
                self._secret.encode("utf-8", "replace"),
            ):
                log.warning("replay rejecting unauthenticated attach "
                            "from %s", addr)
                _SRV.rejects["unauthorized"].inc()
                with contextlib.suppress(Exception):
                    wire.send_msg(
                        sock, {"t": "error", "reason": "unauthorized"}
                    )
                sock.close()
                continue
            self._admit(sock, hello)

    def _reject(self, sock, reason: str, **extra) -> None:
        with contextlib.suppress(Exception):
            wire.send_msg(sock, {"t": "error", "reason": reason, **extra})
        sock.close()

    def _pick_recording(self, hello: dict) -> "Optional[_Recording]":
        sid = hello.get("session")
        if sid is None:
            if len(self._recordings) == 1:
                return next(iter(self._recordings.values()))
            return None
        return self._recordings.get(sid) if isinstance(sid, str) else None

    def _admit(self, sock: socket.socket, hello: dict) -> None:
        if (self.max_peers is not None
                and len(self._conns) >= self.max_peers):
            _SRV.rejects["at-capacity"].inc()
            self._reject(sock, "at-capacity",
                         retry_after=self.retry_after_secs)
            return
        rec = self._pick_recording(hello)
        if rec is None:
            self._reject(sock, "unknown-session")
            return
        if not hello.get("binary") or not hello.get("want_flips"):
            # Recorded frames are binary FBATCH payloads forwarded
            # verbatim — re-encoding for legacy peers would break the
            # whole tier's invariant (the relay's capability floor).
            self._reject(sock, "replay-binary-only")
            return
        hb = bool(hello.get("hb", False)) and self.heartbeat_secs > 0
        conn = _Conn(sock, True, binary=True, role="observe", hb=hb,
                     batch=_clamp_batch(hello, self.batch_turns),
                     high_water=self.high_water,
                     drain_secs=self.drain_secs, pool=self.pool)
        with self._conn_lock:
            self._conns.append(conn)
            self._by_conn[conn] = rec
            _SRV.peers.set(len(self._conns))
        _SRV.attaches["observe"].inc()
        install_lag_gauge(conn)
        ack = {"t": "attach-ack", "clock": True, "depth": 0,
               "replay": True, "session": rec.sid}
        if conn.batch:
            ack["batch"] = conn.batch
        if hb:
            ack["hb_secs"] = self.heartbeat_secs
        try:
            conn.send(ack)
            conn.start_writer(self._drop_conn)
        except (wire.WireError, OSError):
            self._drop_conn(conn)
            return
        _METRICS.serves.inc()
        tracing.event("replay.attach", "lifecycle", token=conn.token,
                      recording=rec.sid)
        flight.note("replay.attach", token=conn.token, recording=rec.sid)
        # Catch-up + membership in ONE critical section against the
        # pump: the keyframe this peer syncs from and the first
        # broadcast frame it receives are adjacent in the recording.
        with rec.lock:
            self._ensure_pump(rec)
            if rec.catchup:
                try:
                    self._send_catchup(conn, rec.keyframe_turn,
                                       rec.catchup)
                    conn.note_written(rec.turn)
                except (wire.WireError, OSError):
                    self._drop_conn(conn)
                    return
            rec.conns.append(conn)
        threading.Thread(
            target=self._reader_loop, args=(conn,),
            name="gol-replay-reader", daemon=True,
        ).start()

    def _send_catchup(self, conn: _Conn, keyframe_turn: int,
                      payloads: "list[bytes]") -> None:
        """Keyframe + suffix, verbatim bytes (the seek answer shape).
        Control-plane: never shed — it IS the resync."""
        catchup_conn(conn, keyframe_turn, payloads)

    def _drop_conn(self, conn: _Conn) -> None:
        with self._conn_lock:
            removed = conn in self._conns
            if removed:
                self._conns.remove(conn)
            rec = self._by_conn.pop(conn, None)
            _SRV.peers.set(len(self._conns))
        if rec is not None:
            with rec.lock:
                with contextlib.suppress(ValueError):
                    rec.conns.remove(conn)
        if removed:
            _SRV.detaches.inc()
            remove_lag_gauge(conn)
            self.freshness.forget(conn.token)
            tracing.event("replay.detach", "lifecycle", token=conn.token)
        conn.close()

    # --- the pump: one thread per recording, file -> broadcast ---

    def _ensure_pump(self, rec: _Recording) -> None:
        """Start a recording's pump at its FIRST observer (caller
        holds rec.lock) — an unwatched recording costs nothing, not
        even file reads (the static-cache ideal)."""
        if rec.started:
            return
        rec.started = True
        t = threading.Thread(target=self._pump, args=(rec,),
                             name=f"gol-replay-pump-{rec.sid}",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _pace(self, prev_ts: Optional[float], ts: float,
              turns: int) -> None:
        if self.replay_rate is not None:
            if self.replay_rate > 0 and turns:
                self._shutdown.wait(turns / self.replay_rate)
            return
        if prev_ts is not None and ts > prev_ts:
            self._shutdown.wait(min(ts - prev_ts, PACE_GAP_CAP))

    def release_pumps(self) -> None:
        """Open the playback gate (see `pump_paused`)."""
        self._pump_hold.set()

    def _pump(self, rec: _Recording) -> None:
        while not self._pump_hold.wait(0.1):
            if self._shutdown.is_set():
                return
        prev_ts = None
        for seg_turn, path in scan_segments(rec.root):
            for ts, payload in read_records(path):
                if self._shutdown.is_set():
                    return
                if payload[:1] and payload[0] == wire._TAG_BOARD:
                    self._pace(prev_ts, ts, 0)
                    with rec.lock:
                        rec.catchup = [payload]
                        rec.keyframe_turn = seg_turn
                        rec.turn = max(rec.turn, seg_turn)
                        self.freshness.note_commit(rec.turn, key=rec.sid)
                        for conn in list(rec.conns):
                            if conn.scrub:
                                continue
                            try:
                                self._send_catchup(conn, seg_turn,
                                                   [payload])
                                conn.note_written(rec.turn)
                            except (wire.WireError, OSError):
                                self._drop_conn(conn)
                else:
                    span = fbatch_span(payload)
                    if span is None:
                        continue  # unknown/torn record kinds are skipped
                    first, last = span
                    self._pace(prev_ts, ts, last - first + 1)
                    with rec.lock:
                        rec.catchup.append(payload)
                        if last > rec.turn:
                            _METRICS.turns.inc(last - max(rec.turn,
                                                          first - 1))
                            rec.turn = last
                            self.freshness.note_commit(last, key=rec.sid)
                        self._broadcast(rec, payload, last)
                    _METRICS.position.set(max(
                        r.turn for r in self._recordings.values()
                    ))
                prev_ts = ts
        rec.finished = True
        tracing.event("replay.finished", "lifecycle", recording=rec.sid,
                      turn=rec.turn)
        flight.note("replay.finished", recording=rec.sid, turn=rec.turn)

    def _broadcast(self, rec: _Recording, payload: bytes,
                   last_turn: int) -> None:
        """One recorded stream frame to every attached observer
        (caller holds rec.lock): verbatim bytes, degradation shedding per
        peer, drain-recovery via a catch-up resync from the current
        keyframe."""
        for conn in list(rec.conns):
            if conn.lag_metric is not None:
                conn.lag_metric.set(conn.queued())
            if conn.scrub:
                continue  # parked at a seek position
            if conn.drained():
                conn.resync_pending = True
                with contextlib.suppress(wire.WireError, OSError):
                    self._send_catchup(conn, rec.keyframe_turn,
                                       rec.catchup)
                    conn.note_written(rec.turn)
                continue
            if not conn.synced or last_turn <= conn.synced_turn:
                continue
            try:
                if not conn.offer_stream():
                    continue
                conn.send_raw(payload)
                conn.note_written(last_turn)
                _METRICS.frames.inc()
                _METRICS.bytes.inc(len(payload))
            except (wire.WireError, OSError):
                self._drop_conn(conn)

    # --- observer control plane (seek verbs, clk, q) ---

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
            if t == "seek":
                self._handle_seek(conn, msg)
                continue
            if t == "key":
                if msg.get("key") == "q":
                    with contextlib.suppress(Exception):
                        conn.send({"t": "detached"})
                    conn.finish()
                    self._drop_conn(conn)
                    return
                with contextlib.suppress(Exception):
                    conn.send({"t": "error", "reason": "replay"})

    def _replay_lookup(self, rid: str) -> Optional[dict]:
        with self._replay_lock:
            return self._replay.get(rid)

    def _replay_record(self, rid: str, reply: dict) -> None:
        with self._replay_lock:
            self._replay[rid] = reply
            while len(self._replay) > self.REPLAY_WINDOW:
                del self._replay[next(iter(self._replay))]

    def _handle_seek(self, conn: _Conn, msg: dict) -> None:
        reply = serve_seek(
            conn, msg, self._by_conn.get(conn),
            replay_lookup=self._replay_lookup,
            replay_record=self._replay_record,
        )
        with contextlib.suppress(wire.WireError, OSError):
            conn.send(reply)

    # --- liveness (the relay's downstream discipline) ---

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, self.heartbeat_secs / 2.0)
        while not self._shutdown.wait(interval):
            now = time.monotonic()
            with self._conn_lock:
                conns = list(self._conns)
                recs = dict(self._by_conn)
            self.freshness.sample(
                (c, recs[c].sid) for c in conns if c in recs
            )
            for conn in conns:
                if not conn.writer_started:
                    continue
                if conn.degraded:
                    if (now - conn.degraded_since > conn.drain_secs
                            and conn.queued() > conn.LOW_WATER):
                        log.warning(
                            "evicting replay peer %d: wedged %.1fs "
                            "past the drain deadline", conn.token,
                            now - conn.degraded_since,
                        )
                        if conn.count_overflow():
                            _SRV.overflows.inc()
                        self._drop_conn(conn)
                    continue
                if (conn.hb and conn.hb_unanswered >= self.HB_MISS_LIMIT
                        and now - conn.last_rx > self.evict_secs):
                    log.warning("evicting unresponsive replay peer %d",
                                conn.token)
                    _SRV.evicted.inc()
                    self._drop_conn(conn)
                    continue
                if now - conn.last_tx >= self.heartbeat_secs:
                    rec = self._by_conn.get(conn)
                    turn = rec.turn if rec is not None else 0
                    try:
                        conn.send_raw(wire.heartbeat_to_frame(max(turn, 0)))
                    except (wire.WireError, OSError):
                        self._drop_conn(conn)
                        continue
                    _SRV.heartbeats.inc()
                    if conn.hb:
                        conn.hb_unanswered += 1


def catchup_conn(conn, keyframe_turn: int,
                 payloads: "list[bytes]") -> None:
    """The ONE resync-from-recorded-bytes sequence (attach catch-up,
    drain recovery, seek serving, live rejoin all share it): forward
    the keyframe + suffix verbatim, then reset the peer's stream
    state so gating and the delta chain restart at the keyframe."""
    for payload in payloads:
        conn.send_raw(payload)
        _METRICS.frames.inc()
        _METRICS.bytes.inc(len(payload))
    conn.synced = True
    conn.synced_turn = keyframe_turn
    conn.delta_prev = None
    conn.mark_recovered()


def valid_seek_turn(turn) -> bool:
    """A seek's "turn" operand: a non-negative plausible int (bools —
    JSON true/false — are ints to Python and are hostile here) or the
    literal "live". Everything else is a reasoned 'bad-turn'."""
    if turn == "live":
        return True
    return (isinstance(turn, int) and not isinstance(turn, bool)
            and 0 <= turn < (1 << 62))


def serve_seek(conn, msg: dict, target,
               replay_lookup=None, replay_record=None) -> dict:
    """The ONE seek implementation both serving planes share (the
    SessionServer passes a recording log dir + live-resync callback,
    the ReplayServer its _Recording): validate the verb, rid-replay a
    completed one verbatim, serve the nearest <= T keyframe's BoardSync
    plus the FBATCH suffix through `conn` (raw bytes, the ordinary
    client apply path), park the peer (`conn.scrub`) until a
    {"turn":"live"} rejoin. Returns the reply dict (ok/reason/turn/
    keyframe), which the caller sends AFTER the frames — the reply is
    the completion marker.

    `target` duck-types: `.root` (log dir), `.lock` (orders the served
    frames against the live/broadcast stream), and optionally
    `.catchup`/`.keyframe_turn`/`.turn` (broadcast position, for
    "live" rejoins) or `.resync_live(conn)` (the session plane's
    engine-thread resync)."""
    rid = msg.get("rid")
    if not (isinstance(rid, str) and 0 < len(rid) <= 128):
        rid = None
    if rid is not None and replay_lookup is not None:
        cached = replay_lookup(rid)
        if cached is not None:
            return cached
    reply = {"t": "seek-r", "ok": False}
    if rid is not None:
        reply["rid"] = rid
    turn = msg.get("turn")
    if not valid_seek_turn(turn):
        reply["reason"] = "bad-turn"
        return reply
    if target is None:
        reply["reason"] = "not-recorded"
        return reply
    if not conn.binary:
        reply["reason"] = "binary-only"
        return reply
    _METRICS.seeks.inc()
    if turn == "live":
        try:
            if hasattr(target, "resync_live"):
                # Session plane: the fresh BoardSync must come from
                # the engine thread, post-commit (the drain-resync
                # ordering) — scrub clears THERE, atomically with the
                # sync, so no live chunk can slip in between.
                target.resync_live(conn)
                reply.update(ok=True, turn=conn.synced_turn)
                return _record(reply, rid, replay_record)
            with target.lock:
                # Broadcast plane (replay server): rejoin from the
                # current segment's keyframe, verbatim bytes.
                conn.scrub = False
                catchup_conn(conn, target.keyframe_turn, target.catchup)
                reply.update(ok=True, turn=target.turn,
                             keyframe=target.keyframe_turn)
            return _record(reply, rid, replay_record)
        except (wire.WireError, OSError):
            raise
        except ValueError as e:
            # SessionError from a live resync (parked/destroyed in
            # between): its message is the wire reason.
            reply["reason"] = str(e) or "unavailable"
            return reply
        except Exception:
            reply["reason"] = "io-error"
            return reply
    try:
        got = seek_frames(target.root, int(turn))
    except OSError:
        got = None
    if got is None:
        reply["reason"] = "not-recorded"
        return reply
    keyframe, landed, payloads = got
    with target.lock:
        # Park FIRST, then serve: once scrub is visible under the
        # lock, no live/broadcast frame can interleave after our
        # BoardSync (which would XOR garbage onto the seeked board).
        conn.scrub = True
        catchup_conn(conn, keyframe, payloads)
    tracing.event("replay.seek", "wire", turn=turn, keyframe=keyframe,
                  landed=landed)
    reply.update(ok=True, turn=landed, keyframe=keyframe)
    return _record(reply, rid, replay_record)


def _record(reply: dict, rid, replay_record) -> dict:
    if rid is not None and replay_record is not None and reply.get("ok"):
        replay_record(rid, reply)
    return reply
