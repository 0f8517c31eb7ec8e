"""Relay node — store-and-forward fan-out with zero re-encode.

One engine cannot talk to 10⁵–10⁶ watchers directly: even with
encode-once batching the root still pays O(peers) queue pushes
AND holds every TCP connection. A depth-log broadcast TREE is the
standard answer (every CDN and pub-sub system converges on it), and
the _TAG_FBATCH frames are deliberately self-contained — so a relay
is a BYTE-COPY problem, not an encode problem:

- UPSTREAM the relay attaches exactly like a batching binary client
  (hello binary+batch, observe role): it receives FBATCH frames, board
  syncs, heartbeats. reconnect+backoff and clock sync
  compose PER HOP — the relay re-syncs its clock against its upstream
  and answers downstream probes with its own clock PLUS that offset,
  so offsets sum along the path and a leaf's latency readings are
  against the ROOT's emit stamps.
- DOWNSTREAM it re-serves N observers on the same wire protocol,
  forwarding the IDENTICAL frame bytes (`wire.recv_frame` keeps the
  raw payload; `_Conn.send_raw` length-prefixes the same bytes — no
  encoder runs per peer, ever). Only per-stream state is local: each
  downstream's BoardSync (encoded from the relay's shadow raster at
  attach/recovery) and its synced_turn gate.
- The degradation machinery runs per downstream on the writer
  pool's queues: a wedged observer sheds FRAMES (whole batches), is
  made whole by ONE coalescing BoardSync from the shadow raster when
  it drains, and is evicted only past the drain deadline.
- The WebSocket gateway (`relay.ws`, CLI --ws-port) is a leaf tier on
  the same abstraction: browser observers get the identical binary
  payloads inside WS binary messages, pings carry the heartbeat
  plane.

A relay's /metrics sidecar exports depth/upstream labels
(`gol_tpu_relay_depth`, `gol_tpu_relay_node_info{listen,upstream}`)
so `obs.console` renders the whole tree from scrapes alone.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import logging
import random
import socket
import threading
import time
from typing import Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.distributed import wire
from gol_tpu_torch.distributed.client import apply_fbatch_raster, \
    sanitize_retry_after
from gol_tpu_torch.distributed.server import (
    _Conn,
    _forget_peer_usage,
    install_lag_gauge,
    remove_lag_gauge,
)
from gol_tpu_torch.obs import accounting, flight, tracing
from gol_tpu_torch.obs.freshness import ServerFreshness, sane_lag
from gol_tpu_torch.relay import ws as wsproto
from gol_tpu_torch.relay.writerpool import WriterPool
from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["RelayNode", "WSConn"]

log = logging.getLogger(__name__)


class _RelayMetrics:
    def __init__(self):
        self.depth = obs.gauge(
            "gol_tpu_relay_depth",
            "Hops from the root engine (root serves depth 0; a relay "
            "attached to it is depth 1)",
        )
        self.peers = obs.gauge(
            "gol_tpu_relay_peers", "Downstream observers attached",
        )
        self.ws_peers = obs.gauge(
            "gol_tpu_relay_ws_peers",
            "Downstream observers attached over WebSocket",
        )
        self.forwarded = obs.counter(
            "gol_tpu_relay_forwarded_frames_total",
            "Stream frames forwarded downstream (byte-identical, "
            "zero re-encode)",
        )
        self.forwarded_bytes = obs.counter(
            "gol_tpu_relay_forwarded_bytes_total",
            "Payload bytes forwarded downstream",
        )
        self.reconnects = obs.counter(
            "gol_tpu_relay_upstream_reconnects_total",
            "Successful upstream re-dial + re-sync cycles",
        )
        self.clock_offset = obs.gauge(
            "gol_tpu_relay_clock_offset_seconds",
            "Estimated offset of THIS hop's upstream clock chain "
            "(upstream-advertised time - local time; offsets sum "
            "along the relay path)",
        )
        self.rtt = obs.gauge(
            "gol_tpu_relay_upstream_rtt_seconds",
            "Min round-trip of the upstream clock probe — this hop's "
            "added latency is about half of it",
        )
        self.rejects = obs.counter(
            "gol_tpu_relay_rejects_total",
            "Downstream attaches rejected (bad hello, capability "
            "mismatch, capacity, auth)",
        )
        self.repoints = obs.counter(
            "gol_tpu_relay_repoints_total",
            "Upstream re-point verbs applied (control plane heal: the "
            "old link is torn down and the node re-attaches to a new "
            "upstream with a fresh BoardSync)",
        )
        self.forward_latency = obs.histogram(
            "gol_tpu_relay_forward_latency_seconds",
            "Root emit stamp -> frame arrival at THIS hop, on the "
            "summed per-hop corrected clock — successive tiers' "
            "readings decompose emit->leaf-apply into per-hop legs "
            "(docs/OBSERVABILITY.md \"Freshness plane\")",
        )


_METRICS = _RelayMetrics()


class WSConn(_Conn):
    """A downstream peer speaking RFC-6455: the identical wire frame
    payloads ride inside WS BINARY messages (no length prefix — WS
    frames self-delimit), and the heartbeat beacon is a WS ping whose
    automatic browser pong refreshes liveness."""

    def _wrap(self, payload: bytes) -> bytes:
        return wsproto.encode_frame(wsproto.OP_BINARY, payload)

    def beacon(self, turn: int) -> None:
        # Ping payload: the committed turn as ASCII — visible in any
        # browser devtools, ignorable by the auto-pong.
        frame = wsproto.encode_frame(wsproto.OP_PING,
                                     str(turn).encode("ascii"))
        if self._handle is not None:
            self._handle.enqueue(frame)
        else:
            with self._lock:
                self.sock.sendall(frame)

    def enqueue_control(self, frame: bytes) -> None:
        """Raw WS control frame (pong, close), front of the queue."""
        if self._handle is not None:
            with contextlib.suppress(Exception):
                self._handle.enqueue(frame, front=True)
        else:
            with self._lock, contextlib.suppress(OSError):
                self.sock.sendall(frame)


class RelayNode:
    """Attach upstream as one batching client; re-serve N downstream
    observers (TCP and WebSocket) with zero re-encode."""

    HELLO_TIMEOUT = 10.0
    DRAIN_TIMEOUT = 5.0
    HB_MISS_LIMIT = 3
    CLOCK_PROBES = 8

    def __init__(
        self,
        upstream: "tuple[str, int]",
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        secret: Optional[str] = None,
        session: Optional[str] = None,
        batch_turns: int = 1024,
        heartbeat_secs: float = 2.0,
        evict_secs: Optional[float] = None,
        max_peers: Optional[int] = None,
        high_water: Optional[int] = None,
        drain_secs: Optional[float] = None,
        retry_after_secs: float = 1.0,
        writer_pool_threads: int = 2,
        ws_host: Optional[str] = None,
        ws_port: Optional[int] = None,
        reconnect_window: float = 60.0,
        reconnect_seed: Optional[int] = None,
        dial_timeout: float = 30.0,
    ):
        self.upstream = (upstream[0], int(upstream[1]))
        self._secret = secret
        self._session = session
        self.batch_turns = max(1, int(batch_turns))
        self.heartbeat_secs = max(0.0, heartbeat_secs)
        self.evict_secs = (evict_secs if evict_secs is not None
                           else 3.0 * self.heartbeat_secs)
        self.max_peers = max_peers
        self.high_water = high_water
        self.drain_secs = drain_secs
        self.retry_after_secs = max(0.0, retry_after_secs)
        self._window = reconnect_window
        self._rng = random.Random(reconnect_seed)
        self._dial_timeout = dial_timeout
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._ws_listener = None
        if ws_port is not None:
            self._ws_listener = socket.create_server(
                (ws_host or host, ws_port)
            )
            self.ws_address = self._ws_listener.getsockname()
        else:
            self.ws_address = None
        for addr in (self.address, self.ws_address):
            if addr is not None and (
                self.upstream[1] == addr[1]
                and self.upstream[0] in (addr[0], "localhost")
            ):
                self._listener.close()
                if self._ws_listener is not None:
                    self._ws_listener.close()
                raise ValueError(
                    f"relay upstream {self.upstream} loops back to its "
                    "own listener — a relay cannot feed itself"
                )
        # The pool LAST: every earlier constructor failure (loopback
        # refusal, EADDRINUSE) must not leak its loop threads.
        self.pool = WriterPool(writer_pool_threads, "gol-relay-writer")
        #: Shadow raster + committed turn, advanced by every upstream
        #: frame under `_board_lock` — what a NEW downstream observer
        #: board-syncs from (the one per-stream thing a relay encodes).
        self.board: Optional[np.ndarray] = None
        self.turn = 0
        self._board_lock = lockcheck.make_lock("RelayNode._board_lock")
        #: Hops from the root: upstream's attach-ack depth + 1.
        self.depth = 1
        #: Negotiated upstream max-k (the granularity our downstream
        #: frames arrive at — re-advertised in our attach-acks).
        self.upstream_batch = 0
        #: Summed clock offset to the ROOT (upstream echoes are
        #: already root-adjusted by the upstream relay, recursively).
        self.clock_offset: Optional[float] = None
        self.upstream_rtt: Optional[float] = None
        self._clk_samples: "list[tuple[float, float]]" = []
        self._clk_left = 0
        self._up_sock: Optional[socket.socket] = None
        self._up_lock = lockcheck.make_lock(
            "RelayNode._up_lock")  # serializes upstream sends
        self._up_hb_secs = 0.0
        self.reconnects = 0
        self.synced = threading.Event()
        #: Set by repoint(): the upstream loop treats the next link
        #: death as a FRESH start (attempt/window reset) — a re-point
        #: is an operator action, not a failure of the new target.
        self._repointed = threading.Event()
        self._conns: "list[_Conn]" = []
        self._conn_lock = lockcheck.make_lock("RelayNode._conn_lock")
        self._shutdown = threading.Event()
        self.done = threading.Event()
        self._threads: "list[threading.Thread]" = []
        #: Freshness plane: downstream peers age against the relay's
        #: shadow turn (advanced by every upstream frame).
        self.freshness = ServerFreshness("relay")
        _METRICS.depth.set(self.depth)
        self._info_gauge()

    def _info_labels(self) -> dict:
        return {"listen": f"{self.address[0]}:{self.address[1]}",
                "upstream": f"{self.upstream[0]}:{self.upstream[1]}"}

    def _info_gauge(self) -> None:
        obs.gauge(
            "gol_tpu_relay_node_info",
            "Relay identity (value 1): this node's serving address "
            "and its upstream — obs.console joins these into the "
            "fan-out tree",
            self._info_labels(),
        ).set(1)

    # --- lifecycle ---

    def start(self) -> "RelayNode":
        loops = [(self._upstream_loop, "gol-relay-upstream"),
                 (self._accept_loop, "gol-relay-accept")]
        if self._ws_listener is not None:
            loops.append((self._ws_accept_loop, "gol-relay-ws-accept"))
        if self.heartbeat_secs > 0:
            loops.append((self._heartbeat_loop, "gol-relay-heartbeat"))
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
        for lst in (self._listener, self._ws_listener):
            if lst is not None:
                with contextlib.suppress(OSError):
                    # Wake any thread parked in accept() (see the
                    # servers' shutdown note) before closing.
                    lst.shutdown(socket.SHUT_RDWR)
                with contextlib.suppress(OSError):
                    lst.close()
        with contextlib.suppress(OSError):
            if self._up_sock is not None:
                self._up_sock.close()
        with self._conn_lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            with contextlib.suppress(Exception):
                conn.send({"t": "bye"})
            if isinstance(conn, WSConn):
                with contextlib.suppress(Exception):
                    conn.enqueue_control(wsproto.close_frame())
            conn.request_finish()
        deadline = time.monotonic() + self.DRAIN_TIMEOUT
        for conn in conns:
            conn.join_writer(max(0.1, deadline - time.monotonic()))
            conn.close()
        self.pool.close()
        # Evict the per-instance info child: ephemeral-port relays
        # constructed in one process (tests, embedders) must not
        # accumulate dead tree roots in the process-global registry.
        obs.registry().remove("gol_tpu_relay_node_info",
                              self._info_labels())
        self.freshness.close()
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def health(self) -> dict:
        with self._conn_lock:
            peers = len(self._conns)
        return {
            "status": ("shutting-down" if self._shutdown.is_set()
                       else "ok" if self.synced.is_set()
                       else "attaching"),
            "role": "relay",
            "depth": self.depth,
            "upstream": f"{self.upstream[0]}:{self.upstream[1]}",
            "address": list(self.address),
            "turn": self.turn,
            "peers": peers,
            "reconnects": self.reconnects,
        }

    def repoint(self, addr: "tuple[str, int]") -> dict:
        """Re-point the upstream link at a NEW address (control plane
        heal): tear the current link, swap `self.upstream`, and
        let the supervised `_upstream_loop` re-dial the new target with
        a FRESH reconnect window and a fresh BoardSync. Downstream
        peers never notice beyond the same brief stall an ordinary
        upstream reconnect causes — their frames resume byte-exact
        once the new upstream's board sync lands.

        Returns {"upstream": "host:port", "changed": bool}; raises
        ValueError for an address that would make the relay feed
        itself (same guard as the constructor)."""
        new = (str(addr[0]), int(addr[1]))
        for own in (self.address, self.ws_address):
            if own is not None and (
                new[1] == own[1] and new[0] in (own[0], "localhost")
            ):
                raise ValueError(
                    f"repoint target {new} loops back to this relay's "
                    "own listener — a relay cannot feed itself"
                )
        with self._up_lock:
            changed = new != self.upstream
            old_labels = self._info_labels()
            self.upstream = new
            sock, self._up_sock = self._up_sock, None
        if changed:
            # Swap the info-gauge child BEFORE the re-dial: the
            # console/controller tree join must see the new edge on
            # the very next scrape, not after the link comes up.
            obs.registry().remove("gol_tpu_relay_node_info", old_labels)
            self._info_gauge()
            self.clock_offset = None
            self.upstream_rtt = None
            _METRICS.repoints.inc()
            tracing.event("relay.repoint", "lifecycle",
                          upstream=f"{new[0]}:{new[1]}")
            flight.note("relay.repoint", upstream=f"{new[0]}:{new[1]}")
        self.synced.clear()
        self._repointed.set()
        if sock is not None:
            # Killing the socket makes _forward_stream raise; the
            # supervised loop then re-dials self.upstream — which now
            # names the new target. Works identically when the loop is
            # parked in a backoff wait (the _repointed flag resets its
            # attempt counter and window).
            with contextlib.suppress(OSError):
                sock.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                sock.close()
        return {"upstream": f"{new[0]}:{new[1]}", "changed": changed}

    # --- upstream: one batching binary client ---

    def _dial_upstream(self) -> socket.socket:
        from gol_tpu_torch.testing import faults

        sock = faults.wrap("client", socket.create_connection(
            self.upstream, timeout=self._dial_timeout
        ))
        sock.settimeout(self._dial_timeout)
        hello = {"t": "hello", "want_flips": True, "binary": True,
                 "compact": True, "hb": True, "delta": False,
                 "role": "observe", "batch": self.batch_turns,
                 "relay": True}
        if self._session is not None:
            hello["session"] = self._session
        if self._secret is not None:
            hello["secret"] = self._secret
        wire.send_msg(sock, hello)
        first = wire.recv_msg(sock, allow_binary=False)
        if first is None:
            raise wire.WireError("upstream closed during handshake")
        if first.get("t") == "error":
            reason = first.get("reason", "rejected")
            hint = sanitize_retry_after(first.get("retry_after"))
            raise _UpstreamRejected(reason, hint)
        if first.get("t") != "attach-ack":
            raise wire.WireError(f"unexpected first reply: {first!r}")
        self._up_hb_secs = float(first.get("hb_secs", 0) or 0)
        self.depth = int(first.get("depth", 0)) + 1
        _METRICS.depth.set(self.depth)
        self.upstream_batch = int(first.get("batch", 0) or 0)
        # Streaming deadline: three missed beacons = upstream is gone
        # (the client discipline, per hop).
        sock.settimeout(3.0 * self._up_hb_secs
                        if self._up_hb_secs > 0 else None)
        if first.get("clock"):
            self._clk_samples = []
            self._clk_left = self.CLOCK_PROBES
            # Directly on the dialing socket: _up_sock is only
            # installed after this returns, so _send_up would no-op
            # and the probe chain (echo-driven) would never start.
            with contextlib.suppress(OSError, ConnectionError,
                                     wire.WireError):
                with self._up_lock:
                    wire.send_msg(sock, {"t": "clk", "t0": time.time()})
        return sock

    def _send_up(self, msg: dict) -> None:
        with contextlib.suppress(OSError, ConnectionError,
                                 wire.WireError):
            with self._up_lock:
                if self._up_sock is not None:
                    wire.send_msg(self._up_sock, msg)

    def _upstream_loop(self) -> None:
        """Supervised forwarder: read raw frames, advance the shadow,
        fan identical bytes out; on link death, re-dial with backoff
        and resume through the upstream's BoardSync."""
        attempt = 0
        deadline = None  # armed on first failure
        while not self._shutdown.is_set():
            try:
                sock = self._dial_upstream()
            except _UpstreamRejected as e:
                if e.reason in ("unauthorized", "unknown-session"):
                    log.error("upstream rejected relay: %s", e.reason)
                    break  # policy: not retryable
                delay = (e.retry_after
                         if e.retry_after is not None else None)
                attempt, deadline, dead = self._backoff(
                    attempt, deadline, delay)
                if dead:
                    break
                continue
            except (wire.WireError, ConnectionError, OSError,
                    TimeoutError) as e:
                attempt, deadline, dead = self._backoff(
                    attempt, deadline, None)
                if dead:
                    break
                log.warning("upstream dial failed (%s) — retrying", e)
                continue
            self._up_sock = sock
            if self._repointed.is_set():
                # A repoint landed while this dial was in flight: the
                # socket may still point at the OLD upstream. Drop it
                # and re-dial — self.upstream now names the new target.
                self._repointed.clear()
                with contextlib.suppress(OSError):
                    sock.close()
                self._up_sock = None
                attempt, deadline = 0, None
                continue
            if attempt:
                self.reconnects += 1
                _METRICS.reconnects.inc()
                tracing.event("relay.reconnected", "lifecycle",
                              attempt=attempt)
                flight.note("relay.reconnected", attempt=attempt)
            attempt, deadline = 0, None
            try:
                self._forward_stream(sock)
                break  # clean end of stream (bye)
            except TimeoutError:
                reason = "upstream heartbeat deadline expired"
            except (wire.WireError, OSError, ConnectionError) as e:
                reason = str(e) or type(e).__name__
            if self._shutdown.is_set():
                break
            tracing.event("relay.link_down", "lifecycle", reason=reason)
            flight.note("relay.link_down", reason=reason)
            log.warning("upstream link failed (%s) — reconnecting",
                        reason)
            with contextlib.suppress(OSError):
                sock.close()
            self._up_sock = None
            attempt = 1
            deadline = time.monotonic() + self._window
        self.shutdown()

    def _backoff(self, attempt, deadline, hint):
        """One supervised retry wait; returns (attempt, deadline,
        exhausted)."""
        if self._repointed.is_set():
            # A repoint landed mid-backoff: the NEW target deserves a
            # fresh attempt counter and window, whatever the old
            # address had burned dialing a dead upstream.
            self._repointed.clear()
            attempt, deadline = 0, None
        if deadline is None:
            deadline = time.monotonic() + self._window
        if hint is not None:
            delay = hint * (0.9 + 0.2 * self._rng.random())
        else:
            delay = min(2.0, 0.05 * (2 ** min(attempt, 10)))
            delay *= 0.5 + self._rng.random()
        if time.monotonic() + delay >= deadline:
            log.error("upstream reconnect window exhausted")
            return attempt, deadline, True
        if self._shutdown.wait(delay):
            return attempt, deadline, True
        return attempt + 1, deadline, False

    #: Message kinds consumed at this hop, never forwarded: the relay
    #: runs its own heartbeat/clock planes per hop, and handshake
    #: replies are per-link.
    _HOP_LOCAL = ("attach-ack", "clk", "hb", "error", "detached")

    def _forward_stream(self, sock) -> None:
        while True:
            payload = wire.recv_frame(sock)
            if payload is None:
                raise wire.WireError(
                    "upstream closed the stream without a goodbye"
                )
            msg = wire.parse_payload(payload)
            t = msg.get("t")
            if t in self._HOP_LOCAL:
                self._handle_hop_local(msg)
                continue
            if t == "board":
                self._on_upstream_board(msg, payload)
                continue
            if t == "fbatch":
                # Per-hop forward latency: the frame's root emit stamp
                # against THIS hop's arrival, on the summed corrected
                # clock — hostile/absurd stamps are dropped, never
                # observed (sane_lag; the wire fuzz pin).
                lag = sane_lag(msg.get("ts"),
                               time.time() + (self.clock_offset or 0.0))
                if lag is not None:
                    _METRICS.forward_latency.observe(lag)
                with self._board_lock:
                    if self.board is None:
                        raise wire.WireError(
                            "batch frame before any upstream board sync"
                        )
                    apply_fbatch_raster(self.board, msg, self.turn)
                    self.turn = max(
                        self.turn,
                        int(msg["first_turn"]) + int(msg["k"]) - 1,
                    )
                    self.freshness.note_commit(self.turn)
                    self._forward(payload,
                                  last_turn=int(msg["first_turn"])
                                  + int(msg["k"]) - 1, flips=True)
                continue
            if t == "flips":
                # Per-turn coordinate frames (a root whose engine is
                # not in chunk mode): self-contained, forwardable.
                with self._board_lock:
                    if self.board is not None \
                            and msg["turn"] > self.turn:
                        coords = np.asarray(msg["coords"]).reshape(-1, 2)
                        if len(coords):
                            self.board[coords[:, 1], coords[:, 0]] ^= \
                                np.uint8(255)
                        self.turn = int(msg["turn"])
                    self._forward(payload, last_turn=int(msg["turn"]),
                                  flips=True)
                continue
            if t == "ev" and msg.get("k") == "turn":
                lag = sane_lag(msg.get("ts"),
                               time.time() + (self.clock_offset or 0.0))
                if lag is not None:
                    _METRICS.forward_latency.observe(lag)
                with self._board_lock:
                    self.turn = max(self.turn, int(msg.get("turn", 0)))
                    self.freshness.note_commit(self.turn)
                    self._forward(payload,
                                  last_turn=int(msg.get("turn", 0)))
                continue
            # Everything else — alive ticks, state changes, finals,
            # unknown future kinds — forwards verbatim (a relay is
            # transparent to stream content it does not interpret).
            with self._board_lock:
                self._forward(payload, last_turn=None,
                              control=t in ("ev", "bye"))
            if t == "bye":
                return  # upstream run over: propagate and finish

    def _handle_hop_local(self, msg: dict) -> None:
        t = msg.get("t")
        if t == "hb":
            self._send_up({"t": "hb"})
        elif t == "clk":
            self._on_clk_echo(msg)

    def _on_clk_echo(self, msg: dict) -> None:
        if self._clk_left <= 0:
            return
        t1 = time.time()
        try:
            pt0, ts = float(msg["t0"]), float(msg["ts"])
        except (KeyError, TypeError, ValueError):
            return
        rtt = max(0.0, t1 - pt0)
        self._clk_samples.append((rtt, ts - (pt0 + t1) / 2.0))
        self._clk_left -= 1
        if self._clk_left > 0:
            self._send_up({"t": "clk", "t0": time.time()})
            return
        rtt, off = min(self._clk_samples)
        if abs(off) <= rtt / 2.0:
            off = 0.0  # zero is inside the error bound (rule)
        self.clock_offset = off
        self.upstream_rtt = rtt
        _METRICS.clock_offset.set(off)
        _METRICS.rtt.set(rtt)
        # The relay's trace dump joins merged timelines on the ROOT's
        # timebase (upstream echoes are already root-adjusted, so the
        # summed offset is exactly report merge's correction) — what
        # makes the per-hop `turn.forward` marks decomposable.
        tracing.set_clock_offset(off)
        tracing.event("relay.clock_sync", "lifecycle",
                      offset_s=round(off, 6), rtt_s=round(rtt, 6))

    def _on_upstream_board(self, msg: dict, payload: bytes) -> None:
        """Upstream BoardSync (attach, reconnect resync, or upstream
        degradation recovery): replace the shadow and make EVERY
        downstream whole with the same bytes — the sync frame is
        control-plane (never shed) and synced_turn-gates whatever is
        still queued behind it."""
        turn, board = wire.msg_to_board(msg)
        with self._board_lock:
            self.board = np.array(board, dtype=np.uint8)
            self.turn = int(turn)
            self.synced.set()
            for conn in self._all_conns():
                if not conn.writer_started:
                    # Mid-admit: the attach-ack must be this peer's
                    # FIRST message — _admit board-syncs it from the
                    # (just-updated) shadow right after the ack.
                    continue
                self._sync_conn_locked(conn, payload)
        tracing.event("relay.board_sync", "lifecycle", turn=turn)
        flight.note("relay.board_sync", turn=turn)

    # --- downstream fan-out ---

    def _all_conns(self) -> "list[_Conn]":
        with self._conn_lock:
            return list(self._conns)

    def _forward(self, payload: bytes, last_turn: Optional[int],
                 control: bool = False, flips: bool = False) -> None:
        """Fan one upstream frame's BYTES out (caller holds
        _board_lock — forwarding is ordered against shadow advance and
        attach syncs). Stream frames gate per peer through the
        degradation machinery; `control` frames (bye, finals) always
        enqueue; `flips` frames (fbatch, coordinate flips) skip peers
        that did not subscribe to the flip plane (a -noVis leaf wants
        alive ticks and the final, not the raster stream)."""
        conns = self._all_conns()
        if last_turn is not None:
            # The hop's half of the per-turn wire correlation: one
            # instant mark per forwarded frame, on this dump's (root-
            # corrected) timebase — `report merge --hops` differences
            # successive tiers' marks into per-hop legs.
            tracing.event("turn.forward", "wire", turn=last_turn,
                          depth=self.depth)
        self.freshness.sample((c, None) for c in conns)
        for conn in conns:
            if conn.lag_metric is not None:
                conn.lag_metric.set(conn.queued())
            if conn.drained():
                self._coalesce_resync_locked(conn)
            if not conn.synced or (
                last_turn is not None
                and last_turn <= conn.synced_turn
            ):
                continue
            if flips and not conn.want_flips:
                continue
            try:
                if not control and not conn.offer_stream():
                    continue
                conn.send_raw(payload)
                if last_turn is not None:
                    conn.note_written(last_turn)
                _METRICS.forwarded.inc()
                _METRICS.forwarded_bytes.inc(len(payload))
            except (wire.WireError, OSError):
                self._drop_conn(conn)

    def _sync_conn_locked(self, conn: _Conn, payload: bytes) -> None:
        """One downstream's BoardSync (caller holds _board_lock):
        `payload` is a ready board frame to forward byte-identically;
        None encodes one fresh frame from the shadow."""
        if payload is None:
            payload = wire.board_to_frame(self.turn, self.board, 0)
        try:
            conn.send_raw(payload)
        except (wire.WireError, OSError):
            self._drop_conn(conn)
            return
        conn.synced = True
        conn.synced_turn = self.turn
        conn.note_written(self.turn)
        conn.delta_prev = None
        conn.mark_recovered()

    def _coalesce_resync_locked(self, conn: _Conn) -> None:
        """Degraded downstream drained inside the deadline: ONE
        coalescing BoardSync from the shadow makes it whole (the
        recovery, served from relay-local state — no upstream round
        trip)."""
        conn.resync_pending = True
        self._sync_conn_locked(conn, None)

    def _accept_loop(self) -> None:
        from gol_tpu_torch.testing import faults

        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            sock = faults.wrap("server", sock)
            # Handshake on its own thread (the WS side's slow-loris
            # defence, same reasoning): HELLO_TIMEOUT deadlines each
            # recv, not the whole handshake — a byte-trickling peer
            # must wedge only its own thread, never the accept loop.
            threading.Thread(
                target=self._tcp_handshake, args=(sock, addr),
                name="gol-relay-hs", daemon=True,
            ).start()

    def _tcp_handshake(self, sock, addr) -> None:
        try:
            sock.settimeout(self.HELLO_TIMEOUT)
            hello = wire.recv_msg(sock, allow_binary=False)
            if not hello or hello.get("t") != "hello":
                raise wire.WireError(f"bad hello: {hello!r}")
        except (wire.WireError, OSError, ValueError, TimeoutError) as e:
            log.warning("relay rejecting connection from %s: %s",
                        addr, e)
            _METRICS.rejects.inc()
            with contextlib.suppress(OSError):
                sock.close()
            return
        self._admit(sock, hello)

    def _reject(self, sock, reason: str, ws: bool = False,
                **extra) -> None:
        _METRICS.rejects.inc()
        msg = {"t": "error", "reason": reason, **extra}
        with contextlib.suppress(Exception):
            if ws:
                # The peer upgraded to WebSocket: the reject must be
                # a WS message + close frame, not raw wire bytes.
                sock.sendall(wsproto.encode_frame(
                    wsproto.OP_TEXT,
                    json.dumps(msg, separators=(",", ":")).encode(),
                ) + wsproto.close_frame(1002, reason))
            else:
                wire.send_msg(sock, msg)
        sock.close()

    def _admit(self, sock, hello: dict,
               make_conn=None, reader=None) -> None:
        """Shared admission for TCP and WS downstreams; hello rules:
        authenticated, binary + want_flips (the relay forwards binary
        batch frames — it cannot re-encode for legacy peers without
        breaking the zero-re-encode invariant)."""
        is_ws = make_conn is WSConn
        if self._secret is not None and not hmac.compare_digest(
            str(hello.get("secret", "")).encode("utf-8", "replace"),
            self._secret.encode("utf-8", "replace"),
        ):
            self._reject(sock, "unauthorized", ws=is_ws)
            return
        if not hello.get("binary"):
            # The capability floor of a byte-copy tier, stated as a
            # reasoned reject — never a silent incompatible stream
            # (legacy JSON peers would need per-peer re-encoding).
            self._reject(sock, "relay-binary-only", ws=is_ws)
            return
        hb = bool(hello.get("hb", False)) and self.heartbeat_secs > 0
        # Downstream max-k is NOT negotiable below the upstream's:
        # frames arrive pre-encoded at the upstream granularity and
        # forward verbatim — the ack re-advertises that k honestly
        # (peers' parsers accept any k <= FBATCH_MAX_TURNS), and a
        # hostile "batch" value in the hello is simply ignored.
        cls = make_conn if make_conn is not None else _Conn
        # want_flips per peer: a flip-less observer (-noVis leaf) gets
        # the board sync, turn/alive events, heartbeats and the final
        # — never the raster stream it didn't subscribe to.
        conn = cls(sock, bool(hello.get("want_flips", False)),
                   binary=True, role="observe", hb=hb,
                   batch=self.upstream_batch or self.batch_turns,
                   high_water=self.high_water,
                   drain_secs=self.drain_secs, pool=self.pool)
        # Admission check AND slot reservation in ONE critical
        # section: TCP accepts and WS handshakes admit on concurrent
        # threads, and a check-then-append window would let two
        # simultaneous attaches both squeeze past max_peers - 1.
        with self._conn_lock:
            admitted = (self.max_peers is None
                        or len(self._conns) < self.max_peers)
            if admitted:
                self._conns.append(conn)
                _METRICS.peers.set(len(self._conns))
                if isinstance(conn, WSConn):
                    _METRICS.ws_peers.inc()
        if not admitted:
            _METRICS.rejects.inc()
            with contextlib.suppress(Exception):
                # Via the conn, so the error is transport-framed (a
                # WS peer must get a WS message, not raw bytes).
                conn.send({"t": "error", "reason": "at-capacity",
                           "retry_after": self.retry_after_secs})
            conn.close()
            return
        ack = {"t": "attach-ack", "clock": True, "depth": self.depth,
               "batch": conn.batch}
        if hb:
            ack["hb_secs"] = self.heartbeat_secs
        try:
            conn.send(ack)
            conn.start_writer(self._drop_conn)
        except (wire.WireError, OSError):
            self._drop_conn(conn)
            return
        install_lag_gauge(conn)
        tracing.event("relay.attach", "lifecycle", token=conn.token,
                      ws=isinstance(conn, WSConn))
        flight.note("relay.attach", token=conn.token)
        # Board sync under the lock: ordered against shadow advance —
        # a frame being forwarded concurrently can never tear it.
        with self._board_lock:
            if self.board is not None:
                self._sync_conn_locked(conn, None)
            # else: pre-sync attach — the upstream's first board frame
            # fans out to every conn, this one included.
        threading.Thread(
            target=reader if reader is not None else self._reader_loop,
            args=(conn,), name="gol-relay-reader", daemon=True,
        ).start()

    def _drop_conn(self, conn: _Conn) -> None:
        with self._conn_lock:
            removed = conn in self._conns
            if removed:
                self._conns.remove(conn)
            _METRICS.peers.set(len(self._conns))
            if removed and isinstance(conn, WSConn):
                _METRICS.ws_peers.dec()
        if removed:
            remove_lag_gauge(conn)
            self.freshness.forget(conn.token)
            _forget_peer_usage(conn)
            tracing.event("relay.detach", "lifecycle", token=conn.token)
        conn.close()

    # --- downstream control plane ---

    def _clk_reply(self, conn: _Conn, msg: dict) -> None:
        """Per-hop clock composition: echo with OUR clock plus OUR
        upstream offset — the peer's estimate lands on the ROOT's
        timebase, however deep this hop is."""
        with contextlib.suppress(wire.WireError, OSError):
            conn.send_direct({
                "t": "clk", "t0": msg.get("t0"),
                "ts": time.time() + (self.clock_offset or 0.0),
            })

    def _handle_ctl(self, conn: _Conn, msg: dict) -> bool:
        """One downstream control message; False ends the reader."""
        t = msg.get("t")
        if t == "clk":
            self._clk_reply(conn, msg)
        elif t == "repoint":
            # Control-plane heal verb: re-point this relay's
            # upstream at a new address. Rides the ordinary downstream
            # link, so the relay-secret handshake already gates it.
            try:
                host, _, port = str(msg.get("addr", "")).rpartition(":")
                result = self.repoint((host, int(port)))
                reply = {"t": "repoint-r", "ok": True, **result}
            except (ValueError, TypeError) as e:
                reply = {"t": "repoint-r", "ok": False,
                         "reason": str(e) or "bad-addr"}
            with contextlib.suppress(Exception):
                conn.send_direct(reply)
        elif t == "key":
            if msg.get("key") == "q":
                self._drop_from_reader(conn)
                return False
            with contextlib.suppress(Exception):
                conn.send({"t": "error", "reason": "observer"})
        return True

    def _drop_from_reader(self, conn: _Conn) -> None:
        """Clean 'q' detach: farewell + bounded drain, then the ONE
        shared removal path (`_drop_conn`) does the books — two
        bookkeeping copies had already drifted once."""
        with contextlib.suppress(Exception):
            conn.send({"t": "detached"})
        conn.finish()
        self._drop_conn(conn)

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
            if not self._handle_ctl(conn, msg):
                return

    # --- WebSocket gateway (relay.ws) ---

    def _ws_accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, addr = self._ws_listener.accept()
            except OSError:
                return
            # Handshakes run on their own thread: a slow-loris upgrade
            # must not wedge the accept loop.
            threading.Thread(
                target=self._ws_handshake, args=(sock, addr),
                name="gol-relay-ws-hs", daemon=True,
            ).start()

    def _ws_handshake(self, sock, addr) -> None:
        try:
            sock.settimeout(self.HELLO_TIMEOUT)
            wsproto.handshake(sock)
            # First WS message must be the hello JSON.
            op, payload = wsproto.read_message(sock)
            if op not in (wsproto.OP_TEXT, wsproto.OP_BINARY) \
                    or payload is None:
                raise wsproto.WSError("expected a hello message")
            hello = json.loads(payload.decode("utf-8"))
            if not isinstance(hello, dict) \
                    or hello.get("t") != "hello":
                raise wsproto.WSError(f"bad hello: {hello!r}")
        except (wsproto.WSError, wire.WireError, OSError, ValueError,
                TimeoutError) as e:
            log.warning("ws handshake from %s failed: %s", addr, e)
            _METRICS.rejects.inc()
            with contextlib.suppress(OSError):
                sock.close()
            return
        # Browser hellos imply the binary plane (WS binary messages).
        hello.setdefault("binary", True)
        hello.setdefault("want_flips", True)
        self._admit(sock, hello, make_conn=WSConn,
                    reader=self._ws_reader_loop)

    def _ws_reader_loop(self, conn: WSConn) -> None:
        """Downstream WS reader: data messages carry the JSON control
        catalog; pings are answered, pongs refresh liveness; every
        protocol violation detaches THIS peer cleanly and nothing
        else (the fuzz sweep's pin)."""
        def on_control(op, payload):
            conn.last_rx = time.monotonic()
            conn.hb_unanswered = 0
            if op == wsproto.OP_PING:
                conn.enqueue_control(
                    wsproto.encode_frame(wsproto.OP_PONG, payload or b"")
                )

        while True:
            try:
                op, payload = wsproto.read_message(conn.sock,
                                                   on_control=on_control)
            except TimeoutError:
                if conn._dead.is_set():
                    self._drop_conn(conn)
                    return
                continue
            except (wsproto.WSError, OSError):
                with contextlib.suppress(Exception):
                    conn.enqueue_control(wsproto.close_frame(1002))
                self._drop_conn(conn)
                return
            conn.last_rx = time.monotonic()
            conn.hb_unanswered = 0
            if op == wsproto.OP_CLOSE:
                with contextlib.suppress(Exception):
                    conn.enqueue_control(wsproto.close_frame())
                self._drop_conn(conn)
                return
            if op == wsproto.OP_PING:
                conn.enqueue_control(
                    wsproto.encode_frame(wsproto.OP_PONG, payload or b"")
                )
                continue
            if op == wsproto.OP_PONG:
                continue  # the liveness refresh happened above
            try:
                msg = json.loads((payload or b"").decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue  # non-JSON data from a browser: ignorable
            if isinstance(msg, dict) and msg.get("t") == "hb":
                continue
            if isinstance(msg, dict):
                if not self._handle_ctl(conn, msg):
                    return

    # --- downstream liveness (the EngineServer discipline) ---

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, self.heartbeat_secs / 2.0)
        while not self._shutdown.wait(interval):
            now = time.monotonic()
            conns = self._all_conns()
            self.freshness.sample((c, None) for c in conns)
            # Accounting sweep (the servers' discipline, per hop):
            # each downstream's writer backlog in frame-seconds —
            # wire bytes are already charged at the _Conn choke point.
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
                    if conn.drained():
                        with self._board_lock:
                            if self.board is not None:
                                self._coalesce_resync_locked(conn)
                    elif (now - conn.degraded_since > conn.drain_secs
                          and conn.queued() > conn.LOW_WATER):
                        log.warning(
                            "evicting relay peer %d: wedged %.1fs past "
                            "the drain deadline", conn.token,
                            now - conn.degraded_since,
                        )
                        conn.count_overflow()
                        self._drop_conn(conn)
                    continue
                if (conn.hb and conn.hb_unanswered >= self.HB_MISS_LIMIT
                        and now - conn.last_rx > self.evict_secs):
                    log.warning("evicting unresponsive relay peer %d",
                                conn.token)
                    tracing.event("relay.evict", "lifecycle",
                                  token=conn.token)
                    self._drop_conn(conn)
                    continue
                if now - conn.last_tx >= self.heartbeat_secs:
                    try:
                        if isinstance(conn, WSConn):
                            conn.beacon(self.turn)
                            conn.last_tx = time.monotonic()
                        else:
                            conn.send_raw(
                                wire.heartbeat_to_frame(self.turn)
                            )
                    except Exception:
                        self._drop_conn(conn)
                        continue
                    if conn.hb:
                        conn.hb_unanswered += 1


class _UpstreamRejected(ConnectionError):
    def __init__(self, reason: str, retry_after):
        super().__init__(reason)
        self.reason = reason
        self.retry_after = retry_after
