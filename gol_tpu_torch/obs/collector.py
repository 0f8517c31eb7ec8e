"""Remote-write telemetry over the framed wire: the history plane.

Two halves:

- `RemoteWriter` rides inside EVERY metrics sidecar (`--remote-write
  HOST:PORT`): a daemon thread samples the process registry each
  interval and pushes the series that changed since the last
  acknowledged state as one `_TAG_MSAMPLES` frame (absolute values —
  the delta encoding is in the series *set*), plus a periodic full
  snapshot on the keyframe cadence and after every reconnect. The link
  follows the client discipline the distributed plane already lives
  by: connect/send deadlines, jittered exponential backoff, reconnect.
  A slow or dead collector SHEDS samples (counted on
  `gol_tpu_remote_write_shed_samples_total`) — it can never wedge the
  serving process, because nothing outside this thread ever blocks on
  the link.

- `CollectorServer` is the `--collector [HOST:]PORT` process's ingest:
  an accept loop, one reader thread per link, JSON-only hellos before
  anything binary is parsed (the engine server's pre-auth rule), every
  malformed frame surfacing as WireError that closes THAT link and
  nothing else. Accepted sample batches land in the TSDB (bounded
  rings + crash-atomic segment logs) and keep serving `/query` no
  matter what a peer throws at the socket.

Alert state transitions and span digests ride in the frame's meta
dict; the collector stores them as per-source annotations.
"""

from __future__ import annotations

import hmac
import importlib
import logging
import random
import socket
import threading
import time
from typing import Optional

from gol_tpu_torch.distributed import wire
from gol_tpu_torch.obs.scrape import parse_prometheus
from gol_tpu_torch.obs.tsdb import TSDB

_reg = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = ["CollectorServer", "RemoteWriter"]

log = logging.getLogger(__name__)

#: Source labels come from the peer's hello — bound and sanitized
#: before they become dict keys, filenames inside keyframes, or label
#: values in the console's history rows.
_SRC_RE = r"^[A-Za-z0-9._:@-]{1,64}$"

_CONNECT_TIMEOUT = 3.0
_IO_TIMEOUT = 5.0
#: A remote writer pushes every ~1 s; a link idle for this long is a
#: dead peer, not a quiet one.
_SERVER_IDLE_TIMEOUT = 60.0
_BACKOFF_CAP = 30.0


class RemoteWriter:
    """Push this process's registry to a collector, shedding on
    failure. Owned by the MetricsServer sidecar (start()/close())."""

    def __init__(self, target: str, *, source: str,
                 interval: float = 1.0,
                 registry: Optional[object] = None,
                 alerts=None, secret: Optional[str] = None,
                 keyframe_every: int = 30):
        host, _, port = target.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.source = source
        self.interval = max(0.05, float(interval))
        self.keyframe_every = max(1, int(keyframe_every))
        self._registry = registry if registry is not None \
            else _reg.registry()
        self._alerts = alerts
        self._secret = secret
        self._sock: Optional[socket.socket] = None
        self._sent: dict = {}
        self._alert_states: dict = {}
        self._pushes_since_full = 0
        self._attempt = 0
        self._retry_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pushed = _reg.counter(
            "gol_tpu_remote_write_pushed_samples_total",
            "Samples pushed to the collector",
        )
        self._shed = _reg.counter(
            "gol_tpu_remote_write_shed_samples_total",
            "Samples shed because the collector link was down or slow",
        )
        self._reconnects = _reg.counter(
            "gol_tpu_remote_write_reconnects_total",
            "Collector link (re)connect attempts that succeeded",
        )
        self._errors = _reg.counter(
            "gol_tpu_remote_write_errors_total",
            "Collector link failures (send or connect)",
        )

    # -- lifecycle --

    def start(self) -> "RemoteWriter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="gol-remote-write", daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._close_sock()

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- the push loop --

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.push_once()
            except Exception:
                # The writer must never take the sidecar down.
                log.exception("remote-write push failed unexpectedly")

    def _collect(self) -> dict:
        cur = parse_prometheus(self._registry.prometheus_text())
        # Keys past the wire bound would poison whole frames — drop
        # them here (none of our series come close to 512 chars).
        return {k: v for k, v in cur.items()
                if len(k) <= wire.MSAMPLE_KEY_MAX}

    def _meta(self, full: bool) -> Optional[dict]:
        meta = {}
        if self._alerts is not None:
            try:
                transitions = []
                for r in self._alerts.payload().get("rules", []):
                    old = self._alert_states.get(r["name"])
                    if old is not None and old != r["state"]:
                        transitions.append({"rule": r["name"],
                                            "from": old,
                                            "to": r["state"]})
                    self._alert_states[r["name"]] = r["state"]
                if transitions:
                    meta["alerts"] = transitions
            except Exception:
                log.exception("alert transition digest failed")
        if full:
            try:
                from gol_tpu_torch.obs import tracing
                spans = tracing.trace_payload().get("traceEvents", [])
                meta["spans"] = {"events": len(spans)}
            except Exception:
                pass
        return meta or None

    def push_once(self, now: Optional[float] = None) -> bool:
        """One sampling tick. Returns True when the frame went out;
        a down link sheds the changed set and backs off."""
        now = time.time() if now is None else now
        cur = self._collect()
        full = (self._sock is None
                or self._pushes_since_full >= self.keyframe_every)
        changed = (cur if full else {
            k: v for k, v in cur.items() if self._sent.get(k) != v
        })
        meta = self._meta(full)
        if not changed and not meta:
            return True  # nothing new; a quiet tick is not a shed
        if self._sock is None and not self._connect(now):
            self._shed.inc(len(changed))
            return False
        try:
            wire.send_frame(self._sock, wire.samples_to_frame(
                now, sorted(changed.items()), full=full, meta=meta,
            ))
        except (OSError, wire.WireError):
            self._errors.inc()
            self._close_sock()
            self._schedule_retry(now)
            self._shed.inc(len(changed))
            return False
        self._sent = cur
        self._pushes_since_full = 0 if full else \
            self._pushes_since_full + 1
        self._pushed.inc(len(changed))
        self._attempt = 0
        return True

    def _schedule_retry(self, now: float) -> None:
        delay = min(_BACKOFF_CAP, 0.25 * (2 ** min(self._attempt, 8)))
        self._retry_at = now + delay * (0.5 + random.random())
        self._attempt += 1

    def _connect(self, now: float) -> bool:
        if now < self._retry_at:
            return False
        try:
            sock = socket.create_connection(
                self.addr, timeout=_CONNECT_TIMEOUT,
            )
            sock.settimeout(_IO_TIMEOUT)
            hello = {"t": "hello", "mode": "remote-write",
                     "source": self.source, "binary": True}
            if self._secret:
                hello["secret"] = self._secret
            wire.send_msg(sock, hello)
            ack = wire.recv_msg(sock, allow_binary=False)
            if not ack or ack.get("t") != "attach-ack":
                raise wire.WireError(
                    f"collector refused: {ack!r}"
                )
        except (OSError, wire.WireError) as e:
            self._errors.inc()
            self._schedule_retry(now)
            log.debug("collector connect failed: %s", e)
            return False
        self._sock = sock
        self._reconnects.inc()
        # Post-reconnect state is unknown to the collector: force the
        # next frame full so its keyframe chain re-seeds.
        self._pushes_since_full = self.keyframe_every
        return True


class CollectorServer:
    """Accept remote-write links and apply their sample frames to a
    TSDB. Never trusts a peer: JSON-only hello, bounded source labels,
    per-link deadlines, WireError closes one link only."""

    def __init__(self, host: str, port: int, db: TSDB, *,
                 secret: Optional[str] = None):
        import re as _re

        self.db = db
        self._secret = secret
        self._src_re = _re.compile(_SRC_RE)
        self._listener = socket.create_server(
            (host, port), backlog=16, reuse_port=False,
        )
        self.address = self._listener.getsockname()[:2]
        self._lock = threading.Lock()
        self._conns: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="gol-collector-accept",
            daemon=True,
        )
        self._connections = _reg.gauge(
            "gol_tpu_collector_connections",
            "Live remote-write links",
        )
        self._frames = _reg.counter(
            "gol_tpu_collector_frames_total",
            "Sample frames accepted",
        )
        self._rejected = {
            reason: _reg.counter(
                "gol_tpu_collector_dropped_frames_total",
                "Frames/links the collector refused",
                {"reason": reason},
            ) for reason in ("bad_hello", "auth", "wire", "idle")
        }

    def start(self) -> "CollectorServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5)
        self.db.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                self._conns.add(sock)
            threading.Thread(
                target=self._serve_conn, args=(sock, addr),
                name=f"gol-collector-{addr[0]}:{addr[1]}", daemon=True,
            ).start()

    def _hello(self, sock: socket.socket) -> Optional[str]:
        """Validate the pre-auth JSON hello; the peer's source label or
        None (link already answered + closed on refusal)."""
        try:
            msg = wire.recv_msg(sock, allow_binary=False)
        except (OSError, wire.WireError, TimeoutError):
            self._rejected["bad_hello"].inc()
            return None
        if (not isinstance(msg, dict) or msg.get("t") != "hello"
                or msg.get("mode") != "remote-write"
                or not isinstance(msg.get("source"), str)
                or not self._src_re.match(msg["source"])):
            self._rejected["bad_hello"].inc()
            self._refuse(sock, "bad-hello")
            return None
        if self._secret is not None and not hmac.compare_digest(
                str(msg.get("secret") or ""), self._secret):
            self._rejected["auth"].inc()
            self._refuse(sock, "auth")
            return None
        try:
            wire.send_msg(sock, {"t": "attach-ack"})
        except OSError:
            return None
        return msg["source"]

    @staticmethod
    def _refuse(sock: socket.socket, reason: str) -> None:
        try:
            wire.send_msg(sock, {"t": "error", "reason": reason})
        except OSError:
            pass

    def _serve_conn(self, sock: socket.socket, addr) -> None:
        sock.settimeout(_SERVER_IDLE_TIMEOUT)
        self._connections.inc()
        try:
            source = self._hello(sock)
            if source is None:
                return
            while not self._stop.is_set():
                try:
                    msg = wire.recv_msg(sock)
                except TimeoutError:
                    self._rejected["idle"].inc()
                    return
                except (OSError, wire.WireError):
                    # One malformed frame kills one link — the peer
                    # reconnects with a full snapshot; every other
                    # link and the query side keep serving.
                    self._rejected["wire"].inc()
                    return
                if msg is None:
                    return
                if msg.get("t") == "msamples":
                    self._frames.inc()
                    self.db.append(source, msg["ts"], msg["samples"],
                                   meta=msg.get("meta"))
                # hb / unknown kinds: ignorable (forward compat).
        finally:
            self._connections.dec()
            with self._lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass
