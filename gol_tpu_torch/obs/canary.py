"""Synthetic freshness canary — measure what a user would see.

Servers REPORT their peers' turn age (gol_tpu_torch.obs.freshness), but a
fleet view built only from what servers claim has a blind spot: a tier
that stopped accepting, a gateway mangling frames, a recording pump
wedged at its first keyframe all look healthy from the inside. The
canary closes it by BEING a user:

    python -m gol_tpu_torch.obs.canary HOST:PORT [--metrics-port P] ...

attaches ONE real batching observer at any tier — a root engine
server, a relay leaf, the WebSocket gateway (`--ws`), or a replay
server — runs the ordinary apply path (board sync, vectorized FBATCH
raster advance), and continuously publishes the MEASURED end-to-end
applied-turn age:

- gol_tpu_canary_turn_age_seconds    histogram of sampled ages
- gol_tpu_canary_samples_total       sampling heartbeat
- gol_tpu_canary_info{target,transport}  identity (value 1)
- gol_tpu_client_turn_age_seconds    the live gauge (the ordinary
  client freshness plumbing — obs.console's AGE column reads it)

With `--metrics-port` the canary is one more sidecar the fleet console
scrapes, so the fan-out view carries a measured freshness row next to
the servers' claimed ones. `--duration` + `--max-age` make it a CI
probe: run for N seconds, exit nonzero when the p95 sampled age
exceeds the SLO (or the link never syncs / is lost) —
scripts/freshness_smoke.sh drives exactly that against a live tree and
a replay server.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import socket
import sys
import threading
import time
from typing import Optional

from gol_tpu_torch import obs
from gol_tpu_torch.obs.freshness import ClientFreshness, sane_lag

__all__ = ["CanaryStats", "WSObserver", "main", "run_canary"]


class _CanaryMetrics:
    def __init__(self):
        self.age = obs.histogram(
            "gol_tpu_canary_turn_age_seconds",
            "End-to-end applied-turn age MEASURED by a real attached "
            "observer (the freshness canary) — what a user sees, not "
            "what servers claim",
        )
        self.samples = obs.counter(
            "gol_tpu_canary_samples_total",
            "Canary sampling sweeps completed",
        )


_METRICS = _CanaryMetrics()


def _publish_info(target: str, transport: str) -> None:
    obs.gauge(
        "gol_tpu_canary_info",
        "Canary identity (value 1): the endpoint it observes and the "
        "transport it uses",
        {"target": target, "transport": transport},
    ).set(1)


class CanaryStats:
    """Sampled age series + summary (the --json payload). The raw
    sample window is BOUNDED (the run-until-interrupted watchdog mode
    must not grow RSS forever — the EventQueue drain's reasoning): the
    summary quantiles cover the most recent window, while the
    histogram metric and `count` keep the full-run totals."""

    WINDOW = 100_000

    def __init__(self):
        import collections

        self.ages: "collections.deque[float]" = collections.deque(
            maxlen=self.WINDOW)
        self.count = 0

    def add(self, age: float) -> None:
        self.ages.append(age)
        self.count += 1
        _METRICS.age.observe(age)
        _METRICS.samples.inc()

    def summary(self) -> dict:
        if not self.ages:
            return {"samples": 0}
        s = sorted(self.ages)
        return {
            "samples": self.count,
            "last_s": round(self.ages[-1], 6),
            "mean_s": round(sum(s) / len(s), 6),
            "p95_s": round(s[min(len(s) - 1, int(0.95 * len(s)))], 6),
            "max_s": round(s[-1], 6),
        }


class WSObserver:
    """A real browser-shaped observer: RFC-6455 client against the
    relay's WS gateway, applying the IDENTICAL binary frame payloads a
    TCP observer gets (no length prefix — WS frames self-delimit).
    Server pings ARE the heartbeat beacons and carry the committed
    turn, so the head clock advances even while the stream idles."""

    def __init__(self, host: str, port: int, *,
                 secret: Optional[str] = None,
                 session: Optional[str] = None,
                 batch_turns: int = 256, timeout: float = 30.0):
        import numpy as np  # the apply path is vectorized

        from gol_tpu_torch.relay import ws as wsproto

        self._np = np
        self._ws = wsproto
        self.freshness = ClientFreshness()
        self.board = None
        self.synced = threading.Event()
        self.closed = threading.Event()
        #: Set only on an ERROR teardown (protocol violation, socket
        #: death) — a clean server close is the stream ending, not a
        #: canary failure.
        self.lost = threading.Event()
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.settimeout(timeout)
        self._send_lock = threading.Lock()
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        req = (
            f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n"
            f"Sec-WebSocket-Protocol: {wsproto.SUBPROTOCOL}\r\n\r\n"
        )
        self._sock.sendall(req.encode("ascii"))
        # Byte-wise head read so no WS frame byte is ever swallowed
        # into a throwaway buffer (the head is ~200 bytes, once).
        head = bytearray()
        while not head.endswith(b"\r\n\r\n"):
            b = self._sock.recv(1)
            if not b:
                raise ConnectionError("gateway closed during upgrade")
            head.extend(b)
            if len(head) > 65536:
                raise ConnectionError("oversized upgrade response")
        status = bytes(head).split(b"\r\n", 1)[0]
        if b" 101 " not in status + b" ":
            raise ConnectionError(
                f"gateway refused the upgrade: {status!r}"
            )
        hello = {"t": "hello", "want_flips": True, "binary": True,
                 "hb": True, "role": "observe", "batch": batch_turns}
        if session is not None:
            hello["session"] = session
        if secret is not None:
            hello["secret"] = secret
        self._send(wsproto.OP_TEXT,
                   json.dumps(hello, separators=(",", ":")).encode())
        self._thread = threading.Thread(target=self._reader,
                                        name="gol-canary-ws",
                                        daemon=True)
        self._thread.start()

    def _send(self, op: int, payload: bytes) -> None:
        # Client frames MUST be masked (RFC 6455; the gateway fails
        # the connection otherwise).
        frame = self._ws.encode_frame(op, payload, mask=True)
        with self._send_lock:
            self._sock.sendall(frame)

    def wait_sync(self, timeout: float = 60.0) -> bool:
        return self.synced.wait(timeout)

    def turn_age(self) -> float:
        return self.freshness.age()

    def _on_msg(self, msg: dict) -> None:
        from gol_tpu_torch.distributed import wire
        from gol_tpu_torch.distributed.client import apply_fbatch_raster

        np = self._np
        t = msg.get("t")
        if t == "board":
            turn, board = wire.msg_to_board(msg)
            self.board = np.array(board, dtype=np.uint8)
            self.freshness.note_head(turn)
            self.freshness.note_applied(turn)
            self.synced.set()
        elif t == "fbatch" and self.board is not None:
            last = int(msg["first_turn"]) + int(msg["k"]) - 1
            apply_fbatch_raster(self.board, msg,
                                self.freshness.applied_turn)
            lag = sane_lag(msg.get("ts"))
            self.freshness.note_head(
                last, None if lag is None else time.time() - lag
            )
            self.freshness.note_applied(last)
        elif t == "hb":
            self.freshness.note_head(msg.get("turn"))
        elif t == "ev" and msg.get("k") == "turn":
            self.freshness.note_head(msg.get("turn"))
            self.freshness.note_applied(msg.get("turn"))

    def _reader(self) -> None:
        from gol_tpu_torch.distributed import wire

        wsproto = self._ws
        try:
            while True:
                op, payload = wsproto.read_message(self._sock,
                                                   require_mask=False)
                if op == wsproto.OP_CLOSE:
                    return
                if op == wsproto.OP_PING:
                    # The beacon: payload is the committed turn as
                    # ASCII digits — head evidence AND the liveness
                    # pong in one.
                    with contextlib.suppress(ValueError, TypeError):
                        self.freshness.note_head(
                            int((payload or b"0").decode("ascii"))
                        )
                    self._send(wsproto.OP_PONG, payload or b"")
                    continue
                if op == wsproto.OP_PONG or not payload:
                    continue
                with contextlib.suppress(wire.WireError, ValueError,
                                         KeyError):
                    self._on_msg(wire.parse_payload(payload))
        except Exception:
            # Link death (vs the clean OP_CLOSE return above) is a
            # probe FAILURE the sampler must report.
            self.lost.set()
        finally:
            self.closed.set()

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._sock.close()
        self.closed.set()


def run_canary(target: str, *, session: Optional[str] = None,
               secret: Optional[str] = None, batch_turns: int = 256,
               interval: float = 1.0, duration: Optional[float] = None,
               max_age: Optional[float] = None, use_ws: bool = False,
               as_json: bool = False, out=None) -> int:
    """Attach, sample, publish; returns the process exit code (0 ok,
    1 attach failure, 2 link lost, 3 SLO exceeded)."""
    out = out or sys.stdout
    host, _, port_s = target.rpartition(":")
    host = host or "127.0.0.1"
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"bad canary target {target!r} — expected HOST:PORT"
        ) from None
    transport = "ws" if use_ws else "tcp"
    _publish_info(f"{host}:{port}", transport)
    stats = CanaryStats()
    if use_ws:
        watcher = WSObserver(host, port, secret=secret, session=session,
                             batch_turns=batch_turns)
    else:
        from gol_tpu_torch.distributed.client import Controller

        watcher = Controller(
            host, port, want_flips=True, secret=secret, observe=True,
            batch=True, batch_turns=batch_turns,
            batch_flip_events=False, session=session,
        )
        # Drain the event stream: the Controller's EventQueue is
        # unbounded and the canary reads only ages — on a 10^5 turns/s
        # tier the undrained TurnComplete objects would grow RSS until
        # the watchdog process itself is the thing that dies.
        def _drain():
            for _ in watcher.events:
                pass

        threading.Thread(target=_drain, name="gol-canary-drain",
                         daemon=True).start()
    try:
        if not watcher.wait_sync(60.0):
            print("canary: no board sync from the target (attach "
                  "failed or run already over)", file=sys.stderr)
            return 1
        deadline = (time.monotonic() + duration
                    if duration is not None else None)
        link_lost = False
        while deadline is None or time.monotonic() < deadline:
            time.sleep(max(0.05, interval))
            # A LOST link (reconnect exhausted, policy-rejected,
            # protocol death) is a probe failure; a cleanly ended
            # stream (bye — the run or recording is over) just stops
            # the sampling and the SLO gate judges what was measured.
            link_lost = watcher.lost.is_set()
            ended = link_lost or (watcher.closed.is_set() if use_ws
                                  else watcher.events.closed)
            age = watcher.turn_age()
            stats.add(age)
            # The live gauge for BOTH transports: the Controller sets
            # it per message, but the WS observer has no Controller —
            # without this a --ws canary's console row shows no AGE.
            obs.gauge("gol_tpu_client_turn_age_seconds").set(
                round(age, 6))
            if not as_json:
                out.write(
                    f"canary {host}:{port} [{transport}] "
                    f"applied turn {watcher.freshness.applied_turn} "
                    f"head {watcher.freshness.head()} "
                    f"age {age * 1e3:.1f}ms\n"
                )
                out.flush()
            if ended:
                break
        summary = {
            "target": f"{host}:{port}", "transport": transport,
            "applied_turn": watcher.freshness.applied_turn,
            "head_turn": watcher.freshness.head(),
            "age": stats.summary(),
        }
        ok = not link_lost
        if max_age is not None:
            p95 = summary["age"].get("p95_s")
            ok = ok and p95 is not None and p95 <= max_age
            summary["max_age_s"] = max_age
        summary["lost"] = link_lost
        summary["ok"] = ok
        if as_json:
            out.write(json.dumps(summary, indent=1) + "\n")
        else:
            out.write(f"canary summary: {json.dumps(summary)}\n")
        if link_lost:
            print("canary: link lost", file=sys.stderr)
            return 2
        return 0 if ok else 3
    finally:
        with contextlib.suppress(Exception):
            watcher.close()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.obs.canary",
        description="synthetic freshness canary: attach a real "
                    "observer at any tier and publish MEASURED "
                    "end-to-end turn age",
    )
    ap.add_argument("target", metavar="HOST:PORT",
                    help="the tier to observe (root server, relay, "
                         "WS gateway with --ws, or replay server)")
    ap.add_argument("--session", default=None, metavar="ID",
                    help="named session on a --sessions/--replay tier")
    ap.add_argument("--secret", default=os.environ.get("GOL_SECRET"),
                    metavar="TOKEN", help="shared attach secret")
    ap.add_argument("--batch-turns", type=int, default=256,
                    dest="batch_turns", metavar="K",
                    help="negotiated k-turn batch frames (default 256)")
    ap.add_argument("--interval", type=float, default=1.0, metavar="SEC",
                    help="sampling cadence (default 1)")
    ap.add_argument("--duration", type=float, default=None, metavar="SEC",
                    help="stop after SEC seconds and print the summary "
                         "(default: run until interrupted)")
    ap.add_argument("--max-age", type=float, default=None,
                    dest="max_age", metavar="SEC",
                    help="CI gate: exit 3 when the p95 sampled age "
                         "exceeds SEC")
    ap.add_argument("--ws", action="store_true",
                    help="attach over the RFC-6455 WebSocket gateway "
                         "instead of raw TCP")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="suppress per-sample lines; print one JSON "
                         "summary")
    ap.add_argument("--metrics-port", type=int, default=None,
                    dest="metrics_port", metavar="PORT",
                    help="serve this canary's own /metrics sidecar "
                         "(0 = ephemeral, printed) so the fleet "
                         "console scrapes the measured freshness")
    ap.add_argument("--metrics-host", default="127.0.0.1",
                    metavar="HOST")
    ap.add_argument("--remote-write", default=None, dest="remote_write",
                    metavar="HOST:PORT",
                    help="with --metrics-port: push the measured "
                         "freshness series to the history-plane "
                         "collector at HOST:PORT — what the fleet "
                         "controller's scale rule reads back as "
                         "canary turn-age HISTORY "
                         "(docs/OBSERVABILITY.md 'History plane')")
    args = ap.parse_args(argv)

    if args.remote_write is not None and args.metrics_port is None:
        ap.error("--remote-write requires --metrics-port (the writer "
                 "rides the metrics sidecar)")

    from gol_tpu_torch.obs import tracing

    tracing.set_process_label("canary")
    metrics = None
    if args.metrics_port is not None:
        from gol_tpu_torch.obs.http import MetricsServer

        metrics = MetricsServer(args.metrics_host, args.metrics_port)
        if args.remote_write is not None:
            from gol_tpu_torch.obs.collector import RemoteWriter

            metrics.remote = RemoteWriter(
                args.remote_write,
                source=f"canary@{metrics.address[0]}:"
                       f"{metrics.address[1]}",
                secret=args.secret,
            )
            print(f"remote-write to {args.remote_write} "
                  f"(source {metrics.remote.source})")
        metrics.start()
        print(f"metrics serving on http://{metrics.address[0]}:"
              f"{metrics.address[1]}/metrics")
    try:
        return run_canary(
            args.target, session=args.session, secret=args.secret,
            batch_turns=args.batch_turns, interval=args.interval,
            duration=args.duration, max_age=args.max_age,
            use_ws=args.ws, as_json=args.as_json,
        )
    except KeyboardInterrupt:
        return 0
    except (ConnectionError, OSError, ValueError) as e:
        # ValueError covers a malformed target spec — a typo'd
        # HOST:PORT in a CI script gets the diagnostic and exit 1,
        # never a raw traceback.
        print(f"canary: cannot attach to {args.target}: {e}",
              file=sys.stderr)
        return 1
    finally:
        if metrics is not None:
            metrics.close()


if __name__ == "__main__":
    sys.exit(main())
