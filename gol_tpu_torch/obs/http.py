"""Metrics HTTP sidecar — `/metrics`, `/healthz`, `/vars`, `/trace`,
`/flightrecorder`, `/alerts`, `/usage`, `/query`, `/history` on a live
engine (the port of `gol_tpu.obs.http`).

Opt-in (`--metrics-port` in the CLI, or `MetricsServer(...)` from
library code): a ThreadingHTTPServer on its own daemon thread serving

- `/metrics`  Prometheus text exposition of the process registry;
- `/vars`     the same registry as a JSON snapshot (the debug-vars
              convention — curl-and-jq friendly);
- `/healthz`  the caller's health dict as JSON, HTTP 200 when its
              "status" is "ok", 503 otherwise — liveness for probes
              that don't parse metrics;
- `/trace`    the recent span window of the process tracer
              (gol_tpu_torch.obs.tracing) as Chrome-trace JSON — save it and
              feed `python -m gol_tpu_torch.obs.report merge`;
- `/flightrecorder`  the live black box (gol_tpu_torch.obs.flight): recent
              lifecycle notes, metric deltas, spans and the current
              state snapshot — what a crash dump WOULD contain, for a
              process that is still alive;
- `/alerts`   the freshness plane's SLO evaluator state
              (gol_tpu_torch.obs.freshness, CLI --alert-rules): every rule
              with its ok/pending/firing state and last value, plus
              the firing count — sane (empty rules, firing 0) when no
              rules are loaded;
- `/usage`    the accounting plane's per-principal usage snapshot
              (gol_tpu_torch.obs.accounting): dispatch seconds, modeled
              FLOPs, host encode seconds, wire bytes and queue
              occupancy per tenant, process totals, budget state —
              `{"enabled": false}` under GOL_TPU_ACCOUNTING=0, so a
              biller can tell "disabled" from "idle";
- `/query`    (collector sidecars only — `tsdb=` was passed) the
              history plane's range-query API:
              `?expr=rate(family)&start=&end=&step=[&source=]`,
              epoch-second bounds (a value starting with "-" is
              relative to now), grammar = the alert rules' aggs plus
              `delta`; 404 with an explicit body elsewhere;
- `/history`  (collector sidecars only) per-source window snapshots
              the console's `--since` mode renders: `?since=SECS`.

With the plane disabled (`GOL_TPU_METRICS=0`) the last two return an
explicit `{"enabled": false}` payload so a scraper can tell "disabled"
from "idle".

The sidecar runs entirely off the engine's threads: a scrape can never
stall a dispatch, never touches the device, and a wedged engine still
answers (that is the point
— the old AliveCellsCount ticker was the ONLY live signal, and it dies
with the event stream). Stdlib only, loopback by default; non-loopback
binds should sit behind the same network controls as `--serve`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from gol_tpu_torch.obs.registry import REGISTRY, Registry

__all__ = ["MetricsServer"]


class MetricsServer:
    """Serve one registry (default: the process-global one) over HTTP.

    `health` is an optional zero-arg callable returning a JSON-able
    dict; it is invoked per `/healthz` request from the HTTP thread, so
    it must be cheap and must not touch the device (Engine.health and
    EngineServer.health read only host-side committed state).

    `alerts` is an optional `freshness.AlertEvaluator`: the sidecar
    OWNS it — `start()` starts its evaluation thread, `close()` stops
    it — and `/alerts` serves its JSON state. Without one, `/alerts`
    answers the explicit empty shape (a scraper must be able to tell
    "no rules configured" from 404-means-old-build).

    `tsdb` is an optional `tsdb.TSDB` (collector processes): `/query`
    and `/history` serve its range queries; without one they 404 with
    an explicit "no history store" body. `remote` is an optional
    `collector.RemoteWriter`, owned like `alerts` (started/stopped
    with the sidecar) — the `--remote-write` flag's plumbing."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 registry: Optional[Registry] = None,
                 health: Optional[Callable[[], dict]] = None,
                 alerts=None, tsdb=None, remote=None):
        reg = registry if registry is not None else REGISTRY
        self.alerts = alerts
        self.tsdb = tsdb
        self.remote = remote
        srv = self  # the handler closes over the sidecar instance

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no access-log spam on stderr
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._reply(
                        200, reg.prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/vars":
                    self._reply(
                        200, json.dumps(reg.snapshot(), indent=2).encode(),
                        "application/json",
                    )
                elif path == "/trace":
                    from gol_tpu_torch.obs.tracing import trace_payload

                    self._reply(
                        200, json.dumps(trace_payload()).encode(),
                        "application/json",
                    )
                elif path == "/flightrecorder":
                    from gol_tpu_torch.obs import flight

                    self._reply(
                        200,
                        json.dumps(flight.payload(), indent=1).encode(),
                        "application/json",
                    )
                elif path == "/alerts":
                    ev = srv.alerts
                    body = (ev.payload() if ev is not None
                            else {"rules": [], "firing": 0})
                    self._reply(200, json.dumps(body, indent=1).encode(),
                                "application/json")
                elif path == "/usage":
                    from gol_tpu_torch.obs import accounting

                    self._reply(
                        200,
                        json.dumps(accounting.payload(),
                                   indent=1).encode(),
                        "application/json",
                    )
                elif path in ("/query", "/history"):
                    db = srv.tsdb
                    if db is None:
                        self._reply(
                            404,
                            json.dumps({"error": "no history store "
                                        "(not a --collector sidecar)"}
                                       ).encode(),
                            "application/json")
                        return
                    import time as _time
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)

                    def _t(name, default):
                        raw = q.get(name, [None])[0]
                        if raw is None:
                            return default
                        v = float(raw)
                        # "-60" means "60 s before now" — relative
                        # bounds save every caller a clock read.
                        return _time.time() + v if raw.startswith("-") \
                            else v
                    try:
                        if path == "/history":
                            body = db.history_payload(
                                float(q.get("since", ["60"])[0]))
                        else:
                            body = db.query(
                                q.get("expr", [""])[0],
                                _t("start", _time.time() - 300.0),
                                _t("end", _time.time()),
                                float(q.get("step", ["5"])[0]),
                                source=q.get("source", [None])[0],
                            )
                    except (ValueError, TypeError) as e:
                        self._reply(
                            400, json.dumps({"error": str(e)}).encode(),
                            "application/json")
                        return
                    self._reply(200, json.dumps(body).encode(),
                                "application/json")
                elif path == "/healthz":
                    try:
                        info = dict(health()) if health is not None \
                            else {"status": "ok"}
                    except Exception as e:  # a broken probe is "down"
                        info = {"status": "error", "error": repr(e)}
                    code = 200 if info.get("status") == "ok" else 503
                    self._reply(code, json.dumps(info).encode(),
                                "application/json")
                else:
                    self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        #: (host, port) actually bound — port 0 requests an ephemeral one.
        self.address = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="gol-metrics-http", daemon=True,
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        if self.alerts is not None:
            self.alerts.start()
        if self.remote is not None:
            self.remote.start()
        return self

    def close(self) -> None:
        if self.remote is not None:
            self.remote.close()
        if self.alerts is not None:
            self.alerts.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
