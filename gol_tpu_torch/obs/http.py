"""Metrics HTTP sidecar — `/metrics`, `/healthz`, `/vars`, `/trace`,
`/flightrecorder` on a live engine (the host-side copy of
`gol_tpu.obs.http`).

Opt-in (`--metrics-port` in the CLI, or `MetricsServer(...)` from
library code): a ThreadingHTTPServer on its own daemon thread serving

- `/metrics`  Prometheus text exposition of the process registry;
- `/vars`     the same registry as a JSON snapshot;
- `/healthz`  the caller's health dict as JSON, HTTP 200 when its
              "status" is "ok", 503 otherwise — liveness for probes
              that don't parse metrics;
- `/trace`    the recent span window of the process tracer
              (gol_tpu_torch.obs.tracing) as Chrome-trace JSON;
- `/flightrecorder`  the live black box (gol_tpu_torch.obs.flight):
              recent lifecycle notes, metric deltas, spans and the
              current state snapshot — what a crash dump WOULD contain.

gol_tpu's `/alerts`, `/usage`, `/query` and `/history` (the alert
evaluator, the usage ledger and the collector's history store) are not
ported yet.

The sidecar runs entirely off the engine's threads: a scrape can never
stall a dispatch, never touches the device, and a wedged engine still
answers. Stdlib only, loopback by default; non-loopback binds should sit
behind the same network controls as `--serve`.
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
    EngineServer.health read only host-side committed state)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 registry: Optional[Registry] = None,
                 health: Optional[Callable[[], dict]] = None):
        reg = registry if registry is not None else REGISTRY

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
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
