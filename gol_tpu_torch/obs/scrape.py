"""Fleet scraping — the Prometheus-text parser + topology join that
both read-paths of the fleet share.

Until the control plane there was exactly one consumer of the
`/metrics` sidecars: the console (`gol_tpu_torch.obs.console`), and the
parser, the per-endpoint row builder, and the relay-tree join lived
inside it. The controller (`gol_tpu_torch.control`) must observe the SAME
fleet through the SAME join — re-implementing the exposition parser in
a second place is how two views of one fleet drift apart. So the whole
scrape layer lives here, and the console imports it:

- `parse_prometheus` — text exposition -> {name{labels}: value},
- `sum_series` / `max_series` / `label_value` / `histogram_buckets`
  — family readers over that dict,
- `Endpoint` — one `/metrics` sidecar, scraped into the row dict the
  console renders and the controller reconciles against (keeps the
  previous sample for rates, fetches `/usage` and `/alerts` context),
- `build_tree` — the relay fan-out forest joined from `listen` /
  `upstream` labels alone,
- `merge_usage` / `fleet_snapshot` — the fleet-level aggregation.

Stdlib only, read-only, every request timeboxed — the scrape layer
must be safe to point at a half-dead fleet, because that is exactly
when both of its consumers matter most.
"""

from __future__ import annotations

import json
import re
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from gol_tpu_torch.obs.registry import (
    merge_cumulative_buckets,
    quantile_from_buckets,
)

__all__ = [
    "Endpoint",
    "Series",
    "build_tree",
    "fleet_snapshot",
    "histogram_buckets",
    "label_value",
    "max_series",
    "merge_usage",
    "parse_prometheus",
    "sum_series",
]

_SCRAPE_TIMEOUT = 5.0

#: name{labels} -> value. Histogram buckets stay individual series
#: (`<name>_bucket{...,le="x"}`) — `histogram_buckets` reassembles.
Series = Dict[str, float]

_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$'
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Series:
    """The text exposition format -> {name{labels}: float}. Comments
    and malformed lines are skipped (a scraper must survive whatever a
    half-written exposition throws at it); label order is preserved as
    emitted (the registry emits sorted labels, so keys are stable)."""
    out: Series = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        name, labels, raw = m.group(1), m.group(2) or "", m.group(3)
        try:
            v = float(raw.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            continue
        out[name + labels] = v
    return out


def _labels_of(key: str) -> Dict[str, str]:
    i = key.find("{")
    if i < 0:
        return {}
    return {m.group(1): m.group(2).replace('\\"', '"')
            for m in _LABEL.finditer(key[i:])}


def _name_of(key: str) -> str:
    i = key.find("{")
    return key if i < 0 else key[:i]


def sum_series(metrics: Series, name: str,
               match: Optional[Dict[str, str]] = None) -> Optional[float]:
    """Sum every series of one family (optionally filtered by label
    values); None when absent — callers render '-' for metrics a
    process legitimately doesn't export (a client has no sessions)."""
    total, seen = 0.0, False
    for key, v in metrics.items():
        if _name_of(key) != name:
            continue
        if match:
            labels = _labels_of(key)
            if any(labels.get(k) != want for k, want in match.items()):
                continue
        total += v
        seen = True
    return total if seen else None


def max_series(metrics: Series, name: str) -> Optional[float]:
    vals = [v for key, v in metrics.items() if _name_of(key) == name]
    return max(vals) if vals else None


def label_value(metrics: Series, name: str,
                label: str) -> Optional[str]:
    """The `label` value of the first series of one family — for
    info-style gauges (`gol_tpu_relay_node_info{listen,upstream}`,
    `gol_tpu_server_listen_addr{addr}`) whose labels ARE the data."""
    for key in metrics:
        if _name_of(key) == name:
            v = _labels_of(key).get(label)
            if v is not None:
                return v
    return None


def histogram_buckets(metrics: Series, name: str) -> list:
    """Reassemble `<name>_bucket{...,le=...}` series into the
    cumulative [(bound, cum)] form `quantile_from_buckets` takes,
    merging across any non-`le` label sets (one population per
    endpoint)."""
    by_labels: Dict[Tuple, list] = {}
    for key, v in metrics.items():
        if _name_of(key) != f"{name}_bucket":
            continue
        labels = _labels_of(key)
        le = labels.pop("le", None)
        if le is None:
            continue
        bound = float("inf") if le == "+Inf" else float(le)
        by_labels.setdefault(tuple(sorted(labels.items())), []).append(
            (bound, int(v))
        )
    lists = [sorted(buckets) for buckets in by_labels.values()]
    return merge_cumulative_buckets(lists)


class Endpoint:
    """One scraped `/metrics` sidecar, with the previous sample kept so
    rates (turns/s) come from successive scrapes."""

    def __init__(self, spec: str):
        self.spec = spec
        base = spec if "://" in spec else f"http://{spec}"
        if re.fullmatch(r"\d+", spec):
            base = f"http://127.0.0.1:{spec}"
        base = base.rstrip("/")
        if base.endswith("/metrics"):
            # The CLI banner prints the full .../metrics URL — pasting
            # it verbatim must work, not 404 on /metrics/metrics.
            base = base[: -len("/metrics")]
        self.base = base
        self.url = base + "/metrics"
        self.prev: Optional[Tuple[float, Series]] = None
        self.last_error: Optional[str] = None

    def scrape(self) -> Optional[dict]:
        """One sample -> the row dict `render` consumes, or None when
        the endpoint is down (`last_error` says why)."""
        try:
            with urllib.request.urlopen(
                self.url, timeout=_SCRAPE_TIMEOUT
            ) as resp:
                text = resp.read().decode("utf-8", "replace")
        except Exception as e:
            self.last_error = repr(e)
            return None
        self.last_error = None
        now = time.monotonic()
        metrics = parse_prometheus(text)
        row = self._row(metrics, now)
        row["usage"] = self._fetch_usage()
        self.prev = (now, metrics)
        return row

    def _fetch_usage(self) -> Optional[dict]:
        """The sidecar's `/usage` payload (accounting plane), or None
        — a pre-accounting sidecar 404s and an opted-out process
        answers `{"enabled": false}`; both degrade to 'no usage
        columns', never to a DOWN row (the endpoint's /metrics already
        answered)."""
        try:
            with urllib.request.urlopen(
                self.base + "/usage", timeout=_SCRAPE_TIMEOUT
            ) as resp:
                payload = json.loads(resp.read().decode("utf-8",
                                                        "replace"))
        except Exception:
            return None
        if not isinstance(payload, dict) or not payload.get("enabled"):
            return None
        return payload

    def _turns(self, metrics: Series) -> Optional[float]:
        parts = [sum_series(metrics, "gol_tpu_engine_turns_total"),
                 sum_series(metrics, "gol_tpu_session_turns_total"),
                 # Replay servers have no engine: their turn flow is
                 # the pump position (gol_tpu_torch.replay), so rate math
                 # works unchanged on replay rows.
                 sum_series(metrics, "gol_tpu_replay_turns_total")]
        vals = [p for p in parts if p is not None]
        return sum(vals) if vals else None

    def _row(self, metrics: Series, now: float) -> dict:
        turns = self._turns(metrics)
        recordings = sum_series(metrics, "gol_tpu_replay_recordings")
        rate = None
        if self.prev is not None and turns is not None:
            t0, prev_metrics = self.prev
            prev_turns = self._turns(prev_metrics)
            if prev_turns is not None and now > t0:
                rate = max(0.0, (turns - prev_turns) / (now - t0))
        lat = histogram_buckets(
            metrics, "gol_tpu_client_turn_latency_seconds"
        )
        rtt = sum_series(metrics, "gol_tpu_relay_upstream_rtt_seconds")
        # Freshness plane: the worst turn age this endpoint reports —
        # a server's worst-peer sweep gauge, a client/canary's own
        # applied-turn age, whichever is present and worst.
        ages = [v for v in (
            max_series(metrics, "gol_tpu_server_worst_turn_age_seconds"),
            max_series(metrics, "gol_tpu_client_turn_age_seconds"),
        ) if v is not None]
        firing = [
            _labels_of(key)["rule"]
            for key, v in metrics.items()
            if _name_of(key) == "gol_tpu_alert_firing" and v >= 1
            and "rule" in _labels_of(key)
        ]
        # The firing COUNT: the evaluator's gauge when present (0
        # renders as 0 — "no alerts" differs from "no evaluator"),
        # else derived from the per-rule gauges.
        alerts_firing = sum_series(metrics, "gol_tpu_alerts_firing")
        if alerts_firing is None and firing:
            alerts_firing = float(len(firing))
        return {
            # Topology identity (the relay tier's sidecar labels): how
            # the fan-out tree is joined from scrapes alone.
            "listen": (
                label_value(metrics, "gol_tpu_relay_node_info",
                            "listen")
                or label_value(metrics, "gol_tpu_server_listen_addr",
                               "addr")
            ),
            "upstream": label_value(metrics, "gol_tpu_relay_node_info",
                                    "upstream"),
            "depth": max_series(metrics, "gol_tpu_relay_depth"),
            "relay_peers": sum_series(metrics, "gol_tpu_relay_peers"),
            "ws_peers": sum_series(metrics, "gol_tpu_relay_ws_peers"),
            "hop_latency_s": None if rtt is None else rtt / 2.0,
            "hop_clock_offset_s": sum_series(
                metrics, "gol_tpu_relay_clock_offset_seconds"
            ),
            "endpoint": self.spec,
            "up": True,
            # Replay servers (gol_tpu_torch.replay): no engine series at all
            # — they export listen_addr + the replay family, and the
            # row renders from those instead of as a broken '-' row.
            # Keyed on recordings > 0, not presence: a live session
            # server that merely ANSWERED a seek verb registers the
            # family at 0 (import side effect) and must keep its
            # engine row.
            "mode": "replay" if recordings else None,
            "recordings": recordings,
            "replay_serves": sum_series(
                metrics, "gol_tpu_replay_serves_total"
            ),
            "turn": (
                max_series(metrics, "gol_tpu_replay_position_turn")
                if recordings
                else max_series(metrics, "gol_tpu_engine_committed_turn")
            ),
            "turns_total": turns,
            "turns_per_sec": rate,
            "sessions": sum_series(metrics, "gol_tpu_sessions_active"),
            "peers": sum_series(metrics, "gol_tpu_server_peers"),
            "peer_lag": max_series(metrics,
                                   "gol_tpu_server_peer_lag_frames"),
            "turn_age_s": max(ages) if ages else None,
            "alerts_firing": alerts_firing,
            "alerts": sorted(firing),
            "degradations": sum_series(
                metrics, "gol_tpu_server_degradations_total"
            ),
            "shed": sum_series(metrics,
                               "gol_tpu_server_shed_frames_total"),
            "reconnects": sum_series(
                metrics, "gol_tpu_client_reconnects_total"
            ),
            "clock_offset_s": sum_series(
                metrics, "gol_tpu_client_clock_offset_seconds"
            ),
            "compiles": sum_series(metrics,
                                   "gol_tpu_device_compiles_total"),
            "hbm_watermark_bytes": max_series(
                metrics, "gol_tpu_device_hbm_watermark_bytes"
            ),
            "violations": sum_series(
                metrics, "gol_tpu_invariant_violations_total"
            ),
            # Control plane: a controller's sidecar exports its
            # identity + desired-vs-observed node counts; every other
            # process leaves these None and the console skips the row
            # decoration.
            "controller": label_value(
                metrics, "gol_tpu_controller_info", "spec"
            ),
            "desired_nodes": sum_series(
                metrics, "gol_tpu_controller_desired_nodes"
            ),
            "observed_nodes": sum_series(
                metrics, "gol_tpu_controller_observed_nodes"
            ),
            "controller_actions": sum_series(
                metrics, "gol_tpu_controller_actions_total"
            ),
            "controller_action_failures": sum_series(
                metrics, "gol_tpu_controller_actions_total",
                {"outcome": "error"},
            ),
            # Writer-pool saturation (broadcast tier): the controller's
            # scale rule reads busy-seconds off the root's sidecar.
            "writer_busy_s": sum_series(
                metrics, "gol_tpu_server_writer_pool_busy_seconds_total"
            ),
            "latency_buckets": lat,
            "latency": {
                q: quantile_from_buckets(lat, p)
                for q, p in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))
            } if lat else None,
        }


def build_tree(rows: List[dict]) -> List[dict]:
    """Join scraped endpoints into the fan-out topology: a relay's
    `upstream` label matches its parent's `listen` label (roots export
    `gol_tpu_server_listen_addr`, relays `gol_tpu_relay_node_info`).
    Returns the forest of root nodes — each node carries depth, peer
    counts (TCP + WS) and the per-hop added latency (half the hop's
    min clock-probe RTT). Endpoints whose upstream is not scraped
    become roots of their own subtree (partial scrapes stay useful);
    an accidental relay cycle cannot recurse (visited set)."""
    by_listen = {r["listen"]: r for r in rows
                 if r.get("up") and r.get("listen")}
    children: Dict[str, List[dict]] = {}
    roots = []
    for r in by_listen.values():
        up = r.get("upstream")
        if up and up in by_listen and up != r["listen"]:
            children.setdefault(up, []).append(r)
        else:
            roots.append(r)
    visited = set()

    def node(r) -> dict:
        visited.add(r["listen"])
        kids = [c for c in sorted(children.get(r["listen"], []),
                                  key=lambda x: x["listen"])
                if c["listen"] not in visited]
        return {
            "endpoint": r["endpoint"],
            "listen": r["listen"],
            "upstream": r.get("upstream"),
            "mode": r.get("mode"),
            "depth": r.get("depth"),
            "peers": (r.get("relay_peers")
                      if r.get("upstream") is not None
                      else r.get("peers")),
            "ws_peers": r.get("ws_peers"),
            "hop_latency_s": r.get("hop_latency_s"),
            "hop_clock_offset_s": r.get("hop_clock_offset_s"),
            "children": [node(c) for c in kids],
        }

    forest = [node(r) for r in
              sorted(roots, key=lambda x: x["listen"])]
    # Pure cycles (A -> B -> A) have no root at all: promote their
    # members so every scraped node appears exactly once.
    for r in sorted(by_listen.values(), key=lambda x: x["listen"]):
        if r["listen"] not in visited:
            forest.append(node(r))
    return forest


def merge_usage(rows: List[dict],
                sort_key: str = "flops") -> Optional[dict]:
    """Join every endpoint's `/usage` payload into the fleet view:
    per-principal resource sums across processes (a tenant served by
    a session server AND billed wire bytes by a relay is ONE row),
    ranked most-expensive-first on `sort_key`, plus a fleet TOTAL
    equal to the sum of the per-process `totals` blocks (which include
    already-forgotten principals — the fleet bill survives eviction).
    None when no scraped endpoint exposes the accounting plane."""
    by: Dict[str, dict] = {}
    total: Dict[str, float] = {}
    budgets: Dict[str, float] = {}
    seen = False
    for r in rows:
        u = r.get("usage")
        if not u:
            continue
        seen = True
        for p, res in (u.get("principals") or {}).items():
            dst = by.setdefault(p, {"over_budget": False})
            for k, v in res.items():
                if k == "over_budget":
                    dst["over_budget"] = bool(dst["over_budget"] or v)
                else:
                    dst[k] = dst.get(k, 0.0) + float(v)
        for k, v in (u.get("totals") or {}).items():
            total[k] = total.get(k, 0.0) + float(v)
        for k, v in (u.get("budgets") or {}).items():
            if v is not None:
                budgets[k] = v
    if not seen:
        return None
    ranked = sorted(by, key=lambda p: (-by[p].get(sort_key, 0.0), p))
    return {"by_principal": by, "ranked": ranked, "total": total,
            "budgets": budgets, "sort": sort_key}


def fleet_snapshot(endpoints: List[Endpoint],
                   usage_sort: str = "flops") -> dict:
    """Scrape every endpoint once; returns {"rows": [...], "total":
    {...}, "down": [spec, ...], "tree": [...], "usage": {...}|None} —
    `tree` is the relay fan-out forest (build_tree), `usage` the
    fleet-joined TOP-by-cost view (merge_usage). The TOTAL row merges
    latency histograms across endpoints BEFORE taking percentiles."""
    # Concurrent scrapes: one black-holed endpoint (a hanging TCP
    # connect eats its whole 5s timeout) must not freeze the healthy
    # rows' refresh — a partial outage is when the console matters.
    from concurrent.futures import ThreadPoolExecutor

    rows, down = [], []
    with ThreadPoolExecutor(max_workers=min(16, len(endpoints))) as pool:
        scraped = list(pool.map(lambda ep: ep.scrape(), endpoints))
    for ep, row in zip(endpoints, scraped):
        if row is None:
            down.append(ep.spec)
            rows.append({"endpoint": ep.spec, "up": False,
                         "error": ep.last_error})
        else:
            rows.append(row)
    return snapshot_from_rows(rows, down, len(endpoints), usage_sort)


def snapshot_from_rows(rows: List[dict], down: List[str],
                       n_endpoints: int,
                       usage_sort: str = "flops") -> dict:
    """Join already-built rows into the snapshot shape (`fleet_snapshot`
    after its scrapes; `history_snapshot` from collector queries)."""
    live = [r for r in rows if r.get("up")]

    def total_of(key):
        vals = [r[key] for r in live if r.get(key) is not None]
        return sum(vals) if vals else None

    merged_lat = merge_cumulative_buckets(
        [r["latency_buckets"] for r in live if r.get("latency_buckets")]
    )
    ages = [r["turn_age_s"] for r in live
            if r.get("turn_age_s") is not None]
    alerts = [{"endpoint": r["endpoint"], "rule": rule}
              for r in live for rule in (r.get("alerts") or [])]
    total = {
        "endpoints": n_endpoints,
        "up": len(live),
        "turns_per_sec": total_of("turns_per_sec"),
        "sessions": total_of("sessions"),
        "peers": total_of("peers"),
        "turn_age_s": max(ages) if ages else None,
        "alerts_firing": total_of("alerts_firing"),
        "alerts": alerts,
        "degradations": total_of("degradations"),
        "compiles": total_of("compiles"),
        "violations": total_of("violations"),
        "latency": {
            q: quantile_from_buckets(merged_lat, p)
            for q, p in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))
        } if merged_lat else None,
    }
    return {"rows": rows, "total": total, "down": down,
            "tree": build_tree(rows),
            "usage": merge_usage(live, usage_sort)}


def history_snapshot(collector: str, since: float,
                     usage_sort: str = "flops") -> dict:
    """The console's `--since` snapshot: rows rendered from a
    collector's `/history` window payload instead of live scrapes.
    One row per remote-writing source; the row builder is the SAME
    `Endpoint._row` the live path uses (series dict in, row out), fed
    the window-edge series the store returns — rates therefore come
    from history, not from successive scrapes. The collector being
    down is the one DOWN row (there is nothing else to ask)."""
    spec = collector if "://" in collector else f"http://{collector}"
    if re.fullmatch(r"\d+", collector):
        spec = f"http://127.0.0.1:{collector}"
    url = (f"{spec.rstrip('/')}/history?"
           f"since={float(since):g}")
    try:
        with urllib.request.urlopen(url, timeout=_SCRAPE_TIMEOUT) as r:
            payload = json.loads(r.read().decode("utf-8", "replace"))
    except Exception as e:
        return snapshot_from_rows(
            [{"endpoint": collector, "up": False, "error": repr(e)}],
            [collector], 1, usage_sort,
        )
    rows = []
    for src in sorted(payload.get("sources") or {}):
        h = payload["sources"][src]
        ep = Endpoint(src)
        prev = h.get("prev")
        if prev:
            ep.prev = (float(h.get("prev_ts") or 0.0), prev)
        row = ep._row(h.get("series") or {}, float(h.get("ts") or 0.0))
        row["endpoint"] = src
        row["spark"] = h.get("spark") or []
        row["events"] = h.get("events") or []
        row["usage"] = None
        rows.append(row)
    snap = snapshot_from_rows(rows, [], len(rows), usage_sort)
    snap["since"] = payload.get("since", since)
    snap["collector"] = collector
    return snap
