"""Fleet console — `top` for a gol_tpu fleet, over N `/metrics` sidecars.

The obs planes below one process are rich (metrics, spans, the black
box), but a multi-tenant server plus N clients/relays had no aggregated
view at all: an operator tailed N curl loops. This module is the plane
ABOVE the process:

    python -m gol_tpu_torch.obs.console 127.0.0.1:9100 127.0.0.1:9101
    python -m gol_tpu_torch.obs.console 9100 --once          # CI snapshot
    python -m gol_tpu_torch.obs.console 9100 --json --once   # machine form

Each endpoint is one process's `--metrics-port` sidecar. The console
scrapes `/metrics` (Prometheus text — parsed by `gol_tpu_torch.obs.scrape`,
the layer shared with the controller; stdlib only) on an interval and
renders one row per endpoint: committed turn, turns/s (rate between
scrapes), live sessions/peers, worst peer lag, shed/degradation
counters, clock offset, compile count, the HBM/live-buffer watermark,
and p50/p95/p99 turn latency computed from the histogram buckets via
the registry's own `quantile_from_buckets` (one quantile
implementation for every surface). A `TOTAL` row sums the fleet,
merging the latency histograms across endpoints before taking
percentiles (`merge_cumulative_buckets`) — fleet percentiles are NOT
averages of per-endpoint percentiles.

Each scrape also fetches the sidecar's `/usage` payload (accounting
plane): the per-endpoint payloads join into ONE fleet
TOP-by-cost table — a row per principal summed across tiers, ranked
on `--sort-usage`, a BUDG column for soft-budget state, a TOTAL row
equal to the summed per-process grand totals, and `--principal ID`
drills one tenant down to which endpoint billed what. Sidecars that
predate the plane (404) or opted out (`GOL_TPU_ACCOUNTING=0`) simply
contribute no usage rows.

A controller sidecar (control plane) renders as a `ctl`-tagged
row plus a desired-vs-observed diff line under the tree — the console
is where an operator checks whether the reconciler has converged.

`--once` prints a single non-interactive snapshot (no rates — there is
no previous sample) and exits 0 as long as every endpoint answered —
the CI mode `scripts/metrics_smoke.sh` drives. Live mode redraws with
ANSI clears every `--interval` seconds until Ctrl-C. A down endpoint
renders as `DOWN` and never kills the loop (fleets have partial
outages; that is when you want the console most).

Stdlib only, read-only, loopback-friendly: every request carries a
timeout, nothing is written anywhere.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import deque
from typing import List, Optional

# The scrape + join layer moved to gol_tpu_torch.obs.scrape so the
# controller reconciles against the SAME parser and tree the console
# renders. Re-exported here: every pre-18 `from gol_tpu_torch.obs.console
# import parse_prometheus` call site (tests, smoke harnesses) keeps
# working.
from gol_tpu_torch.obs.scrape import (  # noqa: F401  (re-exports)
    Endpoint,
    Series,
    build_tree,
    fleet_snapshot,
    histogram_buckets,
    history_snapshot,
    label_value,
    max_series,
    merge_usage,
    parse_prometheus,
    sum_series,
)

__all__ = [
    "Endpoint",
    "build_tree",
    "fleet_snapshot",
    "histogram_buckets",
    "history_snapshot",
    "label_value",
    "main",
    "merge_usage",
    "parse_prometheus",
    "render",
    "render_tree",
    "render_usage",
    "spark",
    "sum_series",
]


# --- rendering -----------------------------------------------------------


def _num(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if unit == "bytes":
        for suffix, scale in (("G", 1 << 30), ("M", 1 << 20),
                              ("K", 1 << 10)):
            if v >= scale:
                return f"{v / scale:.1f}{suffix}"
        return str(int(v))
    if unit == "s":
        return f"{v * 1e3:.1f}ms" if abs(v) < 1.0 else f"{v:.2f}s"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}M"
    if abs(v) >= 1e4:
        return f"{v / 1e3:.1f}k"
    if v == int(v):
        return str(int(v))
    return f"{v:.1f}"


#: Sparkline glyphs, lowest to highest.
_SPARK_BARS = "▁▂▃▄▅▆▇█"


def spark(points, width: int = 8) -> str:
    """Unicode sparkline of a [[ts, value], ...] (or bare value) list
    — the per-row turns/s history column. Min-max normalized; a flat
    non-empty series renders mid-height so 'steady' and 'no data'
    ('-') look different."""
    vals = [(p[1] if isinstance(p, (list, tuple)) else p)
            for p in (points or [])]
    vals = [v for v in vals if v is not None][-width:]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_BARS[3] * len(vals)
    n = len(_SPARK_BARS) - 1
    return "".join(
        _SPARK_BARS[round((v - lo) / (hi - lo) * n)] for v in vals
    )


_COLUMNS = (
    ("endpoint", "ENDPOINT", 21, None),
    ("turn", "TURN", 9, ""),
    ("turns_per_sec", "TURNS/S", 9, ""),
    ("spark", "HIST", 8, None),
    ("sessions", "SESS", 5, ""),
    ("peers", "PEERS", 5, ""),
    ("peer_lag", "LAG", 5, ""),
    ("turn_age_s", "AGE", 8, "s"),
    ("alerts_firing", "ALRT", 4, ""),
    ("degradations", "DEGR", 5, ""),
    ("reconnects", "RECON", 5, ""),
    ("clock_offset_s", "CLOCK", 8, "s"),
    ("compiles", "COMPS", 5, ""),
    ("hbm_watermark_bytes", "HBM^", 7, "bytes"),
    ("p50", "P50", 8, "s"),
    ("p95", "P95", 8, "s"),
    ("p99", "P99", 8, "s"),
)


def _cells(row: dict) -> list:
    lat = row.get("latency") or {}
    cells = []
    for key, _, width, unit in _COLUMNS:
        if key == "endpoint":
            name = str(row.get("endpoint", "TOTAL"))
            if row.get("mode") == "replay":
                # Replay servers render DISTINCTLY: no engine behind
                # them, their SESS column carries recordings.
                name = f"{name} ⟲"
            elif row.get("controller") is not None:
                name = f"{name} ctl"
            cells.append(name[:width])
        elif key == "sessions" and row.get("mode") == "replay":
            cells.append(_num(row.get("recordings"), unit))
        elif key == "spark":
            cells.append(spark(row.get("spark"))[:width])
        elif key in ("p50", "p95", "p99"):
            cells.append(_num(lat.get(key), "s"))
        else:
            cells.append(_num(row.get(key), unit))
    return cells


def render_tree(tree: List[dict], out=None) -> None:
    out = out or sys.stdout

    def line(n, indent):
        peers = n.get("peers")
        ws = n.get("ws_peers")
        bits = [f"{_num(peers)} peers" if peers is not None else "?"]
        if ws:
            bits.append(f"{_num(ws)} ws")
        if n.get("hop_latency_s") is not None and n.get("upstream"):
            bits.append(f"+{_num(n['hop_latency_s'], 's')}/hop")
        tag = ("replay" if n.get("mode") == "replay"
               else "root" if not n.get("upstream")
               else f"depth {_num(n.get('depth'))}")
        out.write(f"{'  ' * indent}{'└─ ' if indent else ''}"
                  f"{n['listen']}  [{tag}]  {', '.join(bits)}\n")
        for c in n["children"]:
            line(c, indent + 1)

    if tree:
        out.write("fan-out tree:\n")
        for n in tree:
            line(n, 0)


def render_controller(rows: List[dict], out=None) -> None:
    """The desired-vs-observed diff line per controller row: whether
    the reconciler has converged, and how many actions it has taken
    (error outcomes called out — they are the off-zero bench gate)."""
    out = out or sys.stdout
    for r in rows:
        if not r.get("up") or r.get("controller") is None:
            continue
        want, have = r.get("desired_nodes"), r.get("observed_nodes")
        if want is None and have is None:
            continue
        state = ("converged" if want == have
                 else f"RECONCILING ({_num(have)}/{_num(want)} nodes)")
        bits = [f"desired {_num(want)}", f"observed {_num(have)}", state]
        acts = r.get("controller_actions")
        if acts is not None:
            bits.append(f"{_num(acts)} actions")
        fails = r.get("controller_action_failures")
        if fails:
            bits.append(f"!! {_num(fails)} failed")
        out.write(f"controller {r.get('controller')} "
                  f"@{r['endpoint']}:  {', '.join(bits)}\n")


#: TOP-by-cost columns: (resource key, header, width, unit).
_USAGE_COLUMNS = (
    ("flops", "FLOPS", 9, ""),
    ("dispatch_seconds", "DISP", 8, "s"),
    ("host_seconds", "HOST", 8, "s"),
    ("wire_bytes", "WIRE", 7, "bytes"),
    ("queue_frame_seconds", "QOCC", 8, "s"),
    ("turns", "TURNS", 9, ""),
)


def render_usage(usage: Optional[dict], out=None, top: int = 10,
                 principal: Optional[str] = None,
                 rows: Optional[List[dict]] = None) -> None:
    """The fleet TOP-by-cost table: one row per principal (session id,
    peer:<token>, or the anonymous `legacy` tier), most expensive
    first on the snapshot's sort key, a BUDG column for soft-budget
    state (OVER is advisory — the accounting plane never enforces),
    and a TOTAL row summing the per-process grand totals. With
    `principal` set, a drill-down follows: that tenant's share at each
    scraped endpoint (which tier billed what)."""
    out = out or sys.stdout
    w = out.write
    if usage is None:
        return
    by = usage["by_principal"]
    ranked = usage["ranked"]
    w(f"usage — top by {usage.get('sort', 'flops')} "
      f"({len(ranked)} principals)\n")
    header = f"{'PRINCIPAL':<21}  " + "  ".join(
        f"{title:>{width}}" for _, title, width, _ in _USAGE_COLUMNS
    ) + "  BUDG"
    w(header + "\n")

    def line(name, res):
        cells = "  ".join(
            f"{_num(res.get(key), unit):>{width}}"
            for key, _, width, unit in _USAGE_COLUMNS
        )
        budg = "OVER" if res.get("over_budget") else "-"
        w(f"{name[:21]:<21}  {cells}  {budg:>4}\n")

    for p in ranked[:max(0, top)]:
        line(p, by[p])
    if len(ranked) > top:
        w(f"… {len(ranked) - top} more principals\n")
    line("TOTAL", usage.get("total") or {})
    if principal is not None:
        w(f"usage drill-down — {principal}:\n")
        found = False
        for r in rows or []:
            u = r.get("usage") or {}
            res = (u.get("principals") or {}).get(principal)
            if res is None:
                continue
            found = True
            line(f"  @{r.get('endpoint', '?')}", res)
        if not found:
            w("  (no endpoint reports this principal)\n")


def render(snap: dict, out=None, clear: bool = False,
           usage_top: int = 10,
           principal: Optional[str] = None) -> None:
    out = out or sys.stdout
    w = out.write
    if clear:
        w("\x1b[2J\x1b[H")
    w("gol_tpu fleet console — %s  (%d/%d endpoints up)\n" % (
        time.strftime("%H:%M:%S"),
        snap["total"]["up"], snap["total"]["endpoints"],
    ))
    header = "  ".join(
        f"{title:>{width}}" if key != "endpoint" else f"{title:<{width}}"
        for key, title, width, _ in _COLUMNS
    )
    w(header + "\n")
    for row in snap["rows"]:
        if not row.get("up"):
            w(f"{row['endpoint']:<21}  DOWN  {row.get('error', '')}\n")
            continue
        cells = _cells(row)
        w("  ".join(
            f"{c:>{width}}" if key != "endpoint" else f"{c:<{width}}"
            for (key, _, width, _), c in zip(_COLUMNS, cells)
        ) + "\n")
    if len(snap["rows"]) > 1:
        t = dict(snap["total"])
        t["endpoint"] = "TOTAL"
        cells = _cells(t)
        w("  ".join(
            f"{c:>{width}}" if key != "endpoint" else f"{c:<{width}}"
            for (key, _, width, _), c in zip(_COLUMNS, cells)
        ) + "\n")
    tree = snap.get("tree") or []
    if any(n["children"] or n.get("upstream") for n in tree):
        render_tree(tree, out)
    render_controller(snap["rows"], out)
    render_usage(snap.get("usage"), out, top=usage_top,
                 principal=principal, rows=snap["rows"])
    for a in snap["total"].get("alerts") or []:
        w(f"!! ALERT firing on {a['endpoint']}: {a['rule']}\n")
    viol = snap["total"].get("violations")
    if viol:
        w(f"!! INVARIANT VIOLATIONS across the fleet: {int(viol)}\n")


# --- entry ---------------------------------------------------------------


def _duration_secs(spec: str) -> float:
    """'60s' / '5m' / '1h' / bare '90' -> seconds."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([smh]?)", spec.strip())
    if not m:
        raise ValueError(f"cannot parse duration {spec!r} "
                         "(expected e.g. 60s, 5m, 1h)")
    return float(m.group(1)) * {"": 1.0, "s": 1.0,
                                "m": 60.0, "h": 3600.0}[m.group(2)]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.obs.console",
        description="top-like live view over gol_tpu /metrics endpoints",
    )
    ap.add_argument("endpoints", nargs="+", metavar="HOST:PORT",
                    help="metrics sidecars to scrape (a bare PORT means "
                         "loopback; full http:// URLs accepted)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (CI mode; exits 1 "
                         "if any endpoint is down, 2 if any alert rule "
                         "is firing)")
    ap.add_argument("--interval", type=float, default=2.0, metavar="SEC",
                    help="live-mode refresh cadence (default 2)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the snapshot as JSON instead of the table")
    ap.add_argument("--sort-usage", default="flops",
                    choices=("flops", "dispatch_seconds", "host_seconds",
                             "wire_bytes", "queue_frame_seconds",
                             "turns"),
                    help="resource the TOP-by-cost usage table ranks on "
                         "(default flops)")
    ap.add_argument("--usage-top", type=int, default=10, metavar="N",
                    help="labeled rows in the usage table before the "
                         "'… more' fold (default 10)")
    ap.add_argument("--principal", default=None, metavar="ID",
                    help="drill into one tenant: its usage share at "
                         "every scraped endpoint")
    ap.add_argument("--since", default=None, metavar="DUR",
                    help="render from the history plane instead of "
                         "live scrapes: the single endpoint is a "
                         "--collector sidecar, rows come from its "
                         "/history window of DUR (e.g. 60s, 5m)")
    args = ap.parse_args(argv)

    if args.since is not None:
        try:
            since = _duration_secs(args.since)
        except ValueError as e:
            ap.error(str(e))
        if len(args.endpoints) != 1:
            ap.error("--since takes exactly one endpoint "
                     "(the collector's metrics sidecar)")

        def take_snapshot():
            return history_snapshot(args.endpoints[0], since,
                                    usage_sort=args.sort_usage)
    else:
        eps = [Endpoint(spec) for spec in args.endpoints]
        #: Live-mode per-endpoint turns/s history feeding the HIST
        #: sparkline column (the --since path gets its points from
        #: the collector instead).
        spark_hist: dict = {}

        def take_snapshot():
            snap = fleet_snapshot(eps, usage_sort=args.sort_usage)
            for row in snap["rows"]:
                if not row.get("up"):
                    continue
                ring = spark_hist.setdefault(
                    row["endpoint"], deque(maxlen=16))
                if row.get("turns_per_sec") is not None:
                    ring.append(row["turns_per_sec"])
                row["spark"] = list(ring)
            return snap

    if args.once:
        snap = take_snapshot()
        if args.as_json:
            snap = {**snap, "rows": [
                {k: v for k, v in r.items() if k != "latency_buckets"}
                for r in snap["rows"]
            ]}
            print(json.dumps(snap, indent=1))
        else:
            render(snap, usage_top=args.usage_top,
                   principal=args.principal)
        if snap["down"]:
            return 1
        # Firing alerts are a CI failure too (freshness plane): the
        # distinct code lets a harness tell "endpoint down" from
        # "SLO broken".
        return 2 if snap["total"].get("alerts") else 0
    try:
        while True:
            snap = take_snapshot()
            if args.as_json:
                print(json.dumps(snap["total"]))
            else:
                render(snap, clear=True, usage_top=args.usage_top,
                       principal=args.principal)
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
