"""The reconciling fleet controller (docs/CONTROL.md).

One level-triggered loop: scrape observed state (the SAME
`gol_tpu_torch.obs.scrape` join the console renders), diff it against the
declarative `FleetSpec`, and apply at most `actions_per_round`
corrective verbs — heal, roll, migrate, scale, in that priority order
(a dead relay starves observers NOW; an over-provisioned tree merely
wastes a process). The loop never remembers what it "already did":
every round re-derives its worklist from observation plus the
crash-atomic `ControllerManifest`, so a controller SIGKILLed between
any two statements resumes by reconciling, not by replaying a journal.

Safety rules every verb obeys:

- **budget** — at most `actions_per_round` verbs per round; work left
  over waits for the next round (`budget_exhausted_total` counts the
  rounds that clipped).
- **staleness** — a destructive verb (kill, park, destroy, drain) is
  refused unless the evidence endpoint answered a scrape within
  `stale_secs` (`stale_refusals_total`); acting on a stale picture is
  how controllers kill healthy nodes.
- **backoff** — a failing action key retries under seeded-jitter
  exponential backoff (the discipline), so a flapping alert
  cannot spawn-storm the host.
- **drain-then-kill** — a retiring relay's children are re-pointed
  first and the retiree is killed only once a FRESH scrape observes
  zero peers; a rolling engine is drained (checkpoint-all + refuse new
  session attaches) before its SIGTERM, and comes back behind
  `--resume latest` + coalesced BoardSync.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from gol_tpu_torch import obs
from gol_tpu_torch.analysis.concurrency import lockcheck
from gol_tpu_torch.control.manifest import ControllerManifest
from gol_tpu_torch.control.spec import EngineSpec, FleetSpec
from gol_tpu_torch.distributed import wire
from gol_tpu_torch.obs import flight, tracing
from gol_tpu_torch.obs.scrape import Endpoint, fleet_snapshot

log = logging.getLogger(__name__)

__all__ = ["Controller", "engine_cost", "repoint_relay"]

_RELAY_BANNER = re.compile(
    r"relay serving on ([\w.-]+:\d+) \(upstream [\w.-]+:\d+\)"
)
_ENGINE_BANNER = re.compile(r"session engine serving on ([\w.-]+:\d+)")
_METRICS_BANNER = re.compile(r"metrics serving on http://([\w.-]+:\d+)")


def repoint_relay(addr: str, new_upstream: str,
                  secret: Optional[str] = None,
                  timeout: float = 10.0) -> dict:
    """Send the `repoint` verb to a relay's DOWNSTREAM listener: dial,
    hello (binary — the relay tier's capability floor), wait for the
    attach-ack, issue the verb, and read frames until the `repoint-r`
    answer (board syncs and heartbeats ride the same link and are
    skipped). Raises WireError on a reasoned rejection; OSError family
    on link failures — the caller's backoff owns retries."""
    from gol_tpu_torch.testing import faults

    host, _, port = str(addr).rpartition(":")
    sock = faults.wrap("client", socket.create_connection(
        (host, int(port)), timeout=timeout
    ))
    try:
        sock.settimeout(timeout)
        hello = {"t": "hello", "binary": True, "want_flips": False,
                 "role": "observe"}
        if secret is not None:
            hello["secret"] = secret
        wire.send_msg(sock, hello)
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() > deadline:
                raise wire.WireError("repoint verb timed out")
            msg = wire.recv_msg(sock)
            if msg is None:
                raise wire.WireError("relay closed before repoint-r")
            t = msg.get("t")
            if t == "error":
                raise wire.WireError(
                    f"relay rejected: {msg.get('reason', 'rejected')}"
                )
            if t == "attach-ack":
                wire.send_msg(sock, {"t": "repoint",
                                     "addr": new_upstream})
            elif t == "repoint-r":
                if not msg.get("ok"):
                    raise wire.WireError(
                        f"repoint refused: {msg.get('reason')}"
                    )
                return msg
            # board / fbatch / hb / clk frames: not ours, skip.
    finally:
        with contextlib.suppress(OSError):
            sock.close()


def engine_cost(out_dir: str) -> float:
    """One engine's attributable load, read from its crash-safe usage
    ledgers (accounting plane, <out>/usage): the seconds-denominated
    resources summed across every principal — time an engine spent
    working for tenants is the comparable currency across engines
    (FLOPs and wire bytes scale with board geometry, not load). An
    absent or torn ledger reads as 0: a fresh engine is the cheapest
    by definition, which is exactly where a new session belongs."""
    from gol_tpu_torch.obs import accounting

    totals = accounting.read_ledger(os.path.join(out_dir, "usage"))
    cost = 0.0
    for res in totals.values():
        for key in ("dispatch_seconds", "host_seconds",
                    "queue_frame_seconds"):
            try:
                cost += float(res.get(key, 0.0) or 0.0)
            except (TypeError, ValueError):
                continue
    return cost


class _CtlMetrics:
    def __init__(self, spec_name: str):
        obs.gauge(
            "gol_tpu_controller_info",
            "Controller identity (value 1): which spec this process "
            "reconciles — obs.console decorates its fleet row with it",
            {"spec": spec_name},
        ).set(1)
        self.desired = obs.gauge(
            "gol_tpu_controller_desired_nodes",
            "Node count the spec wants (relays wanted by the scale "
            "rule + declared engines)",
        )
        self.observed = obs.gauge(
            "gol_tpu_controller_observed_nodes",
            "Node count the last reconcile round actually observed up",
        )
        self.rounds = obs.counter(
            "gol_tpu_controller_rounds_total",
            "Reconcile rounds completed (scrape + diff + actions)",
        )
        self.budget_exhausted = obs.counter(
            "gol_tpu_controller_budget_exhausted_total",
            "Rounds that still had corrective work after spending the "
            "actions_per_round budget",
        )
        self.stale_refusals = obs.counter(
            "gol_tpu_controller_stale_refusals_total",
            "Destructive actions refused because the evidence scrape "
            "was older than stale_secs",
        )
        self.scale_source = {
            src: obs.counter(
                "gol_tpu_controller_scale_decisions_total",
                "Scale-rule evaluations by evidence source: 'history' "
                "(canary turn-age queried from the collector, "
                "sustained over canary_for_secs) or 'peers' (live "
                "peer-count fallback)",
                {"source": src},
            ) for src in ("history", "peers")
        }
        self.last_heal = obs.gauge(
            "gol_tpu_controller_last_heal_seconds",
            "Wall seconds the most recent heal took: dead-relay "
            "detection confirmed -> replacement spawned -> orphan "
            "subtree re-pointed (the control_heal bench lane)",
        )
        self._actions: Dict[Tuple[str, str], object] = {}

    def action(self, verb: str, outcome: str) -> None:
        key = (verb, outcome)
        c = self._actions.get(key)
        if c is None:
            c = obs.counter(
                "gol_tpu_controller_actions_total",
                "Corrective verbs applied by the reconcile loop, by "
                "verb (heal/scale/migrate/roll/spawn) and outcome "
                "(ok/error)",
                {"verb": verb, "outcome": outcome},
            )
            self._actions[key] = c
        c.inc()


class Controller:
    """The reconcile loop over one `FleetSpec`. `reconcile_once` is
    the whole control plane — `start()` merely repeats it on
    `spec.interval_secs`; tests drive it directly (optionally with an
    injected snapshot, so every refusal path is unit-testable without
    a process mesh)."""

    def __init__(self, spec: FleetSpec, *, out_dir: str,
                 seed: Optional[int] = None):
        self.spec = spec
        self.out_dir = os.fspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.manifest = ControllerManifest(
            os.path.join(self.out_dir, "controller.json"))
        self._rng = random.Random(seed)
        self._metrics = _CtlMetrics(os.path.basename(spec.path))
        self._lock = lockcheck.make_lock("Controller._lock")
        #: spec string -> Endpoint (persistent: rates need prev samples).
        self._endpoints: Dict[str, Endpoint] = {}
        for s in spec.scrape:
            self._endpoints[s] = Endpoint(s)
        for e in spec.engines:
            if e.metrics is not None:
                self._endpoints.setdefault(e.metrics, Endpoint(e.metrics))
        #: Last OBSERVED identity per endpoint spec — what we still
        #: know about a node after it stops answering (heal needs the
        #: dead relay's listen + upstream).
        self._ident: Dict[str, dict] = {}
        self._last_ok: Dict[str, float] = {}
        self._down: Dict[str, int] = {}
        #: action key -> (attempt, not-before monotonic).
        self._backoff: Dict[str, Tuple[int, float]] = {}
        #: Relays mid-retirement (listen addrs): children re-pointed,
        #: waiting for an observed-zero-peers scrape before the kill.
        self._retiring: set = set()
        self._procs: Dict[str, subprocess.Popen] = {}
        self._ctls: Dict[str, object] = {}
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rounds = 0
        self.last_summary: dict = {}
        # Re-adopt spawned nodes from a previous incarnation: their
        # metrics endpoints re-enter the scrape set (Popen children
        # survive a controller SIGKILL; the manifest remembers them).
        for kind in ("relays", "engines"):
            for listen, meta in self.manifest.spawned(kind).items():
                if meta.get("metrics"):
                    self._endpoints.setdefault(meta["metrics"],
                                               Endpoint(meta["metrics"]))

    # --- lifecycle (the relay/server idiom) ---

    def start(self) -> "Controller":
        t = threading.Thread(target=self._run_loop,
                             name="gol-control-reconcile", daemon=True)
        t.start()
        self._thread = t
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown.wait(timeout)

    def shutdown(self) -> None:
        """Stop reconciling. Spawned fleet processes are LEFT RUNNING
        — a control-plane restart must never take the data plane down
        with it (the manifest lets the next incarnation re-adopt
        them)."""
        self._shutdown.set()
        for ctl in self._ctls.values():
            with contextlib.suppress(Exception):
                ctl.close()
        self._ctls.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self.reconcile_once()
            except Exception:
                # The loop IS the product: one broken round must never
                # end reconciliation (level-triggered — next round
                # re-observes from scratch).
                log.exception("reconcile round failed")
            self._shutdown.wait(self.spec.interval_secs)

    def health(self) -> dict:
        with self._lock:
            return {
                "mode": "control",
                "spec": self.spec.path,
                "rounds": self.rounds,
                "retiring": sorted(self._retiring),
                "pending_migrations":
                    len(self.manifest.pending_migrations()),
                "last_round": dict(self.last_summary),
            }

    # --- the round ---

    def reconcile_once(self, snapshot: Optional[dict] = None,
                       now: Optional[float] = None) -> dict:
        """One level-triggered round. Returns the summary dict (also
        kept as `last_summary` for /healthz). `snapshot` injects a
        pre-built `fleet_snapshot` result (tests); `now` pins the
        staleness clock."""
        if now is None:
            now = time.monotonic()
        if snapshot is None:
            snapshot = fleet_snapshot(list(self._endpoints.values()))
            # fleet_snapshot just scraped: every up row is fresh NOW.
            for row in snapshot["rows"]:
                if row.get("up"):
                    self._last_ok[row["endpoint"]] = now
        rows = [r for r in snapshot.get("rows", []) if r.get("up")]
        down_specs = set(snapshot.get("down", []))
        self._observe(rows, down_specs)

        actions: List[dict] = []
        actions += self._plan_heal(rows, now)
        actions += self._plan_roll(rows, now)
        actions += self._plan_migrate(now)
        actions += self._plan_scale(rows, snapshot.get("tree", []), now)

        budget = self.spec.actions_per_round
        applied, deferred, refused = [], 0, 0
        for action in actions:
            if budget <= 0:
                self._metrics.budget_exhausted.inc()
                break
            key = action["key"]
            attempt, not_before = self._backoff.get(key, (0, 0.0))
            if now < not_before:
                deferred += 1
                continue
            if action.get("evidence") is not None and not self._fresh(
                action["evidence"], now
            ):
                self._metrics.stale_refusals.inc()
                refused += 1
                continue
            budget -= 1
            try:
                action["fn"]()
            except Exception as e:
                self._metrics.action(action["verb"], "error")
                delay = min(2.0, 0.05 * (2 ** min(attempt, 10)))
                delay *= 0.5 + self._rng.random()
                self._backoff[key] = (attempt + 1, now + delay)
                log.warning("action %s failed: %s", key, e)
                flight.note("control.action_failed", key=key,
                            error=str(e))
                applied.append({"key": key, "verb": action["verb"],
                                "ok": False, "error": str(e)})
            else:
                self._metrics.action(action["verb"], "ok")
                self._backoff.pop(key, None)
                applied.append({"key": key, "verb": action["verb"],
                                "ok": True})

        desired = (self._want_relays(rows)
                   + len(self.spec.engines))
        observed = len(rows)
        self._metrics.desired.set(desired)
        self._metrics.observed.set(observed)
        self._metrics.rounds.inc()
        summary = {
            "desired": desired, "observed": observed,
            "planned": len(actions), "applied": applied,
            "deferred": deferred, "stale_refused": refused,
            "budget_left": budget,
        }
        with self._lock:
            self.rounds += 1
            self.last_summary = summary
        tracing.event("control.round", "lifecycle",
                      planned=len(actions), applied=len(applied))
        return summary

    def _observe(self, rows: List[dict], down_specs: set) -> None:
        for row in rows:
            spec_str = row["endpoint"]
            self._down[spec_str] = 0
            if row.get("listen"):
                self._ident[spec_str] = {
                    "listen": row["listen"],
                    "upstream": row.get("upstream"),
                    "relay": row.get("upstream") is not None,
                }
        for spec_str in down_specs:
            self._down[spec_str] = self._down.get(spec_str, 0) + 1

    def _fresh(self, spec_str: str, now: float) -> bool:
        last = self._last_ok.get(spec_str)
        return last is not None and (now - last) <= self.spec.stale_secs

    # --- heal ---

    def _plan_heal(self, rows: List[dict], now: float) -> List[dict]:
        actions = []
        spawned_relays = self.manifest.spawned("relays")
        spawned_engines = self.manifest.spawned("engines")
        handled = set()
        for spec_str, misses in sorted(self._down.items()):
            if misses < self.spec.down_rounds:
                continue
            ident = self._ident.get(spec_str)
            if ident is None:
                # An endpoint that never answered carries no identity
                # to heal around; engines are matched below by their
                # declared metrics spec instead.
                eng = self._engine_by_metrics(spec_str)
                if eng is not None and eng.spawn:
                    actions.append(self._heal_engine_action(eng))
                    handled.add(eng.addr)
                continue
            if ident["relay"]:
                listen = ident["listen"]
                if listen in self._retiring:
                    continue  # dying on purpose
                actions.append({
                    "verb": "heal", "key": f"heal:{listen}",
                    "evidence": None,  # the evidence IS the absence
                    "fn": lambda s=spec_str, i=ident, r=rows:
                        self._heal_relay(s, i, r),
                })
            else:
                eng = self._engine_by_metrics(spec_str)
                if eng is not None and eng.spawn:
                    actions.append(self._heal_engine_action(eng))
                    handled.add(eng.addr)
        # Alert-driven heal: a relay that still answers scrapes but
        # has one of the spec's heal alerts firing (turn-age SLO blown
        # = the node forwards nothing useful) is replaced the same way.
        if self.spec.heal_alerts:
            want = set(self.spec.heal_alerts)
            for row in rows:
                if row.get("upstream") is None:
                    continue
                if row["listen"] in self._retiring:
                    continue
                if want & set(row.get("alerts") or ()):
                    ident = {"listen": row["listen"],
                             "upstream": row.get("upstream"),
                             "relay": True}
                    actions.append({
                        "verb": "heal",
                        "key": f"heal:{row['listen']}",
                        "evidence": row["endpoint"],
                        "fn": lambda s=row["endpoint"], i=ident, r=rows:
                            self._heal_relay(s, i, r),
                    })
        # Managed engines never seen at all (first boot): spawn them.
        for eng in self.spec.engines:
            if not eng.spawn or eng.addr in handled:
                continue
            if eng.addr in spawned_engines or eng.addr in self._procs:
                continue
            if eng.metrics is not None and self._last_ok.get(eng.metrics):
                continue  # answered at least once: it exists
            actions.append({
                "verb": "spawn", "key": f"spawn:{eng.addr}",
                "evidence": None,
                "fn": lambda e=eng: self._spawn_engine(e),
            })
        # Spawned relays whose record outlived the process (pid gone,
        # endpoint down): drop the registry entry so scale re-counts.
        for listen, meta in spawned_relays.items():
            pid = meta.get("pid")
            if pid and not _pid_alive(pid):
                m = meta.get("metrics")
                if m is None or self._down.get(m, 0) > 0:
                    self.manifest.forget_spawn("relays", listen)
                    self._retiring.discard(listen)
        return actions

    def _engine_by_metrics(self, spec_str: str) -> Optional[EngineSpec]:
        for e in self.spec.engines:
            if e.metrics == spec_str:
                return e
        return None

    def _heal_engine_action(self, eng: EngineSpec) -> dict:
        return {
            "verb": "heal", "key": f"heal-engine:{eng.addr}",
            "evidence": None,
            "fn": lambda e=eng: self._spawn_engine(e),
        }

    def _heal_relay(self, spec_str: str, ident: dict,
                    rows: List[dict]) -> None:
        """Replace one dead relay: spawn a fresh `--relay` on the dead
        node's upstream, then re-point every orphaned child at the
        replacement. Bit-exactness is the data plane's job — each
        re-pointed child re-attaches with a fresh BoardSync and its
        leaves ride the reconnect."""
        t0 = time.monotonic()
        dead_listen = ident["listen"]
        upstream = ident.get("upstream") or self.spec.root
        listen, metrics = self._spawn_relay(upstream)
        orphans = [r for r in rows
                   if r.get("upstream") == dead_listen
                   and r.get("listen") != listen]
        for child in orphans:
            repoint_relay(child["listen"], listen,
                          secret=self.spec.secret)
        # The dead node's books: registry entry, scrape endpoint,
        # identity — all retired with it.
        self.manifest.forget_spawn("relays", dead_listen)
        self._endpoints.pop(spec_str, None)
        self._ident.pop(spec_str, None)
        self._down.pop(spec_str, None)
        self._last_ok.pop(spec_str, None)
        took = time.monotonic() - t0
        self._metrics.last_heal.set(took)
        log.info("healed relay %s -> %s (%d orphans re-pointed, "
                 "%.2fs)", dead_listen, listen, len(orphans), took)
        tracing.event("control.heal", "lifecycle", dead=dead_listen,
                      replacement=listen, orphans=len(orphans))
        flight.note("control.heal", dead=dead_listen,
                    replacement=listen, seconds=round(took, 3))

    # --- scale ---

    def _want_relays(self, rows: List[dict]) -> int:
        """The scale rule: enough relays that no one carries more than
        `observers_per_relay` downstreams, clamped to [min, max]."""
        observers = 0.0
        for r in rows:
            if r.get("upstream") is not None:
                observers += (r.get("relay_peers") or 0)
                observers += (r.get("ws_peers") or 0)
            elif r.get("listen"):
                observers += (r.get("peers") or 0)
        want = -(-int(observers) // int(self.spec.observers_per_relay))
        return max(self.spec.relay_min,
                   min(self.spec.relay_max, want))

    def _canary_age_points(self) -> Optional[List[Tuple[float, float]]]:
        """The canary's MEASURED turn-age history over the trailing
        `canary_for_secs` window, queried from the collector's /query
        API: [(ts, age)], newest last — or None when no collector is
        configured or the query fails (the caller falls back to the
        live peer-count rule)."""
        if self.spec.collector is None \
                or self.spec.canary_max_age_s is None:
            return None
        window = max(2.0, self.spec.canary_for_secs)
        step = max(0.5, window / 8.0)
        url = (f"http://{self.spec.collector}/query"
               f"?expr=max(gol_tpu_client_turn_age_seconds)"
               f"&start=-{window}&end=-0&step={step}")
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                payload = json.loads(r.read())
            return [(float(p[0]), float(p[1]))
                    for p in payload["series"][0]["points"]
                    if p[1] is not None]
        except Exception as e:
            log.warning("collector query failed (%s): falling back "
                        "to the peer-count scale rule", e)
            return None

    def _want_relays_from_history(self, have: int) -> Optional[int]:
        """The SLO-history scale rule: grow when the canary's queried
        turn age breached `canary_max_age_s` for the WHOLE window
        (every recorded point — one noisy scrape holds, it never
        pages a spawn), shrink when the whole window sat in deep
        comfort (< 1/4 of the SLO). Anything in between — including a
        window with too few points to judge — holds the current count.
        None = no usable history; use the peer-count rule."""
        points = self._canary_age_points()
        if points is None or len(points) < 2:
            return None
        max_age = self.spec.canary_max_age_s
        values = [v for _, v in points]
        lo, hi = self.spec.relay_min, self.spec.relay_max
        if all(v > max_age for v in values):
            return max(lo, min(hi, have + 1))
        if all(v < 0.25 * max_age for v in values):
            return max(lo, min(hi, have - 1))
        return max(lo, min(hi, have))

    def _plan_scale(self, rows: List[dict], tree: List[dict],
                    now: float) -> List[dict]:
        actions = []
        live_relays = [r for r in rows
                       if r.get("upstream") is not None
                       and r["listen"] not in self._retiring]
        have = len(live_relays)
        want = self._want_relays_from_history(have)
        if want is not None:
            self._metrics.scale_source["history"].inc()
        else:
            want = self._want_relays(rows)
            self._metrics.scale_source["peers"].inc()
        # A node mid-debounce (missed a scrape but not yet confirmed
        # dead by down_rounds) makes `have` ambiguous: growing against
        # that dip double-provisions — the node either comes back (the
        # grow was spurious) or is confirmed dead and HEALED (the
        # replacement fills the same slot). Hold growth until the
        # picture settles; shrink/kill are already evidence-gated.
        ambiguous = any(
            0 < misses < self.spec.down_rounds
            for spec_str, misses in self._down.items()
            if self._ident.get(spec_str, {}).get("relay")
        )
        if have < want and not ambiguous:
            for i in range(want - have):
                actions.append({
                    "verb": "scale", "key": f"scale:grow:{i}",
                    "evidence": None,
                    "fn": lambda: self._grow(),
                })
        elif have > want:
            actions += self._plan_shrink(rows, have - want, now)
        # Retiring relays drained to zero observed peers on a FRESH
        # scrape: finish the kill.
        for row in rows:
            listen = row.get("listen")
            if listen not in self._retiring:
                continue
            if (row.get("relay_peers") or 0) == 0 \
                    and (row.get("ws_peers") or 0) == 0:
                actions.append({
                    "verb": "scale", "key": f"scale:kill:{listen}",
                    "evidence": row["endpoint"],
                    "fn": lambda l=listen, s=row["endpoint"]:
                        self._kill_retired(l, s),
                })
        return actions

    def _plan_shrink(self, rows: List[dict], excess: int,
                     now: float) -> List[dict]:
        """Retire = drain-then-kill: re-point the victim's children at
        its upstream NOW, kill only on a later round's observed-empty
        scrape. Only controller-spawned relays are candidates — the
        controller never kills a node an operator started."""
        actions = []
        spawned = self.manifest.spawned("relays")
        candidates = sorted(
            r["listen"] for r in rows
            if r.get("upstream") is not None
            and r["listen"] in spawned
            and r["listen"] not in self._retiring
        )
        for listen in list(reversed(candidates))[:excess]:
            row = next(r for r in rows if r.get("listen") == listen)
            actions.append({
                "verb": "scale", "key": f"scale:retire:{listen}",
                "evidence": row["endpoint"],
                "fn": lambda l=listen, r=rows: self._retire(l, r),
            })
        return actions

    def _grow(self) -> None:
        listen, _ = self._spawn_relay(self.spec.root)
        log.info("scaled up: relay %s under %s", listen, self.spec.root)

    def _retire(self, listen: str, rows: List[dict]) -> None:
        victim = next(r for r in rows if r.get("listen") == listen)
        upstream = victim.get("upstream") or self.spec.root
        children = [r for r in rows if r.get("upstream") == listen]
        for child in children:
            repoint_relay(child["listen"], upstream,
                          secret=self.spec.secret)
        self._retiring.add(listen)
        log.info("retiring relay %s (%d children re-pointed to %s); "
                 "kill follows the observed drain", listen,
                 len(children), upstream)
        flight.note("control.retire", listen=listen,
                    children=len(children))

    def _kill_retired(self, listen: str, spec_str: str) -> None:
        meta = self.manifest.spawned("relays").get(listen) or {}
        self._terminate(listen, meta.get("pid"))
        self.manifest.forget_spawn("relays", listen)
        self._retiring.discard(listen)
        self._endpoints.pop(spec_str, None)
        self._ident.pop(spec_str, None)
        self._down.pop(spec_str, None)
        self._last_ok.pop(spec_str, None)
        log.info("retired relay %s (observed drained)", listen)
        flight.note("control.retired", listen=listen)

    # --- migrate ---

    def _plan_migrate(self, now: float) -> List[dict]:
        if not self.spec.sessions and \
                not self.manifest.pending_migrations():
            return []
        actions = []
        # Crash resume FIRST: an open intent is a migration mid-flight
        # whose legs must be re-driven to done/aborted before any new
        # intent for the same placement diff is considered.
        for rid, rec in sorted(self.manifest.pending_migrations().items()):
            actions.append({
                "verb": "migrate", "key": f"migrate:{rec['sid']}",
                "evidence": self._engine_evidence(rec["src"]),
                "fn": lambda r=rid, m=rec: self._drive_migration(r, m),
            })
        planned = {a["key"] for a in actions}
        locations = self._session_locations()
        for sid, dst in sorted(self.spec.sessions.items()):
            if f"migrate:{sid}" in planned:
                continue
            src = locations.get(sid)
            if dst == "auto":
                dst = self._pick_auto_destination(src)
            if src is None or src == dst or dst is None:
                continue
            actions.append({
                "verb": "migrate", "key": f"migrate:{sid}",
                "evidence": self._engine_evidence(src),
                "fn": lambda s=sid, a=src, b=dst:
                    self._begin_migration(s, a, b),
            })
        return actions

    def _pick_auto_destination(self, src: Optional[str]
                               ) -> Optional[str]:
        """Ledger-driven placement for `sessions[sid] == "auto"`: the
        cheapest-loaded declared engine wins (accounting plane,
        `engine_cost`). Ties break to the CURRENT location first — a
        session never churns between equally-loaded engines — then
        lexicographic addr, so the pick is deterministic for any
        ledger state."""
        if not self.spec.engines:
            return None
        ranked = sorted(
            (engine_cost(e.out), e.addr != src, e.addr)
            for e in self.spec.engines
        )
        return ranked[0][2]

    def _engine_evidence(self, addr: Optional[str]) -> Optional[str]:
        if addr is None:
            return None
        eng = self.spec.engine(addr)
        return eng.metrics if eng is not None else None

    def _session_locations(self) -> Dict[str, str]:
        """sid -> engine addr, from live list() verbs (parked sessions
        included — a parked session still LIVES somewhere)."""
        out: Dict[str, str] = {}
        for eng in self.spec.engines:
            try:
                for s in self._ctl(eng.addr).list():
                    out.setdefault(s["id"], eng.addr)
            except Exception as e:
                log.warning("cannot list sessions on %s: %s",
                            eng.addr, e)
        return out

    def _begin_migration(self, sid: str, src: str, dst: str) -> None:
        rid = self.manifest.migration_begin(sid, src, dst)
        rec = self.manifest.migration(rid)
        self._drive_migration(rid, rec)

    def _drive_migration(self, rid: str, rec: dict) -> None:
        """Drive one migration's legs to convergence. Every leg is
        state-based idempotent on the engine side, so this function is
        safe to re-enter from any point — which is exactly what a
        controller SIGKILL between legs turns into."""
        from gol_tpu_torch.sessions.manager import SessionError

        sid, src, dst = rec["sid"], rec["src"], rec["dst"]
        src_eng, dst_eng = self.spec.engine(src), self.spec.engine(dst)
        if src_eng is None or dst_eng is None:
            self.manifest.migration_abort(
                rid, "src/dst no longer declared in the spec")
            return
        dst_ctl = self._ctl(dst)
        src_ctl = self._ctl(src)
        on_dst = {s["id"] for s in dst_ctl.list()}
        try:
            if sid not in on_dst:
                on_src = {s["id"] for s in src_ctl.list()}
                if sid not in on_src:
                    self.manifest.migration_abort(
                        rid, f"session {sid} observed on neither "
                             f"{src} nor {dst}")
                    return
                src_ctl.park(sid)
                dst_ctl.adopt(sid, os.path.abspath(src_eng.out))
            # Adopt landed (this round or a pre-crash one): the source
            # copy retires. destroy is tombstone-first and idempotent,
            # so a crash between adopt and destroy re-runs it safely.
            src_ctl.destroy(sid)
        except SessionError as e:
            # A durable verb rejection (not a link failure): the
            # migration cannot converge. The session stays PARKED on
            # the source — its next attach rehydrates it there, which
            # is the rollback.
            self.manifest.migration_abort(rid, str(e))
            flight.note("control.migrate_abort", sid=sid,
                        reason=str(e))
            return
        self.manifest.migration_done(rid, serving=dst)
        log.info("migrated session %s: %s -> %s", sid, src, dst)
        tracing.event("control.migrate", "lifecycle", sid=sid,
                      src=src, dst=dst)
        flight.note("control.migrate", sid=sid, src=src, dst=dst)

    def _ctl(self, addr: str):
        ctl = self._ctls.get(addr)
        if ctl is None:
            from gol_tpu_torch.distributed.client import SessionControl

            host, _, port = addr.rpartition(":")
            ctl = SessionControl(
                host, int(port), secret=self.spec.secret,
                timeout=15.0, retry_window=20.0,
                retry_seed=self._rng.randrange(2 ** 31),
            )
            self._ctls[addr] = ctl
        return ctl

    # --- roll ---

    def _plan_roll(self, rows: List[dict], now: float) -> List[dict]:
        gen = self.spec.roll_generation
        state = self.manifest.roll_state()
        if gen <= 0 or (state["generation"] == gen
                        and not self._roll_pending(state)):
            return []
        self.manifest.roll_start(gen)
        done = set(self.manifest.roll_done())
        # One engine per round — the whole point of a ROLLING restart.
        for eng in self.spec.engines:
            if not eng.spawn or eng.addr in done:
                continue
            return [{
                "verb": "roll", "key": f"roll:{gen}:{eng.addr}",
                "evidence": eng.metrics,
                "fn": lambda e=eng, g=gen: self._roll_engine(e, g),
            }]
        return []

    def _roll_pending(self, state: dict) -> bool:
        done = set(state.get("done", []))
        return any(e.spawn and e.addr not in done
                   for e in self.spec.engines)

    def _roll_engine(self, eng: EngineSpec, gen: int) -> None:
        """drain -> SIGTERM -> respawn with --resume latest -> mark.
        Drain checkpoints every resident session and refuses new
        session attaches, so the restart window loses nothing; the
        respawned engine rehydrates behind coalesced BoardSync."""
        # A fresh control connection, evicted from the cache — after
        # the restart the cached link would point at a dead socket.
        ctl = self._ctl(eng.addr)
        self._ctls.pop(eng.addr, None)
        try:
            ctl.drain()
        finally:
            with contextlib.suppress(Exception):
                ctl.close()
        meta = self.manifest.spawned("engines").get(eng.addr) or {}
        self._terminate(eng.addr, meta.get("pid"))
        self._spawn_engine(eng)
        self.manifest.roll_mark(eng.addr)
        log.info("rolled engine %s (generation %d)", eng.addr, gen)
        tracing.event("control.roll", "lifecycle", addr=eng.addr,
                      generation=gen)
        flight.note("control.roll", addr=eng.addr, generation=gen)

    # --- process spawning (the chaos-harness banner idiom) ---

    def _spawn_relay(self, upstream: str) -> Tuple[str, str]:
        cmd = [sys.executable, "-m", "gol_tpu_torch",
               "--relay", upstream, "--serve", "127.0.0.1:0",
               "--metrics-port", "0"] + list(self.spec.spawn_args)
        if self.spec.secret is not None:
            cmd += ["--secret", self.spec.secret]
        listen, metrics = self._spawn(cmd, "relay", _RELAY_BANNER)
        self._endpoints.setdefault(metrics, Endpoint(metrics))
        self.manifest.record_spawn("relays", listen, metrics,
                                   self._procs[listen].pid)
        return listen, metrics

    def _spawn_engine(self, eng: EngineSpec) -> Tuple[str, str]:
        host, _, port = eng.addr.rpartition(":")
        cmd = [sys.executable, "-m", "gol_tpu_torch", "-noVis",
               "--serve", eng.addr, "--sessions",
               "--out", os.path.abspath(eng.out),
               "--metrics-port",
               eng.metrics.rpartition(":")[2] if eng.metrics else "0",
               "--resume", "latest"] + list(eng.args)
        if self.spec.secret is not None:
            cmd += ["--secret", self.spec.secret]
        listen, metrics = self._spawn(cmd, f"engine-{port}",
                                      _ENGINE_BANNER, key=eng.addr)
        self._endpoints.setdefault(metrics, Endpoint(metrics))
        self.manifest.record_spawn("engines", eng.addr, metrics,
                                   self._procs[eng.addr].pid)
        return eng.addr, metrics

    def _spawn(self, cmd: List[str], tag: str, banner: "re.Pattern",
               key: Optional[str] = None,
               boot_timeout: float = 60.0) -> Tuple[str, str]:
        """Start one fleet process, wait for its serving + metrics
        banners (the chaos harness's log-parse idiom — the child binds
        port 0 and the banner is the only place the real port
        exists)."""
        logs = os.path.join(self.out_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        log_path = os.path.join(
            logs, f"{tag}-{int(time.time() * 1000)}.log")
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(
            sys.modules["gol_tpu_torch"].__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        with open(log_path, "w") as lf:
            proc = subprocess.Popen(cmd, stdout=lf,
                                    stderr=subprocess.STDOUT, env=env)
        deadline = time.monotonic() + boot_timeout
        listen = metrics = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"spawned {tag} died during boot — see {log_path}")
            with open(log_path) as f:
                for line in f:
                    m = banner.search(line)
                    if m:
                        listen = m.group(1)
                    m = _METRICS_BANNER.search(line)
                    if m:
                        metrics = m.group(1)
            if listen and metrics:
                self._procs[key or listen] = proc
                return listen, metrics
            if self._shutdown.wait(0.1):
                break
        with contextlib.suppress(Exception):
            proc.kill()
        raise RuntimeError(
            f"spawned {tag} never printed its banners — see {log_path}")

    def _terminate(self, key: str, pid: Optional[int]) -> None:
        """SIGTERM + reap a node we own: the in-process Popen handle
        when we have one, the manifest pid after a controller restart
        (the child survived OUR death, not its own)."""
        proc = self._procs.pop(key, None)
        if proc is not None:
            with contextlib.suppress(OSError):
                proc.terminate()
            with contextlib.suppress(Exception):
                proc.wait(timeout=15)
            return
        if pid:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGTERM)
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and _pid_alive(pid):
                time.sleep(0.1)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True
