"""Desired-state spec for the fleet controller (docs/CONTROL.md).

One JSON file declares what the fleet SHOULD look like; the
controller's reconcile loop makes observed state match it. The format
follows the alert-rules file's discipline (obs.freshness.load_rules):
plain JSON, strict validation at load time, every mistake a
SpecError naming the offending field — a controller that boots on a
typo'd spec and reconciles toward garbage is worse than one that
refuses to start.

Minimal spec (heal-only, no engines):

    {
      "root": "127.0.0.1:8100",
      "scrape": ["9100", "9101", "9102"],
      "relays": {"min": 2}
    }

Full shape:

    {
      "root": "HOST:PORT",            # upstream for spawned relays
      "scrape": ["HOST:PORT", ...],   # static /metrics sidecars
      "secret": "TOKEN" | null,
      "relays": {
        "min": 0, "max": 8,           # relay-count bounds
        "observers_per_relay": 64     # grow/shrink load threshold
      },
      "engines": [
        {"addr": "HOST:PORT", "out": "outA",
         "metrics": "HOST:PORT" | null,
         "spawn": false, "args": ["--platform", "cpu", ...]}
      ],
      "sessions": {"SID": "ENGINE-ADDR" | "auto", ...},  # placement
                                      # ("auto": cheapest engine by
                                      #  the accounting-plane ledger)
      "collector": "HOST:PORT" | null,  # history-plane collector:
      "canary_max_age_s": 2.0,        #  scale on the canary's
      "canary_for_secs": 10.0,        #  SUSTAINED measured turn age
      "roll_generation": 0,           # bump to roll managed engines
      "interval_secs": 2.0,           # reconcile cadence
      "stale_secs": 15.0,             # refuse to act on older scrapes
      "down_rounds": 2,               # consecutive misses = dead
      "actions_per_round": 2,         # the spawn-storm budget
      "heal_alerts": ["rule", ...],   # firing = relay needs healing
      "spawn_args": ["--platform", "cpu"]   # extra argv for relays
    }
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

__all__ = ["EngineSpec", "FleetSpec", "SpecError", "load_spec"]

_ADDR = re.compile(r"^[A-Za-z0-9_.-]+:\d{1,5}$")


class SpecError(ValueError):
    """A malformed controller spec; the message names the field."""


def _addr(value, field: str) -> str:
    if not isinstance(value, str) or not _ADDR.match(value):
        raise SpecError(f"{field}: expected HOST:PORT, got {value!r}")
    return value


def _num(value, field: str, lo: float, default: float) -> float:
    if value is None:
        return default
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise SpecError(f"{field}: expected a number, got {value!r}")
    if value < lo:
        raise SpecError(f"{field}: must be >= {lo}, got {value!r}")
    return float(value)


class EngineSpec:
    """One session engine the controller observes (and, with
    `spawn: true`, owns: spawned at boot, drained + restarted with
    `--resume latest` on a roll)."""

    def __init__(self, raw: dict, index: int):
        field = f"engines[{index}]"
        if not isinstance(raw, dict):
            raise SpecError(f"{field}: expected an object")
        self.addr = _addr(raw.get("addr"), f"{field}.addr")
        out = raw.get("out")
        if not isinstance(out, str) or not out:
            raise SpecError(f"{field}.out: expected a directory path")
        self.out = out
        self.metrics: Optional[str] = None
        if raw.get("metrics") is not None:
            self.metrics = _addr(raw["metrics"], f"{field}.metrics")
        self.spawn = bool(raw.get("spawn", False))
        args = raw.get("args", [])
        if not (isinstance(args, list)
                and all(isinstance(a, str) for a in args)):
            raise SpecError(f"{field}.args: expected a list of strings")
        self.args: List[str] = list(args)


class FleetSpec:
    """The parsed, validated desired state. Attribute-bag by design:
    the controller reads it, never mutates it — a reconcile loop with
    a drifting spec has no level to trigger on."""

    def __init__(self, raw: dict, path: str = "<inline>"):
        if not isinstance(raw, dict):
            raise SpecError("spec: expected a JSON object")
        self.path = path
        self.root = _addr(raw.get("root"), "root")
        scrape = raw.get("scrape", [])
        if not (isinstance(scrape, list)
                and all(isinstance(s, str) and s for s in scrape)):
            raise SpecError("scrape: expected a list of endpoint specs")
        self.scrape: List[str] = list(scrape)
        secret = raw.get("secret")
        if secret is not None and not isinstance(secret, str):
            raise SpecError("secret: expected a string or null")
        self.secret: Optional[str] = secret

        relays = raw.get("relays", {})
        if not isinstance(relays, dict):
            raise SpecError("relays: expected an object")
        self.relay_min = int(_num(relays.get("min"), "relays.min", 0, 0))
        self.relay_max = int(_num(relays.get("max"), "relays.max", 0, 8))
        if self.relay_max < self.relay_min:
            raise SpecError("relays.max: must be >= relays.min")
        self.observers_per_relay = _num(
            relays.get("observers_per_relay"),
            "relays.observers_per_relay", 1, 64,
        )

        raw_engines = raw.get("engines", [])
        if not isinstance(raw_engines, list):
            raise SpecError("engines: expected a list")
        self.engines = [EngineSpec(e, i)
                        for i, e in enumerate(raw_engines)]
        by_addr = {e.addr: e for e in self.engines}
        if len(by_addr) != len(self.engines):
            raise SpecError("engines: duplicate addr")

        sessions = raw.get("sessions", {})
        if not isinstance(sessions, dict):
            raise SpecError("sessions: expected an object (sid -> addr)")
        for sid, addr in sessions.items():
            if not isinstance(sid, str) or not sid:
                raise SpecError(f"sessions: bad session id {sid!r}")
            if addr == "auto":
                # Ledger-driven placement: the controller picks the
                # cheapest-loaded declared engine (accounting plane,
                # deterministic tie-break) at reconcile time.
                if not self.engines:
                    raise SpecError(
                        f"sessions[{sid!r}]: \"auto\" placement needs "
                        "at least one declared engine"
                    )
                continue
            _addr(addr, f"sessions[{sid!r}]")
            if addr not in by_addr:
                raise SpecError(
                    f"sessions[{sid!r}]: {addr!r} is not a declared "
                    "engine addr"
                )
        self.sessions = dict(sessions)

        self.roll_generation = int(_num(
            raw.get("roll_generation"), "roll_generation", 0, 0))
        self.interval_secs = _num(
            raw.get("interval_secs"), "interval_secs", 0.05, 2.0)
        self.stale_secs = _num(
            raw.get("stale_secs"), "stale_secs", 0.1, 15.0)
        self.down_rounds = int(_num(
            raw.get("down_rounds"), "down_rounds", 1, 2))
        self.actions_per_round = int(_num(
            raw.get("actions_per_round"), "actions_per_round", 1, 2))
        # History plane (docs/OBSERVABILITY.md): with a collector
        # declared, the scale rule reads the canary's MEASURED turn-age
        # history from it — sustained breach over canary_for_secs
        # grows the tree, sustained deep comfort shrinks it; no
        # collector (or a failed query) falls back to raw peer counts.
        collector = raw.get("collector")
        if collector is not None:
            collector = _addr(collector, "collector")
        self.collector: Optional[str] = collector
        max_age = raw.get("canary_max_age_s")
        self.canary_max_age_s: Optional[float] = None \
            if max_age is None \
            else _num(max_age, "canary_max_age_s", 0.001, 0.0)
        self.canary_for_secs = _num(
            raw.get("canary_for_secs"), "canary_for_secs", 0.5, 10.0)
        if self.canary_max_age_s is not None and collector is None:
            raise SpecError(
                "canary_max_age_s: needs a collector (the history "
                "scale rule reads canary age from it)"
            )
        alerts = raw.get("heal_alerts", [])
        if not (isinstance(alerts, list)
                and all(isinstance(a, str) for a in alerts)):
            raise SpecError("heal_alerts: expected a list of rule names")
        self.heal_alerts: List[str] = list(alerts)
        spawn_args = raw.get("spawn_args", [])
        if not (isinstance(spawn_args, list)
                and all(isinstance(a, str) for a in spawn_args)):
            raise SpecError("spawn_args: expected a list of strings")
        self.spawn_args: List[str] = list(spawn_args)

    def engine(self, addr: str) -> Optional[EngineSpec]:
        for e in self.engines:
            if e.addr == addr:
                return e
        return None


def load_spec(path: "str | os.PathLike") -> FleetSpec:
    """Parse + validate a spec file; raises SpecError on anything
    malformed (including unreadable files — the CLI turns that into a
    startup SystemExit, exactly like --alert-rules)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise SpecError(f"cannot read spec: {e}") from None
    except ValueError as e:
        raise SpecError(f"spec is not valid JSON: {e}") from None
    return FleetSpec(raw, path=os.fspath(path))
