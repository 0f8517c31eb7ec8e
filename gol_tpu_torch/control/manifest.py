"""Crash-atomic controller manifest: the controller's WAL.

Everything the controller cannot afford to forget across a SIGKILL
lives here — two-phase migration records, the registry of nodes IT
spawned (so a restarted controller re-adopts its children instead of
double-spawning), and roll progress. One JSON file, rewritten whole
through `obs.atomic_write_text` (temp + fsync + rename), exactly the
session manifest's durability discipline: a torn write is impossible,
a missing file means "fresh controller".

Migration records are the load-bearing part. Each is

    {"sid": S, "src": A, "dst": B, "phase": "intent"|"done"|"aborted",
     "serving": ADDR|null, "reason": str|null}

keyed by a stable rid `mig-<sid>-<seq>`. The controller writes
`intent` BEFORE touching engine A, and `done`/`aborted` only AFTER
the fleet reflects the outcome. A controller killed between the two
finds the `intent` at boot and re-drives the same legs — every leg
verb (park / adopt / destroy) is state-based idempotent on the engine
side, so re-driving converges instead of duplicating.
"""

from __future__ import annotations

import copy
import os
import json
from typing import Dict, List, Optional

from gol_tpu_torch import obs
from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["ControllerManifest"]

_PHASES = ("intent", "done", "aborted")


class ControllerManifest:
    """Durable controller state at `path`. Every mutator persists
    before returning — callers may treat a returned mutation as
    survived-a-SIGKILL."""

    def __init__(self, path: "str | os.PathLike"):
        self.path = os.fspath(path)
        self._lock = lockcheck.make_lock("ControllerManifest._lock")
        self._state = self._load()

    # -- persistence ------------------------------------------------------

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            # Missing or torn (pre-rename crash leaves the OLD file, so
            # "torn" here really means hand-edited garbage): start fresh.
            raw = {}
        if not isinstance(raw, dict):
            raw = {}
        state = {
            "seq": int(raw.get("seq", 0) or 0),
            "migrations": {},
            "spawned": {"relays": {}, "engines": {}},
            "roll": {"generation": 0, "done": []},
        }
        migs = raw.get("migrations")
        if isinstance(migs, dict):
            for rid, rec in migs.items():
                if (isinstance(rec, dict)
                        and rec.get("phase") in _PHASES
                        and isinstance(rec.get("sid"), str)):
                    state["migrations"][str(rid)] = {
                        "sid": rec["sid"],
                        "src": rec.get("src"),
                        "dst": rec.get("dst"),
                        "phase": rec["phase"],
                        "serving": rec.get("serving"),
                        "reason": rec.get("reason"),
                    }
        spawned = raw.get("spawned")
        if isinstance(spawned, dict):
            for kind in ("relays", "engines"):
                nodes = spawned.get(kind)
                if isinstance(nodes, dict):
                    for listen, meta in nodes.items():
                        if isinstance(meta, dict):
                            state["spawned"][kind][str(listen)] = {
                                "metrics": meta.get("metrics"),
                                "pid": meta.get("pid"),
                            }
        roll = raw.get("roll")
        if isinstance(roll, dict):
            state["roll"] = {
                "generation": int(roll.get("generation", 0) or 0),
                "done": [a for a in roll.get("done", [])
                         if isinstance(a, str)],
            }
        return state

    def _persist_locked(self) -> None:
        obs.atomic_write_text(
            self.path, json.dumps(self._state, indent=1, sort_keys=True))

    # -- migrations (two-phase) -------------------------------------------

    def migration_begin(self, sid: str, src: str, dst: str) -> str:
        """Record intent and return the migration's rid. Re-begun for a
        sid that already has an open intent, returns THAT rid — the
        resume path after a controller crash, not a new migration."""
        with self._lock:
            for rid, rec in self._state["migrations"].items():
                if rec["sid"] == sid and rec["phase"] == "intent":
                    return rid
            self._state["seq"] += 1
            rid = f"mig-{sid}-{self._state['seq']}"
            self._state["migrations"][rid] = {
                "sid": sid, "src": src, "dst": dst,
                "phase": "intent", "serving": src, "reason": None,
            }
            self._persist_locked()
            return rid

    def migration_done(self, rid: str, serving: str) -> None:
        with self._lock:
            rec = self._state["migrations"].get(rid)
            if rec is None:
                raise KeyError(rid)
            rec["phase"] = "done"
            rec["serving"] = serving
            self._persist_locked()

    def migration_abort(self, rid: str, reason: str) -> None:
        with self._lock:
            rec = self._state["migrations"].get(rid)
            if rec is None:
                raise KeyError(rid)
            rec["phase"] = "aborted"
            rec["reason"] = reason
            self._persist_locked()

    def migration(self, rid: str) -> Optional[dict]:
        with self._lock:
            rec = self._state["migrations"].get(rid)
            return copy.deepcopy(rec) if rec is not None else None

    def pending_migrations(self) -> Dict[str, dict]:
        """Open intents (rid -> record), the crash-resume worklist."""
        with self._lock:
            return {rid: copy.deepcopy(rec)
                    for rid, rec in self._state["migrations"].items()
                    if rec["phase"] == "intent"}

    def serving(self, sid: str) -> Optional[str]:
        """Where the newest migration record says `sid` is served, or
        None if no migration ever touched it."""
        with self._lock:
            best = None
            for rid, rec in self._state["migrations"].items():
                if rec["sid"] == sid:
                    best = rec  # insertion order == seq order
            return best["serving"] if best else None

    # -- spawned-node registry --------------------------------------------

    def record_spawn(self, kind: str, listen: str,
                     metrics: Optional[str], pid: Optional[int]) -> None:
        with self._lock:
            self._state["spawned"][kind][listen] = {
                "metrics": metrics, "pid": pid}
            self._persist_locked()

    def forget_spawn(self, kind: str, listen: str) -> None:
        with self._lock:
            if self._state["spawned"][kind].pop(listen, None) is not None:
                self._persist_locked()

    def spawned(self, kind: str) -> Dict[str, dict]:
        with self._lock:
            return copy.deepcopy(self._state["spawned"][kind])

    # -- roll progress ----------------------------------------------------

    def roll_state(self) -> dict:
        with self._lock:
            return copy.deepcopy(self._state["roll"])

    def roll_start(self, generation: int) -> None:
        """Reset progress for a new generation (no-op if already on
        it, preserving mid-roll progress across controller restarts)."""
        with self._lock:
            if self._state["roll"]["generation"] != generation:
                self._state["roll"] = {"generation": generation,
                                       "done": []}
                self._persist_locked()

    def roll_mark(self, addr: str) -> None:
        with self._lock:
            if addr not in self._state["roll"]["done"]:
                self._state["roll"]["done"].append(addr)
                self._persist_locked()

    def roll_done(self) -> List[str]:
        with self._lock:
            return list(self._state["roll"]["done"])
