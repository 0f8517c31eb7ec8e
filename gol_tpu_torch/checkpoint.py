"""Checkpoint discovery — PGM snapshots as the fault-tolerance store; the
port's copy of `gol_tpu.checkpoint`.

A PGM snapshot is a complete checkpoint: the board is the whole state
and the turn number is encoded in the filename `<W>x<H>x<T>.pgm`
(filename convention ref: gol/distributor.go:181,230; PGM-as-checkpoint
per SURVEY.md §5 "Checkpoint / resume"). The reference's fault-tolerance
extension (ref: README.md:261-265) asks for runs that survive component
death; here that is: periodic engine-side autosaves (Params.autosave_*),
crash-atomic writes (io/pgm.py), and these helpers to find the newest
complete checkpoint to resume from.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

_SNAP = re.compile(r"^(\d+)x(\d+)x(\d+)\.pgm$")

#: Basename of the per-session-tree tombstone a destroy leaves behind
#: (docs/SESSIONS.md "Crash-consistent resume"): resume discovery
#: treats a tombstoned session directory as destroyed even when the
#: manifest rewrite that normally records the destroy never landed
#: (SIGKILL between the two writes).
TOMBSTONE = ".tombstone"


def record_resume_turn(turn: int) -> None:
    """Publish the turn this process resumed from as the
    `gol_tpu_resume_turn` gauge (0 = fresh start) — the one
    registration point every resume path (local CLI, EngineServer)
    shares, so the smoke harness and operators read a single series.
    Imported lazily: checkpoint discovery itself stays stdlib-only."""
    from gol_tpu_torch import obs

    obs.gauge(
        "gol_tpu_resume_turn",
        "Turn this process resumed from (0 = fresh start)",
    ).set(turn)


def snapshot_turn(path: str | os.PathLike) -> int:
    """Turn number encoded in a snapshot filename `<W>x<H>x<T>.pgm`."""
    m = _SNAP.match(os.path.basename(os.fspath(path)))
    if not m:
        raise ValueError(f"not a snapshot filename: {path!r}")
    return int(m.group(3))


def session_checkpoint_dir(out_dir: str | os.PathLike) -> str:
    """Root of the per-session checkpoint tree: each session owns
    `<out>/sessions/<id>/` holding its `<W>x<H>x<T>.pgm` snapshots and
    a `session.json` sidecar (rule + geometry — the PGM filename alone
    cannot carry the ruleset). Layout: docs/SESSIONS.md."""
    return os.path.join(os.fspath(out_dir), "sessions")


def session_manifest_path(out_dir: str | os.PathLike) -> str:
    """The session set's commit record: `<out>/sessions/manifest.json`,
    rewritten crash-atomically (temp + rename) at every create/destroy.
    Resume trusts the manifest over the directory listing — a crashed
    process may leave half-written session trees, but the manifest names
    exactly the set that was live at the last completed verb."""
    return os.path.join(session_checkpoint_dir(out_dir), "manifest.json")


def read_session_manifest(out_dir: str | os.PathLike) -> Optional[dict]:
    """The manifest's `sessions` mapping (sid -> {width, height, rule,
    seed?, density?}), or None when it is missing, torn, or not the
    expected shape — a truncated manifest on a freshly crashed tree is
    "no manifest" (fall back to the directory scan), never an
    exception."""
    try:
        with open(session_manifest_path(out_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    sessions = data.get("sessions") if isinstance(data, dict) else None
    if not isinstance(sessions, dict):
        return None
    return {
        sid: meta for sid, meta in sessions.items()
        if isinstance(sid, str) and isinstance(meta, dict)
    }


def manifest_parked(meta) -> bool:
    """True when a manifest session entry records a PARKED (hibernated)
    session — checkpointed, device rows freed, rehydrated bit-exactly
    on the next attach (docs/SESSIONS.md "Hibernation"). The one
    spelling of the flag, shared by the manager's writer and resume
    discovery: a parked entry carries `parked: true` plus the `turn`
    its snapshot encodes, alongside the ordinary recipe fields."""
    return bool(isinstance(meta, dict) and meta.get("parked"))


def tombstone_path(out_dir: str | os.PathLike, sid: str) -> str:
    """Per-session destroy marker `<out>/sessions/<sid>/.tombstone` —
    written BEFORE the manifest rewrite, so every crash window between
    the two leaves the session provably destroyed, never resurrected."""
    return os.path.join(session_checkpoint_dir(out_dir), sid, TOMBSTONE)


def is_tombstoned(out_dir: str | os.PathLike, sid: str) -> bool:
    """True when `sid` carries a destroy tombstone. Only existence
    matters: a truncated (even empty) tombstone still records the
    destroy — the content is operator forensics, not protocol."""
    return os.path.exists(tombstone_path(out_dir, sid))


def latest_any_snapshot(
    snap_dir: str | os.PathLike,
) -> Optional[tuple[str, int, int]]:
    """(path, width, height) of the highest-turn snapshot of ANY
    geometry in `snap_dir`, or None. The per-session variant of
    `latest_snapshot`: a session directory's geometry is whatever its
    snapshots say, so discovery cannot pre-filter on W x H. Same
    determinism contract: sorted listing, lexicographic tie-break,
    unreadable dir = no checkpoint."""
    best_turn, best = -1, None
    try:
        names = sorted(os.listdir(snap_dir))
    except OSError:
        return None
    for name in names:
        m = _SNAP.match(name)
        if not m:
            continue
        w, h, turn = (int(g) for g in m.groups())
        if turn > best_turn:
            best_turn = turn
            best = (os.path.join(os.fspath(snap_dir), name), w, h)
    return best


def latest_snapshot(
    out_dir: str | os.PathLike, width: int, height: int
) -> Optional[str]:
    """Path of the highest-turn `<W>x<H>x<T>.pgm` in `out_dir`, or None.

    Only complete snapshots are visible: in-flight writes live under a
    dotted `.tmp` name until their atomic rename, so a run killed
    mid-write never offers a truncated board here. An unreadable (or
    missing) directory is "no checkpoint", never an exception — resume
    discovery runs on freshly crashed trees.

    Ties (two filenames encoding the same turn, e.g. a zero-padded
    `64x64x0100.pgm` next to `64x64x100.pgm`) resolve to the
    lexicographically first name: discovery must be deterministic
    across runs, and os.listdir order is not.
    """
    best_turn, best = -1, None
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        return None
    for name in names:
        m = _SNAP.match(name)
        if not m:
            continue
        w, h, turn = (int(g) for g in m.groups())
        if (w, h) == (width, height) and turn > best_turn:
            best_turn, best = turn, os.path.join(os.fspath(out_dir), name)
    return best
