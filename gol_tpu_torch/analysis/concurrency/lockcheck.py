"""lockcheck — the static lock-graph pass's dynamic twin.

Opt-in via `GOL_TPU_LOCKCHECK=1` (the `GOL_TPU_CHECK_INVARIANTS`
idiom: creation-time gating, zero overhead when off — `make_lock`
returns a plain `threading.Lock` and nothing below ever runs). When
on, every serving-plane lock created through `make_lock`/`make_rlock`
is a TrackedLock, and three monitors run:

- **Runtime order graph.** Each thread's held stack feeds a merged
  acquisition-order digraph — the same edges the static lock-order
  pass derives from the AST, but witnessed by real interleavings
  (callback indirection, `on_close` sinks, anything resolution can't
  see). An edge that closes a cycle is a potential deadlock and is
  reported BEFORE the acquisition blocks, so the report lands even
  when (especially when) the interleaving would hang.
- **Held-too-long watchdog.** A daemon sweeper flags any lock held
  past `GOL_TPU_LOCKCHECK_MAX_HELD_SECS` (default 10s — above a cold
  CPU bucket compile, far below a test timeout): either a deadlock in
  progress or a blocking call smuggled under a lock that the static
  pass's call graph couldn't resolve.
- **Resource census.** `resource_census()` snapshots what teardown
  must not leak: non-daemon threads, listening server sockets (via
  /proc on Linux), and labeled per-entity metric series still in the
  obs registry. `gol_tpu_torch.testing.leaks` turns the before/after delta
  into per-test assertions.

Every report increments `gol_tpu_lockcheck_violations_total{kind=...}`
(the invariant checker's violation-counter discipline), lands a
flight note, and is
kept in a bounded in-process list for test assertions
(`reports()` / `reports_total()`).

Like `invariants`, this module imports neither jax nor the engine —
gol_tpu_torch.obs is pure stdlib — so the serving modules can import it
unconditionally.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from gol_tpu_torch import obs

__all__ = [
    "enable",
    "lockcheck_enabled",
    "make_lock",
    "make_rlock",
    "reports",
    "reports_total",
    "resource_census",
]

_VIOLATIONS = {
    kind: obs.counter(
        "gol_tpu_lockcheck_violations_total",
        "Runtime lock-order cycles and held-too-long watchdog hits",
        {"kind": kind},
    ) for kind in ("lock-order", "held-too-long")
}


def lockcheck_enabled() -> bool:
    return os.environ.get("GOL_TPU_LOCKCHECK", "") == "1"


def enable(on: bool = True) -> None:
    """Programmatic switch; creation-time gating means it must be set
    BEFORE the servers under test build their locks (the env var form
    is what multi-process jobs inherit)."""
    if on:
        os.environ["GOL_TPU_LOCKCHECK"] = "1"
    else:
        os.environ.pop("GOL_TPU_LOCKCHECK", None)


def _max_held_secs() -> float:
    try:
        return float(os.environ.get("GOL_TPU_LOCKCHECK_MAX_HELD_SECS", "10"))
    except ValueError:
        return 10.0


def reports_total() -> int:
    """Total lockcheck reports this process — the number that must stay
    0 across any healthy run (tests assert the per-test delta)."""
    return int(sum(c.value for c in _VIOLATIONS.values()))


def reports() -> List[dict]:
    with _meta:
        return list(_reports)


def make_lock(name: str):
    """A lock for the serving plane: plain `threading.Lock` when
    lockcheck is off (zero overhead — the metrics-off discipline), a
    TrackedLock when on. `name` should be the lock's static identity
    (`_Conn._lock`, `SessionManager._lock`) so runtime reports and
    static findings speak the same language."""
    if not lockcheck_enabled():
        return threading.Lock()
    return _TrackedLock(name, threading.Lock(), reentrant=False)


def make_rlock(name: str):
    if not lockcheck_enabled():
        return threading.RLock()
    return _TrackedLock(name, threading.RLock(), reentrant=True)


# -- tracked state (all guarded by _meta) ---------------------------------

_meta = threading.Lock()
_tls = threading.local()
#: (held, acquired) -> witness description, merged across all threads.
_edges: Dict[Tuple[str, str], str] = {}
#: Cycles already reported, as frozensets of lock names.
_seen_cycles: Set[frozenset] = set()
#: Live holds: (thread_id, name) -> [t0, thread_name, reported_flag].
_holds: Dict[Tuple[int, str], list] = {}
_reports: deque = deque(maxlen=256)
_watchdog_started = False


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _report(kind: str, msg: str) -> None:
    _VIOLATIONS[kind].inc()
    _reports.append({"kind": kind, "msg": msg, "ts": time.time()})
    from gol_tpu_torch.obs import flight

    flight.note("lockcheck.violation", violation=kind, msg=msg)


def _reaches(frm: str, to: str) -> Optional[List[str]]:
    """A path frm..to in the order graph (holding _meta), or None."""
    stack = [(frm, [frm])]
    seen = {frm}
    while stack:
        node, path = stack.pop()
        if node == to:
            return path
        for (a, b) in _edges:
            if a == node and b not in seen:
                seen.add(b)
                stack.append((b, path + [b]))
    return None


def _note_acquire(name: str) -> None:
    """Record order edges for acquiring `name` with the current
    thread's stack held; report any cycle the new edges close. Called
    BEFORE the raw acquire so a true deadlock still gets its report."""
    held = [e[0] for e in _stack()]
    if not held:
        return
    tname = threading.current_thread().name
    with _meta:
        for h in held:
            if h == name:
                continue
            _edges.setdefault((h, name),
                              f"thread {tname} took {name} holding {h}")
            back = _reaches(name, h)
            if back is not None:
                cyc = frozenset(back + [name])
                if cyc not in _seen_cycles:
                    _seen_cycles.add(cyc)
                    _report(
                        "lock-order",
                        "potential deadlock: acquisition-order cycle "
                        + " -> ".join([h, name] + back[1:])
                        + f" (latest edge: thread {tname} took {name} "
                          f"while holding {h})")


class _TrackedLock:
    """Order-graph + watchdog instrumentation around a raw lock. Only
    the `with` protocol and acquire/release are supported — the only
    surface the serving plane uses."""

    __slots__ = ("name", "_raw", "_reentrant")

    def __init__(self, name: str, raw, reentrant: bool):
        self.name = name
        self._raw = raw
        self._reentrant = reentrant
        _start_watchdog()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _stack()
        for entry in st:
            if entry[0] == self.name and self._reentrant:
                ok = self._raw.acquire(blocking, timeout)
                if ok:
                    entry[2] += 1
                return ok
        _note_acquire(self.name)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            st.append([self.name, time.monotonic(), 1])
            key = (threading.get_ident(), self.name)
            with _meta:
                _holds[key] = [time.monotonic(),
                               threading.current_thread().name, False]
        return ok

    def release(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] != self.name:
                continue
            st[i][2] -= 1
            if st[i][2] > 0:
                break
            held_for = time.monotonic() - st[i][1]
            del st[i]
            key = (threading.get_ident(), self.name)
            with _meta:
                hold = _holds.pop(key, None)
            limit = _max_held_secs()
            if held_for > limit and not (hold and hold[2]):
                # The watchdog may have reported this hold already.
                _report(
                    "held-too-long",
                    f"{self.name} held {held_for:.1f}s by thread "
                    f"{threading.current_thread().name} "
                    f"(limit {limit:.1f}s) — blocking work under a "
                    "lock, or a deadlock that resolved late")
            break
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _start_watchdog() -> None:
    global _watchdog_started
    with _meta:
        if _watchdog_started:
            return
        _watchdog_started = True
    t = threading.Thread(target=_watchdog_loop, name="gol-lockcheck-watchdog",
                         daemon=True)
    t.start()


def _watchdog_loop() -> None:
    while True:
        limit = _max_held_secs()
        time.sleep(min(1.0, limit / 4))
        now = time.monotonic()
        with _meta:
            stuck = [(key, h) for key, h in _holds.items()
                     if not h[2] and now - h[0] > limit]
            for _, h in stuck:
                h[2] = True
        for (tid, name), h in stuck:
            _report(
                "held-too-long",
                f"{name} STILL held after {now - h[0]:.1f}s by thread "
                f"{h[1]} (limit {limit:.1f}s) — likely deadlocked or "
                "blocking under the lock")


# -- teardown resource census ---------------------------------------------

#: Label keys that mark a metric series per-entity — the ones whose
#: teardown must registry.remove() them (bounded-cardinality rule).
_ENTITY_LABEL_KEYS = ("session", "sid", "peer", "conn")


def resource_census() -> dict:
    """What a clean teardown leaves behind: nothing. Keys:

    - `non_daemon_threads`: live non-daemon threads other than main —
      each would hang interpreter exit;
    - `listen_sockets`: this process's LISTENing TCP sockets
      ("host:port"; [] on platforms without /proc) — an unclosed
      server listener;
    - `entity_series`: labeled per-entity metric series (session/peer
      keys) still registered — a destroyed entity that skipped
      `registry.remove` (unbounded growth under churn).

    Callers diff two snapshots around a test (gol_tpu_torch.testing.leaks);
    absolute contents are meaningful only for a fresh process."""
    threads = sorted(
        t.name for t in threading.enumerate()
        if t.is_alive() and not t.daemon and t is not threading.main_thread()
    )
    series = sorted(
        f"{m.name}{{{','.join(f'{k}={v}' for k, v in m.labels)}}}"
        for m in obs.registry().metrics()
        if any(k in _ENTITY_LABEL_KEYS for k, _ in (m.labels or ()))
    )
    return {
        "non_daemon_threads": threads,
        "listen_sockets": _listen_sockets(),
        "entity_series": series,
    }


def _listen_sockets() -> List[str]:
    """local addresses of LISTENing TCP sockets owned by this process,
    via /proc (Linux; [] elsewhere — the census degrades, the thread
    half still works)."""
    try:
        inodes = set()
        fd_dir = f"/proc/{os.getpid()}/fd"
        for fd in os.listdir(fd_dir):
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target.startswith("socket:["):
                inodes.add(target[8:-1])
        out = []
        for table in ("/proc/net/tcp", "/proc/net/tcp6"):
            try:
                with open(table) as f:
                    lines = f.readlines()[1:]
            except OSError:
                continue
            for line in lines:
                parts = line.split()
                if len(parts) < 10 or parts[3] != "0A":  # 0A = LISTEN
                    continue
                if parts[9] not in inodes:
                    continue
                addr, port = parts[1].rsplit(":", 1)
                out.append(f"{_hex_addr(addr)}:{int(port, 16)}")
        return sorted(out)
    except OSError:
        return []


def _hex_addr(h: str) -> str:
    if len(h) == 8:  # IPv4, little-endian hex
        b = bytes.fromhex(h)
        return ".".join(str(x) for x in b[::-1])
    return f"[{h}]"  # IPv6: opaque but stable for diffing
