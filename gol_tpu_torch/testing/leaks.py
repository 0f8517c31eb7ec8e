"""Thread/socket leak census for the distributed test modules.

A serving-plane test that leaks a non-daemon thread hangs interpreter
exit; one that leaks a listening socket poisons every later test that
binds port 0 on a crowded CI box; one that leaks per-entity metric
series grows the registry without bound under churn. None of those
show up in the test's own asserts — they show up three modules later.

`lockcheck_guard` is the per-test discipline the distributed modules
(`test_overload`, `test_resilience`, `test_sessions`) wrap in an
autouse fixture, composing three checks around every test:

- forces `GOL_TPU_LOCKCHECK=1` (the invariants-forced-ON pattern), so
  every serving-plane lock built during the test is a TrackedLock;
- asserts zero new lockcheck reports (runtime lock-order cycles,
  held-too-long watchdog hits) over the test;
- asserts the resource census delta is empty at teardown: no new
  non-daemon thread and no new listening socket survives, with a short
  grace loop for teardown that is still winding down (a joined server
  thread takes a beat to leave `threading.enumerate`).

Entity-series growth is reported in the assertion message but does not
gate — a test may legitimately leave session-scoped series behind when
it shares a process-global registry with its neighbors; the smoke
lanes gate those from a fresh process.
"""

from __future__ import annotations

import time

from gol_tpu_torch.analysis.concurrency import lockcheck

__all__ = ["assert_no_leaks", "lockcheck_guard", "snapshot"]

#: Teardown grace: how long a census delta may take to drain before it
#: is a leak (server shutdown joins its threads, but enumerate() can
#: trail by a scheduler beat).
GRACE_SECS = 3.0


def snapshot() -> dict:
    return lockcheck.resource_census()


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for key in ("non_daemon_threads", "listen_sockets", "entity_series"):
        new = [x for x in after.get(key, []) if x not in before.get(key, [])]
        if new:
            out[key] = new
    return out


def assert_no_leaks(before: dict, *, grace: float = GRACE_SECS,
                    what: str = "test") -> None:
    """Fail if the census grew vs `before` and stays grown past the
    grace window. Threads and listeners gate; entity series inform."""
    deadline = time.monotonic() + grace
    while True:
        d = _delta(before, snapshot())
        gating = {k: v for k, v in d.items()
                  if k in ("non_daemon_threads", "listen_sockets")}
        if not gating:
            return
        if time.monotonic() > deadline:
            raise AssertionError(
                f"resource leak after {what}: {gating} "
                f"(entity series delta: {d.get('entity_series', [])})"
            )
        time.sleep(0.05)


def lockcheck_guard(monkeypatch, *, invariants: bool = True):
    """Generator for an autouse fixture: wrap with

        @pytest.fixture(autouse=True)
        def _concurrency_on(monkeypatch):
            yield from lockcheck_guard(monkeypatch)

    Forces LOCKCHECK (and, by default, the runtime invariants) ON for
    the test, then asserts zero lockcheck reports and an empty leak
    census delta at teardown."""
    monkeypatch.setenv("GOL_TPU_LOCKCHECK", "1")
    if invariants:
        monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
    from gol_tpu_torch.analysis.invariants import violations_total

    inv_before = violations_total() if invariants else 0
    reports_before = lockcheck.reports_total()
    census_before = snapshot()
    yield
    if invariants:
        assert violations_total() - inv_before == 0, (
            "a runtime invariant broke during this test"
        )
    new = lockcheck.reports_total() - reports_before
    if new:
        tail = [r for r in lockcheck.reports()][-new:]
        raise AssertionError(
            f"{new} lockcheck report(s) during this test: "
            + "; ".join(f"[{r['kind']}] {r['msg']}" for r in tail)
        )
    assert_no_leaks(census_before)
