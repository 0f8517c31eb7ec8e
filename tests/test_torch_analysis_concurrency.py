"""The port's static concurrency passes against gol_tpu's.

lock-order, lock-blocking, thread-ownership and guarded-field do not
depend on the framework: every static snippet of gol_tpu's own tests
goes through both packages' passes, staged in either package's serving
plane, and the findings must agree as (check, line, scope). The device
sync is the one framework spelling — `synchronize`, `.item()` and
`.cpu()` in the port for gol_tpu's `block_until_ready`. Both packages'
corpus runners read gol_tpu's race fixtures in place and must fire the
same checks, and both trees' findings must agree once `gol_tpu/` maps
to `gol_tpu_torch/`.
"""

import collections
import pathlib
import textwrap

import pytest

from gol_tpu.analysis import lint_paths as jlint
from gol_tpu.analysis.checks import blocking_io as jblocking_io
from gol_tpu.analysis.concurrency import CONCURRENCY_CHECKS as JCONC
from gol_tpu.analysis.concurrency.corpus import run_corpus as jrun_corpus
from gol_tpu_torch.analysis import lint_paths
from gol_tpu_torch.analysis.checks import blocking_io
from gol_tpu_torch.analysis.concurrency import CONCURRENCY_CHECKS
from gol_tpu_torch.analysis.concurrency.corpus import (
    expected_checks,
    main as corpus_main,
    run_corpus,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "concurrency"


def _lint(tmp_path, code, pkg="gol_tpu_torch", name="mod.py",
          plane="distributed"):
    """Stage a snippet inside `pkg`'s serving plane and run that
    package's concurrency checks only."""
    d = tmp_path / pkg / plane
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(textwrap.dedent(code))
    lint, checks = ((lint_paths, CONCURRENCY_CHECKS) if pkg == "gol_tpu_torch"
                    else (jlint, JCONC))
    return lint([tmp_path / pkg], tmp_path, checks=checks)


def _keys(findings):
    return [(f.check, f.line, f.scope) for f in findings]


#: gol_tpu's static snippets (tests/test_analysis_concurrency.py), each
#: with the check it is about and whether that check must fire.
SNIPPETS = {
    "lock-order-ab-ba": ("lock-order", True, """
        import threading

        class Manager:
            def __init__(self, server):
                self._lock = threading.Lock()
                self.server: Server = server

            def service(self, sid):
                with self._lock:
                    self.server.drop_conn(sid)

        class Server:
            def __init__(self, manager):
                self._conn_lock = threading.Lock()
                self.manager: Manager = manager

            def drop_conn(self, sid):
                with self._conn_lock:
                    pass

            def reader_drop(self, sid):
                with self._conn_lock:
                    self.manager.service(sid)
    """),
    "lock-order-consistent": ("lock-order", False, """
        import threading

        class Node:
            def __init__(self):
                self._board_lock = threading.Lock()
                self._conn_lock = threading.Lock()

            def publish(self):
                with self._board_lock:
                    with self._conn_lock:
                        pass

            def snapshot(self):
                with self._board_lock:
                    with self._conn_lock:
                        pass
    """),
    "lock-blocking-direct": ("lock-blocking", True, """
        import threading

        class Broadcaster:
            def __init__(self, sock):
                self._lock = threading.Lock()
                self.sock = sock

            def push(self, payload):
                with self._lock:
                    self.sock.sendall(payload)
    """),
    "lock-blocking-transitive": ("lock-blocking", True, """
        import threading

        class _Conn:
            def __init__(self, sock):
                self._lock = threading.Lock()
                self.sock = sock

            def _flush(self, payload):
                self.sock.sendall(payload)

            def push(self, payload):
                with self._lock:
                    self._flush(payload)
    """),
    "lock-blocking-outside": ("lock-blocking", False, """
        import threading

        class _Conn:
            def __init__(self, sock):
                self._lock = threading.Lock()
                self.sock = sock
                self.pending = []

            def push(self, payload):
                with self._lock:
                    self.pending.append(payload)
                self.sock.sendall(payload)
    """),
    "ownership-send": ("thread-ownership", True, """
        class Broadcaster:
            def push(self, sock, payload):
                sock.sendall(payload)
    """),
    "ownership-heartbeat-verb": ("thread-ownership", True, """
        class Server:
            def _heartbeat_loop(self):
                for conn in list(self.conns):
                    sess = self.manager.get(conn.sid)
    """),
    "ownership-heartbeat-peek": ("thread-ownership", False, """
        class Server:
            def _heartbeat_loop(self):
                for conn in list(self.conns):
                    turn = self.manager.peek_turn(conn.sid)
                    known = self.manager.known(conn.sid)
    """),
    "ownership-internal-verb": ("thread-ownership", True, """
        class Admission:
            def evict(self, sid):
                self.manager._destroy(sid)
    """),
    "guarded-field-bare": ("guarded-field", True, """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = []
                self.peers = 0

            def enqueue(self, item):
                with self._lock:
                    self._q.append(item)
                    self.peers += 1

            def service(self):
                item = self._q.pop()
                self.peers -= 1
                return item
    """),
    "guarded-field-clean": ("guarded-field", False, """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = []
                self._q.append(None)  # __init__ is pre-publication

            def enqueue(self, item):
                with self._lock:
                    self._q.append(item)

            def _drain_locked(self):
                self._q.clear()
    """),
}


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_static_pass_matches_gol_tpu(tmp_path, case):
    check, fires, code = SNIPPETS[case]
    mine = _lint(tmp_path, code)
    theirs = _lint(tmp_path, code, pkg="gol_tpu")
    assert _keys(mine) == _keys(theirs)
    assert (check in {f.check for f in mine}) == fires, _keys(mine)


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()",
                                  "x.synchronize()", "x.sum().item()",
                                  "x.cpu()"])
def test_ownership_flags_device_sync_in_serving_plane(tmp_path, call):
    """gol_tpu's `block_until_ready` rule in the port's spelling: a
    server, relay or replay scope that waits on the card."""
    findings = _lint(tmp_path, f"""
        import torch

        class Pump:
            def step(self, x):
                {call}
                return x
    """)
    assert [f.check for f in findings] == ["thread-ownership"]
    assert "device sync" in findings[0].message


def test_device_sync_is_legal_in_the_dispatch_plane(tmp_path):
    """The engine/sessions plane owns device dispatch: the same sync
    there is no ownership finding."""
    findings = _lint(tmp_path, """
        class Bucket:
            def count(self, x):
                return x.sum().item()
    """, plane="sessions")
    assert findings == []


def test_lock_blocking_flags_device_sync_under_lock(tmp_path):
    findings = _lint(tmp_path, """
        import threading

        class Bucket:
            def __init__(self):
                self._lock = threading.Lock()

            def count(self, x):
                with self._lock:
                    return x.sum().item()
    """, plane="sessions")
    assert [f.check for f in findings] == ["lock-blocking"]
    assert ".item()" in findings[0].message


# --- the corpus: gol_tpu's shipped races, read in place ---


def test_corpus_every_shipped_race_still_fires():
    failures, fired = run_corpus(FIXTURES)
    assert failures == [], failures
    assert len(fired) >= 3
    assert {"lock-order", "lock-blocking", "guarded-field",
            "thread-ownership"} <= set().union(*fired.values())


def test_corpus_fires_what_gol_tpu_fires():
    _, mine = run_corpus(FIXTURES)
    _, theirs = jrun_corpus(FIXTURES)
    assert mine == theirs


def test_corpus_cli_exits_zero(capsys):
    assert corpus_main([str(FIXTURES)]) == 0
    assert "every declared check fired" in capsys.readouterr().out
    assert corpus_main([str(FIXTURES / "missing")]) == 2


def test_corpus_fixture_without_header_is_a_failure(tmp_path):
    (tmp_path / "race_undeclared.py").write_text("x = 1\n")
    failures, _ = run_corpus(tmp_path)
    assert any("lint-expect" in f for f in failures)


def test_expected_checks_parses_header():
    src = "# lint-expect: lock-order, guarded-field\nclass A: pass\n"
    assert expected_checks(src) == {"lock-order", "guarded-field"}


# --- both trees: the same lock discipline ---


def test_tree_findings_match_gol_tpu():
    """The concurrency and blocking-io-timeout findings over the port's
    tree equal gol_tpu's over its own, scope for scope (a port that
    changed a lock discipline shows here): today 15 findings in the 14
    grandfathered scopes of both allowlists."""
    def keyed(findings, prefix):
        return collections.Counter(
            (f.check, f.path.replace(prefix, "gol_tpu_torch/", 1), f.scope)
            for f in findings)

    mine = lint_paths([REPO / "gol_tpu_torch"], REPO,
                      checks=[blocking_io] + CONCURRENCY_CHECKS)
    theirs = jlint([REPO / "gol_tpu"], REPO,
                   checks=[jblocking_io] + JCONC)
    assert keyed(mine, "gol_tpu_torch/") == keyed(theirs, "gol_tpu/")
    assert len(mine) == 15 and len({f.scope for f in mine}) == 14
