"""Concurrency analysis plane — static lock/thread lint + dynamic twin.

The port's serving plane is gol_tpu's threads and locks carried over
module for module, and with them the races gol_tpu shipped and fixed
by hand review (the detach deadlock, the attach-before-reader eviction,
the writer-pool peek-then-pop, the double-decremented WS gauge). This
package holds the tooling that review was standing in for, ported with
the port's path prefixes:

- `graph.py` — the shared project index: classes, methods, lock
  identities, an interprocedural call graph, and per-statement
  held-lock sets. Pure `ast` + stdlib like the rest of the linter.
- `lock_order.py` — [lock-order] cycles in the merged lock-acquisition
  digraph (a static AB/BA deadlock detector).
- `lock_blocking.py` — [lock-blocking] locks held across blocking
  operations (socket sends/recvs, `manager.attach`/bucket builds,
  thread joins, deadlined queue ops, a device sync: `synchronize`,
  `.item()`, `.cpu()`), directly or through the call graph.
- `ownership.py` — [thread-ownership] the declared thread-ownership
  table: outbound frames leave only through writer-plane scopes,
  session verb internals are engine-thread-only, heartbeat/liveness
  loops never take the manager lock, the serving tier never syncs on
  the card.
- `guarded_field.py` — [guarded-field] fields mutated under a class's
  lock in one method and bare in another (the peek-then-pop shape).
- `lockcheck.py` — the dynamic twin (`GOL_TPU_LOCKCHECK=1`): tracked
  locks merging runtime acquisition orders into the same kind of order
  graph, a held-too-long watchdog, and a teardown resource census.

The static checks register in `gol_tpu_torch.analysis.checks.ALL_CHECKS`
and ride `python -m gol_tpu_torch.analysis --strict` with the
shrink-only allowlist discipline; gol_tpu's regression corpus under
`tests/fixtures/concurrency/` proves they flag the bug classes the
serving plane actually shipped
(`python -m gol_tpu_torch.analysis.concurrency.corpus`).
"""

from gol_tpu_torch.analysis.concurrency import (  # noqa: F401
    guarded_field,
    lock_blocking,
    lock_order,
    ownership,
)

#: The concurrency checks, in report order (appended to ALL_CHECKS).
CONCURRENCY_CHECKS = [lock_order, lock_blocking, ownership, guarded_field]

__all__ = ["CONCURRENCY_CHECKS", "guarded_field", "lock_blocking",
           "lock_order", "ownership"]
