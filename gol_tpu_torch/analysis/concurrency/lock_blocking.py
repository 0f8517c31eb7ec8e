"""lock-blocking — locks held across operations that block the thread.

A lock held across a blocking call turns one slow peer into a stalled
plane: every thread that wants the lock waits out the blocked one's
socket deadline (the attach shape — `_conn_lock` held across
`manager.attach`, which can sit behind a cold bucket build, starved
the heartbeat judge into evicting live peers). Flagged here:

- a blocking operation (socket send/recv/connect/accept, wire frame
  I/O, a device sync — `synchronize`, `.item()`, `.cpu()` —,
  `time.sleep`, event/condition waits,
  thread joins, deadlined queue ops) lexically inside a `with <lock>:`
  body, and
- a call made while holding a lock whose resolved callee can block,
  transitively through the project call graph — `manager.attach`
  blocks because `_exec` waits on the engine thread, which is invisible
  to any single-file pass.

The legitimate exceptions are locks whose entire PURPOSE is to
serialize one socket (`_Conn._lock` around `sendall` — the wire is the
resource the lock guards, and the writer deadline bounds the hold).
Those carry allowlist entries with that retained-contract rationale,
the same discipline the donation check uses; an entry here is a
documented design decision, not a mute button.
"""

from __future__ import annotations

from typing import Iterator, Sequence

from gol_tpu_torch.analysis.core import Finding, ModuleContext
from gol_tpu_torch.analysis.concurrency.graph import blocking_op, index_for

CHECK = "lock-blocking"

SCOPE_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/",
                "gol_tpu_torch/sessions/", "gol_tpu_torch/replay/",
                "gol_tpu_torch/engine/",
                # The accounting plane's contract is that ledger file
                # I/O never runs under a lock the serving path takes —
                # the meter's lock only guards dict updates.
                "gol_tpu_torch/obs/accounting")


def run_project(ctxs: Sequence[ModuleContext]) -> Iterator[Finding]:
    index = index_for(ctxs)
    for fn in index.funcs:
        if not fn.rel.startswith(SCOPE_PREFIX):
            continue
        for op in fn.blocking:
            if not op.held:
                continue
            yield fn.ctx.finding(
                CHECK, op.node,
                f"{op.desc} while holding {', '.join(op.held)} — every "
                "thread wanting that lock now waits out this I/O; move "
                "the blocking work outside the lock or document the "
                "lock-serializes-this-resource contract in the "
                "allowlist",
            )
        for cs in fn.calls:
            if not cs.held or blocking_op(cs.node) is not None:
                continue  # direct ops already flagged above
            for target in cs.targets:
                why = index.blocking_reason(target)
                if why is None:
                    continue
                yield fn.ctx.finding(
                    CHECK, cs.node,
                    f"call to {target.qualname} while holding "
                    f"{', '.join(cs.held)}, and {target.qualname} can "
                    f"block: {why} — the attach-under-conn-lock "
                    "shape; call it after releasing the lock",
                )
                break
