"""thread-ownership — the declared thread-ownership table, enforced.

The serving plane's thread roles are a contract the code only states
in comments ("peek_turn, NOT manager.get: the manager lock is held
across bucket dispatches"). This check turns the contract into data.
The table (gol_tpu's, which docs/ANALYSIS.md reproduces):

- **Outbound frames are writer-plane-only.** Raw `sendall` /
  `wire.send_frame` may appear only in the sanctioned writer scopes:
  the wire primitives themselves, `_Conn`'s serialized send paths
  (`_send_now` / `_write_loop` / `send_direct`), the WS control
  senders (`WSConn.beacon` / `enqueue_control`), and the relay's
  reject/handshake paths. Everything else must enqueue through a
  `_Conn`/pool so backpressure accounting and shed policy see the
  frame.
- **Session verb internals are engine-thread-only.** The manager's
  underscore verbs (`_create`, `_destroy`, `_attach`, `_detach`,
  `_checkpoint`, `_fetch_board`, `_park`, `_rehydrate`) run under the
  manager lock on the engine thread via `_exec`; calling one from
  outside `gol_tpu_torch/sessions/` bypasses that routing and races the
  engine.
- **Liveness loops never take the manager lock.** A `_heartbeat_loop`
  judging peer freshness must read the lock-free peek surface
  (`peek_turn` / `known` / `peek_geometry`); a manager verb there
  stalls eviction behind a bucket build — the starvation the attach fix
  removed.
- **The serving tier never blocks on device work.** A device sync —
  `synchronize()` on the card or a stream/event, and the read-backs
  `.item()` / `.cpu()` that wait for the card — belongs to the
  engine/sessions dispatch plane (gol_tpu's `block_until_ready`); a
  server, relay, or replay scope that syncs on a device value has
  smuggled a dispatch into the I/O plane.

Per-module and purely name/scope-based (no call graph): the table is a
declaration about WHERE operations may appear, which is exactly what a
scope check can read.
"""

from __future__ import annotations

import ast
from typing import Iterator

from gol_tpu_torch.analysis.core import Finding, ModuleContext
from gol_tpu_torch.analysis.concurrency.graph import tail

CHECK = "thread-ownership"

SCOPE_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/",
                "gol_tpu_torch/sessions/", "gol_tpu_torch/replay/")

#: Rule 1 — sanctioned outbound-frame scopes: (path suffix, scope
#: prefix or None for the whole module). The writer plane.
SEND_SANCTIONED = (
    ("distributed/wire.py", None),
    ("relay/ws.py", None),           # WS framing primitives + handshake
    ("distributed/server.py", "_Conn."),
    ("relay/node.py", "WSConn."),
    ("relay/node.py", "RelayNode._reject"),
)
_SEND_TAILS = {"sendall", "send_frame"}

#: Rule 2 — manager verb internals (engine-thread-only via _exec).
_VERB_TAILS = {"_create", "_destroy", "_attach", "_detach", "_checkpoint",
               "_fetch_board", "_park", "_rehydrate"}
#: Receiver tails that denote the session manager.
_MANAGER_TAILS = {"manager", "mgr", "_manager"}

#: Rule 3 — manager surface forbidden in liveness loops (the lock-free
#: peeks `peek_turn` / `known` / `peek_geometry` are the sanctioned
#: alternative and are absent from this set).
_LIVENESS_FORBIDDEN = {"get", "attach", "detach", "create", "destroy",
                       "checkpoint", "fetch_board", "park", "resync",
                       "list_sessions", "pump"}
_LIVENESS_SCOPES = ("_heartbeat_loop",)

#: Rule 4 — device-plane ops banned from the I/O tier.
_DEVICE_TAILS = {"synchronize", "item", "cpu"}
_DEVICE_BANNED_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/",
                         "gol_tpu_torch/replay/")


def _send_sanctioned(ctx: ModuleContext, node: ast.AST) -> bool:
    scope = ctx.scope_of(node)
    for suffix, prefix in SEND_SANCTIONED:
        if not ctx.rel.endswith(suffix):
            continue
        if prefix is None or scope == prefix.rstrip(".") \
                or scope.startswith(prefix):
            return True
    return False


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not ctx.rel.startswith(SCOPE_PREFIX):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = tail(fn)
        if name in _SEND_TAILS and not _send_sanctioned(ctx, node):
            yield ctx.finding(
                CHECK, node,
                f"outbound frame ({name}) outside the writer plane's "
                "sanctioned scopes — enqueue through a _Conn/WriterPool "
                "so backpressure accounting and shed policy see it",
            )
        elif name in _VERB_TAILS and isinstance(fn, ast.Attribute) \
                and tail(fn.value) in _MANAGER_TAILS \
                and not ctx.rel.startswith("gol_tpu_torch/sessions/"):
            yield ctx.finding(
                CHECK, node,
                f"manager verb internal .{name}() called outside the "
                "manager — verbs are engine-thread-only; call the "
                f"public {name.lstrip('_')}() so _exec routes it",
            )
        elif name in _LIVENESS_FORBIDDEN and isinstance(fn, ast.Attribute) \
                and tail(fn.value) in _MANAGER_TAILS:
            scope = ctx.scope_of(node)
            if scope.rsplit(".", 1)[-1] in _LIVENESS_SCOPES:
                yield ctx.finding(
                    CHECK, node,
                    f"liveness loop calls manager.{name}() — a verb "
                    "waits out the manager lock (held across bucket "
                    "compiles); judge freshness on the lock-free "
                    "peek_turn/known surface instead",
                )
        elif name in _DEVICE_TAILS \
                and ctx.rel.startswith(_DEVICE_BANNED_PREFIX):
            yield ctx.finding(
                CHECK, node,
                f"device sync (.{name}()) in the serving tier — "
                "device dispatch is engine-thread-only; consume the "
                "engine's event stream instead of syncing on arrays",
            )
