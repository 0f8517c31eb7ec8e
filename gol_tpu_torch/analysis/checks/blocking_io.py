"""blocking-io-timeout — unbounded socket reads/connects in the wire plane.

The resilience layer's ground rule (docs/RESILIENCE.md), gol_tpu's and
the port's alike: every blocking socket read or connect in
`gol_tpu_torch/distributed/` (and the relay tier) carries a deadline,
so a dead peer, a silent TCP connect, or a blackholed path can only
stall a thread for a bounded interval — never forever. Without it the
accept thread could be wedged permanently by one peer that connected
and sent nothing, with the 30s SO_SNDTIMEO the system's ONLY failure
detector.

What the check enforces, per module under `gol_tpu_torch/distributed/`
and `gol_tpu_torch/relay/`:

- Raw `.recv(...)` / `.recv_into(...)` is allowed ONLY inside the wire
  plane's designated read primitive (`wire.py::_recv_exact`, which owns
  the idle-vs-mid-frame timeout semantics). Everything else must read
  through `wire.recv_msg`.
- `socket.create_connection(...)` must pass a `timeout` (kwarg or the
  second positional).
- A `recv_msg(X, ...)` / `X.connect(...)` call is accepted only when
  the module applies a read deadline to a socket whose dotted-chain
  tail matches X's (`conn.sock` ⇄ `sock.settimeout(t)`,
  `self._sock` ⇄ `self._sock.settimeout(t)`): a `settimeout` whose
  argument is not the literal None, or a `setsockopt` naming
  SO_RCVTIMEO/SO_SNDTIMEO. Tail matching is deliberately name-based —
  the point is that the module *documents the deadline discipline for
  that socket*, which line-level dataflow cannot prove anyway.
- `.accept()` on the listener is exempt: its lifecycle is close-driven
  (closing the listener is how the accept loop is told to exit), and a
  deadline there would only add spurious wakeups.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "blocking-io-timeout"

_SCOPE_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/")
#: Sanctioned raw-recv sites: (path suffix, enclosing scope). The
#: relay tier adds two — the WS plane's exact-read primitive and its
#: header-delimited upgrade reader (both deadline-disciplined the
#: wire._recv_exact way).
_RECV_PRIMITIVES = (
    ("wire.py", "_recv_exact"),
    ("ws.py", "_read_exact"),
    ("ws.py", "handshake"),
)
_TIMEOUT_OPTS = {"SO_RCVTIMEO", "SO_SNDTIMEO"}


def _tail(node: ast.AST):
    """Final attribute/name of a dotted chain: `conn.sock` -> 'sock',
    `self._sock` -> '_sock', `sock` -> 'sock'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _deadlined_tails(ctx: ModuleContext) -> Set[str]:
    """Chain tails this module applies a read/write deadline to."""
    tails: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr == "settimeout" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and arg.value is None:
                continue  # explicit blocking mode is not a deadline
            t = _tail(node.func.value)
            if t is not None:
                tails.add(t)
        elif node.func.attr == "setsockopt":
            names = {
                n.attr if isinstance(n, ast.Attribute) else n.id
                for a in node.args for n in ast.walk(a)
                if isinstance(n, (ast.Attribute, ast.Name))
            }
            if names & _TIMEOUT_OPTS:
                t = _tail(node.func.value)
                if t is not None:
                    tails.add(t)
    return tails


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not ctx.rel.startswith(_SCOPE_PREFIX):
        return
    deadlined = _deadlined_tails(ctx)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = _tail(fn)
        if name in ("recv", "recv_into") and isinstance(fn, ast.Attribute):
            if any(ctx.rel.endswith(suffix)
                   and ctx.scope_of(node) == scope
                   for suffix, scope in _RECV_PRIMITIVES):
                continue
            yield ctx.finding(
                CHECK, node,
                f"raw socket .{name}() outside the sanctioned wire "
                "read primitives (wire._recv_exact / ws._read_exact) "
                "— read through wire.recv_msg on a deadlined socket "
                "instead",
            )
        elif name == "create_connection":
            if len(node.args) >= 2 or any(
                kw.arg == "timeout" for kw in node.keywords
            ):
                continue
            yield ctx.finding(
                CHECK, node,
                "create_connection without a timeout — a wedged or "
                "blackholed server would hang the dialing thread "
                "forever",
            )
        elif name == "connect" and isinstance(fn, ast.Attribute):
            if _tail(fn.value) in deadlined:
                continue
            yield ctx.finding(
                CHECK, node,
                "socket .connect() with no deadline applied to "
                f"'{_tail(fn.value)}' anywhere in this module — use "
                "create_connection(timeout=...) or settimeout first",
            )
        elif name in ("recv_msg", "recv_frame") and node.args:
            if ctx.rel.endswith("distributed/wire.py"):
                continue  # the wire plane's own internal plumbing
            target = _tail(node.args[0])
            if target in deadlined:
                continue
            yield ctx.finding(
                CHECK, node,
                f"wire.{name} on '{target}' but this module never "
                "applies a read deadline to that socket (settimeout / "
                "SO_RCVTIMEO) — a dead peer would block this thread "
                "unboundedly",
            )
