"""lock-order — cycles in the project's merged lock-acquisition graph.

The static face of the AB/BA deadlock: thread 1 takes `_conn_lock`
then (through `manager.detach`) the manager lock, while the engine
thread holds the manager lock and (through an `on_close` sink) takes
`_conn_lock` — the detach shape gol_tpu shipped and hand-debugged. Every
`with B:` while A is lexically held adds edge A→B; calls made while
holding A add A→L for every lock L the resolved callee may acquire
(transitively). A cycle in the merged digraph means two threads can
interleave those paths into a deadlock.

Self-edges are ignored: re-acquiring the same identity is the RLock
re-entrancy pattern (`SessionManager._lock` is an RLock for exactly
this), not an ordering hazard. Each edge of a cycle yields its own
finding at its witness site — the actionable fix is breaking ONE edge
(usually by moving a call outside the lock, as its fix did), and the
allowlist key must point at code someone can edit.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

from gol_tpu_torch.analysis.core import Finding, ModuleContext
from gol_tpu_torch.analysis.concurrency.graph import ProjectIndex, index_for

CHECK = "lock-order"

#: Paths whose witnesses may yield findings — the threaded serving
#: plane. The index still covers the whole tree (a cycle may pass
#: through any module); only the flagged EDGE must sit in scope.
SCOPE_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/",
                "gol_tpu_torch/sessions/", "gol_tpu_torch/replay/",
                "gol_tpu_torch/engine/")


def _edges(index: ProjectIndex) -> Dict[Tuple[str, str], tuple]:
    """(A, B) -> first witness (ctx, node, scope, detail)."""
    out: Dict[Tuple[str, str], tuple] = {}
    for fn in index.funcs:
        for acq in fn.acquires:
            for held in acq.held:
                if held != acq.lock:
                    out.setdefault(
                        (held, acq.lock),
                        (fn.ctx, acq.node, fn.qualname,
                         f"acquires {acq.lock} while holding {held}"))
        for cs in fn.calls:
            if not cs.held or not cs.targets:
                continue
            for target in cs.targets:
                for lock in index.acquired_transitively(target):
                    for held in cs.held:
                        if held != lock:
                            out.setdefault(
                                (held, lock),
                                (fn.ctx, cs.node, fn.qualname,
                                 f"holds {held} across a call to "
                                 f"{target.qualname}, which may acquire "
                                 f"{lock}"))
    return out


def _cyclic_edges(edges: Sequence[Tuple[str, str]]) -> List[tuple]:
    """Edges on some cycle, each with one witness cycle path."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)

    def path(src: str, dst: str) -> List[str]:
        """A simple path src..dst in adj, or [] (DFS)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, p = stack.pop()
            if node == dst:
                return p
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, p + [nxt]))
        return []

    out = []
    for a, b in edges:
        back = path(b, a)
        if back:
            out.append(((a, b), back))
    return out


def run_project(ctxs: Sequence[ModuleContext]) -> Iterator[Finding]:
    index = index_for(ctxs)
    edges = _edges(index)
    for (a, b), back in _cyclic_edges(list(edges)):
        ctx, node, scope, detail = edges[(a, b)]
        if not ctx.rel.startswith(SCOPE_PREFIX):
            continue
        cycle = " -> ".join([a, b] + back[1:])
        yield ctx.finding(
            CHECK, node,
            f"lock-order cycle {cycle}: this site {detail} — another "
            "thread taking them in the opposite order deadlocks both "
            "(the detach shape); move the inner acquisition "
            "outside the outer lock",
        )
