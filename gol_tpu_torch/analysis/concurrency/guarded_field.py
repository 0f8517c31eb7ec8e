"""guarded-field — a field locked in one method, mutated bare in another.

The peek-then-pop shape: `PoolHandle.enqueue` mutates `self._q` under
`self._lock`, so the class has declared that deque lock-guarded — a
`self._q.popleft()` in another method with no lock held races every
guarded site (the writer-pool bug `_sending` was invented to fix), and
the double-decremented WS gauge was the AugAssign twin (`self.ws_peers
-= 1` on two threads, one of them bare).

Per class: collect every *mutation* of a `self.X` field — AugAssign,
container mutators (`append`/`pop`/`popleft`/`appendleft`/`remove`/
`clear`/`add`/`discard`/`update`/`extend`/`insert`/`setdefault`), and
subscript stores/deletes — with the set of `with`-lock tails lexically
held. A field mutated at least once under a lock makes every bare
mutation of it a finding. Plain rebinds (`self.turn = t`) are NOT
tracked: rebinding a reference is atomic under the GIL and flagging it
would bury the real races in noise.

Exempt scopes: `__init__` (no concurrent observer exists yet) and the
codebase's `*_locked` naming convention (`_release_locked`,
`_sync_conn_locked` — the caller holds the lock by contract; the
convention IS the documentation this check reads).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Set, Tuple

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "guarded-field"

SCOPE_PREFIX = ("gol_tpu_torch/distributed/", "gol_tpu_torch/relay/",
                "gol_tpu_torch/sessions/", "gol_tpu_torch/replay/",
                "gol_tpu_torch/engine/")

_LOCK_NAME_RE = re.compile(r"(lock|gate|mutex)s?$", re.I)
_MUTATORS = {"append", "appendleft", "pop", "popleft", "remove", "clear",
             "add", "discard", "update", "extend", "insert", "setdefault"}


def _tail(node: ast.AST):
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_field(node: ast.AST):
    """'X' when node is `self.X`, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _mutations(stmt: ast.AST) -> Iterator[Tuple[str, ast.AST, str]]:
    """(field, node, kind) for self-field mutations directly in stmt:
    assignment targets first, then container-mutator calls anywhere in
    the statement's direct expressions (`self._q.popleft()` bare or as
    an assignment's right-hand side alike)."""
    if isinstance(stmt, ast.AugAssign):
        f = _self_field(stmt.target)
        if f:
            yield f, stmt, "augmented assignment"
        elif isinstance(stmt.target, ast.Subscript):
            f = _self_field(stmt.target.value)
            if f:
                yield f, stmt, "item update"
    elif isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if isinstance(t, ast.Subscript):
                f = _self_field(t.value)
                if f:
                    yield f, stmt, "item store"
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            if isinstance(t, ast.Subscript):
                f = _self_field(t.value)
                if f:
                    yield f, stmt, "item delete"
    for child in ast.iter_child_nodes(stmt):
        if not isinstance(child, ast.expr):
            continue
        for node in ast.walk(child):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                f = _self_field(node.func.value)
                if f:
                    yield f, node, f".{node.func.attr}()"


class _ClassScan:
    def __init__(self) -> None:
        #: field -> lock tails it was mutated under (somewhere).
        self.locked_under: Dict[str, Set[str]] = {}
        #: bare mutation sites: (field, node, kind).
        self.bare: List[Tuple[str, ast.AST, str]] = []

    def walk(self, body, held: Tuple[str, ...]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs have their own discipline
            inner = held
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    t = _tail(item.context_expr)
                    if not isinstance(item.context_expr, ast.Call) \
                            and t and _LOCK_NAME_RE.search(t):
                        inner = inner + (t,)
                self.walk(stmt.body, inner)
                continue
            for field, node, kind in _mutations(stmt):
                if held:
                    self.locked_under.setdefault(field, set()).update(held)
                else:
                    self.bare.append((field, node, kind))
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    self.walk([child], held)
                elif isinstance(child, ast.excepthandler):
                    self.walk(child.body, held)


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not ctx.rel.startswith(SCOPE_PREFIX):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = _ClassScan()
        exempt_sites: Set[int] = set()
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue
            before = len(scan.bare)
            scan.walk(method.body, ())
            if method.name == "__init__" or method.name.endswith("_locked"):
                exempt_sites.update(
                    id(node) for _, node, _ in scan.bare[before:])
        for field, node, kind in scan.bare:
            if id(node) in exempt_sites:
                continue
            locks = scan.locked_under.get(field)
            if not locks:
                continue
            yield ctx.finding(
                CHECK, node,
                f"self.{field} {kind} with no lock held, but this class "
                f"mutates it under {', '.join(sorted(locks))} elsewhere "
                "— the peek-then-pop race shape; take the lock here or "
                "rename the method *_locked if the caller holds it",
            )
