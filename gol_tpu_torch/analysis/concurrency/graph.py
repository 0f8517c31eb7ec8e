"""Project index for the concurrency checks — locks, calls, held sets.

Pure `ast` + stdlib (the linter's ground rule: it must run where the
package under analysis cannot import). The index is deliberately
name-based where dataflow would be needed for precision, with the same
philosophy as blocking_io's tail matching: the point is that a module
*documents* its locking discipline in names and structure, and the
checks read that documentation.

What gets resolved, and how:

- **Lock identity.** A `with`-item is a lock acquisition when its
  context expression is a bare Name/Attribute that either resolves to
  a known lock binding (`self.X = threading.Lock()` / `RLock` /
  `lockcheck.make_lock(...)`, or a module-level such assignment) or
  whose tail name looks like a lock (`...lock`, `...gate`, `...mutex`).
  `self.X` in class C identifies as `C.X` — walking single-inheritance
  bases to the class that actually BINDS the attr, so `WSConn` methods
  acquiring the `_Conn`-bound `self._lock` merge with `_Conn`'s own
  acquisitions into one graph node. Unresolvable attribute chains get
  a scope-unique identity: they can still witness "held across a
  blocking call" but never merge with someone else's lock (no false
  cycle from two unrelated `.lock` fields).
- **Call targets.** `self.m()` → own class then bases; `self.attr.m()`
  via the attr's constructor type (`self.attr = ClassName(...)` or an
  `attr: ClassName` annotation); `local.m()` via a same-function
  `local = ClassName(...)` assignment; `mod.f()` via the import map
  when `mod` is a project module; bare `f()` via the module's own
  top-level functions. Anything else stays unresolved — the checks
  treat unresolved calls as non-blocking/non-acquiring (conservative:
  silence over noise).
- **Held sets.** A statement-level walk per function tracks the tuple
  of lock identities lexically held at every node, in acquisition
  order.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from gol_tpu_torch.analysis.core import ModuleContext

__all__ = ["ProjectIndex", "FuncInfo", "ClassInfo", "CallSite",
           "BlockingOp", "Acquire", "blocking_op", "index_for", "tail"]

#: Callables that bind a lock: stdlib constructors plus the dynamic
#: twin's tracked factory (lockcheck.make_lock / make_rlock).
_LOCK_FACTORY_TAILS = {"Lock", "RLock", "make_lock", "make_rlock"}
#: Name-pattern fallback for with-items with no resolvable binding.
_LOCK_NAME_RE = re.compile(r"(lock|gate|mutex)s?$", re.I)

#: Chain tails that block the calling thread. `wait`/`join`/queue ops
#: are bounded by deadlines in this codebase but still block for up to
#: the deadline — exactly what must never happen under a lock.
_BLOCKING_TAILS = {
    "sendall": "socket sendall",
    "send_frame": "wire send_frame",
    "send_msg": "wire send_msg",
    "recv_msg": "wire recv_msg",
    "recv_frame": "wire recv_frame",
    "recv": "socket recv",
    "recv_into": "socket recv_into",
    "accept": "socket accept",
    "connect": "socket connect",
    "create_connection": "socket connect",
    "synchronize": "device sync (synchronize)",
    "item": "device read-back (.item())",
    "cpu": "device read-back (.cpu())",
    "sleep": "time.sleep",
    "select": "select",
    "wait": "event/condition wait",
    "join": "thread join",
}
#: `.join` receivers that are string/path joins, not thread joins.
_JOIN_EXEMPT_BASES = {"path", "os", "posixpath", "sep"}


def tail(node: ast.AST) -> Optional[str]:
    """Final attribute/name of a dotted chain (blocking_io's helper)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def blocking_op(node: ast.Call) -> Optional[str]:
    """Description when `node` is a call that blocks its thread."""
    t = tail(node.func)
    desc = _BLOCKING_TAILS.get(t or "")
    if desc is None:
        # Deadlined queue ops: .get/.put WITH a timeout kwarg — the
        # spelling this codebase uses for bounded queue waits (a bare
        # dict .get never carries one).
        if t in ("get", "put") and any(kw.arg == "timeout"
                                       for kw in node.keywords):
            return f"deadlined queue .{t}"
        return None
    if t == "join":
        if not isinstance(node.func, ast.Attribute):
            return None
        base = node.func.value
        if isinstance(base, ast.Constant) or isinstance(base, ast.JoinedStr):
            return None  # "sep".join(...)
        if tail(base) in _JOIN_EXEMPT_BASES:
            return None  # os.path.join(...)
    if t in ("recv", "recv_into", "accept", "connect", "wait") \
            and not isinstance(node.func, ast.Attribute):
        return None  # bare names of these are not socket/event methods
    return desc


def _is_lock_factory(value: ast.AST) -> bool:
    return isinstance(value, ast.Call) and \
        tail(value.func) in _LOCK_FACTORY_TAILS


@dataclasses.dataclass
class Acquire:
    """One `with <lock>:` acquisition."""

    lock: str                  #: lock identity
    node: ast.AST              #: the With statement
    held: Tuple[str, ...]      #: identities already held at this point


@dataclasses.dataclass
class BlockingOp:
    desc: str
    node: ast.AST
    held: Tuple[str, ...]


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    held: Tuple[str, ...]
    targets: List["FuncInfo"]  #: resolved project-internal callees


@dataclasses.dataclass
class FuncInfo:
    """One analyzed function/method."""

    ctx: ModuleContext
    node: ast.AST
    qualname: str
    cls: Optional["ClassInfo"]
    acquires: List[Acquire] = dataclasses.field(default_factory=list)
    blocking: List[BlockingOp] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)

    @property
    def rel(self) -> str:
        return self.ctx.rel


@dataclasses.dataclass
class ClassInfo:
    name: str
    qualname: str
    ctx: ModuleContext
    node: ast.ClassDef
    bases: List[str] = dataclasses.field(default_factory=list)
    methods: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    #: self.X = ClassName(...) / self.X: ClassName — light type facts.
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: Attrs bound to a Lock/RLock/make_lock in any method.
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)


def _dotted(rel: str) -> str:
    """'gol_tpu_torch/relay/node.py' -> 'gol_tpu_torch.relay.node'."""
    return rel[:-3].replace("/", ".") if rel.endswith(".py") else rel


class ProjectIndex:
    """Everything the concurrency checks share, built once per lint."""

    def __init__(self, ctxs: Sequence[ModuleContext]):
        self.ctxs = list(ctxs)
        self.modules: Dict[str, ModuleContext] = {
            _dotted(c.rel): c for c in self.ctxs
        }
        #: class simple name -> every ClassInfo carrying it.
        self.classes: Dict[str, List[ClassInfo]] = {}
        #: per module: top-level function name -> FuncInfo.
        self.mod_funcs: Dict[ModuleContext, Dict[str, FuncInfo]] = {}
        #: per module: imported name -> dotted module or class name.
        self.imports: Dict[ModuleContext, Dict[str, str]] = {}
        #: per module: module-level lock names.
        self.mod_locks: Dict[ModuleContext, Set[str]] = {}
        self.funcs: List[FuncInfo] = []
        self._trans_blocking: Optional[Dict[int, str]] = None
        self._trans_acquires: Optional[Dict[int, Set[str]]] = None
        for ctx in self.ctxs:
            self._register_module(ctx)
        for fn in self.funcs:
            self._analyze(fn)

    # -- pass 1: declarations ---------------------------------------------

    def _register_module(self, ctx: ModuleContext) -> None:
        funcs: Dict[str, FuncInfo] = {}
        imports: Dict[str, str] = {}
        locks: Set[str] = set()
        for node in ctx.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._record_import(node, imports)
            elif isinstance(node, ast.FunctionDef):
                fi = FuncInfo(ctx, node, ctx.qualname(node), None)
                funcs[node.name] = fi
                self.funcs.append(fi)
            elif isinstance(node, ast.ClassDef):
                self._register_class(ctx, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_lock_factory(node.value):
                locks.add(node.targets[0].id)
        self.mod_funcs[ctx] = funcs
        self.imports[ctx] = imports
        self.mod_locks[ctx] = locks

    def _record_import(self, node: ast.AST, out: Dict[str, str]) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"

    def _register_class(self, ctx: ModuleContext,
                        node: ast.ClassDef) -> None:
        ci = ClassInfo(node.name, ctx.qualname(node), ctx, node,
                       bases=[tail(b) or "" for b in node.bases])
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                fi = FuncInfo(ctx, item, ctx.qualname(item), ci)
                ci.methods[item.name] = fi
                self.funcs.append(fi)
        # Attribute facts from every method body: `self.X = Y(...)`
        # types the attr, `self.X = Lock()` marks it a lock binding;
        # `self.X: T` annotations count as types too.
        for sub in ast.walk(node):
            target = value = None
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                target, value = sub.targets[0], sub.value
            elif isinstance(sub, ast.AnnAssign):
                target, value = sub.target, sub.value
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            if value is not None and _is_lock_factory(value):
                ci.lock_attrs.add(target.attr)
            elif isinstance(value, ast.Call):
                t = tail(value.func)
                if t and t[:1].isupper():
                    ci.attr_types.setdefault(target.attr, t)
            if isinstance(sub, ast.AnnAssign):
                ann = tail(sub.annotation)
                if ann and ann[:1].isupper():
                    ci.attr_types.setdefault(target.attr, ann)
        self.classes.setdefault(node.name, []).append(ci)

    # -- name/type resolution ---------------------------------------------

    def resolve_class(self, ctx: ModuleContext,
                      name: str) -> Optional[ClassInfo]:
        """A class by simple name as seen from `ctx`: same module first,
        then the import map, then a project-unique name."""
        cands = self.classes.get(name, [])
        for ci in cands:
            if ci.ctx is ctx:
                return ci
        imp = self.imports.get(ctx, {}).get(name)
        if imp:
            mod = imp.rsplit(".", 1)[0]
            for ci in cands:
                if _dotted(ci.ctx.rel) == mod:
                    return ci
        if len(cands) == 1:
            return cands[0]
        return None

    def _mro(self, ci: ClassInfo) -> Iterator[ClassInfo]:
        seen = set()
        stack = [ci]
        while stack:
            cur = stack.pop(0)
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            yield cur
            for b in cur.bases:
                base = self.resolve_class(cur.ctx, b) if b else None
                if base is not None:
                    stack.append(base)

    def method(self, ci: ClassInfo, name: str) -> Optional[FuncInfo]:
        for cls in self._mro(ci):
            if name in cls.methods:
                return cls.methods[name]
        return None

    def lock_owner(self, ci: ClassInfo, attr: str) -> ClassInfo:
        """The MRO class that binds `attr` as a lock — so `WSConn`'s
        inherited `self._lock` and `_Conn`'s own are one identity."""
        for cls in self._mro(ci):
            if attr in cls.lock_attrs:
                return cls
        return ci

    # -- pass 2: per-function body analysis --------------------------------

    def _analyze(self, fn: FuncInfo) -> None:
        local_types = self._local_types(fn)
        self._walk_body(fn, fn.node.body, (), local_types)

    def _local_types(self, fn: FuncInfo) -> Dict[str, str]:
        """`v = ClassName(...)` assignments in this function."""
        out: Dict[str, str] = {}
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name) \
                    and isinstance(sub.value, ast.Call):
                t = tail(sub.value.func)
                if t and t[:1].isupper():
                    out.setdefault(sub.targets[0].id, t)
        return out

    def lock_identity(self, fn: FuncInfo, expr: ast.AST,
                      local_types: Optional[Dict[str, str]] = None
                      ) -> Optional[str]:
        """Identity of `expr` as a lock, or None if it isn't one."""
        ctx = fn.ctx
        if isinstance(expr, ast.Name):
            if expr.id in self.mod_locks.get(ctx, ()):
                return f"{_dotted(ctx.rel)}:{expr.id}"
            if _LOCK_NAME_RE.search(expr.id):
                return f"{_dotted(ctx.rel)}:{expr.id}"
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base, attr = expr.value, expr.attr
        if isinstance(base, ast.Name) and base.id == "self" \
                and fn.cls is not None:
            if attr in _all_lock_attrs(self, fn.cls) \
                    or _LOCK_NAME_RE.search(attr):
                return f"{self.lock_owner(fn.cls, attr).name}.{attr}"
            return None
        # `rec.lock` via a typed local / typed self-attr.
        owner = self._expr_class(fn, base, local_types or {})
        if owner is not None and (attr in _all_lock_attrs(self, owner)
                                  or _LOCK_NAME_RE.search(attr)):
            return f"{self.lock_owner(owner, attr).name}.{attr}"
        if _LOCK_NAME_RE.search(attr):
            # A lock by name with no resolvable owner: scope-unique
            # identity — witnesses held-across-blocking, never merges.
            return f"{_dotted(ctx.rel)}:{fn.qualname}:{attr}"
        return None

    def _expr_class(self, fn: FuncInfo, expr: ast.AST,
                    local_types: Dict[str, str]) -> Optional[ClassInfo]:
        """Light type inference for a call/lock receiver."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return fn.cls
            t = local_types.get(expr.id)
            return self.resolve_class(fn.ctx, t) if t else None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and fn.cls is not None:
            for cls in self._mro(fn.cls):
                t = cls.attr_types.get(expr.attr)
                if t:
                    return self.resolve_class(cls.ctx, t)
        return None

    def _resolve_call(self, fn: FuncInfo, call: ast.Call,
                      local_types: Dict[str, str]) -> List[FuncInfo]:
        f = call.func
        if isinstance(f, ast.Name):
            target = self.mod_funcs.get(fn.ctx, {}).get(f.id)
            if target is not None:
                return [target]
            imp = self.imports.get(fn.ctx, {}).get(f.id)
            if imp and "." in imp:
                mod, name = imp.rsplit(".", 1)
                mctx = self.modules.get(mod)
                if mctx is not None:
                    t = self.mod_funcs.get(mctx, {}).get(name)
                    if t is not None:
                        return [t]
            return []
        if isinstance(f, ast.Attribute):
            # Module-qualified: wire.send_msg(...).
            if isinstance(f.value, ast.Name):
                imp = self.imports.get(fn.ctx, {}).get(f.value.id)
                mctx = self.modules.get(imp) if imp else None
                if mctx is not None:
                    t = self.mod_funcs.get(mctx, {}).get(f.attr)
                    return [t] if t is not None else []
            owner = self._expr_class(fn, f.value, local_types)
            if owner is not None:
                t = self.method(owner, f.attr)
                return [t] if t is not None else []
        return []

    def _with_locks(self, fn: FuncInfo, stmt: ast.With,
                    local_types: Dict[str, str]) -> List[str]:
        out = []
        for item in stmt.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                continue  # contextlib.suppress(...), open(...), ...
            lock = self.lock_identity(fn, expr, local_types)
            if lock is not None:
                out.append(lock)
        return out

    def _walk_body(self, fn: FuncInfo, body, held: Tuple[str, ...],
                   local_types: Dict[str, str]) -> None:
        for stmt in body:
            self._walk_stmt(fn, stmt, held, local_types)

    def _walk_stmt(self, fn: FuncInfo, stmt: ast.AST,
                   held: Tuple[str, ...],
                   local_types: Dict[str, str]) -> None:
        if isinstance(stmt, ast.With):
            locks = self._with_locks(fn, stmt, local_types)
            inner = held
            for lock in locks:
                fn.acquires.append(Acquire(lock, stmt, inner))
                if lock not in inner:
                    inner = inner + (lock,)
            for item in stmt.items:
                self._scan_exprs(fn, item.context_expr, held, local_types)
            self._walk_body(fn, stmt.body, inner, local_types)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's body runs when CALLED, not here: analyze
            # it with an empty held set under the same FuncInfo (its
            # findings still anchor to the enclosing scope's context).
            self._walk_body(fn, stmt.body, (), local_types)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._walk_stmt(fn, child, held, local_types)
            elif isinstance(child, ast.excepthandler):
                for inner in child.body:
                    self._walk_stmt(fn, inner, held, local_types)
            elif isinstance(child, ast.expr):
                # Expressions directly in this statement; nested
                # lambdas/comprehensions scan with the SAME held set —
                # a lexical approximation (closure bodies handed to
                # `_exec` run elsewhere), which is what feeds the
                # transitive-blocking closure its verb-body facts.
                self._scan_exprs(fn, child, held, local_types)

    def _scan_exprs(self, fn: FuncInfo, expr: ast.AST,
                    held: Tuple[str, ...],
                    local_types: Dict[str, str]) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            desc = blocking_op(node)
            if desc is not None:
                fn.blocking.append(BlockingOp(desc, node, held))
            targets = self._resolve_call(fn, node, local_types)
            fn.calls.append(CallSite(node, held, targets))

    # -- interprocedural closures ------------------------------------------

    def blocking_reason(self, fn: FuncInfo) -> Optional[str]:
        """Why `fn` can block its caller, or None. Transitive through
        resolved calls (fixpoint; unresolved calls assumed cheap)."""
        if self._trans_blocking is None:
            self._trans_blocking = self._fix_blocking()
        return self._trans_blocking.get(id(fn.node))

    def _fix_blocking(self) -> Dict[int, str]:
        reason: Dict[int, str] = {}
        for fn in self.funcs:
            if fn.blocking:
                reason[id(fn.node)] = fn.blocking[0].desc
        changed = True
        while changed:
            changed = False
            for fn in self.funcs:
                if id(fn.node) in reason:
                    continue
                for cs in fn.calls:
                    hit = next((t for t in cs.targets
                                if id(t.node) in reason), None)
                    if hit is not None:
                        reason[id(fn.node)] = (
                            f"calls {hit.qualname} which blocks "
                            f"({reason[id(hit.node)]})")
                        changed = True
                        break
        return reason

    def acquired_transitively(self, fn: FuncInfo) -> Set[str]:
        """Lock identities `fn` may acquire, through resolved calls."""
        if self._trans_acquires is None:
            self._trans_acquires = self._fix_acquires()
        return self._trans_acquires.get(id(fn.node), set())

    def _fix_acquires(self) -> Dict[int, Set[str]]:
        acq: Dict[int, Set[str]] = {
            id(fn.node): {a.lock for a in fn.acquires} for fn in self.funcs
        }
        changed = True
        while changed:
            changed = False
            for fn in self.funcs:
                mine = acq[id(fn.node)]
                for cs in fn.calls:
                    for t in cs.targets:
                        extra = acq.get(id(t.node), set()) - mine
                        if extra:
                            mine |= extra
                            changed = True
        return acq


def _all_lock_attrs(index: ProjectIndex, ci: ClassInfo) -> Set[str]:
    out: Set[str] = set()
    for cls in index._mro(ci):
        out |= cls.lock_attrs
    return out


#: One-slot cache: lint_paths hands every run_project the SAME ctx
#: list, so lock-order and lock-blocking share one index build.
_LAST: List = [None, None]


def index_for(ctxs: Sequence[ModuleContext]) -> ProjectIndex:
    if _LAST[0] is not ctxs:
        _LAST[0] = ctxs
        _LAST[1] = ProjectIndex(ctxs)
    return _LAST[1]
