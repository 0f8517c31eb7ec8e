"""Linter core — findings, hot-context discovery, allowlist, file walk.

Everything here is pure `ast` + stdlib on purpose: the linter must run
(and fail usefully) on a machine where torch, the CUDA toolkit, the
native board, or the package under analysis cannot even import. Checks
live in `gol_tpu_torch/analysis/checks/`; each module exposes

    CHECK = "kebab-name"        # finding category
    def run(ctx: ModuleContext) -> Iterator[Finding]

and registers itself in `checks.ALL_CHECKS`.

Allowlist keys are (check, path, scope) — scope is the enclosing
function's dotted qualname (or "<module>") — NOT line numbers, so an
unrelated edit above a grandfathered finding cannot silently retire or
orphan its entry. The flip side: one entry covers every same-check
finding in that function, which is the granularity reasons are written
at anyway.

The hot context. gol_tpu's checks hang on jit-context discovery: a
function decorated with (or handed to) `jax.jit`, `lax.scan`,
`shard_map`, ... runs under trace, and its parameters are tracers
except the `static_argnames`. The port has no jit: a function's body
runs on the host every time it is called, and what matters is which
bodies run once per DISPATCH to the card — there a host read-back
(`.item()`, `bool()` of a tensor, a device-to-host copy) stalls the
pipeline once per chunk. Those bodies are named by a table, not found
by a decorator, so the tree under analysis changes only where a
finding is fixed:

- `parallel/` modules: the multi-turn stepper entries — closures named
  in HOT_CLOSURES (`scan_diffs.step_n_with_diffs`,
  `_packed_state_stepper._step_n`, the rings' shared
  `dense_step_n.step_n` / `packed_step_n.step_n` /
  `_mesh_stepper.step_n`, ...) unless they sit inside a dispatch
  wrapper (DISPATCH_WRAPPERS: the stepper's obs wrapper and the
  multi-process mirror's opcode handlers, which run once per dispatch
  BY DESIGN and whose bodies are host bookkeeping) — and the top-level
  functions in HOT_FUNCTIONS (the ring's deep block, `halo.ring_block`).
- `ops/` modules: the kernel wrappers and plain steps — every function
  whose name starts with `step_n`, and the launchers in OPS_LAUNCHERS
  (`_launch`, `_run`, `_tiled_pass`, `_run_passes`).

Nested defs and lambdas inside a hot function are hot too, as an inner
helper of a jitted function is traced. Every parameter of a hot
function is a tensor parameter (the counterpart of a traced one) except
the Python statics named in STATIC_PARAMS, which takes the role of
gol_tpu's `static_argnames`.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

#: Closure names of the multi-turn stepper entries in `parallel/`.
HOT_CLOSURES = {"step_n", "_step_n", "step_n_with_diffs",
                "step_n_with_diffs_sparse", "step_n_with_diffs_compact"}
#: Top-level hot functions of `parallel/`: the rings' deep block.
HOT_FUNCTIONS = {"ring_block"}
#: Factories whose closures wrap a stepper at dispatch granularity —
#: the stepper's obs wrapper (instrumentation belongs there) and the
#: multi-process mirror's opcode handlers — not hot bodies themselves.
DISPATCH_WRAPPERS = {"instrument_stepper", "spmd_worker_loop"}
#: Kernel launchers of `ops/` besides the `step_n*` entries.
OPS_LAUNCHERS = {"_launch", "_run", "_tiled_pass", "_run_passes"}
#: Parameters of hot functions that are Python values, never tensors:
#: turn counts, rules, buffer caps, plans, launch counters and names,
#: ring geometry and the callables a block steps with.
STATIC_PARAMS = {"k", "n", "rule", "cap", "total_cap", "geom", "launches",
                 "name", "plan", "lead", "depth", "real", "mesh",
                 "step_ext", "one_pass", "strip_rows", "halo_words",
                 "tile_rows", "turns"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One hazard the linter found."""

    check: str    #: category, e.g. "host-sync"
    path: str     #: repo-relative posix path
    line: int
    scope: str    #: enclosing function qualname, or "<module>"
    message: str

    @property
    def key(self) -> tuple:
        """Allowlist identity — line-number free (see module docstring)."""
        return (self.check, self.path, self.scope)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.check}] {self.message}"
                f"  (scope: {self.scope})")


@dataclasses.dataclass
class HotInfo:
    """One function whose body runs once per dispatch to the card."""

    node: ast.AST                 # FunctionDef
    qualname: str
    plane: str                    # "parallel" (stepper entry) or "ops"


class ModuleContext:
    """Parsed module + the derived maps every check needs."""

    def __init__(self, path: pathlib.Path, rel: str, source: str):
        self.path = path
        self.rel = rel  # repo-relative posix path used in findings
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        #: Every node of the module in `ast.walk` order, walked once and
        #: shared by the checks.
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self._qualnames = self._build_qualnames()
        self.hot: Dict[ast.AST, HotInfo] = {}
        self._find_hot()

    # -- structure helpers -------------------------------------------------

    def _build_qualnames(self) -> Dict[ast.AST, str]:
        names: Dict[ast.AST, str] = {}

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    names[child] = q
                    visit(child, q)
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return names

    def qualname(self, node: ast.AST) -> str:
        return self._qualnames.get(node, "<module>")

    def scope_of(self, node: ast.AST) -> str:
        """Dotted qualname of the innermost enclosing function/class."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if cur in self._qualnames:
                return self._qualnames[cur]
            cur = self.parents.get(cur)
        return "<module>"

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def finding(self, check: str, node: ast.AST, message: str) -> Finding:
        return Finding(check, self.rel, getattr(node, "lineno", 0),
                       self.scope_of(node), message)

    # -- hot-context discovery ---------------------------------------------

    def hot_context(self, node: ast.AST) -> Optional[HotInfo]:
        """The HotInfo whose body `node` sits in, walking out through
        nested defs — an inner helper of a hot function runs once per
        dispatch too."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if cur in self.hot:
                return self.hot[cur]
            cur = self.parents.get(cur)
        return None

    def _find_hot(self) -> None:
        if "parallel/" in self.rel:
            plane = "parallel"
        elif "ops/" in self.rel:
            plane = "ops"
        else:
            return
        for node in self.nodes:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            outer = [f.name for f in self._outer_functions(node)]
            if plane == "ops":
                hot = (node.name.startswith("step_n")
                       or node.name in OPS_LAUNCHERS)
            elif outer:
                hot = (node.name in HOT_CLOSURES
                       and not DISPATCH_WRAPPERS.intersection(outer))
            else:
                hot = node.name in HOT_FUNCTIONS
            if hot:
                self.hot[node] = HotInfo(node, self.qualname(node), plane)

    def _outer_functions(self, node: ast.AST) -> List[ast.AST]:
        out = []
        cur = self.enclosing_function(node)
        while cur is not None:
            out.append(cur)
            cur = self.enclosing_function(cur)
        return [f for f in out if not isinstance(f, ast.Lambda)]


def _tail_name(node: ast.AST) -> Optional[str]:
    """'torch.compile' -> 'compile', 'load' -> 'load', anything else ->
    None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


#: Tensor attributes and methods that read METADATA kept on the host —
#: reading (or branching on) them never waits for the card.
STATIC_ATTRS = {"dtype", "shape", "ndim", "size", "dim", "numel", "device",
                "is_cuda", "layout", "is_contiguous", "data_ptr", "stride",
                "storage_offset", "element_size", "itemsize", "nbytes"}
#: Builtins whose result depends only on a tensor's identity, type or
#: length — never on a value held on the card.
_IDENTITY_CALLS = {"isinstance", "len", "type", "id", "callable", "hasattr"}


def tensor_params(info: HotInfo) -> Set[str]:
    """Parameter names of a hot function that hold tensors: everything
    not in STATIC_PARAMS."""
    args = info.node.args
    names = {a.arg for a in [*args.posonlyargs, *args.args,
                             *args.kwonlyargs]}
    return names - STATIC_PARAMS


def dynamic_names(expr: ast.AST) -> Set[str]:
    """Names mentioned in `expr` as a VALUE on the card: not as the base
    of a metadata read (`w.shape[0]`, `p.device.type`), not as an
    operand of an identity test (`out is None`), and not as an argument
    of `isinstance` / `len` and the like. `w + 1` and `w > 0` mention
    `w`. The shared vocabulary of the host-sync and tracer-branch
    checks — both must agree on what reads the card."""
    exempt = set()
    for node in ast.walk(expr):
        bases = []
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            bases = [node.value]
        elif isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            bases = [node.left, *node.comparators]
        elif isinstance(node, ast.Call) \
                and _tail_name(node.func) in _IDENTITY_CALLS:
            bases = list(node.args)
        for base in bases:
            for sub in ast.walk(base):
                if isinstance(sub, ast.Name):
                    exempt.add(sub)
    return {
        n.id for n in ast.walk(expr)
        if isinstance(n, ast.Name) and n not in exempt
    }


# -- allowlist ------------------------------------------------------------


class AllowlistError(ValueError):
    pass


@dataclasses.dataclass
class AllowEntry:
    check: str
    path: str
    scope: str
    reason: str
    lineno: int  # in the allowlist file, for diagnostics

    @property
    def key(self) -> tuple:
        return (self.check, self.path, self.scope)


class Allowlist:
    """Grandfathered findings, one `check | path | scope | reason` line
    each. Every entry MUST carry a non-empty reason — an allowlist
    entry is a documented engineering decision, not a mute button."""

    def __init__(self, entries: Sequence[AllowEntry] = ()):
        self.entries = list(entries)
        self._by_key = {e.key: e for e in self.entries}

    @classmethod
    def load(cls, path: pathlib.Path) -> "Allowlist":
        entries = []
        for i, raw in enumerate(path.read_text().splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) != 4 or not all(parts):
                raise AllowlistError(
                    f"{path}:{i}: expected 'check | path | scope | reason'"
                    f" with all four fields non-empty, got {raw!r}"
                )
            entries.append(AllowEntry(*parts, lineno=i))
        return cls(entries)

    def allows(self, finding: Finding) -> bool:
        return finding.key in self._by_key

    def stale(self, findings: Iterable[Finding],
              scanned: Optional[Set[str]] = None) -> List[AllowEntry]:
        """Entries matching no current finding — fixed hazards whose
        entry must now be deleted (the shrink-only contract). With
        `scanned` (the rel paths this run actually linted), entries for
        files OUTSIDE the scan are exempt: a partial-tree run can only
        prove staleness for files it looked at."""
        live = {f.key for f in findings}
        return [e for e in self.entries
                if e.key not in live
                and (scanned is None or e.path in scanned)]


# -- file walk (the run loop itself lives in torchlint.py) ----------------

_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".venv"}


def iter_py_files(paths: Sequence[pathlib.Path],
                  root: pathlib.Path) -> Iterator[pathlib.Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    yield f
