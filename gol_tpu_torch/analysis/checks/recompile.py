"""recompile — kernel builds and library loads outside the one cache.

gol_tpu's hazard is the silent recompile: a `jax.jit()` built inside a
loop body, or a static argument whose value differs per call, compiles
again on every iteration. The port has exactly one compile cache:
`ops/_build.py` compiles `csrc/*.cu` with nvcc once per source hash
(`_compile`) and loads the library once per process (`load`). Two
shapes defeat it:

1. a build or load entry anywhere outside `ops/_build.py` —
   `ctypes.CDLL`, `_build._compile`, a `subprocess` call that names
   `nvcc`, `torch.utils.cpp_extension.load` / `load_inline`, or
   `torch.compile` — a second cache (or none) beside the one the
   compile watcher records;
2. any build or load entry (the above, or `_build.load`) called inside
   a loop body: the `jax.jit()`-in-a-loop shape — every iteration
   rebuilds, or re-enters the loader, per slot or per chunk.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "recompile"

_CACHE_MODULE = "ops/_build.py"
_BUILD_MODULE = "gol_tpu_torch.ops._build"
_SUBPROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output"}
_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for that attribute chain, None when the
    chain is rooted at anything but a name (a call, a subscript)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _build_roots(ctx: ModuleContext) -> tuple:
    """(names bound to the `_build` module, names bound to its `load` /
    `_compile` functions) in this module."""
    mods: Set[str] = set()
    funcs: Set[str] = set()
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if f"{node.module}.{a.name}" == _BUILD_MODULE:
                    mods.add(a.asname or a.name)
                elif node.module == _BUILD_MODULE \
                        and a.name in ("load", "_compile"):
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _BUILD_MODULE and a.asname:
                    mods.add(a.asname)
    return mods, funcs


def _names_nvcc(call: ast.Call) -> bool:
    """True when an argument of `call` mentions nvcc, as a string or as
    a variable's name."""
    for arg in [*call.args, *(k.value for k in call.keywords)]:
        for n in ast.walk(arg):
            text = n.value if isinstance(n, ast.Constant) \
                else getattr(n, "id", None)
            if isinstance(text, str) and "nvcc" in text:
                return True
    return False


def _entry(call: ast.Call, mods, funcs) -> Optional[tuple]:
    """(what, outside_cache_rule_applies) when `call` builds or loads a
    kernel library, else None."""
    name = _dotted(call.func) or ""
    parts = name.split(".")
    tail = parts[-1]
    if tail == "CDLL":
        return "ctypes.CDLL", True
    if name == "torch.compile":
        return "torch.compile", True
    if tail in ("load", "load_inline") and "cpp_extension" in parts:
        return f"cpp_extension.{tail}", True
    if parts[0] == "subprocess" and tail in _SUBPROCESS_CALLS \
            and _names_nvcc(call):
        return "an nvcc subprocess", True
    if len(parts) == 2 and parts[0] in mods \
            and tail in ("load", "_compile"):
        return f"_build.{tail}", tail == "_compile"
    if len(parts) == 1 and tail in funcs:
        return f"_build.{tail}", tail == "_compile"
    return None


def _in_loop(ctx: ModuleContext, node: ast.AST) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        if isinstance(cur, _LOOPS):
            return True
        cur = ctx.parents.get(cur)
    return False


def run(ctx: ModuleContext) -> Iterator[Finding]:
    mods, funcs = _build_roots(ctx)
    in_cache = ctx.rel.endswith(_CACHE_MODULE)
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        hit = _entry(node, mods, funcs)
        if hit is None:
            continue
        what, outside_rule = hit
        if _in_loop(ctx, node):
            yield ctx.finding(
                CHECK, node,
                f"{what} called inside a loop builds or loads the kernel "
                "library every iteration — hoist it out (ops/_build.load "
                "caches the library once per process)",
            )
        elif outside_rule and not in_cache:
            yield ctx.finding(
                CHECK, node,
                f"{what} outside ops/_build.py — a second build/load "
                "cache beside the one keyed by the sources' hash; "
                "route the build through _build.load",
            )
