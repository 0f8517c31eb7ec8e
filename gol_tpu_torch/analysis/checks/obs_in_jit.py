"""obs-in-jit — metrics/span/flight calls inside the per-launch wrappers.

The gol_tpu_torch.obs contract, gol_tpu's: instrumentation is
HOST-SIDE, at dispatch/event granularity. gol_tpu's hazard is a metric
call under trace, baked into the compiled program as a once-per-compile
no-op. The port has no trace, so the same call runs — once per kernel
LAUNCH instead of once per dispatch: a ring's deep block is a launch a
shard, a tiled pass a launch a strip, so a counter or span in a kernel
wrapper costs registry locks and allocations on the path the kernels'
microseconds are measured on, and counts launches where the metrics
speak of dispatches. Instrumentation belongs in the stepper's obs
wrapper (`parallel/stepper.instrument_stepper`), once a dispatch; the
kernels' own launch counts are the `LAUNCHES` dicts, plain ints.

Flagged: any call that reaches the registry, the tracer, the flight
recorder, the device plane or the ledger — through the `obs` module
object, a name imported from any gol_tpu_torch.obs module, or a
module-level handle assigned from one — inside the `ops/` part of the
hot context (`core`: the kernel wrappers and plain steps). The check
keeps gol_tpu's name so that reports and allowlist keys line up.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "obs-in-jit"

#: The observability plane's modules — a name imported FROM any of
#: these (or binding one) becomes a tainted root, so calls through it
#: in a hot wrapper are flagged; plain `.inc()` on an unrelated object
#: never fires.
_OBS_MODULES = (
    "gol_tpu_torch.obs",
    "gol_tpu_torch.obs.registry",
    "gol_tpu_torch.obs.http",
    "gol_tpu_torch.obs.tracing",
    "gol_tpu_torch.obs.flight",
    "gol_tpu_torch.obs.device",
    "gol_tpu_torch.obs.console",
    "gol_tpu_torch.obs.accounting",
)


def _target_roots(tgt: ast.AST) -> Iterator[str]:
    """Root names an assignment target binds/mutates: `x` -> x,
    `x[k] = ...` / `x.attr = ...` -> x, tuple targets recurse. `self`/
    `cls` attribute targets are EXCLUDED — an instance holding a metric
    handle is handled at class granularity (see _obs_bound_names), and
    tainting the literal name 'self' would flag every `self.anything()`
    call in the module's hot methods."""
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
        root = _root_name(tgt)
        if root is not None and root not in ("self", "cls"):
            yield root
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for elt in tgt.elts:
            yield from _target_roots(elt)


def _obs_bound_names(ctx: ModuleContext) -> Set[str]:
    """Names this module binds to gol_tpu_torch.obs or to things derived
    from it: the module alias itself, `from gol_tpu_torch.obs import X`
    names, classes whose bodies touch an obs root (handle containers —
    their constructors and instances carry metric handles), and
    assignment targets whose value expression is rooted at any of those
    (`_M = obs.counter(...)`, `_METRICS = _EngineMetrics()`, dict-fills
    of handles)."""
    roots: Set[str] = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in _OBS_MODULES:
                    # `import gol_tpu_torch.obs` binds `gol_tpu_torch`;
                    # `import gol_tpu_torch.obs as obs` binds the alias.
                    roots.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod in _OBS_MODULES:
                for a in node.names:
                    roots.add(a.asname or a.name)
            elif mod == "gol_tpu_torch":
                for a in node.names:
                    if a.name == "obs":
                        roots.add(a.asname or "obs")
    if not roots:
        return roots
    # Propagate until fixed point: classes whose body touches an obs
    # root become roots themselves (instances are handle containers),
    # and assignment targets inherit rootness from their value.
    changed = True
    while changed:
        changed = False
        for node in ctx.nodes:
            if isinstance(node, ast.ClassDef):
                if node.name not in roots and _mentions(node, roots):
                    roots.add(node.name)
                    changed = True
            elif isinstance(node, ast.Assign):
                if not _mentions(node.value, roots):
                    continue
                for tgt in node.targets:
                    for name in _target_roots(tgt):
                        if name not in roots:
                            roots.add(name)
                            changed = True
    return roots


def _mentions(expr: ast.AST, names: Set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in names for n in ast.walk(expr)
    )


def _root_name(node: ast.AST):
    """Leftmost Name of a dotted/subscripted access chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not any(info.plane == "ops" for info in ctx.hot.values()):
        return
    roots = _obs_bound_names(ctx)
    if not roots:
        return
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        info = ctx.hot_context(node)
        if info is None or info.plane != "ops":
            continue
        root = _root_name(node.func)
        if root in roots:
            yield ctx.finding(
                CHECK, node,
                f"metrics call rooted at obs-bound name '{root}' inside "
                f"the per-launch wrapper '{info.qualname}' — "
                "instrumentation must stay at dispatch granularity (the "
                "stepper's obs wrapper), not once per kernel launch",
            )
