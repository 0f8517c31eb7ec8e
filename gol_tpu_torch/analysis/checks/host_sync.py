"""host-sync — host-device synchronization on the card's dispatch path.

In gol_tpu a `.item()` or `float()` of a traced value inside a jitted
function fails at trace time or forces a device round trip. Here no
trace exists, but the cost is the same: CUDA launches return before
the card finishes, and a host read of a device value waits for every
launch queued before it — once per dispatch when it sits in a hot
function (`core` names them: the multi-turn stepper entries, the ring
block, the kernel wrappers and plain steps). Flagged in hot context:
`.item()`, `.tolist()`, `.cpu()`, `.numpy()`; `int()` / `float()` /
`bool()` of a tensor parameter's value (`int(w.shape[0])` reads host
metadata and is free); `np.asarray` / `np.array` /
`np.ascontiguousarray` of a tensor parameter.

The `block_until_ready` counterpart is flagged anywhere outside bench
code: `torch.cuda.synchronize()` and `<stream or event>.synchronize()`
drain the queue and serialize the dispatch pipeline, which is only
ever intentional (and then allowlisted with the reason).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from gol_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    dynamic_names,
    tensor_params,
)

CHECK = "host-sync"

#: Tensor methods that copy a device value to the host (and wait for it).
_READBACKS = {"item", "tolist", "cpu", "numpy"}
#: numpy-namespace calls that materialize a host array from their arg.
_HOST_MATERIALIZERS = {"asarray", "array", "ascontiguousarray"}
#: Python builtins that force a scalar read-back of a device value.
_SCALARIZERS = {"float", "int", "bool"}
#: Paths where blocking on the device is the point, not a hazard.
_BENCH_PATH_TOKENS = ("bench", "scripts/", "tests/", "__graft_entry__")


def _numpy_roots(ctx: ModuleContext) -> Set[str]:
    """Names the module binds to the real numpy ('np', 'numpy', ...)."""
    roots = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    roots.add(a.asname or "numpy")
    return roots or {"np", "numpy", "_np"}


def run(ctx: ModuleContext) -> Iterator[Finding]:
    numpy_roots = _numpy_roots(ctx) if ctx.hot else set()
    bench_path = any(tok in ctx.rel for tok in _BENCH_PATH_TOKENS)
    for node in ctx.nodes:
        # synchronize outside bench code — module-wide, hot or not (on
        # the host side it stalls the dispatch pipeline).
        if (not bench_path and isinstance(node, ast.Attribute)
                and node.attr == "synchronize"):
            yield ctx.finding(
                CHECK, node,
                "synchronize() outside bench code waits for every queued "
                "launch and serializes the dispatch pipeline (allowlist "
                "only with the reason it is intentional)",
            )
            continue
        if not isinstance(node, ast.Call):
            continue
        info = ctx.hot_context(node)
        if info is None:
            continue
        tensors = tensor_params(info)
        callee = node.func
        # x.item() / .tolist() / .cpu() / .numpy(): a device-to-host copy.
        if isinstance(callee, ast.Attribute) and callee.attr in _READBACKS:
            yield ctx.finding(
                CHECK, node,
                f".{callee.attr}() inside hot '{info.qualname}' copies a "
                "device value to the host and waits for the card once "
                "per dispatch",
            )
        # np.asarray(x) & friends of a tensor parameter.
        elif isinstance(callee, ast.Attribute) \
                and callee.attr in _HOST_MATERIALIZERS \
                and isinstance(callee.value, ast.Name) \
                and callee.value.id in numpy_roots:
            hit = (dynamic_names(node.args[0]) & tensors if node.args
                   else set())
            if hit:
                yield ctx.finding(
                    CHECK, node,
                    f"np.{callee.attr}() of tensor '{sorted(hit)[0]}' "
                    f"inside hot '{info.qualname}' materializes a host "
                    "array from a device value",
                )
        # float(x)/int(x)/bool(x) where x mentions a tensor param as a
        # VALUE — int(w.shape[0]) reads host metadata and is free, which
        # dynamic_names exempts (same vocabulary as tracer-branch).
        elif isinstance(callee, ast.Name) and callee.id in _SCALARIZERS \
                and node.args:
            hit = dynamic_names(node.args[0]) & tensors
            if hit:
                yield ctx.finding(
                    CHECK, node,
                    f"{callee.id}() of tensor '{sorted(hit)[0]}' inside "
                    f"'{info.qualname}' forces a host scalar read-back",
                )
