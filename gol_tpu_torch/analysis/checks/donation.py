"""donation — carried world state without an explicit donation decision.

gol_tpu's ring steppers hand back a fresh array every dispatch, and
jit keeps input and output both live unless the input is donated. The
port has the same choice in torch's form: a multi-turn stepper entry
either writes its result into its input (in place, an `out=` argument,
or `.copy_` into the carry), so one board-sized buffer serves the
dispatch, or it returns fresh tensors and the input stays live until
its last reference drops. Writing in place is not free either: the
engine retains references to dispatched worlds (the committed (turn,
world) pair served to BoardSync/snapshot fetches, cycle-detector
anchors, the sparse-overflow redo input), and overwriting a world
something still reads corrupts it. So the check does not demand
in-place stepping — it demands the decision be EXPLICIT: every
multi-turn stepper entry over a carried world either writes into its
carry or carries an allowlist entry saying why not.

Flagged: hot functions in `parallel/` modules (the stepper entries of
`core`'s table) with a multi-turn parameter (k/n) whose first parameter
is a recognized carry name and whose body never writes into it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from gol_tpu_torch.analysis.core import STATIC_PARAMS, Finding, ModuleContext

CHECK = "donation"

#: First-parameter spellings of carried device state in this codebase.
_CARRY_NAMES = {"world", "state", "p", "q", "w", "planes", "block"}
_MULTI_TURN_STATICS = {"k", "n"}


def _root(node: ast.AST):
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _writes_carry(fn: ast.AST, carry: str) -> bool:
    """True when `fn`'s body stores into `carry`: an in-place method
    (`carry.copy_(...)`, `carry[...].add_(...)`), an `out=carry`
    argument, or an item store `carry[...] = ...`."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr.endswith("_") \
                    and not f.attr.startswith("_") \
                    and _root(f.value) == carry:
                return True
            if any(k.arg == "out" and _root(k.value) == carry
                   for k in node.keywords):
                return True
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Subscript) and _root(t) == carry
                   for t in targets):
                return True
    return False


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if "parallel/" not in ctx.rel:
        return
    for node, info in ctx.hot.items():
        params = [a.arg for a in node.args.args]
        if not set(params) & _MULTI_TURN_STATICS:
            continue  # single-turn helpers: both buffers are transient
        if not params or params[0] not in _CARRY_NAMES:
            continue
        if params[0] in STATIC_PARAMS:
            continue
        if _writes_carry(node, params[0]):
            continue
        yield ctx.finding(
            CHECK, node,
            f"multi-turn stepper '{info.qualname}' carries world state "
            f"'{params[0]}' and returns fresh tensors — write the result "
            "into the carry (in place, out=, .copy_), or allowlist with "
            "the reason the input must stay live",
        )
