"""tracer-branch — Python control flow on tensor values in hot code.

In gol_tpu an `if`/`while` on a traced argument of a jitted function
raises at trace time. In torch it runs — `if x > 0:` calls
`bool(x > 0)`, an implicit `.item()`: the host waits for the card once
per dispatch, and the branch is taken on a value the host had to fetch.
Flagged: an `if`/`while` in hot context (see `core`) whose condition
mentions a tensor parameter as a value. Data-dependent choices belong
on the card, in `torch.where`; Python branching is legal on the
statics (turn counts, rules, caps) and on host metadata (`x.shape`,
`x.device`, `out is None`), which `dynamic_names` exempts.
"""

from __future__ import annotations

import ast
from typing import Iterator

from gol_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    dynamic_names,
    tensor_params,
)

CHECK = "tracer-branch"


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not ctx.hot:
        return
    for node in ctx.nodes:
        if not isinstance(node, (ast.If, ast.While)):
            continue
        info = ctx.hot_context(node)
        if info is None:
            continue
        hit = sorted(dynamic_names(node.test) & tensor_params(info))
        if hit:
            kind = "if" if isinstance(node, ast.If) else "while"
            yield ctx.finding(
                CHECK, node,
                f"Python '{kind}' on tensor '{hit[0]}' inside hot "
                f"'{info.qualname}' — an implicit bool() host sync on "
                "the card (not a trace error as under jit); keep the "
                "choice on the device with torch.where",
            )
