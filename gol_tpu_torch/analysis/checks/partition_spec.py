"""partition-spec — placement construction outside the partition table.

gol_tpu moved every ``Mesh``/``NamedSharding``/``PartitionSpec``
construction in its parallel layer into ``parallel/partition.py``; the
port keeps that monopoly over its own placement types. The ordered rule
table is the ONE place device placement is decided, so an operator
override (``--partition-rule``) provably reaches every array a stepper
owns. A backend that quietly builds its own mesh or sharding re-opens
the hole: its arrays stop being overridable and the 1-D-ring
hard-coding creeps back in.

Flagged, in ``gol_tpu_torch/parallel`` modules other than
``partition.py``:

- any call spelled ``Mesh(...)``, ``Sharding(...)`` or ``spec(...)``,
  bare or dotted — construction, not the mere type mention
  (annotations and docstrings stay legal). Backends get their meshes
  from ``partition.ring_mesh`` / ``partition.mesh2d`` and their
  shardings from ``partition.table_for(...).resolve`` / ``.sharding``
  or ``partition.named_sharding``;
- any import of torch's own placement types (``torch.distributed``'s
  ``device_mesh`` / ``tensor``, gol_tpu's ``jax.sharding``), which
  would be a second placement vocabulary beside the table's.

Strict, as in gol_tpu: the check carries no allowlist entries and none
may be added for new code — a site it flags is routed through
``partition.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "partition-spec"

_CONSTRUCTORS = {"Mesh", "Sharding", "spec"}
_FOREIGN_PLACEMENT = ("torch.distributed.device_mesh",
                      "torch.distributed.tensor",
                      "torch.distributed._tensor")


def _in_scope(ctx: ModuleContext) -> bool:
    return ("parallel/" in ctx.rel
            and not ctx.rel.endswith("parallel/partition.py"))


def _foreign(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in _FOREIGN_PLACEMENT)


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not _in_scope(ctx):
        return
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom):
            if node.module and _foreign(node.module):
                yield ctx.finding(
                    CHECK, node,
                    f"import from {node.module} outside partition.py — "
                    "resolve placements through partition.table_for so "
                    "operator overrides reach this array",
                )
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _foreign(alias.name):
                    yield ctx.finding(
                        CHECK, node,
                        f"import of {alias.name} outside partition.py — "
                        "the partition table is the one placement "
                        "constructor in the parallel layer",
                    )
        elif isinstance(node, ast.Call):
            fn = node.func
            name = None
            if isinstance(fn, ast.Name):
                name = fn.id
            elif isinstance(fn, ast.Attribute):
                name = fn.attr
            if name in _CONSTRUCTORS:
                yield ctx.finding(
                    CHECK, node,
                    f"direct {name}(...) construction outside "
                    "partition.py — build it through the partition "
                    "table so --partition-rule can override it",
                )
