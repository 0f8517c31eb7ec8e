"""dtype-drift — off-contract dtypes in the kernel plane.

Every kernel family of the port speaks exactly three dtypes: uint8
boards ({0,255} cells / gray levels), int32 packed words, counts and
diff rows (bit-identical to gol_tpu's uint32 words — the port's CUDA
kernels and torch's shifts work on int32, `bitlife.lsr` shifts right
logically), and bool masks. The packed and dense families stay
bit-exact against each other and against gol_tpu precisely because
nothing ever routes through a float or a differently-sized integer —
a float32 neighbour sum or an int64 index sneaking into
`ops/bitlife.py` or `parallel/packed_halo.py` is drift between the
families even when it happens to round-trip.

The check walks dtype references (`torch.float32`, `torch.long`,
`dtype="float64"`, `.astype('int16')`, `x.double()`) in kernel modules
— selected by filename stem, gol_tpu's selection (`cuda_bitlife`,
`cuda_life` and the rest match it), so the families cannot drift by
adding a new kernel file either — and flags any dtype outside the
contract set.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterator

from gol_tpu_torch.analysis.core import Finding, ModuleContext

CHECK = "dtype-drift"

#: The kernel plane's entire dtype vocabulary (see module docstring);
#: `bool_` is numpy's spelling of bool.
KERNEL_DTYPES = {"uint8", "int32", "bool_", "bool"}

#: Dtype tokens worth flagging when seen outside the contract set, and
#: torch's aliases (`torch.long`, `x.double()`) by the dtype they name.
_ALL_DTYPES = {
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float16", "float32", "float64", "bfloat16",
    "complex64", "complex128", "bool_", "bool",
}
_ALIASES = {"long": "int64", "short": "int16", "half": "float16",
            "float": "float32",
            "double": "float64", "cfloat": "complex64",
            "cdouble": "complex128"}

#: Kernel modules by filename stem: the ops/ families and the ring
#: steppers. (multihost/board/wire host plumbing legitimately uses
#: int64 and is not kernel code.)
_KERNEL_STEM = re.compile(
    r"(^|_)(bit\w*|pallas\w*|halo|life|gens|generations|stepper)$"
)


def is_kernel_module(rel: str) -> bool:
    return bool(_KERNEL_STEM.search(pathlib.PurePosixPath(rel).stem))


def run(ctx: ModuleContext) -> Iterator[Finding]:
    if not is_kernel_module(ctx.rel):
        return
    for node in ctx.nodes:
        token = None
        if isinstance(node, ast.Attribute):
            if node.attr in _ALL_DTYPES:
                token = node.attr
            elif node.attr in _ALIASES:
                token = _ALIASES[node.attr]
        elif isinstance(node, ast.Call):
            # dtype="float32" kwarg / .astype("float32") string form.
            cands = [k.value for k in node.keywords if k.arg == "dtype"]
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("astype", "view")):
                cands.extend(node.args[:1])
            for c in cands:
                if isinstance(c, ast.Constant) and c.value in _ALL_DTYPES:
                    token = c.value
        if token is not None and token not in KERNEL_DTYPES:
            yield ctx.finding(
                CHECK, node,
                f"dtype '{token}' in kernel module — the packed/dense "
                f"kernel contract is exactly "
                f"{sorted(KERNEL_DTYPES - {'bool_'})}",
            )
