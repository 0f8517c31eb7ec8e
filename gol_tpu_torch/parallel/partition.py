"""Partition-rule tables and the world's placement — the ONE place the
port's device grids and shardings are built.

The counterpart of `gol_tpu.parallel.partition`. The rule tables, their
override grammar (`--partition-rule`), the backend families' defaults,
the layout registry and every error text are gol_tpu's: an ordered table
of ``regex -> spec`` rules, resolved by first match against the logical
NAME of each device array a stepper owns (``world``, ``planes``,
``diffs``, ...), with operator overrides prepended.

torch has no `jax.sharding`, so the placement is this package's own:

- `Mesh`: a ``rows x cols`` grid of `torch.device`s, row-major, over the
  axes ``rows`` (board word-rows) and ``cols`` (word columns). A device
  may appear more than once: ``["cpu"] * 4`` is a 4-shard ring on the
  CPU, ``[cuda:0] * 4`` one on a single card, whose shards then run one
  after another on that card. It is not `torch.distributed`'s
  DeviceMesh, which needs a process group.
- a spec is a tuple of axis names (or None), one per array dimension —
  gol_tpu's PartitionSpec; ``REPLICATED`` is ``()``;
- `Sharding` (a mesh and a spec) splits a global array into the mesh
  cells' blocks and gathers them back;
- `Sharded` is a world so placed: one tensor per mesh cell, each on its
  cell's device, plus the global (padded) shape. It is the state the
  ring and mesh steppers' entries take and return.

Across processes (`parallel/multihost.py`): a device list of
`JobDevice`s — every process's devices in rank order, each with its
owner — makes a mesh of a multi-process job. A `Sharded` then holds
tensors only for the cells its process owns (None for the others), and
the seams that reach another cell go through the job: `move` (a
neighbour's ghost slab; cross-process slabs are staged through the host
and sent over gloo), `Sharding.gather` (an all-gather: every process
gets the whole array, `spmd_fetch`'s contract), `Sharded.equal` (an
all-reduce of the local verdicts) and the count (`halo.ring_sum`, an
all-reduce). Every process calls them together, in the same order.

Layouts: a ``layout=NAME`` override selects a KERNEL layout rather than
a sharding. ``lane-coupled`` (`gol_tpu_torch/ops/lanes.py`) registers on
import, as in gol_tpu.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

#: Mesh axis names — the only two the steppers ever use.
AXIS_ROWS = "rows"
AXIS_COLS = "cols"

#: The replicated spec.
REPLICATED: Tuple = ()


class PartitionError(ValueError):
    """A partition request the table cannot satisfy — an unresolvable
    array name, a rank mismatch, or a malformed mesh/override string."""


def spec(*axes) -> tuple:
    """A spec: one mesh axis name (or None, replicated) per array
    dimension; trailing dimensions not named replicate."""
    return tuple(axes)


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"ROWSxCOLS"`` -> ``(rows, cols)``; both positive ints."""
    m = re.fullmatch(r"(\d+)[xX](\d+)", text.strip())
    if not m:
        raise PartitionError(
            f"mesh spec {text!r} is not ROWSxCOLS (e.g. 2x4)"
        )
    rows, cols = int(m.group(1)), int(m.group(2))
    if rows < 1 or cols < 1:
        raise PartitionError(f"mesh {rows}x{cols} has an empty axis")
    return rows, cols


@dataclasses.dataclass(frozen=True)
class JobDevice:
    """One entry of a multi-process job's device list: a device and the
    rank of the process that owns it (`multihost.global_devices`)."""

    device: torch.device
    rank: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``rows x cols`` grid of torch devices, row-major: cell (r, c) is
    ``devices[r * cols + c]``. Ring neighbours along ``rows`` are cells
    (r ± 1) mod rows, along ``cols`` (c ± 1) mod cols. In a multi-process
    job `owners` names each cell's rank and `job` is the job
    (`multihost.Job`); both None when this process owns every cell."""

    devices: tuple
    rows: int
    cols: int = 1
    owners: Optional[tuple] = None
    job: Optional[object] = dataclasses.field(default=None, compare=False)

    def device(self, r: int, c: int = 0) -> torch.device:
        return self.devices[r * self.cols + c]

    def owns(self, i: int) -> bool:
        """True when this process holds cell i's tensors."""
        return self.owners is None or self.owners[i] == self.job.rank

    @property
    def home(self) -> torch.device:
        """Where results of the whole mesh land in this process: its
        first own cell's device."""
        return next(d for i, d in enumerate(self.devices) if self.owns(i))


def _placed(devices: Sequence, rows: int, cols: int) -> Mesh:
    """The mesh of `devices`: torch devices (or their names), or a
    multi-process job's `JobDevice`s."""
    if any(isinstance(d, JobDevice) for d in devices):
        from gol_tpu_torch.parallel import multihost

        job = multihost.job()
        owners = tuple(d.rank for d in devices)
        if job.rank not in owners:
            raise PartitionError(
                f"mesh {rows}x{cols} gives process {job.rank} no cell — "
                "every process of the job must own at least one shard"
            )
        return Mesh(tuple(d.device for d in devices), rows, cols, owners,
                    job)
    return Mesh(tuple(torch.device(d) for d in devices), rows, cols)


def ring_mesh(devices: Sequence) -> Mesh:
    """The 1-D row ring over `devices` in order: an ``n x 1`` mesh."""
    return _placed(devices, len(devices), 1)


def mesh2d(devices: Sequence, rows: int, cols: int) -> Mesh:
    """A ``rows x cols`` device mesh, row-major over `devices`."""
    if rows * cols != len(devices):
        raise PartitionError(
            f"mesh {rows}x{cols} needs {rows * cols} devices, "
            f"got {len(devices)}"
        )
    return _placed(devices, rows, cols)


def move(mesh: Mesh, parts: Sequence, routes: Sequence) -> list:
    """Ghost slabs between cells: for each route ``(src, dst, take)``
    the slab ``take(parts[src])`` on cell dst's device (None where this
    process does not own dst). Within a process a slab is a `.to` of a
    slice; across processes the job stages it through the host and
    sends it over gloo (`multihost.Job.move`)."""
    if mesh.job is None:
        return [take(parts[src]).to(mesh.devices[dst])
                for src, dst, take in routes]
    return mesh.job.move(mesh, parts, routes)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a global array lies on a mesh: dimension d is split into
    equal blocks along mesh axis ``spec[d]`` (None, or past the spec's
    length: whole on every cell)."""

    mesh: Mesh
    spec: tuple

    def index(self, shape: Sequence[int], r: int, c: int = 0) -> tuple:
        """The index of mesh cell (r, c)'s block in a global array of
        `shape`."""
        idx = []
        for d, size in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            if axis is None:
                idx.append(slice(None))
                continue
            n, i = ((self.mesh.rows, r) if axis == AXIS_ROWS
                    else (self.mesh.cols, c))
            if size % n:
                raise PartitionError(
                    f"dimension {d} of size {size} does not split into "
                    f"{n} equal blocks along {axis!r}"
                )
            b = size // n
            idx.append(slice(i * b, (i + 1) * b))
        return tuple(idx)

    def cells(self):
        return [(r, c) for r in range(self.mesh.rows)
                for c in range(self.mesh.cols)]

    def place(self, host: np.ndarray) -> "Sharded":
        """A host array (the global, padded layout) -> its blocks on the
        mesh's devices. int32 tensors hold uint32 words bit for bit."""
        host = np.ascontiguousarray(host)
        if host.dtype == np.uint32:
            host = host.view(np.int32)
        parts = tuple(
            torch.from_numpy(np.array(
                host[self.index(host.shape, r, c)])).to(
                    self.mesh.device(r, c))
            if self.mesh.owns(i) else None
            for i, (r, c) in enumerate(self.cells()))
        return Sharded(parts, self, tuple(host.shape))

    def gather(self, parts: Sequence[torch.Tensor], shape: Sequence[int],
               device=None) -> torch.Tensor:
        """The blocks back as one global tensor on `device` (the mesh's
        home device by default); in a multi-process job every process
        gets the whole array (an all-gather)."""
        if self.mesh.job is not None:
            parts = self.mesh.job.allgather_parts(self.mesh, parts)
        dev = self.mesh.home if device is None else device
        out = torch.empty(tuple(shape), dtype=parts[0].dtype, device=dev)
        for (r, c), part in zip(self.cells(), parts):
            out[self.index(shape, r, c)] = part.to(dev)
        return out


def named_sharding(mesh: Mesh, axes: tuple) -> Sharding:
    """``Sharding`` constructor for the parallel layer, monopolized here
    (the partition-spec lint flags construction anywhere else), as
    gol_tpu's ``partition.named_sharding``."""
    return Sharding(mesh, tuple(axes))


class Sharded:
    """A world placed on a mesh: `parts[r * cols + c]` is mesh cell
    (r, c)'s block, on that cell's device; `shape` is the global layout
    (padding included, as gol_tpu's global array holds it). Steppers
    make a new one every dispatch and never write one in place."""

    def __init__(self, parts, sharding: Sharding, shape: tuple):
        self.parts = tuple(parts)
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def local(self) -> list:
        """The tensors this process holds (every part in one process)."""
        return [p for p in self.parts if p is not None]

    @property
    def dtype(self):
        return self.local[0].dtype

    @property
    def device(self) -> torch.device:
        return self.local[0].device

    def replace(self, parts) -> "Sharded":
        """A world of the same placement holding `parts`."""
        return Sharded(parts, self.sharding, self.shape)

    def gather(self, device=None) -> torch.Tensor:
        return self.sharding.gather(self.parts, self.shape, device)

    def numpy(self) -> np.ndarray:
        """The global array on the host (uint32 for packed words)."""
        host = self.gather(torch.device("cpu")).numpy()
        return host.view(np.uint32) if host.dtype == np.int32 else host

    def equal(self, other) -> bool:
        """Exact equality, part by part on the parts' devices (one scalar
        a part comes back) — `torch.equal`'s contract; in a
        multi-process job every process's verdict is all-reduced."""
        same = (isinstance(other, Sharded) and other.shape == self.shape
                and all(torch.equal(a, b)
                        for a, b in zip(self.parts, other.parts)
                        if a is not None))
        job = self.sharding.mesh.job
        return same if job is None else job.all_true(same)


# --- rule tables ---------------------------------------------------------

_AXIS_TOKENS = {
    "rows": AXIS_ROWS,
    "cols": AXIS_COLS,
    "*": None,
    ".": None,
    "none": None,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One ordered table entry: arrays whose name matches `pattern`
    (``re.search``) shard as ``spec(*axes)``. ``axes=()`` is replicated."""

    pattern: str
    axes: Tuple[Optional[str], ...]

    def __post_init__(self):
        re.compile(self.pattern)  # fail fast on a bad regex
        for a in self.axes:
            if a not in (None, AXIS_ROWS, AXIS_COLS):
                raise PartitionError(
                    f"rule {self.pattern!r}: unknown mesh axis {a!r}"
                )


class RuleTable:
    """Ordered first-match resolver from array names to specs (gol_tpu's
    RuleTable): ``resolve(name, ndim=...)`` returns the FIRST matching
    rule's spec; no match raises PartitionError, and so does a spec
    longer than the array's rank."""

    def __init__(self, rules: Iterable[Rule], name: str = "custom",
                 layout: Optional[str] = None):
        self.rules = tuple(rules)
        self.name = name
        #: Kernel layout selected by a ``layout=NAME`` override, if any.
        self.layout = layout

    def resolve(self, array: str, ndim: Optional[int] = None) -> tuple:
        for rule in self.rules:
            if re.search(rule.pattern, array):
                if ndim is not None and len(rule.axes) > ndim:
                    raise PartitionError(
                        f"table {self.name!r}: rule {rule.pattern!r} "
                        f"spec {rule.axes} has rank {len(rule.axes)} "
                        f"but array {array!r} has rank {ndim}"
                    )
                return spec(*rule.axes)
        raise PartitionError(
            f"table {self.name!r} resolves no rule for array "
            f"{array!r} — add a rule or an override"
        )

    def sharding(self, mesh: Mesh, array: str,
                 ndim: Optional[int] = None) -> Sharding:
        return Sharding(mesh, self.resolve(array, ndim))

    def with_overrides(self, overrides) -> "RuleTable":
        """A new table with operator `overrides` PREPENDED (first match
        wins). `overrides` is an override string (see `parse_overrides`)
        or parsed rules."""
        if overrides is None:
            return self
        layout = self.layout
        if isinstance(overrides, str):
            rules, layout_over = parse_overrides(overrides)
            layout = layout_over or layout
        else:
            rules = tuple(overrides)
        return RuleTable(rules + self.rules, name=self.name,
                         layout=layout)


def parse_overrides(text: str) -> Tuple[Tuple[Rule, ...], Optional[str]]:
    """Parse a CLI override string into ``(rules, layout)``.

    Grammar: ``entry(;entry)*`` where an entry is ``PATTERN=AXES`` —
    AXES a comma list of ``rows``/``cols``/``*`` (``*`` = replicate
    that dim), or ``-`` for fully replicated — or the special
    ``layout=NAME`` selecting a registered kernel layout:

        --partition-rule 'world=rows,cols;sparse_rows=-'
        --partition-rule 'layout=lane-coupled'
    """
    rules = []
    layout = None
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise PartitionError(
                f"override {entry!r} is not PATTERN=AXES (or "
                f"layout=NAME)"
            )
        pattern, _, axes_text = entry.partition("=")
        pattern, axes_text = pattern.strip(), axes_text.strip()
        if pattern == "layout":
            get_layout(axes_text)  # unknown layout fails at parse time
            layout = axes_text
            continue
        if axes_text in ("-", ""):
            axes: Tuple[Optional[str], ...] = ()
        else:
            axes_list = []
            for tok in axes_text.split(","):
                tok = tok.strip().lower()
                if tok not in _AXIS_TOKENS:
                    raise PartitionError(
                        f"override {entry!r}: unknown axis {tok!r} "
                        f"(want rows, cols or *)"
                    )
                axes_list.append(_AXIS_TOKENS[tok])
            axes = tuple(axes_list)
        try:
            rules.append(Rule(pattern, axes))
        except re.error as e:
            raise PartitionError(
                f"override {entry!r}: bad pattern ({e})"
            ) from None
    return tuple(rules), layout


#: Shared tail every family ends with: scalar/housekeeping arrays are
#: replicated unless a family (or operator) says otherwise.
_COMMON_TAIL = (
    Rule(r"^(count|mask|sparse_rows|compact_headers|compact_values)$", ()),
    Rule(r"^stack$", ()),
)

#: Default rule tables by backend family — gol_tpu's, entry for entry.
_DEFAULTS: Dict[str, Tuple[Rule, ...]] = {
    "dense_ring": (
        Rule(r"^world$", (AXIS_ROWS,)),
        Rule(r"^diffs$", (None, AXIS_ROWS)),
    ) + _COMMON_TAIL,
    "packed_ring": (
        Rule(r"^world$", (AXIS_ROWS, None)),
        Rule(r"^diffs$", (None, AXIS_ROWS, None)),
    ) + _COMMON_TAIL,
    "gens_ring": (
        Rule(r"^world$", (AXIS_ROWS,)),
        Rule(r"^diffs$", (None, AXIS_ROWS)),
    ) + _COMMON_TAIL,
    # Generations planes (C-1, H/32, W): the plane axis never shards.
    "gens_packed_ring": (
        Rule(r"^(world|planes)$", (None, AXIS_ROWS, None)),
        Rule(r"^diffs$", (None, AXIS_ROWS, None)),
    ) + _COMMON_TAIL,
    "packed_mesh2d": (
        Rule(r"^world$", (AXIS_ROWS, AXIS_COLS)),
        Rule(r"^diffs$", (None, AXIS_ROWS, AXIS_COLS)),
    ) + _COMMON_TAIL,
    "gens_mesh2d": (
        Rule(r"^(world|planes)$", (None, AXIS_ROWS, AXIS_COLS)),
        Rule(r"^diffs$", (None, AXIS_ROWS, AXIS_COLS)),
    ) + _COMMON_TAIL,
    "single": _COMMON_TAIL + (Rule(r"", ()),),
}


def table_for(family: str, overrides: Optional[str] = None) -> RuleTable:
    """The default rule table of a backend `family`, with operator
    `overrides` (CLI string) prepended when given."""
    if family not in _DEFAULTS:
        raise PartitionError(
            f"unknown backend family {family!r} "
            f"(have {sorted(_DEFAULTS)})"
        )
    table = RuleTable(_DEFAULTS[family], name=family)
    return table.with_overrides(overrides)


# --- kernel layouts ------------------------------------------------------

#: name -> factory(rule, **kw) -> ``(packed, n) -> packed`` multi-turn
#: function. Selected by a ``layout=NAME`` partition override; consumed
#: by the single-device packed constructor (stepper._single_device_packed).
LAYOUTS: Dict[str, Callable] = {}


def register_layout(name: str, factory: Callable) -> None:
    LAYOUTS[name] = factory


def get_layout(name: str) -> Callable:
    try:
        return LAYOUTS[name]
    except KeyError:
        raise PartitionError(
            f"unknown layout {name!r} (have {sorted(LAYOUTS)})"
        ) from None


from gol_tpu_torch.ops import lanes as _lanes  # noqa: E402

register_layout("lane-coupled", _lanes.make_lane_coupled)
