"""Multi-process jobs — the counterpart of `gol_tpu.parallel.multihost`,
over `torch.distributed` with the gloo backend.

Topology, as in gol_tpu: the **data plane** is one ring or mesh of
shards over every process's devices, each process stepping the shards
it owns with the kernels of its own devices; the **control plane** —
the engine, its server, IO and the event stream — runs on the
coordinator (rank 0) only, and every other process replays the
coordinator's dispatches (`spmd_worker_loop`), so all of them enter
each exchange together.

gol_tpu's processes run one SPMD program over a global array and XLA
inserts the halo `ppermute`s; here a world is a `partition.Sharded` (a
tensor per shard, only the own shards' in each process) and the ring
layer's seams reach other processes through the `Job`:

- **ghost slabs** (`Job.move`, behind `halo.edge_exchange` and
  `mesh2d._extend`): a slab that crosses processes goes device → host
  (a synchronous copy, which also waits for the kernel that wrote it)
  → gloo → host → device. One exchange posts ALL its sends and
  receives at once with `torch.distributed.batch_isend_irecv` (each
  slab its own tag) and then waits for them, so a ring of blocking
  sends cannot deadlock;
- **the count** (`halo.ring_sum`): an all-reduce of the processes'
  sums;
- **a fetch** (`Sharding.gather`, `spmd_fetch`): an all-gather that
  gives every process the whole array;
- **equality** (`Sharded.equal`): an all-reduce of the verdicts.

Why gloo: NCCL puts no two ranks on one device, and a job may well
run several processes on one card (each in its own CUDA context).
Gloo's point-to-point operations take CPU tensors, hence the host
staging. A NCCL path for ranks on distinct cards is future work; no
code tries NCCL.

Job membership (`initialize`): the coordinator's ``HOST:PORT``, the
process count and this process's id come from the arguments (the CLI's
``--mh-coordinator`` / ``--mh-procs`` / ``--mh-id``), else from
torchrun's ``MASTER_ADDR`` + ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``; with none set it is a no-op. Each process's devices default
to `stepper.resolve_devices(device)` — every CUDA card, or the CPU
when the caller asks for it — and `local_devices` gives a process
several shards (``["cpu"] * 4``, ``[cuda:0] * 2``). The global device
list (`global_devices`) is every process's devices in rank order, each
a `partition.JobDevice` naming its owner.

A worker whose coordinator dies stops: gloo fails the pending
operation on the closed connection, and `spmd_worker_loop` raises
`JobError`. The process group's timeout (`TIMEOUT_S`) bounds every
other wait (a hung peer); a coordinator idle for longer than it (a
paused engine) ends its workers the same way.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gol_tpu_torch import obs
from gol_tpu_torch.obs import device as obs_device
from gol_tpu_torch.parallel.partition import JobDevice
from gol_tpu_torch.parallel.stepper import ENTRY_TABLE

#: Seconds any collective or exchange may wait for its peers.
TIMEOUT_S = 1800.0


class JobError(RuntimeError):
    """The job lost a process (its connection closed) or timed out."""


@dataclasses.dataclass
class Job:
    """This process's membership of a multi-process job: its rank, the
    process count, its own devices and the global device list; and the
    transport the ring layer's seams use (all of them collective: every
    process calls them together, in the same order)."""

    rank: int
    size: int
    local: tuple
    devices: tuple
    #: Cross-process traffic this process sent and the host-side seconds
    #: around it: exchanges (slabs sent), bytes, staging (device->host
    #: and host->device copies), wire (waiting for gloo).
    stats: dict = dataclasses.field(default_factory=lambda: {
        "exchanges": 0, "bytes": 0, "staging_s": 0.0, "wire_s": 0.0})

    def move(self, mesh, parts: Sequence, routes: Sequence) -> list:
        """`partition.move` across processes: slabs between own cells
        are `.to` copies, the others staged through the host and posted
        together as one batch of isend / irecv."""
        import torch.distributed as dist

        proto = next(p for p in parts if p is not None)
        out: list = [None] * len(routes)
        ops, inbox, sent = [], [], 0
        t0 = time.perf_counter()
        for i, (src, dst, take) in enumerate(routes):
            mine_src, mine_dst = mesh.owns(src), mesh.owns(dst)
            if mine_src and mine_dst:
                out[i] = take(parts[src]).to(mesh.devices[dst])
            elif mine_src:
                buf = take(parts[src]).contiguous().cpu()
                sent += buf.numel() * buf.element_size()
                ops.append(dist.P2POp(dist.isend, buf, mesh.owners[dst],
                                      tag=i))
            elif mine_dst:
                like = take(proto)
                buf = torch.empty(like.shape, dtype=like.dtype)
                ops.append(dist.P2POp(dist.irecv, buf, mesh.owners[src],
                                      tag=i))
                inbox.append((i, buf, mesh.devices[dst]))
        t1 = time.perf_counter()
        if ops:
            try:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            except RuntimeError as e:
                raise JobError(f"halo exchange failed: {e}") from None
        t2 = time.perf_counter()
        for i, buf, dev in inbox:
            out[i] = buf.to(dev)
        staging = (t1 - t0) + (time.perf_counter() - t2)
        n_sent = sum(1 for op in ops if op.op is dist.isend)
        self.stats["exchanges"] += n_sent
        self.stats["bytes"] += sent
        self.stats["staging_s"] += staging
        self.stats["wire_s"] += t2 - t1
        if ops:
            _STAGING.observe(staging)
            _WIRE.observe(t2 - t1)
            _SENT_BYTES.inc(sent)
        return out

    def allreduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        """An int32 scalar summed over the processes, back on its
        device."""
        import torch.distributed as dist

        host = value.to("cpu", torch.int64).reshape(1)
        dist.all_reduce(host)
        return host[0].to(value.device, torch.int32)

    def all_true(self, flag: bool) -> bool:
        import torch.distributed as dist

        t = torch.tensor([1 if flag else 0], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def allgather_parts(self, mesh, parts: Sequence) -> list:
        """Every cell's tensor in every process: the own ones as they
        are, the others' as host copies (one all-gather of each
        process's stacked own cells, padded to the largest count)."""
        import torch.distributed as dist

        proto = next(p for p in parts if p is not None)
        per_rank = [[i for i, o in enumerate(mesh.owners) if o == r]
                    for r in range(self.size)]
        most = max(len(cells) for cells in per_rank)
        mine = torch.zeros((most, *proto.shape), dtype=proto.dtype)
        for j, i in enumerate(per_rank[self.rank]):
            mine[j] = parts[i].cpu()
        got = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(got, mine)
        out = list(parts)
        for r, cells in enumerate(per_rank):
            if r != self.rank:
                for j, i in enumerate(cells):
                    out[i] = got[r][j]
        return out


_JOB: Optional[Job] = None
_SENT_BYTES = obs.counter(
    "gol_tpu_multihost_exchange_bytes_total",
    "Halo bytes this process sent to other processes")
_STAGING = obs.histogram(
    "gol_tpu_multihost_staging_seconds",
    "Host seconds of one cross-process halo exchange's device->host and "
    "host->device copies")
_WIRE = obs.histogram(
    "gol_tpu_multihost_wire_seconds",
    "Host seconds one cross-process halo exchange waits for gloo")


def _membership(coordinator_address, num_processes, process_id):
    """(address, size, rank) from the arguments, else torchrun's
    variables; None when neither names a coordinator."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT")
        if not port:
            raise ValueError(
                "MASTER_ADDR is set without MASTER_PORT — torchrun's "
                "rendezvous needs both")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "num_processes/process_id given without a coordinator "
                "address — set coordinator_address or MASTER_ADDR and "
                "MASTER_PORT"
            )
        return None
    size = num_processes if num_processes is not None else (
        os.environ.get("WORLD_SIZE"))
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if size is None or rank is None:
        raise ValueError(
            "a multi-process job needs its process count and this "
            "process's id — set num_processes/process_id (--mh-procs/"
            "--mh-id) or WORLD_SIZE/RANK"
        )
    size, rank = int(size), int(rank)
    if size < 1 or not 0 <= rank < size:
        raise ValueError(
            f"process id {rank} is not in a {size}-process job")
    host, _, port = str(coordinator_address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address {coordinator_address!r} is not "
            "HOST:PORT")
    return f"{host}:{port}", size, rank


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    local_devices: Optional[list] = None,
) -> None:
    """Join (or create) a multi-process job: a gloo process group with
    the coordinator's TCP store at `coordinator_address`, then every
    process's device names exchanged into the global device list.

    Arguments default to torchrun's variables (see the module
    docstring); with none set this is a no-op, and process count or id
    without a coordinator raises ValueError, as in gol_tpu. This
    process's devices are `local_devices`, else
    `stepper.resolve_devices(device)` (which raises without a card
    unless `device` is the CPU). Call before anything steps a board.
    A job's processes must all run on one device type."""
    global _JOB
    found = _membership(coordinator_address, num_processes, process_id)
    if found is None:
        return
    if _JOB is not None:
        raise RuntimeError("this process already joined a job")
    import torch.distributed as dist

    from gol_tpu_torch.parallel.stepper import resolve_devices

    address, size, rank = found
    local = tuple(resolve_devices(device, local_devices))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{address}", world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    names: list = [None] * size
    dist.all_gather_object(names, [str(d) for d in local])
    types = {torch.device(n).type for ns in names for n in ns}
    if len(types) > 1:
        raise ValueError(
            f"the job's processes run on different device types "
            f"{sorted(types)} — every process needs the same --platform")
    devices = tuple(JobDevice(torch.device(n), r)
                    for r, ns in enumerate(names) for n in ns)
    _JOB = Job(rank, size, local, devices)


def job() -> Optional[Job]:
    """This process's job, or None outside one."""
    return _JOB


def process_count() -> int:
    return 1 if _JOB is None else _JOB.size


def is_coordinator() -> bool:
    """True on the process that owns IO, events, and the engine server."""
    return _JOB is None or _JOB.rank == 0


def is_multiprocess_mesh(devices) -> bool:
    """True when `devices` spans processes, i.e. worlds sharded over
    them are not wholly held here and their dispatches must be mirrored
    on every process."""
    if _JOB is None:
        return False
    return any(isinstance(d, JobDevice) and d.rank != _JOB.rank
               for d in devices)


def global_devices(device=None) -> list:
    """Every device of the job in rank order (`JobDevice`s); one
    process: `stepper.resolve_devices(device)`."""
    if _JOB is not None:
        return list(_JOB.devices)
    from gol_tpu_torch.parallel.stepper import resolve_devices

    return resolve_devices(device)


def device_count(device=None) -> int:
    return len(global_devices(device))


def global_ring_mesh(device=None):
    """The 1-D ring over every device of the job, in rank order (the
    processes' devices grouped, so neighbours within a process exchange
    without the host)."""
    from gol_tpu_torch.parallel import partition

    return partition.ring_mesh(global_devices(device))


def spmd_put(sharding, host):
    """Host array -> its blocks under `sharding`, whether or not the
    sharding spans processes: every process holds the full host copy
    (the coordinator broadcasts it first — see `spmd_stepper`'s put)
    and places the blocks it owns."""
    return sharding.place(np.asarray(host))


def spmd_fetch(arr) -> np.ndarray:
    """A sharded world -> the full host copy on every process. All
    processes must call this together (it is an all-gather); one
    process: a plain transfer."""
    if hasattr(arr, "sharding"):
        return arr.numpy()
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


# --- SPMD dispatch mirroring -------------------------------------------------
#
# The engine runs on the coordinator and makes data- and time-dependent
# dispatch choices (chunk sizes, diff-vs-fused paths, snapshot fetches),
# and every exchange of a sharded world needs every process: so the
# coordinator broadcasts a tiny command before each dispatch and the
# workers replay it against their own shards. The opcode numbers come
# off the Stepper capability table (stepper.ENTRY_TABLE, gol_tpu's
# numbers): the table IS the wire protocol, and the mirror below is
# derived from it. The only opcodes no Stepper entry owns are the
# world / mask fetch pair (`fetch` tells them apart by dtype: masks are
# bool) and STOP.

_OPS = {e.name: e.opcode for e in ENTRY_TABLE if e.opcode is not None}
_OP_FETCH_WORLD, _OP_FETCH_MASK, _OP_STOP = 5, 6, 7
assert not {_OP_FETCH_WORLD, _OP_FETCH_MASK, _OP_STOP} & set(_OPS.values())


def _bcast(value: np.ndarray) -> np.ndarray:
    """The coordinator's `value` on every process (each passes an array
    of the same shape and dtype)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(value).copy())
    dist.broadcast(t, src=0)
    return t.numpy()


def _bcast_cmd(op: int, arg: int = 0, arg2: int = 0) -> tuple[int, int, int]:
    # int64: `arg` carries fused chunk sizes, and an int32 would wrap a
    # user --chunk >= 2^31 into a different k on the workers than the
    # coordinator runs — a silent ring deadlock. `arg2` carries the
    # sparse cap (a second argument of the sparse diff scan).
    got = _bcast(np.asarray([op, arg, arg2], np.int64))
    return int(got[0]), int(got[1]), int(got[2])


def round_robin_devices() -> list:
    """The global device list reordered round-robin across processes,
    so a k-device prefix spans as many processes as possible (the
    rank-grouped order would leave whole processes idle whenever k fits
    on the coordinator)."""
    by_proc: dict[int, list] = {}
    for d in global_devices():
        by_proc.setdefault(d.rank, []).append(d)
    groups = [by_proc[p] for p in sorted(by_proc)]
    out = []
    for i in range(max(len(g) for g in groups)):
        for g in groups:
            if i < len(g):
                out.append(g[i])
    return out


def verify_job_config(*fields) -> None:
    """Fail fast when the processes of a job were launched with
    different run parameters: a mismatch would build divergent rings
    whose first exchange hangs. Every process gathers every config and
    compares ALL of them — a one-way broadcast would let the coordinator
    (whose config trivially equals its own broadcast) sail past the
    check and hang at its first exchange while the mismatched worker
    dies."""
    if process_count() == 1:
        return
    import torch.distributed as dist

    mine = ",".join(str(f) for f in fields)
    configs: list = [None] * _JOB.size
    dist.all_gather_object(configs, mine)
    if len(set(configs)) > 1:
        raise ValueError(
            f"multi-host config mismatch: {configs} — all processes "
            "must be launched with identical -w/-h/-t/--rule/--backend"
        )


def spmd_stepper(inner):
    """Coordinator-side wrapper: a Stepper whose every dispatch first
    broadcasts (opcode, args) so workers running `spmd_worker_loop` on
    the same inner stepper co-execute it in lockstep. The mirror is
    derived from ENTRY_TABLE — each entry's opcode / args / token
    declaration builds its wrapper.

    Contract (which the engine satisfies): dispatches are linear in the
    current world — each step consumes the world the previous one
    produced, `fetch` is called on either the current world or the mask
    from the latest `step_with_diff` (told apart by dtype: masks are
    bool)."""
    from gol_tpu_torch.parallel.stepper import Stepper, compact_value_prefix

    # The one legal NON-linear dispatch: after a sparse overflow the
    # engine redoes the chunk densely FROM THE SPARSE CALL'S INPUT,
    # through the explicit `step_n_with_diffs_redo` entry (the engine
    # prefers it whenever a stepper offers one). Workers replay against
    # their own state, so the redo is its own opcode telling them to
    # step from the state they saved before the sparse dispatch.
    # `_sparse_in` tracks the outstanding sparse dispatch's (input,
    # output) pair: the redo asserts it re-steps the exact input, a
    # dense call asserts it continues from the exact output, and
    # anything else raises BEFORE a divergent opcode is broadcast. The
    # record is cleared as soon as the sparse dispatch is consumed, so
    # it stops pinning the pre-sparse world. The roles are keyed by
    # EntryInfo.token ("reset" / "dense" / "sparse" / "redo").
    _sparse_in = {"in": None, "out": None}

    def _sparse_consumed():
        _sparse_in["in"] = _sparse_in["out"] = None

    def _guard(entry, world):
        """Token-discipline check for `entry`, run BEFORE its opcode
        broadcast so a bad dispatch raises without diverging the ring."""
        if entry.token == "dense" and _sparse_in["in"] is not None:
            if world is _sparse_in["in"]:
                raise RuntimeError(
                    "sparse-overflow redo routed through the plain "
                    "dense entry — the engine must call "
                    "step_n_with_diffs_redo so workers replay from "
                    "their saved pre-sparse state"
                )
            if world is not _sparse_in["out"]:
                raise RuntimeError(
                    "dense diffs dispatch on an unrecognized world "
                    "while a sparse dispatch is outstanding — "
                    "broadcasting it would silently diverge the "
                    "ring (workers would step from post-sparse "
                    "state, the coordinator from something else)"
                )
            _sparse_consumed()
        elif entry.token == "redo":
            if _sparse_in["in"] is None:
                raise RuntimeError(
                    "sparse-overflow redo with no sparse dispatch "
                    "outstanding"
                )
            if world is not _sparse_in["in"]:
                raise RuntimeError(
                    "sparse-overflow redo must re-step the sparse "
                    "dispatch's exact input world"
                )
            _sparse_consumed()
        elif entry.token == "sparse" and _sparse_in["in"] is not None \
                and world is not _sparse_in["out"]:
            if entry.name == "step_n_with_diffs_compact":
                raise RuntimeError(
                    "compact diffs dispatch on an unrecognized world "
                    "while a sparse/compact dispatch is outstanding"
                )
            raise RuntimeError(
                "sparse diffs dispatch on an unrecognized world "
                "while another sparse dispatch is outstanding"
            )

    def _mirror(entry, fn):
        """The generic mirrored entry: guard, broadcast the opcode with
        the entry's int arguments (every argument rides the opcode, so
        every process runs the same chunk and cap), dispatch, and keep
        the token record current."""
        def call(world, *args):
            args = tuple(int(a) for a in args)
            _guard(entry, world)
            _bcast_cmd(entry.opcode, *args)
            if entry.token == "reset":
                # A fused dispatch consumes the current world, sparse-
                # produced or not: the outstanding record is spent.
                _sparse_consumed()
            out = fn(world, *args)
            if entry.token == "sparse":
                _sparse_in["in"], _sparse_in["out"] = world, out[0]
            return out

        return call

    def put(world):
        _bcast_cmd(_OPS["put"])
        host = _bcast(np.asarray(world, np.uint8))
        _sparse_consumed()  # a fresh world abandons any outstanding redo
        return inner.put(host)

    def fetch(arr):
        if getattr(arr, "dtype", None) in (torch.bool, np.bool_):
            _bcast_cmd(_OP_FETCH_MASK)
        else:
            _bcast_cmd(_OP_FETCH_WORLD)
        return inner.fetch(arr)

    def fetch_diffs(diffs):
        # The diff stack is told apart from worlds and masks by its own
        # opcode: workers keep the latest stack and fetch theirs.
        _bcast_cmd(_OPS["fetch_diffs"])
        return (inner.fetch_diffs or _host)(diffs)

    fields: dict = {}
    for e in ENTRY_TABLE:
        val = getattr(inner, e.name)
        if e.name == "put":
            fields[e.name] = put
        elif e.name == "fetch":
            fields[e.name] = fetch
        elif e.name == "fetch_diffs":
            if inner.step_n_with_diffs is not None:
                fields[e.name] = fetch_diffs
        elif e.name == "step_n_with_diffs_redo":
            # Mirrored whenever the dense entry is: workers replay the
            # redo from their saved pre-sparse state either way, so the
            # coordinator falls back to the dense inner entry when no
            # dedicated redo exists (the port's rings have none).
            if inner.step_n_with_diffs is not None:
                fields[e.name] = _mirror(e, val or inner.step_n_with_diffs)
        elif e.name == "fetch_compact_values":
            # The compact value buffer is whole in every process (the
            # scans run on the gathered diff): a local read, no opcode.
            if inner.step_n_with_diffs_compact is not None:
                fields[e.name] = val or compact_value_prefix
        elif e.kind == "meta":
            # Host-side metadata (alive_mask, halo_cost) passes through.
            fields[e.name] = val
        elif val is not None:
            fields[e.name] = _mirror(e, val)

    return Stepper(name=f"spmd-{inner.name}", shards=inner.shards, **fields)


def _host(arr) -> np.ndarray:
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) else \
        np.asarray(arr)


def spmd_worker_loop(inner, height: int, width: int) -> None:
    """Run on every non-coordinator process: replay the coordinator's
    dispatch sequence against this process's shards until _OP_STOP.
    A coordinator that is gone (its connection closed) or silent past
    the job's timeout ends the loop with `JobError`. The opcode ->
    handler map is derived from ENTRY_TABLE's `replay` declarations;
    only the world/mask fetch pair and STOP are wired by hand."""
    st = {"state": None, "mask": None, "diffs": None, "pre": None}

    def _put(arg, arg2):
        host = _bcast(np.zeros((height, width), np.uint8))
        st["state"] = inner.put(host)
        st["pre"] = None

    def _step(arg, arg2):
        st["state"] = inner.step(st["state"])
        st["pre"] = None  # mirror the coordinator: token spent

    def _step_n(arg, arg2):
        st["state"], _ = inner.step_n(st["state"], arg)
        st["pre"] = None

    def _diff(arg, arg2):
        st["state"], st["mask"], _ = inner.step_with_diff(st["state"])

    def _dense(arg, arg2):
        st["state"], st["diffs"], _ = inner.step_n_with_diffs(
            st["state"], arg
        )
        # The outstanding sparse chunk (if any) was consumed fine: drop
        # the saved pre-sparse state so it stops pinning a board.
        st["pre"] = None

    def _sparse(arg, arg2):
        # The coordinator reads its own rows; workers co-execute the
        # scan into a throwaway (NOT `diffs`, so a later fetch_diffs
        # still fetches the dense stack) and keep the pre-sparse state
        # for a possible overflow redo.
        st["pre"] = st["state"]
        st["state"], _rows, _ = inner.step_n_with_diffs_sparse(
            st["state"], arg, arg2
        )

    def _compact(arg, arg2):
        st["pre"] = st["state"]
        st["state"], _hdr, _vals, _ = inner.step_n_with_diffs_compact(
            st["state"], arg, arg2
        )

    def _redo(arg, arg2):
        # Sparse-overflow redo: the coordinator broadcast the DEDICATED
        # redo opcode, so step from the state saved before the sparse
        # dispatch — then drop the save (one redo per sparse).
        if st["pre"] is None:
            raise RuntimeError(
                "sparse-overflow redo opcode with no sparse "
                "dispatch outstanding — coordinator/worker "
                "dispatch streams have diverged"
            )
        st["state"], st["diffs"], _ = inner.step_n_with_diffs(
            st["pre"], arg
        )
        st["pre"] = None

    def _count(arg, arg2):
        inner.alive_count_async(st["state"])

    def _fetch_diffs(arg, arg2):
        (inner.fetch_diffs or _host)(st["diffs"])

    replays = {
        "put": _put, "step": _step, "step_n": _step_n, "diff": _diff,
        "count": _count, "dense": _dense, "sparse": _sparse,
        "compact": _compact, "redo": _redo, "fetch_diffs": _fetch_diffs,
    }
    handlers = {
        e.opcode: replays[e.replay]
        for e in ENTRY_TABLE
        if e.opcode is not None and e.replay in replays
    }
    handlers[_OP_FETCH_WORLD] = lambda arg, arg2: inner.fetch(st["state"])
    handlers[_OP_FETCH_MASK] = lambda arg, arg2: inner.fetch(st["mask"])
    # The multi-turn dispatches, after each of which the worker takes
    # its memory census, as the coordinator's engine takes its own.
    censused = {e.opcode for e in ENTRY_TABLE
                if e.name == "step_n" or e.kind == "diff"}
    while True:
        try:
            op, arg, arg2 = _bcast_cmd(_OP_STOP)
        except RuntimeError as e:
            raise JobError(f"the coordinator is gone: {e}") from None
        if op == _OP_STOP:
            return
        handlers[op](arg, arg2)
        if op in censused:
            obs_device.observe_memory(getattr(st["state"], "device", None))


def notify_stop() -> None:
    """Coordinator-side: release workers from `spmd_worker_loop`.

    Callers skip this on an exception path whose error also raised on
    the workers (identical configs fail identically): the broadcast
    would wait for peers that are gone. Workers of an exited
    coordinator stop on their own (`JobError`)."""
    if process_count() > 1 and is_coordinator():
        _bcast_cmd(_OP_STOP)
