"""Chip smoke test of the PyTorch / CUDA port (`gol_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It
builds the hand-written CUDA kernels from `gol_tpu_torch/csrc`, holds
each kernel bit-exact against its plain PyTorch version, holds every
diff scan of the CUDA steppers (dense, sparse and compact rows, one
kernel launch a scanned turn) byte-identical to the plain steppers'
(phase `diffs`), drives the port's paths through `gol_tpu_torch.run` —
Life at 512² against the golden fixtures and at 16384² against the
plain version; Generations (B/S/C) rules at 64² against the rules
fixtures, at 512² against the plain planes and at 16384² against the
plain planes; the dense CUDA backend at 512² against the golden
fixture; the watched runs (phases `main-watched-512`,
`main-watched-gens-512`, `main-watched-16384`: the diff-chunk pipeline
against the per-turn path, compact chunks, a forced overflow, level-mode
FlipBatches, FlipChunks at 16384²); the activity-tiled stepper (kernel
A batched over each slab of ghost-extended tiles: phase `kernels` holds
the batched entry bit-exact against the batched plain step, phase
`tiled` holds a 32768² tiled world bit-identical to the dense stepper's
and times both, `main-tiled-16384` runs `run(Params(tile=1024))`,
`main-watched-tiled` a watched tiled run against the dense paths) —
runs the CLI (also with `--tile 1024`), headless and (phase
`main-cli-full`) visualised on the native board with
`--check-invariants`, `--autosave-turns`, `--resume` and
`--profile-dir`, whose `torch.profiler` captures give the device's busy
share of a run — serves the engine over TCP (phases `main-serve-512`:
an EngineServer on the card with a batching driver behind a
byte-counting proxy and two observers, delivered turns/s and link bytes
per turn, beside the same server on the host CPU; `main-serve-attach`:
headless, watched, headless and observed legs of one run;
`main-serve-16384`: a BoardSync's bytes and seconds by leg, the 'k'
snapshot and the final frame; `main-serve-gens`: gray levels;
`cli-serve`: `--serve` and `--connect` processes, 'k' typed on the
connect's terminal), runs the session plane (phase `kernels`: kernel
A's batched entry at the session-bucket shapes, kernel B and E per
slot; `main-sessions`: SessionManager + SessionEngine on the card, 64 x
256², 2 x 4096² and 4 x 100² buckets, watchers through plain diffs,
compact chunks and a forced redo, park and rehydrate, one kernel A
launch a 256² bucket's fused chunk and one a watched turn;
`sessions-lane`: bench.py's 64 x 256² lane, one bucket against 64
sequential steppers; `main-sessions-serve`: a recording SessionServer
with a driver behind the byte-counting proxy, beside the same server
on the host CPU, a live seek and a ReplayServer's cold seek;
`cli-sessions`: `--serve --sessions --record`, `--connect --session`,
`--replay` processes), runs the broadcast tier, the telemetry planes
and the fleet (phase `relay-fanout`: the settled 512² fixture served to
50 and 500 observers direct and through a 2-level relay chain, root
bytes per observer-turn, one root encode a chunk, one kernel A launch a
turn; `main-relay-16384`: a late BoardSync from a relay's shadow raster
at 16384², by leg, and a WebSocket observer on its gateway;
`main-telemetry`: a SessionServer with the turn-age alert fired by a
wedged observer and resolved by its drain, the usage ledger and the
cost price, remote-write into a collector, a WebSocket canary;
`cli-fleet`: `--collector`, `--serve --sessions`, `--relay` and
`--control` processes, a SIGKILLed relay healed), runs rings and 2-D
meshes of shards over `[cuda:0] * k` (phase `kernels`: each local-block
plan's entry on the rings' ghost-extended blocks at 512² and 16384²
over 4, 1504 x 512 over 3 and 3072 x 8192 over 2, kernel E on the dense
ring's strips, one-turn launches on the mesh's and the lane layout's
blocks; `main-ring-512`: the fixture through an Engine on a 4-shard
ring, Life and B2/S/C3, launches equal to the plan's and the halo
series; `main-ring-16384`: Life and B2/S/C3 over 4 shards against the
single-device boards, both walls; `main-ring-uneven`: balanced and
narrow splits and the dense ring against the single-device steppers,
padding dead, diff rows stripped; `main-watched-ring`: FlipBatch and
FlipChunk streams with a forced redo, equal to one device's, one launch
a watched turn a shard; `main-mesh`: 2x2 meshes and
`layout=lane-coupled`; `cli-mesh`: `--mesh 2x2` refused on one card,
`-t 4` one shard), every board against the plain version — runs
multi-process jobs and the chaos harness last (phase `multihost`: two
processes over gloo on the one card, each rank `[cuda:0] * 2` in its
own CUDA context (`--mh-rank`), a 4-shard ring through Life 512² by an
Engine against the fixture and the CSV, B2/S/C3 512² against the plain
planes, Life and B2/S/C3 16384² x 256 against the single-device boards,
the dense ring against `life.step_n` and a watched leg with a forced
redo against the single device, each rank's launches equal to its
plan, the job's `step_n` wall beside the one-process ring's, the
cross-rank halo bytes and host staging; the `--mh-*` CLI pair's PGM
against the fixture and a mismatched pair failing in both processes;
phase `chaos`: `ChaosRunner` SIGKILLing a `--serve --sessions` server
on the card mid-storm, survivors against the plain oracle, the session
dispatches by path before the kill and after the resume; phase `cli`
also reads a fresh process's compile watcher from /metrics) — and
prints the `kernels` JSON line, the card's name and power limit, and a last
line `{"ok": true, "device": {...}}`. Any failed phase raises, so the
script exits nonzero and prints no result. Without a CUDA device, or
without the repository beside it, it exits nonzero at once.

    python3 chip_smoke.py --ab OTHER_CHECKOUT

compares kernels A-E of another checkout of this repository (the
parent commit unpacked with `git archive`, say) with this one's on the
same card, in four processes (other, this, this, other), each building
its own kernels: ms per launch of one 32-turn pass of a 16384² board, B
on B3/S23 and B36/S23, D on B2/S/C3 and B2/S345/C4; ms per 64-turn
launch on a 512² board, A on B3/S23, C on B2/S/C3 and B2/S345/C4; ms
per call of E's `step_n_cuda_dense`, 100 turns on a 512² board (with
the host's enqueue and the device's time) and 32 on a 16384² one; the
ptxas registers of each build; and whether each kernel instantiation
compiled to the same SASS in both builds.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import csv
import json
import os
import pathlib
import random
import re
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "fixtures"

#: Every kernel of the main path: which TPU kernel it replaces.
KERNELS = {
    "bitlife_resident": {
        "source": "gol_tpu_torch/csrc/bitlife.cu",
        "replaces": "gol_tpu/ops/pallas_bitlife.py:176",
    },
    "bitlife_tiled": {
        "source": "gol_tpu_torch/csrc/bitlife.cu",
        "replaces": "gol_tpu/ops/pallas_bitlife.py:437",
        "also_replaces": "gol_tpu/ops/pallas_bitlife.py:300",
    },
    "bitgens_resident": {
        "source": "gol_tpu_torch/csrc/bitgens.cu",
        "replaces": "gol_tpu/ops/pallas_bitgens.py:163",
    },
    "bitgens_tiled": {
        "source": "gol_tpu_torch/csrc/bitgens.cu",
        "replaces": "gol_tpu/ops/pallas_bitgens.py:403",
        "also_replaces": "gol_tpu/ops/pallas_bitgens.py:253",
    },
    "life_dense": {
        "source": "gol_tpu_torch/csrc/life.cu",
        "replaces": "gol_tpu/ops/pallas_life.py:89",
    },
    # Kernel A's batched entry: the tiled stepper's slab, one cluster a
    # ghost-extended tile, in place of gol_tpu's jax.vmap of the plain
    # packed step (no Pallas kernel).
    "bitlife_resident_batch": {
        "source": "gol_tpu_torch/csrc/bitlife.cu",
        "replaces": "gol_tpu/parallel/tiled.py:292",
        "kernel": "bitlife_resident",
    },
    # Kernel A's batched entry again: a session bucket's chunk, one
    # cluster a board, in place of gol_tpu's jax.vmap of the plain packed
    # step over the bucket (no Pallas kernel).
    "bitlife_resident_sessions": {
        "source": "gol_tpu_torch/csrc/bitlife.cu",
        "replaces": "gol_tpu/parallel/stepper.py:600",
        "kernel": "bitlife_resident",
    },
}

#: Boards (height, width) of kernels A and C: cluster plans of 1, 2, 3
#: and 8 blocks (`cuda_bitlife._cluster_plan`), the last the main
#: path's 512².
RESIDENT_BOARDS = ((32, 512), (64, 64), (96, 96), (512, 512))
#: Turns at the cluster's seams: none, one, either side of the first and
#: second halo exchange, and the main path's chunks of 64 and 36.
RESIDENT_TURNS = (0, 1, 31, 32, 33, 36, 64, 100)

#: Published H100 SXM memory rate (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per SM on Hopper (four partitions of 16).
INT32_LANES_PER_SM = 64


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_resources(log: str, kernel: str) -> dict:
    """{instantiation: "N registers, S bytes spill stores, L bytes spill
    loads"} for each entry function of `kernel` in an `nvcc -Xptxas -v`
    log (templates by their mangled argument, e.g. "ILi0E")."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = None
            if kernel in mangled:
                tail = mangled.split(kernel, 1)[1]
                name = kernel + (tail.split("EE")[0] + "E"
                                 if tail.startswith("ILi") else "")
        elif name and "spill stores" in ln:
            spills = ln.strip().split(", ", 1)[1]
            out[name] = spills
        elif name and "Used" in ln and "registers" in ln:
            regs = ln.split("Used ", 1)[1].split(",")[0]
            out[name] = f"{regs}, {out.get(name, '')}"
            name = None
    return out


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def life_fewest_instructions(p):
    """One B3/S23 turn of a packed int32 board, written in the fewest
    32-bit integer instructions known here for sm_90, in the unit of the
    INT32 peak: each `ins(...)` is one instruction — a funnel shift (SHF)
    for each vertical carry, one LOP3 for any logic of up to three
    inputs. It sums all nine cells, the centre too, so next =
    [sum9 == 3] | (alive & [sum9 == 4]). Each word's column sum is formed
    once and read by both neighbours; bringing a neighbour's word in
    (shared memory, shuffle) is no integer operation. Returns (next
    board, instructions per word). The bound's operation count is that
    number, and `measure` holds the board equal to the plain step on the
    card, so the count is of a form that computes Life."""
    import torch

    from gol_tpu_torch.ops.bitlife import lsr

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    def maj(a, b, c):
        return (a & b) | (a & c) | (b & c)

    def west(x):
        return torch.roll(x, 1, 1)

    def east(x):
        return torch.roll(x, -1, 1)

    up = ins((p << 1) | lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    g = ins((z0 & b1 & ~b2) | (~z0 & ~b1 & b2))  # sum9 in {3, 4}
    return ins(g & (p | z0)), count            # 3, or 4 with the centre alive


def highlife_fewest_instructions(p):
    """One B36/S23 (HighLife) turn of a packed int32 board, counted as
    `life_fewest_instructions` counts Life: the same ten instructions
    for the nine-cell sum's bits, then two. Among the sums that can turn
    a cell on, {3, 4, 6} (bits 0..2 name each uniquely: 8 and 9 have
    bit 3), 3 is the one with bit 0 set, so next = z0 ? (b1 & ~b2) :
    (b2 & (b1 ^ alive)) — 4 with the centre alive, 6 with it dead.
    f = (b1 & ~b2) | (b2 & (b1 ^ alive)) holds both halves, and next =
    f & (z0 ^ b2). Returns (next board, instructions per word)."""
    import torch

    from gol_tpu_torch.ops.bitlife import lsr

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    def maj(a, b, c):
        return (a & b) | (a & c) | (b & c)

    def west(x):
        return torch.roll(x, 1, 1)

    def east(x):
        return torch.roll(x, -1, 1)

    up = ins((p << 1) | lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    f = ins((b1 & ~b2) | (b2 & (b1 ^ p)))      # LOP3 of b1, b2, alive
    return ins(f & (z0 ^ b2)), count           # 3; 4 alive; 6 dead


def gens_fewest_instructions(planes):
    """One B2/S/C3 (Brian's Brain) turn of packed int32 planes (alive,
    dying), counted as `life_fewest_instructions` counts Life. Birth
    needs a dead centre, so the nine-cell sum equals the neighbour count
    wherever it matters: new alive = [sum9 == 2] & ~alive & ~dying. The
    survive set is empty, so the new dying plane IS the old alive plane
    (a rename, no instruction) and the old dying plane falls off.
    Returns (next planes, instructions per word)."""
    import torch

    from gol_tpu_torch.ops.bitlife import lsr

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    def maj(a, b, c):
        return (a & b) | (a & c) | (b & c)

    def west(x):
        return torch.roll(x, 1, 1)

    def east(x):
        return torch.roll(x, -1, 1)

    p, dying = planes[0], planes[1]
    up = ins((p << 1) | lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    g = ins(~z0 & b1 & ~b2)                    # sum9 == 2
    born = ins(g & ~p & ~dying)                # ... on a dead cell
    return torch.stack([born, p]), count


def starwars_fewest_instructions(planes):
    """One B2/S345/C4 (Star Wars) turn of packed int32 planes (alive,
    dying_1, dying_2), counted as `life_fewest_instructions` counts
    Life: the same ten instructions for the nine-cell sum's bits, then
    five. An alive centre survives on 3, 4 or 5 neighbours, a nine-cell
    sum of 4, 5 or 6: bits (b2, b1, z0) 100, 101, 110 — b2 and not both
    b1 and z0 (7 is 111; 8 and 9 have b2 clear). A dead centre is born
    on sum9 == 2. The new dying_1 plane is the alive cells that do not
    survive, the new dying_2 plane IS the old dying_1 (a rename, no
    instruction), and the old dying_2 plane falls off. Returns (next
    planes, instructions per word)."""
    import torch

    from gol_tpu_torch.ops.bitlife import lsr

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    def maj(a, b, c):
        return (a & b) | (a & c) | (b & c)

    def west(x):
        return torch.roll(x, 1, 1)

    def east(x):
        return torch.roll(x, -1, 1)

    p, d1, d2 = planes[0], planes[1], planes[2]
    up = ins((p << 1) | lsr(torch.roll(p, 1, 0), 31))     # SHF: row y-1
    down = ins(lsr(p, 1) | (torch.roll(p, -1, 0) << 31))  # SHF: row y+1
    s = ins(up ^ p ^ down)                     # column sum, bit 0
    c = ins(maj(up, p, down))                  # column sum, bit 1
    z0 = ins(west(s) ^ s ^ east(s))            # sum9 bit 0
    c0 = ins(maj(west(s), s, east(s)))         # its carry (weight 2)
    a = ins(west(c) ^ c ^ east(c))             # weight-2 parity
    m = ins(maj(west(c), c, east(c)))          # weight-4 carry
    b1 = ins(a ^ c0)                           # sum9 bit 1
    b2 = ins(m ^ (a & c0))                     # sum9 bit 2 (bit 3: 8 or 9)
    keep = ins(b2 & ~(b1 & z0))                # sum9 in {4, 5, 6}
    born = ins(~z0 & b1 & ~b2)                 # sum9 == 2
    free = ins(born & ~d1 & ~d2)               # ... on a dead cell
    alive = ins((p & keep) | (~p & free))      # LOP3 of alive, keep, free
    dying = ins(p & ~keep)                     # alive cells that die
    return torch.stack([alive, dying, d1]), count


def dense_fewest_instructions(bits):
    """One B3/S23 turn of a dense {0,1} uint8 (H, W) board, W % 4 == 0,
    in byte-SIMD form: four cells per 32-bit word (byte k = column
    4j+k), each `ins(...)` one 32-bit integer instruction (IADD/IADD3,
    a funnel shift SHF, a LOP3). No byte overflows: the vertical sum is
    at most 3, the neighbour count 8. next = [(count | alive) == 3].
    Returns (next board as {0,1} uint8, instructions per word)."""
    import torch

    from gol_tpu_torch.ops.bitlife import lsr

    count = 0

    def ins(v):
        nonlocal count
        count += 1
        return v

    w = bits.contiguous().view(torch.int32)
    ns = ins(torch.roll(w, 1, 0) + torch.roll(w, -1, 0))  # IADD: rows y±1
    v = ins(ns + w)                                       # IADD: triple
    left = ins((v << 8) | lsr(torch.roll(v, 1, 1), 24))   # SHF: column x-1
    right = ins(lsr(v, 8) | (torch.roll(v, -1, 1) << 24))  # SHF: column x+1
    n8 = ins(left + right + ns)                # IADD3: neighbour count
    x = ins((n8 | w) ^ 0x03030303)             # LOP3: byte 0 iff == 3
    z = ins(x + 0x0F0F0F0F)                    # IADD: bit 4 set iff x != 0
    t = ins(lsr(z, 4))                         # SHF
    nxt = ins(~t & 0x01010101)                 # LOP3
    return nxt.view(torch.uint8), count


def bound_ms(nbytes: int, ops: int, int_ops_per_s: float) -> tuple:
    """(least ms, what bounds it): `nbytes` (each input read once, each
    output written once) over the memory rate against `ops` INT32
    instructions over the INT32 rate."""
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = ops / int_ops_per_s
    return (max(byte_s, op_s) * 1e3,
            "operations" if op_s >= byte_s else "bytes")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA
    events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def drain(events, timeout: float = 600.0) -> list:
    """Every event of a run, until the stream closes."""
    return [ev for _, ev in drain_timed(events, timeout)]


def drain_timed(events, timeout: float = 600.0) -> list:
    """(wall time of arrival, event) for every event of a run."""
    out = []
    deadline = time.monotonic() + timeout
    while True:
        ev = events.get(timeout=max(1.0, deadline - time.monotonic()))
        if ev is None:
            return out
        out.append((time.time(), ev))


def wall_split(t0: float, timed: list) -> str:
    """Where a run's wall time went, from the engine's own flight notes
    (one per committed dispatch) and the arrival of the tail events."""
    from gol_tpu_torch import FinalTurnComplete, ImageOutputComplete
    from gol_tpu_torch.obs import flight

    commits = [ts for ts, kind, _ in flight.FLIGHT.entries
               if kind == "engine.commit" and ts >= t0]
    t_image = next(t for t, e in timed if isinstance(e, ImageOutputComplete))
    t_final = next(t for t, e in timed if isinstance(e, FinalTurnComplete))
    return (f"start->turn-0 commit (put) {commits[0] - t0:.3f} s, "
            f"{len(commits) - 1} chunk dispatches {commits[-1] - commits[0]:.3f} s, "
            f"->snapshot written (device drain, fetch, PGM write) "
            f"{t_image - commits[-1]:.3f} s, ->FinalTurnComplete (fetch, "
            f"alive list) {t_final - t_image:.3f} s")


def gens_planes(rule, h: int, w: int, gen):
    """Packed one-hot planes of random states 0..C-1 on the card."""
    import torch

    from gol_tpu_torch.ops import bitlife

    states = torch.randint(0, rule.states, (h, w), dtype=torch.uint8,
                           generator=gen).cuda()
    return torch.stack([bitlife.pack(states == s)
                        for s in range(1, rule.states)])


def tiled_turns(k: int) -> tuple:
    """Turns at which kernels B and D are checked for a pass of k turns:
    the single turns the watched path launches (n = 1, 2), and either
    side of one and two passes."""
    return (1, 2, k - 1, k, k + 1, 2 * k + 3)


def plain_turns(step_n, p, ns) -> dict:
    """{n: the plain version after n turns} for every n in `ns`, each
    from the previous one."""
    out, q, at = {}, p, 0
    for n in sorted(set(ns)):
        q = step_n(q, n - at)
        at = n
        out[n] = q
    return out


def check_kernels(errs: dict) -> None:
    """Phase 3: kernels A and B against the plain packed step on the
    card, bit-exact, at the main path's shapes and the listed seams."""
    import torch

    from gol_tpu_torch.models.rules import Rule, get_rule
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.ops import cuda_bitlife as cb

    rng = random.Random(20)
    rules = [get_rule("B3/S23"), get_rule("B36/S23"),
             Rule(name="random-b0free",
                  birth=frozenset(rng.sample(range(1, 9), 3)),
                  survive=frozenset(rng.sample(range(9), 3)))]
    gen = torch.Generator().manual_seed(0)

    def board(h, w):
        return torch.randint(-2**31, 2**31 - 1, (h // 32, w),
                             dtype=torch.int32, generator=gen).cuda()

    checked = 0
    plans = {}
    for rule in rules:
        for h, w in RESIDENT_BOARDS:
            p = board(h, w)
            plans[f"{h}x{w}"] = cb._cluster_plan(h // 32, w, 2)
            want = plain_turns(
                lambda x, k: bitlife.step_n_packed_raw(x, k, rule), p,
                RESIDENT_TURNS)
            for n in RESIDENT_TURNS:
                got = cb.step_n_packed_cuda_raw(p, n, rule)
                torch.cuda.synchronize()
                err = max_abs_err(got, want[n])
                errs["bitlife_resident"] = max(errs["bitlife_resident"], err)
                if err:
                    raise AssertionError(
                        f"bitlife_resident {h}x{w} n={n} {rule}: mismatch")
                checked += 1
        # Kernel B's seams: tile shapes, the deepest halo (768-column
        # tiles, more column walkers than threads) and a ragged board
        # (its last tile 160 of 256 columns), the last two at 4096² only.
        for h, w in ((4096, 4096), (16384, 16384), (4096, 4000)):
            side = f"{h}x{w}"
            p = board(h, w)
            variants = [
                ("tiled2d", {}, 32),
                ("tiled", {}, 32),
            ]
            if w == h:
                variants += [
                    ("tiled2d", {"tile_rows": 8}, 32),
                    ("tiled", {"strip_rows": 8, "halo_words": 2}, 64),
                ]
            if h == 4096 and w == h:
                variants.append(("tiled", {"strip_rows": 8, "halo_words": 8},
                                 256))
            want = plain_turns(
                lambda x, k: bitlife.step_n_packed_raw(x, k, rule), p,
                [n for _, _, k in variants for n in tiled_turns(k)])
            for entry, kw, k in variants:
                fn = (cb.step_n_packed_tiled2d_raw if entry == "tiled2d"
                      else cb.step_n_packed_tiled_raw)
                for n in tiled_turns(k):
                    got = fn(p, n, rule, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want[n])
                    errs["bitlife_tiled"] = max(errs["bitlife_tiled"], err)
                    if err:
                        raise AssertionError(
                            f"bitlife_tiled via {entry}{kw} {side} n={n} "
                            f"{rule}: mismatch")
                    checked += 1
            del p, want
            torch.cuda.empty_cache()
    if not {1, 3, 8} <= {blocks for blocks, _, _ in plans.values()}:
        raise AssertionError(f"kernel A's boards miss a cluster seam: {plans}")
    phase("kernels", f"{checked} kernel runs bit-exact against the plain "
                     f"version (rules {[str(r) for r in rules]}, "
                     f"max_abs_err {max(errs.values())}); kernel A's "
                     f"(blocks, slab_rows, halo) {plans}")


def check_gens_kernels(errs: dict) -> None:
    """Phase 3b: kernels C and D against the plain planes on the card,
    bit-exact, at the main paths' shapes and the listed seams."""
    import torch

    from gol_tpu_torch.models.rules import GenRule, get_rule
    from gol_tpu_torch.ops import bitgens
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb

    rng = random.Random(21)

    def random_rule(states):
        return GenRule(name=f"random-b0free-C{states}",
                       birth=frozenset(rng.sample(range(1, 9), 3)),
                       survive=frozenset(rng.sample(range(9), 3)),
                       states=states)

    gen = torch.Generator().manual_seed(1)
    checked = 0
    plans = {}
    resident_rules = [get_rule("B2/S/C3"), get_rule("B2/S345/C4"),
                      get_rule("B36/S23/C2"), random_rule(5), random_rule(7)]
    for rule in resident_rules:
        # C = 7 fills one block at 512² (7 copies of 32 KiB), the most
        # planes kernel C takes there; the other rules on every board.
        boards = ([(512, 512)] if rule.states == 7 else RESIDENT_BOARDS)
        for h, w in boards:
            if not cg.fits_cuda_gens(h, w, rule):
                raise AssertionError(f"{rule} at {h}x{w} must fit kernel C")
            q = gens_planes(rule, h, w, gen)
            plans[f"{h}x{w} C{rule.states}"] = cb._cluster_plan(
                h // 32, w, rule.states)
            want = plain_turns(
                lambda x, k: bitgens.step_n_packed_gens_raw(x, k, rule), q,
                RESIDENT_TURNS)
            for n in RESIDENT_TURNS:
                got = cg.step_n_packed_gens_cuda_raw(q, n, rule)
                torch.cuda.synchronize()
                err = max_abs_err(got, want[n])
                errs["bitgens_resident"] = max(errs["bitgens_resident"], err)
                if err:
                    raise AssertionError(
                        f"bitgens_resident {h}x{w} n={n} {rule}: mismatch")
                checked += 1
    if not {1, 3, 8} <= {blocks for blocks, _, _ in plans.values()}:
        raise AssertionError(f"kernel C's boards miss a cluster seam: {plans}")
    # Kernel D: B2/S/C3 runs the column walkers, the C=8 rule the masks.
    # B2/S/C3's seams at 4096² only: the deepest halo (768-column tiles,
    # more column walkers than threads) and a ragged board (its last tile
    # 160 of 256 columns).
    brain = get_rule("B2/S/C3")
    tiled_cases = [(4096, 4096, brain), (16384, 16384, brain),
                   (4096, 4000, brain), (512, 512, random_rule(8))]
    for h, w, rule in tiled_cases:
        side = f"{h}x{w}"
        if h == 512 and cg.fits_cuda_gens(h, w, rule):
            raise AssertionError("the C=8 case must lie past kernel C's gate")
        q = gens_planes(rule, h, w, gen)
        variants = [
            ("tiled2d", {}, 32),
            ("tiled", {}, 32),
        ]
        if w == h:
            variants += [
                ("tiled2d", {"tile_rows": 8}, 32),
                ("tiled", {"strip_rows": 8, "halo_words": 2}, 64),
            ]
        if h == 4096 and w == h:
            variants.append(("tiled", {"strip_rows": 8, "halo_words": 8},
                             256))
        want = plain_turns(
            lambda x, k: bitgens.step_n_packed_gens_raw(x, k, rule), q,
            [n for _, _, k in variants for n in tiled_turns(k)])
        for entry, kw, k in variants:
            fn = (cg.step_n_packed_gens_tiled2d_raw if entry == "tiled2d"
                  else cg.step_n_packed_gens_tiled_raw)
            for n in tiled_turns(k):
                got = fn(q, n, rule, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(got, want[n])
                errs["bitgens_tiled"] = max(errs["bitgens_tiled"], err)
                if err:
                    raise AssertionError(
                        f"bitgens_tiled via {entry}{kw} {side} n={n} "
                        f"{rule}: mismatch")
                checked += 1
        del q, want
        torch.cuda.empty_cache()
    rules = sorted({str(r) for r in resident_rules}
                   | {str(r) for _, _, r in tiled_cases})
    phase("kernels", f"{checked} Generations kernel runs bit-exact against "
                     f"the plain planes (rules {rules}, max_abs_err "
                     f"{max(errs['bitgens_resident'], errs['bitgens_tiled'])}"
                     f"); kernel C's (blocks, slab_rows, halo) {plans}")


def check_dense_kernel(errs: dict) -> None:
    """Phase 3c: kernel E against the plain dense step on the card,
    bit-exact: both rule forms (B3/S23, B36/S23) at the tiled
    schedule's seams — a width that is not a multiple of 4 (the byte
    loader), a board smaller than the ghost frame, ragged last tiles —
    and at 512² and 512x1024, at n in {0, 1, k-1, k, k+1, 2k+1, 100};
    a board of arbitrary nonzero bytes and a view off a 4-byte boundary
    at 512²; both plans `measure` times (depths 8 and 16) at 512²;
    boards of more rows of tiles than one grid holds (5,000,000 x 4 and
    x 3, two launches a pass, as the launcher reports); and 16384² at n
    in {1, k, k+1, 32}."""
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import cuda_life as cl
    from gol_tpu_torch.ops import life

    def check(what, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["life_dense"] = max(errs["life_dense"], err)
        if err:
            raise AssertionError(f"life_dense {what}: mismatch")

    checked = 0
    plans = {}
    rules = (get_rule("B3/S23"), get_rule("B36/S23"))
    for rule in rules:
        for h, w in ((64, 128), (37, 45), (5, 7), (100, 260), (512, 512),
                     (512, 1024)):
            world = torch.from_numpy(life.random_world(h, w, seed=h + w)).cuda()
            plans[f"{h}x{w}"] = plan = cl._dense_plan(h, w)
            k = plan[4]
            ns = (0, 1, k - 1, k, k + 1, 2 * k + 1, 100)
            want = plain_turns(lambda x, t: life.step_n(x, t, rule), world, ns)
            for n in ns:
                check(f"{h}x{w} n={n} {rule}",
                      cl.step_n_cuda_dense(world, n, rule), want[n])
                checked += 1
    # Nonzero = alive, whatever the byte; a view that starts off a word.
    gen = torch.Generator().manual_seed(4)
    raw = torch.randint(0, 256, (512, 512), dtype=torch.uint8,
                        generator=gen).cuda()
    raw[raw < 128] = 0
    flat = torch.zeros(512 * 512 + 1, dtype=torch.uint8, device="cuda")
    flat[1:] = raw.flatten()
    for what, x in (("arbitrary bytes", raw),
                    ("view at byte 1", flat[1:].view(512, 512))):
        for rule in rules:
            check(f"512x512 {what} {rule}", cl.step_n_cuda_dense(x, 37, rule),
                  life.step_n(raw, 37, rule))
            checked += 1
    # Both plans `measure` times, at 512².
    world = torch.from_numpy(life.random_world(512, 512, seed=1)).cuda()
    want = plain_turns(life.step_n, world, (31, 33, 100))
    for depth in sorted(cl.TILES):
        plan = cl._dense_plan(512, 512, depth)
        for n in (31, 33, 100):
            check(f"512x512 depth {depth} n={n}",
                  cl._run(world, n, rules[0], plan), want[n])
            checked += 1
    # More rows of tiles than a grid holds: each pass in two launches.
    for h, w in ((5_000_000, 4), (5_000_000, 3)):
        world = torch.from_numpy(life.random_world(h, w, seed=w)).cuda()
        plans[f"{h}x{w}"] = plan = cl._dense_plan(h, w)
        k = plan[4]
        slices = -(-(-(-h // plan[0])) // 65_535)
        for rule in rules:
            for n in (1, k + 1):
                before = cl.LAUNCHES["life_dense"]
                got = cl.step_n_cuda_dense(world, n, rule)
                issued = cl.LAUNCHES["life_dense"] - before
                check(f"{h}x{w} n={n} {rule}", got,
                      life.step_n(world, n, rule))
                if issued != -(-n // k) * slices or slices < 2:
                    raise AssertionError(
                        f"life_dense {h}x{w} n={n}: {issued} launches, "
                        f"{slices} grids a pass")
                checked += 1
    del world, want
    side = 16384
    world = torch.from_numpy(life.random_world(side, side, seed=0)).cuda()
    plans[f"{side}x{side}"] = plan = cl._dense_plan(side, side)
    k = plan[4]
    ns = (1, k, k + 1, 32)
    for rule in rules:
        want = plain_turns(lambda x, t: life.step_n(x, t, rule), world, ns)
        for n in ns:
            check(f"{side}x{side} n={n} {rule}",
                  cl.step_n_cuda_dense(world, n, rule), want[n])
            checked += 1
        del want
    del world
    torch.cuda.empty_cache()
    phase("kernels", f"{checked} dense kernel runs bit-exact against the "
                     f"plain step (B3/S23, B36/S23; max_abs_err "
                     f"{errs['life_dense']}); plans (tile_rows, tile_words, "
                     f"halo, ghost, turns, threads, seg_rows) {plans}")


def main_path_512(tmp: pathlib.Path) -> int:
    """Phase 4: run(Params) at 512², headless through kernel A, then with
    per-turn flips; both final PGMs byte-equal to the golden board."""
    import gol_tpu_torch
    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel import make_stepper

    golden = (FIXTURES / "check/images/512x512x100.pgm").read_bytes()
    with open(FIXTURES / "check/alive/512x512.csv") as f:
        want_alive = {int(r["completed_turns"]): int(r["alive_cells"])
                      for r in csv.DictReader(f)}[100]
    if make_stepper(height=512, width=512).name != "single-cuda-packed":
        raise AssertionError("auto stepper at 512² is not single-cuda-packed")

    for kind, flips in (("headless", False), ("flips", True)):
        out = tmp / f"512-{kind}"
        params = Params(image_width=512, image_height=512, turns=100,
                        chunk=0, image_dir=str(FIXTURES / "images"),
                        out_dir=str(out))
        if not flips:
            for k in cb.LAUNCHES:
                cb.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        evs = drain(gol_tpu_torch.run(params, emit_flips=flips))
        wall = time.perf_counter() - t0
        if not flips:
            launches = cb.LAUNCHES["bitlife_resident"]
        final = [e for e in evs if isinstance(e, FinalTurnComplete)]
        if not final or final[0].completed_turns != 100:
            raise AssertionError(f"512² {kind}: no FinalTurnComplete at 100")
        if len(final[0].alive) != want_alive:
            raise AssertionError(
                f"512² {kind}: {len(final[0].alive)} alive, CSV says {want_alive}")
        if (out / "512x512x100.pgm").read_bytes() != golden:
            raise AssertionError(f"512² {kind}: PGM differs from the fixture")
        phase("main-512", f"run(Params 512x512, 100 turns, {kind}) byte-equal "
                          f"to fixture, {want_alive} alive, {wall:.3f} s wall")
    if launches <= 0:
        raise AssertionError("the 512² main path never launched bitlife_resident")
    return launches


def main_path_16384(tmp: pathlib.Path, card: str) -> tuple:
    """Phase 5: run(Params) at 16384² through kernel B, against the
    plain version on the card from the same board."""
    import torch

    import gol_tpu_torch
    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import bitlife, life
    from gol_tpu_torch.ops import cuda_bitlife as cb

    side, turns = 16384, 256
    world = life.random_world(side, side, seed=0)
    out = tmp / "16384"
    params = Params(image_width=side, image_height=side, turns=turns,
                    chunk=0, out_dir=str(out))
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    t0 = time.time()
    timed = drain_timed(gol_tpu_torch.run(params, emit_flips=False,
                                          initial_world=world))
    wall = time.time() - t0
    launches = cb.LAUNCHES["bitlife_tiled"]
    evs = [ev for _, ev in timed]
    split = wall_split(t0, timed)
    if launches <= 0:
        raise AssertionError("the 16384² main path never launched bitlife_tiled")
    final = [e for e in evs if isinstance(e, FinalTurnComplete)]
    if not final or final[0].completed_turns != turns:
        raise AssertionError("16384²: no FinalTurnComplete at the last turn")
    p = bitlife.pack(life.to_bits(torch.from_numpy(world).cuda()))
    want = bitlife.step_n_packed_raw(p, turns)
    REUSE["life"] = (world, want)  # phase main-ring-16384's reference
    got = bitlife.pack(life.to_bits(torch.from_numpy(
        read_pgm(out / f"{side}x{side}x{turns}.pgm")).cuda()))
    if not torch.equal(got, want):
        raise AssertionError("16384²: final board differs from the plain version")
    alive = int(bitlife.count_packed(want).item())
    if len(final[0].alive) != alive:
        raise AssertionError("16384²: FinalTurnComplete alive set differs")
    phase("main-16384", f"run(Params 16384x16384, {turns} turns) equal to the "
                        f"plain version, {alive} alive; {turns / wall:.2f} "
                        f"turns/s, {side * side * turns / wall / 1e9:.3f} "
                        f"Gcells/s end to end ({wall:.2f} s wall: {split}) "
                        f"on {card}")
    return launches


def main_gens_64(tmp: pathlib.Path) -> None:
    """Phase 5b: run(Params 64², B2/S/C3 and B2/S345/C4, 100 turns) with
    backend auto on the card; PGMs byte-equal to the rules fixtures."""
    import gol_tpu_torch
    from gol_tpu_torch import Params
    from gol_tpu_torch.parallel import make_stepper

    for notation in ("B2/S/C3", "B2/S345/C4"):
        name = make_stepper(height=64, width=64, rule=notation).name
        if name != "generations-cuda-packed-1":
            raise AssertionError(f"auto stepper for {notation} at 64² is {name}")
        out = tmp / f"gens64-{notation.replace('/', '_')}"
        drain(gol_tpu_torch.run(Params(
            image_width=64, image_height=64, turns=100, rule=notation,
            chunk=0, image_dir=str(FIXTURES / "images"), out_dir=str(out)),
            emit_flips=False))
        golden = (FIXTURES / "check/rules"
                  / f"64x64x100_{notation.replace('/', '_')}.pgm")
        if (out / "64x64x100.pgm").read_bytes() != golden.read_bytes():
            raise AssertionError(f"64² {notation}: PGM differs from {golden.name}")
        phase("main-gens-64", f"run(Params 64x64, {notation}, 100 turns) "
                              f"byte-equal to {golden.name}")


def main_gens_512(tmp: pathlib.Path) -> int:
    """Phase 5c: run(Params) on fixtures/images/512x512.pgm, B2/S/C3,
    100 turns, headless through kernel C, against the same run on the
    plain planes (backend "packed") on the card: PGM, FinalTurnComplete
    (state-1 cells) and the last (turn, alive count) pair equal, and
    every AliveCellsCount equal to the plain planes' count at its turn.
    The run ends in well under a tick, so the ticker may emit no event;
    the last pair is the one it would report, read from the engine."""
    from gol_tpu_torch import AliveCellsCount, FinalTurnComplete, Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitgens, bitlife
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.parallel import make_stepper

    rule, turns = "B2/S/C3", 100
    ref = make_stepper(height=512, width=512, rule=rule, backend="packed")
    q = ref.put(read_pgm(FIXTURES / "images/512x512.pgm"))
    counts = [int(bitlife.count_packed(q[0]).item())]
    for _ in range(turns):
        q = bitgens.step_packed_gens(q, get_rule(rule))
        counts.append(int(bitlife.count_packed(q[0]).item()))
    runs = {}
    for backend in ("auto", "packed"):
        out = tmp / f"gens512-{backend}"
        params = Params(image_width=512, image_height=512, turns=turns,
                        rule=rule, chunk=0, backend=backend,
                        tick_seconds=0.001,
                        image_dir=str(FIXTURES / "images"), out_dir=str(out))
        name = make_stepper(height=512, width=512, rule=rule,
                            backend=backend).name
        if backend == "auto":
            if name != "generations-cuda-packed-1":
                raise AssertionError(f"auto Generations stepper at 512² is {name}")
            for k in cg.LAUNCHES:
                cg.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        engine = Engine(params, emit_flips=False).start()
        evs = drain(engine.events)
        wall = time.perf_counter() - t0
        engine.join(timeout=60)
        last = engine.alive_count_now()
        if backend == "auto":
            launches = cg.LAUNCHES["bitgens_resident"]
        final = [e for e in evs if isinstance(e, FinalTurnComplete)]
        ticks = [(e.completed_turns, e.cells_count) for e in evs
                 if isinstance(e, AliveCellsCount)]
        if not final or final[0].completed_turns != turns:
            raise AssertionError(f"512² gens {backend}: no FinalTurnComplete")
        if len(final[0].alive) != counts[turns]:
            raise AssertionError(
                f"512² gens {backend}: {len(final[0].alive)} alive in "
                f"FinalTurnComplete, the plain planes have {counts[turns]}")
        if any(c != counts[t] for t, c in ticks + [last]):
            raise AssertionError(f"512² gens {backend}: AliveCellsCount "
                                 f"{ticks}, last pair {last} against the "
                                 "plain planes")
        runs[backend] = ((out / f"512x512x{turns}.pgm").read_bytes(),
                         sorted(map(tuple, final[0].alive)), last)
        phase("main-gens-512", f"run(Params 512x512, {rule}, {turns} turns, "
                               f"{name}): {counts[turns]} alive, "
                               f"{len(ticks)} AliveCellsCount events, last "
                               f"pair {last}, {wall:.3f} s wall")
    if runs["auto"] != runs["packed"]:
        raise AssertionError("512² gens: kernel run and plain-planes run differ")
    if launches <= 0:
        raise AssertionError("the 512² Generations path never launched "
                             "bitgens_resident")
    phase("main-gens-512", f"PGM and FinalTurnComplete equal to the plain "
                           f"planes run; {launches} bitgens_resident launches")
    return launches


def main_gens_16384(tmp: pathlib.Path, card: str) -> int:
    """Phase 5d: run(Params) at 16384², B2/S/C3, through kernel D,
    against the plain planes stepped on the card from the same board."""
    import numpy as np

    import gol_tpu_torch
    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import life
    from gol_tpu_torch.parallel import make_stepper

    side, turns, rule = 16384, 256, "B2/S/C3"
    world = life.random_world(side, side, seed=0)
    out = tmp / "gens16384"
    params = Params(image_width=side, image_height=side, turns=turns,
                    rule=rule, chunk=0, out_dir=str(out))
    for k in cg.LAUNCHES:
        cg.LAUNCHES[k] = 0
    t0 = time.time()
    timed = drain_timed(gol_tpu_torch.run(params, emit_flips=False,
                                          initial_world=world))
    wall = time.time() - t0
    launches = cg.LAUNCHES["bitgens_tiled"]
    split = wall_split(t0, timed)
    if launches <= 0:
        raise AssertionError("the 16384² Generations path never launched "
                             "bitgens_tiled")
    final = [e for _, e in timed if isinstance(e, FinalTurnComplete)]
    if not final or final[0].completed_turns != turns:
        raise AssertionError("16384² gens: no FinalTurnComplete at the last turn")
    ref = make_stepper(height=side, width=side, rule=rule, backend="packed")
    q, count = ref.step_n(ref.put(world), turns)
    REUSE["gens"] = (world, q)  # phase main-ring-16384's reference
    want = ref.fetch(q)
    got = read_pgm(out / f"{side}x{side}x{turns}.pgm")
    if not np.array_equal(got, want):
        raise AssertionError("16384² gens: final board differs from the plain planes")
    alive = int(count.item())
    if len(final[0].alive) != alive:
        raise AssertionError("16384² gens: FinalTurnComplete alive set differs")
    phase("main-gens-16384", f"run(Params {side}x{side}, {rule}, {turns} turns) "
                             f"equal to the plain planes, {alive} alive; "
                             f"{turns / wall:.2f} turns/s, "
                             f"{side * side * turns / wall / 1e9:.3f} Gcells/s "
                             f"end to end ({wall:.2f} s wall: {split}); "
                             f"{launches} bitgens_tiled launches on {card}")
    return launches


def main_dense_512(tmp: pathlib.Path) -> int:
    """Phase 5e: run(Params 512², backend "cuda-dense", 100 turns): the
    PGM byte-equal to the golden board, every turn through kernel E, in
    the plan's count of launches."""
    import gol_tpu_torch
    from gol_tpu_torch import Params
    from gol_tpu_torch.ops import cuda_life as cl
    from gol_tpu_torch.parallel import make_stepper

    name = make_stepper(height=512, width=512, backend="cuda-dense").name
    if name != "single-cuda-dense":
        raise AssertionError(f"cuda-dense stepper is {name}")
    out = tmp / "dense512"
    params = Params(image_width=512, image_height=512, turns=100, chunk=0,
                    backend="cuda-dense", image_dir=str(FIXTURES / "images"),
                    out_dir=str(out))
    cl.LAUNCHES["life_dense"] = 0
    t0 = time.perf_counter()
    drain(gol_tpu_torch.run(params, emit_flips=False))
    wall = time.perf_counter() - t0
    launches = cl.LAUNCHES["life_dense"]
    golden = (FIXTURES / "check/images/512x512x100.pgm").read_bytes()
    if (out / "512x512x100.pgm").read_bytes() != golden:
        raise AssertionError("512² cuda-dense: PGM differs from the fixture")
    # The engine's two chunks, 64 and 36 turns, each ⌈n/k⌉ passes.
    k = cl._dense_plan(512, 512)[4]
    plan_launches = -(-64 // k) + -(-36 // k)
    if launches != plan_launches:
        raise AssertionError(f"the cuda-dense path launched life_dense "
                             f"{launches} times, the plan {plan_launches}")
    phase("main-dense-512", f"run(Params 512x512, backend cuda-dense, 100 "
                            f"turns) byte-equal to the fixture; {launches} "
                            f"life_dense launches (k = {k}), {wall:.3f} s "
                            f"wall")
    return launches


def normalize(evs) -> list:
    """Package-neutral event tuples, as `tests/test_torch_engine.py`'s
    `normalize` gives them, with FlipBatch and FlipChunk payloads
    (AliveCellsCount is timing-dependent and left out)."""
    import numpy as np

    out = []
    for e in evs:
        name = type(e).__name__
        if name == "AliveCellsCount":
            continue
        if name == "CellFlipped":
            payload = tuple(e.cell)
        elif name == "FinalTurnComplete":
            payload = tuple(map(tuple, e.alive))
        elif name == "ImageOutputComplete":
            payload = e.filename
        elif name == "StateChange":
            payload = e.new_state.name
        elif name == "FlipBatch":
            payload = (np.asarray(e.cells).tolist(),
                       None if e.levels is None
                       else np.asarray(e.levels).tolist())
        elif name == "FlipChunk":
            payload = (e.first_turn, np.asarray(e.counts).tolist(),
                       np.asarray(e.bitmaps).tolist(),
                       np.asarray(e.words).tolist())
        else:
            payload = None
        out.append((name, e.completed_turns, payload))
    return out


def engine_counters() -> dict:
    """The engine's watched-path series: dispatches by kind, sparse and
    compact chunks and redos, and the seconds of each leg of the
    device-vs-host split."""
    from gol_tpu_torch import obs
    from gol_tpu_torch.engine.distributor import _METRICS as m

    out = {f"dispatches[{k}]": c.value for k, c in m.dispatches.items()}
    for k in ("sparse_chunks", "compact_chunks", "sparse_redos",
              "compact_redos"):
        out[k] = getattr(m, k).value
    for ph in ("enqueue", "sync", "host"):
        out[f"split {ph} s"] = obs.histogram(
            "gol_tpu_device_dispatch_split_seconds",
            labels={"phase": ph}).snapshot_value()["sum"]
    return out


def moved(before: dict) -> dict:
    """The series of `engine_counters` that moved since `before`."""
    after = engine_counters()
    return {k: round(after[k] - v, 6) for k, v in before.items()
            if after[k] != v}


def run_engine(params, per_turn: bool = False, total_cap=None, **kw):
    """(events, wall seconds, engine series that moved) of one Engine run
    on the card. `per_turn` removes the stepper's diff entries
    (`dataclasses.replace`), so the engine takes the per-turn path;
    `total_cap` forces the compact chunks' value buffer."""
    import dataclasses

    from gol_tpu_torch.engine.distributor import Engine

    engine = Engine(params, **kw)
    if per_turn:
        engine.stepper = dataclasses.replace(engine.stepper,
                                             step_n_with_diffs=None)
    if total_cap is not None:
        engine._compact_total_cap = lambda k: total_cap
    before = engine_counters()
    t0 = time.perf_counter()
    engine.start()
    evs = drain(engine.events)
    wall = time.perf_counter() - t0
    engine.join(timeout=60)
    if engine.error is not None:
        raise engine.error
    return evs, wall, moved(before)


def check_diffs() -> dict:
    """Phase `diffs`: every diff entry of the CUDA steppers on the card —
    Life 512² (kernel A) and 4096² (kernel B), B2/S/C3 512² (kernel C)
    and 4096² (kernel D), `cuda-dense` 512² (kernel E), k in {1, 7, 64},
    sparse and compact caps that fit and that overflow. Rows, headers
    and values byte-identical to the same entry of the plain stepper on
    the card; decoded masks equal to a per-turn `step_with_diff` walk;
    final worlds and counts equal; each scan launching its kernel once a
    turn (LAUNCHES). Returns each kernel's launches in the phase."""
    import numpy as np
    import torch

    from gol_tpu_torch.ops import bitlife, life
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl
    from gol_tpu_torch.parallel import make_stepper
    from gol_tpu_torch.parallel.stepper import (
        compact_decode_rows,
        compact_value_prefix,
        sparse_decode_rows,
    )

    def host(t):
        a = t.cpu().numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a

    cases = [  # kernel, its counts, rule, side, backend, plain backend
        ("bitlife_resident", cb.LAUNCHES, "B3/S23", 512, "cuda-packed",
         "packed"),
        ("bitlife_tiled", cb.LAUNCHES, "B3/S23", 4096, "cuda-packed",
         "packed"),
        ("bitgens_resident", cg.LAUNCHES, "B2/S/C3", 512, "cuda-packed",
         "packed"),
        ("bitgens_tiled", cg.LAUNCHES, "B2/S/C3", 4096, "cuda-packed",
         "packed"),
        ("life_dense", cl.LAUNCHES, "B3/S23", 512, "cuda-dense", "dense"),
    ]
    ks = (1, 7, 64)
    launches, checked = {}, 0
    for name, counts, rule, side, backend, plain_backend in cases:
        st = make_stepper(height=side, width=side, rule=rule,
                          backend=backend)
        ref = make_stepper(height=side, width=side, rule=rule,
                           backend=plain_backend)
        world = life.random_world(side, side, seed=side)
        w0, r0 = st.put(world), ref.put(world)
        packed = st.offers("packed_diffs")
        total_words = side // 32 * side
        # The per-turn walk's masks, packed words where the rows are.
        walk, q = [], w0
        for _ in range(max(ks)):
            q, mask, _ = st.step_with_diff(q)
            walk.append(host(bitlife.pack(mask)) if packed else host(mask))
        launches[name] = 0

        def scan(entry, k, *args):
            counts[name] = 0
            got = getattr(st, entry)(w0, k, *args)
            torch.cuda.synchronize()
            if counts[name] != k:
                raise AssertionError(
                    f"diffs {name} {entry} k={k}: {counts[name]} launches, "
                    f"{k} turns scanned")
            launches[name] += counts[name]
            want = getattr(ref, entry)(r0, k, *args)
            if not torch.equal(got[0], want[0]) or int(got[-1]) != int(want[-1]):
                raise AssertionError(f"diffs {name} {entry} k={k}: final "
                                     "world or count differs from plain")
            for a, b in zip(got[1:-1], want[1:-1]):
                if a.dtype != b.dtype or not np.array_equal(host(a), host(b)):
                    raise AssertionError(f"diffs {name} {entry} k={k} "
                                         f"{args}: rows differ from plain")
            return [host(x) for x in got[1:-1]]

        def same(words, t, what):
            want = walk[t].reshape(-1)
            if not np.array_equal(np.asarray(words).reshape(-1), want):
                raise AssertionError(f"diffs {name} {what} turn {t}: "
                                     "decoded mask differs from the walk")

        for k in ks:
            (stack,) = scan("step_n_with_diffs", k)
            for t in range(k):
                same(stack[t], t, f"dense k={k}")
            checked += 1
            if not packed:
                continue
            for cap in (total_words, 16):
                (rows,) = scan("step_n_with_diffs_sparse", k, cap)
                if cap == 16:
                    if int(rows[:, 0].max()) <= cap:
                        raise AssertionError(f"diffs {name}: cap 16 fits")
                    continue
                for t, words in enumerate(sparse_decode_rows(rows,
                                                             total_words)):
                    same(words, t, f"sparse k={k} cap={cap}")
                checked += 1
            for cap in (k * total_words, 16):
                hdr, vals = scan("step_n_with_diffs_compact", k, cap)
                total = int(hdr[:, 0].sum())
                if cap == 16:
                    if total <= cap:
                        raise AssertionError(f"diffs {name}: cap 16 fits")
                    continue
                prefix = compact_value_prefix(vals, total)
                for t, words in enumerate(compact_decode_rows(
                        hdr, prefix, total_words)):
                    same(words, t, f"compact k={k} cap={cap}")
                checked += 1
        del st, ref, w0, r0, walk, q
        torch.cuda.empty_cache()
        phase("diffs", f"{name} ({rule} {side}x{side}, {backend}): every "
                       f"diff entry at k {ks} byte-identical to the plain "
                       f"stepper ({plain_backend}) and to the per-turn walk; "
                       f"{launches[name]} {name} launches (LAUNCHES), one a "
                       f"scanned turn")
    phase("diffs", f"{checked} decoded scans equal to the walk; launches "
                   f"{launches}")
    return launches


def write_world(path: pathlib.Path, world) -> None:
    from gol_tpu_torch.io.pgm import write_pgm

    path.parent.mkdir(parents=True, exist_ok=True)
    write_pgm(path, world)


def glider_world(side: int):
    """A sparse board — two gliders and a blinker (gol_tpu's
    `tests/test_diffs.py` glider board) — whose per-turn activity is a
    few dozen words, the steady state of the compact chunks."""
    import numpy as np

    world = np.zeros((side, side), np.uint8)
    for dx, dy in ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2)):
        world[4 + dy, 4 + dx] = 255
        world[40 + dy, 40 + dx] = 255
    world[20, 20:23] = 255
    return world


def main_watched_512(tmp: pathlib.Path) -> int:
    """Phase `main-watched-512`: run(Params 512x512, 100 turns) with
    flips on the headline fixture through the diff chunks (kernel A, one
    launch a turn): its normalized stream identical to the per-turn
    path's, its PGM byte-equal to the fixture; then a 512² glider board
    that engages the compact chunks, and the same run with the value
    buffer forced to 4 words, which redoes — both streams identical to
    the per-turn path's."""
    import dataclasses

    import gol_tpu_torch
    from gol_tpu_torch import Params
    from gol_tpu_torch.ops import cuda_bitlife as cb

    golden = (FIXTURES / "check/images/512x512x100.pgm").read_bytes()
    params = Params(image_width=512, image_height=512, turns=100, chunk=0,
                    image_dir=str(FIXTURES / "images"),
                    out_dir=str(tmp / "w512"))
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    before = engine_counters()
    t0 = time.perf_counter()
    evs = drain(gol_tpu_torch.run(params))
    wall = time.perf_counter() - t0
    launches = cb.LAUNCHES["bitlife_resident"]
    series = moved(before)
    if (tmp / "w512/512x512x100.pgm").read_bytes() != golden:
        raise AssertionError("watched 512²: PGM differs from the fixture")
    if launches != params.turns:
        raise AssertionError(f"watched 512²: {launches} bitlife_resident "
                             f"launches for {params.turns} turns")
    ref, ref_wall, ref_series = run_engine(
        dataclasses.replace(params, out_dir=str(tmp / "w512-per-turn")),
        per_turn=True)
    if normalize(evs) != normalize(ref):
        raise AssertionError("watched 512²: stream differs from the "
                             "per-turn path's")
    phase("main-watched-512", f"run(Params 512x512, 100 turns, flips) "
                              f"byte-equal to the fixture, stream identical "
                              f"to the per-turn path ({len(normalize(evs))} "
                              f"events); {wall:.3f} s wall (per-turn path "
                              f"{ref_wall:.3f} s); {launches} "
                              f"bitlife_resident launches; {series}; "
                              f"per-turn path {ref_series}")
    write_world(tmp / "gliders/512x512.pgm", glider_world(512))
    glide = Params(image_width=512, image_height=512, turns=100, chunk=16,
                   image_dir=str(tmp / "gliders"),
                   out_dir=str(tmp / "g512"))
    want = normalize(run_engine(glide, per_turn=True)[0])
    for what, cap, key in (("compact", None, "compact_chunks"),
                           ("forced overflow", 4, "compact_redos")):
        evs, wall, series = run_engine(glide, total_cap=cap)
        if normalize(evs) != want:
            raise AssertionError(f"watched 512² gliders, {what}: stream "
                                 "differs from the per-turn path's")
        if series.get(key, 0) <= 0:
            raise AssertionError(f"watched 512² gliders, {what}: {key} "
                                 f"did not rise ({series})")
        phase("main-watched-512", f"512² gliders x100 turns (chunk 16), "
                                  f"{what}: stream identical to the "
                                  f"per-turn path; {wall:.3f} s wall; "
                                  f"{series}")
    return launches


def main_watched_gens_512(tmp: pathlib.Path) -> int:
    """Phase `main-watched-gens-512`: run(Params 512x512, B2/S/C3, 100
    turns) with level-mode FlipBatches (kernel C, one launch a turn):
    its stream identical to the per-turn path's, the same PGM."""
    import dataclasses

    import gol_tpu_torch
    from gol_tpu_torch import FlipBatch, Params
    from gol_tpu_torch.ops import cuda_bitgens as cg

    params = Params(image_width=512, image_height=512, turns=100,
                    rule="B2/S/C3", chunk=0,
                    image_dir=str(FIXTURES / "images"),
                    out_dir=str(tmp / "wg512"))
    for k in cg.LAUNCHES:
        cg.LAUNCHES[k] = 0
    before = engine_counters()
    t0 = time.perf_counter()
    evs = drain(gol_tpu_torch.run(params, emit_flip_batches=True))
    wall = time.perf_counter() - t0
    launches = cg.LAUNCHES["bitgens_resident"]
    series = moved(before)
    if launches != params.turns:
        raise AssertionError(f"watched gens 512²: {launches} "
                             f"bitgens_resident launches for "
                             f"{params.turns} turns")
    if not all(e.levels is not None for e in evs
               if isinstance(e, FlipBatch)):
        raise AssertionError("watched gens 512²: FlipBatch without levels")
    ref, ref_wall, _ = run_engine(
        dataclasses.replace(params, out_dir=str(tmp / "wg512-per-turn")),
        per_turn=True, emit_flip_batches=True)
    if normalize(evs) != normalize(ref):
        raise AssertionError("watched gens 512²: FlipBatch stream differs "
                             "from the per-turn path's")
    if ((tmp / "wg512/512x512x100.pgm").read_bytes()
            != (tmp / "wg512-per-turn/512x512x100.pgm").read_bytes()):
        raise AssertionError("watched gens 512²: PGM differs from the "
                             "per-turn path's")
    batches = sum(isinstance(e, FlipBatch) for e in evs)
    phase("main-watched-gens-512", f"run(Params 512x512, B2/S/C3, 100 "
                                   f"turns, level-mode FlipBatch): {batches} "
                                   f"batches identical to the per-turn "
                                   f"path's; {wall:.3f} s wall (per-turn "
                                   f"path {ref_wall:.3f} s); {launches} "
                                   f"bitgens_resident launches; {series}")
    return launches


def glider_field(side: int, count: int, seed: int):
    """A {0,255} board of `count` gliders (a square number), one in each
    cell of a square grid at a random offset and heading."""
    import numpy as np

    rng = np.random.default_rng(seed)
    per = int(round(count ** 0.5))
    cell = side // per
    shape = np.zeros((3, 3), np.uint8)
    for dx, dy in ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2)):
        shape[dy, dx] = 255
    world = np.zeros((side, side), np.uint8)
    for i in range(per):
        for j in range(per):
            g = shape[::rng.choice((1, -1)), ::rng.choice((1, -1))]
            y = i * cell + int(rng.integers(0, cell - 3))
            x = j * cell + int(rng.integers(0, cell - 3))
            world[y:y + 3, x:x + 3] = g
    return world


def apply_chunks(board, chunks) -> None:
    """XOR every turn of `chunks` (FlipChunk events) into a flat uint32
    packed board: turn t's changed words sit at the set bits of its
    bitmap row, their masks in `words` in ascending word order."""
    import numpy as np

    for ch in chunks:
        counts = np.asarray(ch.counts)
        words = np.asarray(ch.words, np.uint32)
        off = 0
        for t, m in enumerate(counts):
            bits = np.unpackbits(np.ascontiguousarray(
                ch.bitmaps[t], np.uint32).view(np.uint8), bitorder="little")
            idx = np.flatnonzero(bits)
            if idx.size != int(m):
                raise AssertionError("FlipChunk: bitmap and count disagree")
            board[idx] ^= words[off:off + int(m)]
            off += int(m)


def main_watched_16384(tmp: pathlib.Path, card: str) -> int:
    """Phase `main-watched-16384`: a 16384² board of 1024 gliders from a
    fixed seed, 128 turns, with FlipBatches and FlipChunks (kernel B,
    one launch a turn) — the stream a server sends for a large, quiet
    universe. The FlipChunk payloads applied to the initial packed board
    on the host equal the final world of a headless step_n on the same
    board; the compact chunks engaged."""
    import numpy as np
    import torch

    import gol_tpu_torch
    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.events import FlipChunk
    from gol_tpu_torch.engine.distributor import _METRICS
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel import make_stepper

    side, turns = 16384, 128
    world = glider_field(side, 1024, seed=16384)
    params = Params(image_width=side, image_height=side, turns=turns,
                    chunk=0, out_dir=str(tmp / "w16384"))
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    before = engine_counters()
    t0 = time.time()
    timed = drain_timed(gol_tpu_torch.run(params, initial_world=world,
                                          emit_flip_batches=True,
                                          emit_flip_chunks=True))
    wall = time.time() - t0
    launches = cb.LAUNCHES["bitlife_tiled"]
    evs = [ev for _, ev in timed]
    split = wall_split(t0, timed)
    series = moved(before)
    chunks = [e for e in evs if isinstance(e, FlipChunk)]
    sizes = sorted({e.completed_turns - e.first_turn + 1 for e in chunks})
    if launches != turns:
        raise AssertionError(f"watched 16384²: {launches} bitlife_tiled "
                             f"launches for {turns} turns")
    if series.get("compact_chunks", 0) <= 0:
        raise AssertionError(f"watched 16384²: no compact chunk ({series})")
    board = bitlife.pack_np(world).reshape(-1)
    apply_chunks(board, chunks)
    ref = make_stepper(height=side, width=side)
    q, count = ref.step_n(ref.put(world), turns)
    want = q.cpu().numpy().view(np.uint32).reshape(-1)
    if not np.array_equal(board, want):
        raise AssertionError("watched 16384²: FlipChunks applied to the "
                             "initial board differ from the headless run")
    final = [e for e in evs if isinstance(e, FinalTurnComplete)]
    if not final or len(final[0].alive) != int(count.item()):
        raise AssertionError("watched 16384²: FinalTurnComplete differs")
    del q, ref
    torch.cuda.empty_cache()
    phase("main-watched-16384", f"run(Params 16384x16384, 1024 gliders, "
                                f"{turns} turns, FlipBatch + FlipChunk): "
                                f"{len(chunks)} FlipChunks of {sizes} turns "
                                f"applied to the initial board equal the "
                                f"headless run ({int(count.item())} alive); "
                                f"{wall:.2f} s wall ({split}); {launches} "
                                f"bitlife_tiled launches; compact_ratio "
                                f"{_METRICS.compact_ratio.value}; {series}; "
                                f"{card}")
    return launches


#: Tile sides of the tiled stepper's ext blocks checked against the
#: batched plain step: one-row slabs of 3 and 4 blocks (32, 64), the
#: watched path's 6 x 3 rows (512), the main path's 2 x 17 rows (1024)
#: and 6 x 11 rows (2048).
BATCH_TILES = (32, 64, 512, 1024, 2048)
#: Stack sizes of that check: one block, a few, and up to a whole 8 x 8
#: tile grid (the most one slab of `main-watched-tiled` can hold).
BATCH_SIZES = (1, 3, 16, 64)
#: The centred soup of the tiled phases (bench.py's activity lane).
SOUP_SIDE, SOUP_DENSITY, SOUP_SEED = 512, 0.35, 7
#: Board sides of the phases `tiled` (bench.py's activity lane),
#: `main-tiled-16384`, `main-watched-tiled` and the tiled `cli` run.
TILED_AB_SIDE, MAIN_TILED_SIDE, WATCHED_TILED_SIDE = 32768, 16384, 4096


def ext_shape(tile: int) -> tuple:
    """(word-rows, columns) of a tile's ghost-extended block at g = 1."""
    return tile // 32 + 2, tile + 64


def check_batch_kernel(errs: dict) -> dict:
    """Phase `kernels`, batched kernel A: the ext blocks of tiles 32, 64,
    512, 1024 and 2048 in stacks of 1, 3, 16 and 64, k = 1, 31 and 32,
    Life and B36/S23 (the masks form), bit-exact against the batched
    plain step, one launch a stack; and tile 4096, whose block no
    cluster plan fits, through kernel B's 2-D entry, one launch a
    block. Returns the plans."""
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel import tiled

    gen = torch.Generator().manual_seed(11)
    rules = [get_rule("B3/S23"), get_rule("B36/S23")]
    plans, checked = {}, 0
    for tile in BATCH_TILES:
        rows, cols = ext_shape(tile)
        if tiled.slab_route(tile) != "resident":
            raise AssertionError(f"tile {tile}: no kernel-A cluster plan")
        plans[tile] = cb._resident_args(rows, cols, 2)
        for b in BATCH_SIZES:
            stack = torch.randint(-2**31, 2**31 - 1, (b, rows, cols),
                                  dtype=torch.int32, generator=gen).cuda()
            for rule in rules:
                want = plain_turns(
                    lambda x, k: bitlife.step_n_packed_raw(x, k, rule),
                    stack, (1, 31, 32))
                for k in (1, 31, 32):
                    before = cb.LAUNCHES["bitlife_resident"]
                    got = cb.step_n_packed_batch_cuda_raw(stack, k, rule)
                    torch.cuda.synchronize()
                    if cb.LAUNCHES["bitlife_resident"] - before != 1:
                        raise AssertionError("a batch is not one launch")
                    err = max_abs_err(got, want[k])
                    errs["bitlife_resident_batch"] = max(
                        errs["bitlife_resident_batch"], err)
                    if err:
                        raise AssertionError(
                            f"bitlife_resident batch {b} x {rows}x{cols} "
                            f"k={k} {rule}: mismatch")
                    checked += 1
    if [plans[t][0] for t in (32, 64)] != [3, 4] or plans[32][1] != 1:
        raise AssertionError(f"tiles 32 and 64 are not one-row slabs: {plans}")
    rows, cols = ext_shape(4096)
    if tiled.slab_route(4096) != "tiled2d":
        raise AssertionError("tile 4096 has a kernel-A plan")
    stack = torch.randint(-2**31, 2**31 - 1, (3, rows, cols),
                          dtype=torch.int32, generator=gen).cuda()
    for rule in rules:
        for k in (1, 31, 32):
            want = bitlife.step_n_packed_raw(stack, k, rule)
            before = cb.LAUNCHES["bitlife_tiled"]
            got = torch.stack([cb.step_n_packed_tiled2d_raw(s, k, rule)
                               for s in stack])
            torch.cuda.synchronize()
            if cb.LAUNCHES["bitlife_tiled"] - before != len(stack):
                raise AssertionError("kernel B is not one launch a block")
            err = max_abs_err(got, want)
            errs["bitlife_tiled"] = max(errs["bitlife_tiled"], err)
            if err:
                raise AssertionError(f"bitlife_tiled 4096 ext block k={k} "
                                     f"{rule}: mismatch")
            checked += 1
    phase("kernels", f"{checked} batched runs bit-exact against the batched "
                     f"plain step (ext blocks of tiles {BATCH_TILES} in "
                     f"stacks of {BATCH_SIZES}, k = 1, 31, 32, and tile "
                     f"4096's {rows}x{cols} block through kernel B, one "
                     f"launch a block); kernel A's (blocks, slab_rows, "
                     f"halo, threads, seg_rows) by tile {plans}")
    return plans


def soup_world(side: int):
    """A {0,255} side² board, empty but for a centred SOUP_SIDE² soup at
    SOUP_DENSITY from SOUP_SEED (the parameters of bench.py's activity
    lane, `measure_activity`)."""
    import numpy as np

    rng = np.random.default_rng(SOUP_SEED)
    board = np.zeros((side, side), np.uint8)
    r0 = (side - SOUP_SIDE) // 2
    board[r0:r0 + SOUP_SIDE, r0:r0 + SOUP_SIDE] = (
        (rng.random((SOUP_SIDE, SOUP_SIDE)) < SOUP_DENSITY) * 255
    ).astype(np.uint8)
    return board


def tiled_activity() -> dict:
    """The tiled stepper's activity series, and kernel A's launches."""
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel.tiled import _METRICS as m

    return {"tile_steps": m.tile_steps.value, "tile_rides": m.tile_rides.value,
            "tile_skips": m.tile_skips.value,
            "dispatches": m.dispatches.value,
            "paged_in": m.paged["in"].value, "paged_out": m.paged["out"].value,
            "launches": cb.LAUNCHES["bitlife_resident"]}


def tiled_ab(card: str, int_ops_per_s: float) -> dict:
    """Phase `tiled`: the tiled stepper (T = 1024) against the dense
    `cuda-packed` stepper (kernel B's 2-D entry) on bench.py's activity
    lane — a 32768² board, empty but for a centred 512² soup, 64 turns in
    32-turn chunks, each chunk's count realized. The packed words and the
    counts are bit-identical. Prints both turn rates and the speedup
    without the first chunk, the activity accounting, the slab launch's
    device time against its bound, and one chunk's wall split."""
    import numpy as np
    import torch

    from gol_tpu_torch.parallel import make_stepper
    from gol_tpu_torch.parallel.tiled import _METRICS as m

    side, tile, turns, chunk = TILED_AB_SIDE, 1024, 64, 32
    board = soup_world(side)

    def run(stepper):
        t0 = time.perf_counter()
        world = stepper.put(board)
        put_s = time.perf_counter() - t0
        per_chunk, count, splits = [], 0, []
        for _ in range(turns // chunk):
            steps = m.tile_steps.value
            t0 = time.perf_counter()
            world, count = stepper.step_n(world, chunk)
            count = int(count)
            per_chunk.append(time.perf_counter() - t0)
            if stepper.tiled is not None:
                splits.append({**stepper.tiled.last_split,
                               "blocks": m.tile_steps.value - steps})
        rate = (turns - chunk) / sum(per_chunk[1:])
        return world, count, rate, per_chunk, put_s, splits

    dense = make_stepper(height=side, width=side, backend="cuda-packed")
    dw, dcount, dense_tps, dense_chunks, dense_put, _ = run(dense)
    dense_words = dw.cpu().numpy().view(np.uint32)
    del dw, dense
    torch.cuda.empty_cache()
    before = tiled_activity()
    tiled = make_stepper(height=side, width=side, tile=tile)
    tiled.tiled.time_split = True
    tw, tcount, tiled_tps, tiled_chunks, tiled_put, splits = run(tiled)
    acts = {k: v - before[k] for k, v in tiled_activity().items()}
    impl = tiled.tiled
    if tcount != dcount or not np.array_equal(tw.words, dense_words):
        raise AssertionError(f"tiled {side}²: the tiled world differs from "
                             "the dense cuda-packed stepper's")
    if impl.route != "resident" or acts["launches"] != acts["dispatches"]:
        raise AssertionError(f"tiled {side}²: {acts['launches']} batched "
                             f"kernel-A launches for {acts['dispatches']} slab "
                             f"dispatches (route {impl.route})")
    p = torch.zeros((32, 64), dtype=torch.int32).cuda()
    life_ops = life_fewest_instructions(p)[1]
    slab = int(m.resident.value)
    rows, cols = impl.ext_h, impl.ext_w
    last = splits[-1]
    blocks = int(last.pop("blocks"))
    words = blocks * rows * cols
    b_ms, b_by = bound_ms(2 * 4 * words, words * chunk * life_ops,
                          int_ops_per_s)
    launch_ms = last["launch"] * 1e3
    split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in last.items())
    phase("tiled", f"{side}² board, centred 512² soup at 0.35 (seed 7), T = "
                   f"{tile}, {turns} turns in {chunk}-turn chunks: tiled "
                   f"world and count ({tcount}) bit-identical to the dense "
                   f"cuda-packed stepper's; {tiled_tps:.2f} turns/s tiled "
                   f"against {dense_tps:.2f} dense after the first chunk "
                   f"(x{tiled_tps / dense_tps:.2f}); chunks {tiled_chunks} s "
                   f"against {dense_chunks} s; put {tiled_put:.3f} s against "
                   f"{dense_put:.3f} s; on {card}")
    phase("tiled", f"activity: {impl.gr * impl.gc} tiles, {int(m.active.value)} "
                   f"active in the last chunk, {acts['tile_steps']} tile steps, "
                   f"{acts['tile_rides']} rides, {acts['tile_skips']} skips; "
                   f"paged {acts['paged_in']} B in, {acts['paged_out']} B out; "
                   f"slab capacity {slab} (max_resident {impl.max_resident}); "
                   f"{acts['launches']} batched kernel-A launches for "
                   f"{acts['dispatches']} gol_tpu_tiled_dispatches_total")
    phase("tiled", f"last chunk's slab launch {launch_ms:.4f} ms (CUDA events) "
                   f"for {blocks} blocks of {rows}x{cols} "
                   f"words x {chunk} turns, bound {b_ms:.4f} ms ({b_by}); "
                   f"its wall split (ms): {split}")
    return {"tiled_tps": tiled_tps, "dense_tps": dense_tps,
            "launch_ms": launch_ms, "bound_ms": b_ms, "split": last,
            "acts": acts}


def main_tiled_16384(tmp: pathlib.Path, card: str) -> tuple:
    """Phase `main-tiled-16384`: run(Params 16384², tile 1024, 256 turns,
    cycle_detect on) headless through the engine, on a board empty but
    for the centred soup: the engine's cycle detectors are off, the
    batched kernel A launched, and the PGM and the FinalTurnComplete
    alive set equal the `cuda-packed` stepper's. Returns (kernel A's
    launches, the slab capacity)."""
    import numpy as np

    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel import make_stepper
    from gol_tpu_torch.utils.cell import cells_from_mask

    side, tile, turns = MAIN_TILED_SIDE, 1024, 256
    world = soup_world(side)
    params = Params(image_width=side, image_height=side, turns=turns,
                    chunk=0, tile=tile, cycle_detect=True,
                    out_dir=str(tmp / "t16384"))
    engine = Engine(params, emit_flips=False, initial_world=world)
    if engine._cycles is not None or engine._ride_cycles is not None:
        raise AssertionError(f"tiled {side}²: a cycle detector is on")
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    before = tiled_activity()
    t0 = time.time()
    engine.start()
    timed = drain_timed(engine.events)
    wall = time.time() - t0
    engine.join(timeout=60)
    if engine.error is not None:
        raise engine.error
    launches = dict(cb.LAUNCHES)
    acts = {k: v - before[k] for k, v in tiled_activity().items()}
    split = wall_split(t0, timed)
    if launches["bitlife_resident"] <= 0 or launches["bitlife_tiled"]:
        raise AssertionError(f"tiled {side}²: launches {launches}")
    final = [e for _, e in timed if isinstance(e, FinalTurnComplete)]
    ref = make_stepper(height=side, width=side)
    q, count = ref.step_n(ref.put(world), turns)
    want = ref.fetch(q)
    got = read_pgm(tmp / f"t16384/{side}x{side}x{turns}.pgm")
    if not np.array_equal(got, want):
        raise AssertionError(f"tiled {side}²: PGM differs from cuda-packed's")
    if not final or final[0].alive != cells_from_mask(want):
        raise AssertionError(f"tiled {side}²: FinalTurnComplete differs")
    impl = engine.stepper.tiled
    phase("main-tiled-16384", f"run(Params {side}x{side}, tile {tile}, {turns} "
                              f"turns, cycle_detect) headless: PGM and "
                              f"FinalTurnComplete ({int(count)} alive) equal "
                              f"the cuda-packed stepper's; cycle detectors "
                              f"off; {launches['bitlife_resident']} batched "
                              f"kernel-A launches; {acts}; slab capacity "
                              f"{impl.activity()['pool_cap']}; {wall:.2f} s "
                              f"wall ({split}) on {card}")
    return launches["bitlife_resident"], impl.activity()["pool_cap"]


def chunk_flips(evs, width: int) -> list:
    """(turn, sorted flat indices y * width + x of the turn's flips) of
    every turn of a run's FlipChunks or FlipBatches, in turn order — the
    two forms of one watched stream."""
    import numpy as np

    from gol_tpu_torch.events import FlipBatch, FlipChunk

    out = []
    for e in evs:
        if isinstance(e, FlipBatch):
            xy = np.asarray(e.cells, np.int64).reshape(-1, 2)
            out.append((e.completed_turns,
                        np.sort(xy[:, 1] * width + xy[:, 0])))
        elif isinstance(e, FlipChunk):
            words = np.asarray(e.words, np.uint32)
            off = 0
            for i, m in enumerate(np.asarray(e.counts)):
                idx = np.flatnonzero(np.unpackbits(np.ascontiguousarray(
                    e.bitmaps[i], np.uint32).view(np.uint8), bitorder="little"))
                w = np.ascontiguousarray(words[off:off + int(m)])
                off += int(m)
                word, bit = np.nonzero(np.unpackbits(
                    w.view(np.uint8), bitorder="little").reshape(-1, 32))
                ys = idx[word] // width * 32 + bit
                out.append((e.first_turn + i,
                            np.sort(ys * width + idx[word] % width)))
    return out


def main_watched_tiled(tmp: pathlib.Path, card: str) -> int:
    """Phase `main-watched-tiled`: a 4096² board with a centred 1024² soup,
    T = 512, 64 turns, chunk 16, with FlipBatches and FlipChunks, through
    the engine's unpipelined `_run_diff_chunk` branch (the tiled stepper
    fetches its own diff stacks). Its FlipChunks decoded per turn equal
    the dense per-turn path's FlipBatches (cuda-packed, no diff entries),
    and its stream equals the dense diff-chunk path's event for event."""
    import numpy as np

    from gol_tpu_torch import Params, TurnComplete
    from gol_tpu_torch.events import FlipBatch, FlipChunk
    from gol_tpu_torch.ops import cuda_bitlife as cb

    side, tile, turns = WATCHED_TILED_SIDE, 512, 64
    rng = np.random.default_rng(SOUP_SEED)
    world = np.zeros((side, side), np.uint8)
    r0 = (side - 1024) // 2
    world[r0:r0 + 1024, r0:r0 + 1024] = (
        (rng.random((1024, 1024)) < SOUP_DENSITY) * 255).astype(np.uint8)
    kw = {"initial_world": world, "emit_flip_batches": True,
          "emit_flip_chunks": True}
    base = dict(image_width=side, image_height=side, turns=turns, chunk=16)
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    evs, wall, series = run_engine(
        Params(**base, tile=tile, out_dir=str(tmp / "wt-tiled")), **kw)
    launches = cb.LAUNCHES["bitlife_resident"]
    dense, dense_wall, dense_series = run_engine(
        Params(**base, out_dir=str(tmp / "wt-dense")), **kw)
    per_turn, turn_wall, _ = run_engine(
        Params(**base, out_dir=str(tmp / "wt-per-turn")), per_turn=True, **kw)
    if launches != turns or series.get("dispatches[diffs]") != turns // 16:
        raise AssertionError(f"watched tiled: {launches} batched launches, "
                             f"{series}")
    if normalize(evs) != normalize(dense):
        raise AssertionError("watched tiled: stream differs from the dense "
                             "diff-chunk path's")
    got, want = chunk_flips(evs, side), chunk_flips(per_turn, side)
    same = len(got) == len(want) and all(
        t == u and np.array_equal(a, b) for (t, a), (u, b) in zip(got, want))
    tails = [normalize([e for e in r if not isinstance(
                 e, (FlipBatch, FlipChunk, TurnComplete))])
             for r in (evs, per_turn)]
    if not same or tails[0] != tails[1]:
        raise AssertionError("watched tiled: flips differ from the per-turn "
                             "path's")
    n_chunks = sum(isinstance(e, FlipChunk) for e in evs)
    n_batches = sum(isinstance(e, FlipBatch) for e in per_turn)
    phase("main-watched-tiled", f"{side}² board, centred 1024² soup, T = {tile}, "
                                f"{turns} turns, chunk 16: {n_chunks} "
                                f"FlipChunks, event for event the dense "
                                f"diff-chunk path's, and per turn the dense "
                                f"per-turn path's {n_batches} FlipBatches; "
                                f"{launches} batched kernel-A launches; "
                                f"{wall:.3f} s wall (dense chunks "
                                f"{dense_wall:.3f} s, per-turn "
                                f"{turn_wall:.3f} s); engine series tiled "
                                f"{series}, dense {dense_series}; {card}")
    return launches


def cli_tiled(tmp: pathlib.Path, card: str) -> dict:
    """Phase `cli`, tiled: `python -m gol_tpu_torch --tile 1024 -noVis` and
    the same run untiled, 100 turns of a 4096² board holding the 512²
    fixture at its centre; both PGMs equal; the two walls."""
    import numpy as np

    from gol_tpu_torch.io.pgm import read_pgm

    side = WATCHED_TILED_SIDE
    board = np.zeros((side, side), np.uint8)
    r0 = (side - 512) // 2
    board[r0:r0 + 512, r0:r0 + 512] = read_pgm(FIXTURES / "images/512x512.pgm")
    write_world(tmp / "cli-tiled-images" / f"{side}x{side}.pgm", board)
    walls, pgms = {}, {}
    for kind, extra in (("tiled", ["--tile", "1024"]), ("untiled", [])):
        out = tmp / f"cli-{kind}"
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "-w", str(side), "-h",
             str(side), "-turns", "100", "-noVis", *extra, "--images",
             str(tmp / "cli-tiled-images"), "--out", str(out)],
            check=True, cwd=REPO, capture_output=True, timeout=300)
        walls[kind] = time.perf_counter() - t0
        pgms[kind] = (out / f"{side}x{side}x100.pgm").read_bytes()
    if pgms["tiled"] != pgms["untiled"]:
        raise AssertionError("CLI --tile 1024: PGM differs from the untiled run")
    phase("cli", f"python -m gol_tpu_torch -w {side} -h {side} -turns 100 "
                 f"-noVis --tile 1024 (the 512² fixture at the centre): PGM "
                 f"equal to the untiled run's; {walls['tiled']:.3f} s wall "
                 f"tiled, {walls['untiled']:.3f} s untiled; {card}")
    return walls


# --- multi-process jobs and the chaos harness ----------------------------

#: Processes of phase `multihost`'s job, each holding MH_SHARDS shards of
#: cuda:0 in its own CUDA context: a 4-shard round-robin ring.
MH_RANKS = 2
MH_SHARDS = 2
#: The dense ring of phase `multihost` (kernel E): 100 rows over the
#: job's 4 shards, 25 each.
MH_DENSE = (100, 512)
#: Seconds a process of phase `multihost` may take (a CUDA context and a
#: gloo rendezvous are ~8-12 s; the 16384² legs pack on the host).
MH_DEADLINE = 420


def free_port() -> int:
    """A free port below the kernel's ephemeral range, so that no
    server binding port 0 can take it before the job's rendezvous."""
    import socket

    while True:
        port = random.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


class _Chunks(list):
    """Recorded `step_n` chunks, and the latest world it returned."""

    last = None


def own_blocks_equal(world, want) -> bool:
    """Every block of a sharded `world` that this process holds equal
    to the same block of the global tensor `want` (no collective: in a
    job each rank checks its own shards)."""
    import torch

    sh = world.sharding
    return all(torch.equal(part, want[sh.index(world.shape, r, c)])
               for part, (r, c) in zip(world.parts, sh.cells())
               if part is not None)


def recording_all(stepper) -> tuple:
    """The stepper with `step_n` recording its chunks and every
    single-turn and scan entry its turns: (stepper, chunks, scanned)."""
    import dataclasses

    ks, scanned = _Chunks(), []

    def chunk(fn):
        def wrapper(world, k):
            ks.append(int(k))
            out = fn(world, k)
            ks.last = out[0]
            return out
        return wrapper


    def turns(fn, k_of):
        def wrapper(world, *args):
            scanned.append(k_of(args))
            return fn(world, *args)
        return wrapper

    repl = {"step_n": chunk(stepper.step_n)}
    for name in ("step", "step_with_diff"):
        repl[name] = turns(getattr(stepper, name), lambda a: 1)
    for name in ("step_n_with_diffs", "step_n_with_diffs_sparse",
                 "step_n_with_diffs_redo", "step_n_with_diffs_compact"):
        if getattr(stepper, name) is not None:
            repl[name] = turns(getattr(stepper, name), lambda a: int(a[0]))
    return dataclasses.replace(stepper, **repl), ks, scanned


def mh_plan(leg: dict, ks: list, scanned: list) -> dict:
    """{kernel: launches} one rank's MH_SHARDS shards make for the
    recorded dispatches of `leg`: a packed ring's plan (`ring_launches`)
    for its chunks and one launch a shard a scanned turn; the dense
    ring's kernel-E passes (`dense_step_n`: deep blocks of `deep` turns,
    then single turns)."""
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import cuda_life
    from gol_tpu_torch.parallel import halo

    h, w, k4 = leg["h"], leg["w"], MH_RANKS * MH_SHARDS
    if leg["kernel"] == "life_dense":
        deep = halo.dense_deep(h, k4)
        size = h // k4
        per_deep = -(-deep // cuda_life._dense_plan(size + 2 * deep, w)[4])
        n = 0
        for k in ks:
            blocks, rem = divmod(k, deep)
            n += blocks * per_deep + rem
        return {"life_dense": MH_SHARDS * (n + sum(scanned))}
    plan = ring_plan(get_rule(leg["rule"]), h, w, k4)
    n = sum(ring_launches(plan, k, MH_SHARDS) for k in ks)
    return {leg["kernel"]: n + MH_SHARDS * sum(scanned)}


#: Phase `multihost`'s legs, in the order both ranks run them.
MH_LEGS = (
    {"name": "life-512", "rule": "B3/S23", "h": 512, "w": 512,
     "kernel": "bitlife_resident"},
    {"name": "gens-512", "rule": "B2/S/C3", "h": 512, "w": 512,
     "kernel": "bitgens_resident"},
    {"name": "life-16384", "rule": "B3/S23", "h": 16384, "w": 16384,
     "kernel": "bitlife_tiled"},
    {"name": "gens-16384", "rule": "B2/S/C3", "h": 16384, "w": 16384,
     "kernel": "bitgens_tiled"},
    {"name": "dense", "rule": "B3/S23", "h": MH_DENSE[0], "w": MH_DENSE[1],
     "kernel": "life_dense"},
    {"name": "watched-512", "rule": "B3/S23", "h": 512, "w": 512,
     "kernel": "bitlife_resident"},
)


def mh_coordinator_leg(leg: dict, st, tmp: pathlib.Path) -> dict:
    """The coordinator's part of one leg on the job's ring `st` (its
    dispatches mirrored to the worker): the checks, and what it prints.
    Returns what the parent reports for the leg."""
    import numpy as np
    import torch

    from gol_tpu_torch import AliveCellsCount, FinalTurnComplete, Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import bitlife, life
    from gol_tpu_torch.parallel import make_stepper, multihost

    name, h, w, rule = leg["name"], leg["h"], leg["w"], leg["rule"]
    job = multihost.job()
    stats0 = dict(job.stats)
    out: dict = {"stepper": st.name}
    halo0 = halo_counters(st.name)
    if name == "life-512":
        with open(FIXTURES / "check/alive/512x512.csv") as f:
            csv_alive = {int(r["completed_turns"]): int(r["alive_cells"])
                         for r in csv.DictReader(f)}
        world = read_pgm(FIXTURES / "images/512x512.pgm")
        csv_alive[0] = int((world != 0).sum())
        params = Params(image_width=512, image_height=512, turns=100,
                        threads=4, chunk=0, tick_seconds=0.002,
                        image_dir=str(FIXTURES / "images"),
                        out_dir=str(tmp / "mh-ring512"))
        t0 = time.perf_counter()
        engine = Engine(params, stepper=st, emit_flips=False).start()
        evs = drain(engine.events)
        out["engine_s"] = time.perf_counter() - t0
        engine.join(timeout=60)
        if engine.error is not None:
            raise engine.error
        final = [e for e in evs if isinstance(e, FinalTurnComplete)]
        ticks = [(e.completed_turns, e.cells_count) for e in evs
                 if isinstance(e, AliveCellsCount)]
        bad = [(t, c) for t, c in ticks if csv_alive.get(t) != c]
        if (not final or final[0].completed_turns != 100 or bad
                or len(final[0].alive) != csv_alive[100]):
            raise AssertionError(f"multihost {name}: counts {bad}")
        if (tmp / "mh-ring512/512x512x100.pgm").read_bytes() != (
                FIXTURES / "check/images/512x512x100.pgm").read_bytes():
            raise AssertionError(f"multihost {name}: PGM differs")
    elif name in ("gens-512", "dense"):
        world = (read_pgm(FIXTURES / "images/512x512.pgm") if h == 512
                 else life.random_world(h, w, seed=h))
        chunks = (64, 36) if h == 512 else (100,)
        p = st.put(world)
        for k in chunks:
            p, c = st.step_n(p, k)
        got = st.fetch(p)
        if name == "dense":
            want = life.step_n(torch.from_numpy(world).cuda(), 100,
                               ).cpu().numpy()
            alive = int((want != 0).sum())
        else:
            ref = make_stepper(height=h, width=w, rule=rule,
                               backend="packed", devices=ring_devices(1))
            q, d = ref.step_n(ref.put(world), 100)
            want, alive = ref.fetch(q), int(d.item())
        if not np.array_equal(got, want) or int(c.item()) != alive:
            raise AssertionError(f"multihost {name}: board or count "
                                 "differs from the plain version")
    elif name in ("life-16384", "gens-16384"):
        world = life.random_world(h, w, seed=0)
        want = torch.from_numpy(np.load(tmp / f"mh-{name}.npy")).cuda()
        t0 = time.perf_counter()
        p = st.put(world)
        torch.cuda.synchronize()
        out["put_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k in (64, 64, 64, 64):
            p, c = st.step_n(p, k)
        alive = int(c.item())
        out["chunks_s"] = time.perf_counter() - t0
        if not own_blocks_equal(p, want):
            raise AssertionError(f"multihost {name}: rank 0's words differ "
                                 "from the single-device run")
        want_alive = int(bitlife.count_packed(
            want if want.dim() == 2 else want[0]).item())
        if alive != want_alive:
            raise AssertionError(f"multihost {name}: count {alive} != "
                                 f"{want_alive}")
        out["alive"] = alive
    elif name == "watched-512":
        world = read_pgm(FIXTURES / "images/512x512.pgm")
        # The plain packed stepper on the card: no kernel, so the
        # coordinator's launches stay the job ring's alone.
        ref = make_stepper(height=512, width=512, backend="packed",
                           devices=ring_devices(1))
        got, want = {}, {}
        for s, r in ((st, got), (ref, want)):
            p = s.put(world)
            p, c = s.step_n(p, 40)
            r["count40"] = int(c.item())
            p, mask, c = s.step_with_diff(p)
            r["mask"], r["c_mask"] = s.fetch(mask), int(c.item())
            p, diffs, c = s.step_n_with_diffs(p, 5)
            r["diffs"] = halo_host(s.fetch_diffs(diffs) if s.fetch_diffs
                                   else diffs)
            prev = p
            p, rows, c = s.step_n_with_diffs_sparse(prev, 3, 4)
            r["sparse"], r["c_sparse"] = halo_host(rows), int(c.item())
            if int(halo_host(rows)[:, 0].max()) <= 4:
                raise AssertionError("multihost watched: the sparse chunk "
                                     "did not overflow its cap")
            redo = s.step_n_with_diffs_redo or s.step_n_with_diffs
            p, diffs, c = redo(prev, 3)
            r["redo"] = halo_host(s.fetch_diffs(diffs) if s.fetch_diffs
                                  else diffs)
            p, hdr, vals, c = s.step_n_with_diffs_compact(p, 4, 1 << 16)
            hdr = halo_host(hdr)
            total = int(hdr[:, 0].sum())
            r["headers"] = hdr
            r["values"] = (s.fetch_compact_values(vals, total)
                           if s.fetch_compact_values
                           else halo_host(vals))[:total]
            p, c = s.step_n(p, 20)
            r["board"], r["count"] = s.fetch(p), int(c.item())
        for key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"multihost watched: {key} differs "
                                     "from the single device's")
        out["scanned"] = 16
    out["halo"] = [a - b for a, b in zip(halo_counters(st.name), halo0)]
    out["sent"] = {k: job.stats[k] - stats0[k] for k in job.stats}
    return out


def halo_host(a):
    """A tensor or array on the host, int32 words viewed as uint32."""
    import numpy as np

    host = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return host.view(np.uint32) if host.dtype == np.int32 else host


def linear_wall(stepper, world, chunks, reps: int) -> float:
    """Best seconds of `reps` runs of `chunks` through `step_n`, each
    ended by reading the count and each from a fresh `put` (outside the
    timing): a job's dispatches must be linear in the current world
    (`multihost.spmd_stepper`), so no run restarts from an old one."""
    import torch

    best = float("inf")
    for _ in range(reps):
        p = stepper.put(world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in chunks:
            p, count = stepper.step_n(p, k)
        int(count.item())
        best = min(best, time.perf_counter() - t0)
    return best


def mh_wall_run(leg: dict) -> tuple:
    """(world, chunks, reps) of a leg's `step_n` walls: the 512²
    engine's chunks, or four of 64 at 16384²."""
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import life

    if leg["h"] == 512:
        return read_pgm(FIXTURES / "images/512x512.pgm"), (64, 36), 5
    return life.random_world(leg["h"], leg["w"], seed=0), (64,) * 4, 2


def mh_one_process_wall(leg: dict) -> float:
    """The same walls on the one-process 4-shard ring of the card."""
    import torch

    from gol_tpu_torch.parallel import make_stepper

    one = make_stepper(threads=4, height=leg["h"], width=leg["w"],
                       rule=leg["rule"], devices=ring_devices(4))
    wall = linear_wall(one, *mh_wall_run(leg))
    del one
    torch.cuda.empty_cache()
    return wall


def mh_rank(rank: int, port: int, tmp: pathlib.Path) -> int:
    """`--mh-rank RANK PORT TMP`: one process of phase `multihost`'s job.
    Joins the 2-process gloo job with [cuda:0] * 2, then runs every leg
    of MH_LEGS: the coordinator drives the job's ring (walls and checks,
    then `notify_stop`), the worker replays it (`spmd_worker_loop`).
    Each rank prints one `MH {json}` line a leg: its launches by kernel
    and the count its plan gives for the dispatches it made."""
    import numpy as np
    import torch

    from gol_tpu_torch.parallel import make_stepper, multihost

    multihost.initialize(f"127.0.0.1:{port}", MH_RANKS, rank,
                         local_devices=[torch.device("cuda", 0)] * MH_SHARDS)
    _build_load()
    for leg in MH_LEGS:
        st = make_stepper(threads=4, height=leg["h"], width=leg["w"],
                          rule=leg["rule"])
        st, ks, scanned = recording_all(st)
        reset_launches()
        report: dict = {"rank": rank, "leg": leg["name"],
                        "stepper": st.name}
        timed = leg["name"] in ("life-512", "gens-512", "life-16384")
        if multihost.is_coordinator():
            report.update(mh_coordinator_leg(leg, st, tmp))
            if timed:
                report["walls"] = {"job": linear_wall(st,
                                                      *mh_wall_run(leg))}
            launched = {k: v for k, v in read_launches().items() if v}
            plan = mh_plan(leg, ks, scanned)
            if timed:
                report["walls"]["one_process"] = mh_one_process_wall(leg)
            multihost.notify_stop()
        else:
            multihost.spmd_worker_loop(st, leg["h"], leg["w"])
            launched = {k: v for k, v in read_launches().items() if v}
            plan = mh_plan(leg, ks, scanned)
            if leg["h"] == 16384:
                # The worker holds its own shards: it checks them.
                want = torch.from_numpy(
                    np.load(tmp / f"mh-{leg['name']}.npy")).cuda()
                report["own_blocks_equal"] = own_blocks_equal(ks.last, want)
                del want
        report.update(launches=launched, plan=plan, chunks=ks,
                      scanned=sum(scanned))
        print("MH " + json.dumps(report), flush=True)
        del st
        torch.cuda.empty_cache()
    return 0


def _build_load() -> None:
    from gol_tpu_torch.ops import _build

    _build.load()


def multihost_phase(tmp: pathlib.Path, card: str) -> dict:
    """Phase `multihost`: a 2-process gloo job on the one card, each
    rank [cuda:0] * 2 in its own CUDA context (`--mh-rank`), through
    every leg of MH_LEGS — Life 512² through an Engine against the
    fixture and the CSV, B2/S/C3 512² against the plain planes, Life and
    B2/S/C3 16384² x 256 against the single-device boards of phases
    `main-16384` / `main-gens-16384`, the dense ring against
    `life.step_n`, a watched leg (step_with_diff, step_n_with_diffs,
    sparse with a forced redo, compact) byte for byte against the
    single device — each rank's launches equal to its plan; then the CLI
    pair (`--mh-*`, PGM byte-equal to the fixture) and a mismatched pair
    that both exit nonzero. Returns {kernel: {leg: [rank 0, rank 1]}}."""
    import numpy as np

    t_phase = time.perf_counter()
    for key, name in (("life", "life-16384"), ("gens", "gens-16384")):
        _, want = REUSE.pop(key)
        np.save(tmp / f"mh-{name}.npy", want.cpu().numpy())
        del want
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--mh-rank", str(r),
         str(port), str(tmp)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MH_RANKS)]
    try:
        outs = [p.communicate(timeout=MH_DEADLINE)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    job_wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r}: exit {p.returncode}\n"
                                 + text[-4000:])
    reports = [[json.loads(ln[3:]) for ln in text.splitlines()
                if ln.startswith("MH ")] for text in outs]
    launches: dict = {}
    if [len(r) for r in reports] != [len(MH_LEGS)] * MH_RANKS:
        raise AssertionError(f"multihost: legs reported {reports}")
    for leg, r0, r1 in zip(MH_LEGS, *reports):
        if r1.get("own_blocks_equal") is False:
            raise AssertionError(f"multihost {leg['name']}: rank 1's words "
                                 "differ from the single-device run")
        for r in (r0, r1):
            if r["launches"] != r["plan"]:
                raise AssertionError(
                    f"multihost {leg['name']} rank {r['rank']}: launches "
                    f"{r['launches']}, its plan {r['plan']}")
        kernel = leg["kernel"]
        launches.setdefault(kernel, {})[leg["name"]] = [
            r0["launches"].get(kernel, 0), r1["launches"].get(kernel, 0)]
        extra = ""
        if "walls" in r0:
            wl = r0["walls"]
            extra = (f"; step_n over chunks {r0['chunks'][:4]}...: "
                     f"{wl['job'] * 1e3:.3f} ms on the 2-process ring, "
                     f"{wl['one_process'] * 1e3:.3f} ms on the one-process "
                     f"4-shard ring (best of runs, same card)")
        if "put_s" in r0:
            extra += (f"; put {r0['put_s']:.3f} s, 4 x 64-turn chunks "
                      f"{r0['chunks_s']:.4f} s, {r0['alive']} alive")
        sent = r0["sent"]
        phase("multihost", f"{leg['name']} {r0['stepper']} (worker: "
              f"{r1['stepper']}): launches rank 0 {r0['launches']}, rank "
              f"1 {r1['launches']} (= each rank's plan); halo counters "
              f"+{r0['halo'][0]} exchanges, +{r0['halo'][1]} bytes across "
              f"ranks; rank 0 sent {sent['exchanges']} slabs, "
              f"{sent['bytes']} bytes, host staging {sent['staging_s']:.4f} "
              f"s, gloo wait {sent['wire_s']:.4f} s{extra}")
    phase("multihost", f"2-process job: {job_wall:.1f} s wall for both "
          f"processes and {len(MH_LEGS)} legs; every board equal to its "
          f"reference; {card}")
    mh_cli_pair(tmp)
    phase("multihost", f"{time.perf_counter() - t_phase:.1f} s for the "
          "phase")
    return launches


def mh_cli_pair(tmp: pathlib.Path) -> None:
    """The CLI pair: `--mh-coordinator 127.0.0.1:P --mh-procs 2 --mh-id
    {0,1} -t 8 -w 512 -h 512 -turns 100 -noVis` on the card (one shard a
    process), the PGM byte-equal to the fixture; then a pair with
    different `-w` that both exit nonzero within the deadline."""
    def pair(widths, out, deadline):
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", "-w", str(w), "-h",
             "512", "-t", "8", "-turns", "100", "-noVis", "--images",
             str(FIXTURES / "images"), "--out", str(out),
             "--mh-coordinator", f"127.0.0.1:{port}", "--mh-procs", "2",
             "--mh-id", str(r)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r, w in enumerate(widths)]
        t0 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=deadline)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return ([p.returncode for p in procs], outs,
                time.perf_counter() - t0)

    rcs, outs, wall = pair((512, 512), tmp / "mhcli", 300)
    if rcs != [0, 0]:
        raise AssertionError(f"--mh-* pair: exits {rcs}\n" + outs[0][-2000:]
                             + outs[1][-2000:])
    if (tmp / "mhcli/512x512x100.pgm").read_bytes() != (
            FIXTURES / "check/images/512x512x100.pgm").read_bytes():
        raise AssertionError("--mh-* pair: PGM differs from the fixture")
    worker = [ln for ln in outs[1].splitlines()
              if ln.startswith("kernel launches")]
    phase("multihost", f"CLI pair -t 8 512² x 100 (--mh-procs 2, one "
          f"shard a process): PGM byte-equal to 512x512x100.pgm; "
          f"{wall:.2f} s wall; worker {worker}")
    deadline = 120
    rcs, outs, wall = pair((512, 256), tmp / "mhbad", deadline)
    if 0 in rcs or not all("config mismatch" in o for o in outs):
        raise AssertionError(f"mismatched pair: exits {rcs}\n"
                             + outs[0][-1000:] + outs[1][-1000:])
    phase("multihost", f"mismatched pair (-w 512 / 256): both exit "
          f"nonzero ({rcs}) with the config mismatch in {wall:.2f} s, "
          f"deadline {deadline} s")


def session_dispatches(text: str) -> dict:
    """gol_tpu_session_dispatches_total by path in a /metrics text."""
    out = {}
    for line in text.splitlines():
        m = re.match(r'gol_tpu_session_dispatches_total\{path="(\w+)"\} '
                     r'(\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def chaos_phase(tmp: pathlib.Path, card: str) -> int:
    """Phase `chaos`: `ChaosRunner(platform="gpu")` — a `--serve
    --sessions` server on the card SIGKILLed mid-storm and restarted
    with `--resume latest`, judged against the plain oracle (the CPU):
    every survivor bit-identical, the ledger equal to the live set, the
    invariant counters 0. Prints the report, both boot walls and the
    server's session dispatches by path before the kill and after the
    resume; the fused path (kernel A's batched entry in the child) must
    be above 0. Returns the fused dispatches of both boots."""
    from gol_tpu_torch.testing.chaos import ChaosRunner

    workdir = tmp / "chaos"
    workdir.mkdir()
    runner = ChaosRunner(seed=16, workdir=str(workdir), platform="gpu",
                         image_dir=str(FIXTURES / "images"))
    t0 = time.perf_counter()
    report = runner.run()
    wall = time.perf_counter() - t0
    before = session_dispatches(runner.metrics_before_kill[0]) \
        if runner.metrics_before_kill else {}
    after = session_dispatches(runner.metrics_after)
    if report["kills"] != 1 or report["invariant_violations"] \
            or report["lockcheck_violations"] \
            or report["sessions_verified"] < 2:
        raise AssertionError(f"chaos: {report}")
    if before.get("fused", 0) <= 0 or after.get("fused", 0) <= 0:
        raise AssertionError(f"chaos: fused dispatches {before} / {after}")
    phase("chaos", "report " + json.dumps(report, sort_keys=True))
    phase("chaos", f"boot walls {[round(b, 3) for b in runner.boot_walls]} "
          f"s; session dispatches before the kill {before}, after the "
          f"resume {after}; {wall:.1f} s for the scenario; {card}")
    return int(before.get("fused", 0) + after.get("fused", 0))


def cli(tmp: pathlib.Path) -> float:
    """Phase 6: the CLI writes the golden PGM; returns the process's
    wall seconds."""
    out = tmp / "cli"
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "512", "-h", "512",
         "-turns", "100", "-noVis", "--images", str(FIXTURES / "images"),
         "--out", str(out)],
        check=True, cwd=REPO, capture_output=True, timeout=300,
    )
    wall = time.perf_counter() - t0
    got = (out / "512x512x100.pgm").read_bytes()
    if got != (FIXTURES / "check/images/512x512x100.pgm").read_bytes():
        raise AssertionError("CLI PGM differs from the fixture")
    phase("cli", "python -m gol_tpu_torch -w 512 -h 512 -turns 100 -noVis: "
                 f"PGM byte-equal to the fixture; {wall:.3f} s wall")
    return wall


def cli_watcher(tmp: pathlib.Path, cli_wall: float) -> dict:
    """Phase `cli`, the compile watcher: a fresh `python -m gol_tpu_torch
    -w 512 -h 512 -noVis --metrics-port 0` process (a run of 10^9 turns,
    ended with SIGTERM) whose /metrics shows
    `gol_tpu_device_compiles_total` and `gol_tpu_device_compile_seconds`
    for its kernel library's load; the load's seconds beside the
    process's wall to the scrape that saw it, and the headless CLI's
    whole wall (`cli`)."""
    import signal
    import urllib.request

    out = tmp / "cliwatch"
    log = tmp / "cliwatch.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", "-w", "512", "-h", "512",
             "-turns", str(10 ** 9), "-noVis", "--metrics-port", "0",
             "--images", str(FIXTURES / "images"), "--out", str(out)],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    try:
        port = t_metrics = None
        deadline = time.monotonic() + 120
        while port is None:
            m = re.search(r"metrics serving on http://[\d.]+:(\d+)/",
                          log.read_text())
            if m:
                port, t_metrics = int(m.group(1)), time.perf_counter() - t0
            elif proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("watcher CLI: no metrics sidecar\n"
                                     + log.read_text()[-2000:])
            time.sleep(0.05)
        compiles = None
        while compiles is None:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                text = r.read().decode()
            got = re.findall(r'gol_tpu_device_compiles_total\{cause="([^"]*)"'
                             r'\} (\S+)', text)
            if got:
                compiles = {c: float(v) for c, v in got}
                t_seen = time.perf_counter() - t0
            elif time.monotonic() > deadline:
                raise AssertionError("watcher CLI: no compile recorded")
            else:
                time.sleep(0.05)
        load_s = float(re.search(r"gol_tpu_device_compile_seconds_sum (\S+)",
                                 text).group(1))
        count = float(re.search(r"gol_tpu_device_compile_seconds_count "
                                r"(\S+)", text).group(1))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if sum(compiles.values()) != 1 or count != 1:
        raise AssertionError(f"watcher CLI: compiles {compiles}, {count} "
                             "observations; want one load")
    wall = time.perf_counter() - t0
    phase("cli", f"compile watcher: a fresh CLI process's /metrics shows "
          f"gol_tpu_device_compiles_total {compiles} and "
          f"gol_tpu_device_compile_seconds {load_s:.4f} s (its library "
          f"load from the build cache); the sidecar up {t_metrics:.3f} s "
          f"after spawn, the compile seen {t_seen:.3f} s after spawn, the "
          f"process {wall:.3f} s to its SIGTERM exit; the headless 512² x "
          f"100 CLI took {cli_wall:.3f} s whole")
    return {"load_s": load_s, "sidecar_s": t_metrics, "seen_s": t_seen}


def board_frame(board):
    """A native board's pixels as numpy: gray levels of a level board,
    else alive as 255 (one ctypes read a pixel)."""
    import numpy as np

    if hasattr(board, "get_level"):
        read = board.get_level
    else:
        def read(x, y):
            return 255 if board.get(x, y) else 0
    return np.array([[read(x, y) for x in range(board.width)]
                     for y in range(board.height)], np.uint8)


def cli_run(argv: list, metrics: bool = True, frames: bool = False) -> tuple:
    """One in-process `python -m gol_tpu_torch ARGV` on the card, stdin
    not a tty: (wall seconds, the boards its visualiser loop made — with
    `frames`, each with its final `frame`, read before the loop destroys
    it and inside the wall — and what it printed). `metrics=False` is
    the GOL_TPU_METRICS=0 switch (`obs.set_enabled`), which makes
    `make_stepper` build the bare stepper."""
    import contextlib
    import io

    from gol_tpu_torch import cli, obs
    from gol_tpu_torch.analysis import invariants
    from gol_tpu_torch.visual import loop

    boards = []
    make_board = loop.make_board

    def recording_board(*args, **kwargs):
        board = make_board(*args, **kwargs)
        destroy = board.destroy

        def keep_frame():
            board.frame = board_frame(board)
            destroy()

        if frames:
            board.destroy = keep_frame
        boards.append(board)
        return board

    loop.make_board = recording_board
    obs.set_enabled(metrics)
    stdin, sys.stdin = sys.stdin, open(os.devnull)
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        sys.stdin.close()
        sys.stdin = stdin
        loop.make_board = make_board
        obs.set_enabled(True)
        invariants.enable(False)
    if rc != 0:
        raise AssertionError(f"python -m gol_tpu_torch {argv}: exit {rc}\n"
                             + out.getvalue())
    return wall, boards, out.getvalue()


def busy_share(trace: pathlib.Path, kernel: str) -> dict:
    """The device's busy share in a `--profile-dir` trace: the union of
    CUDA kernel, memcpy and memset intervals over the CLI's window
    (`gol_tpu_torch.run`, run() to FinalTurnComplete), and the launches
    of kernels named `kernel` the trace holds."""
    events = json.loads(trace.read_text())["traceEvents"]
    (win,) = [e for e in events if e.get("name") == "gol_tpu_torch.run"
              and e.get("cat") == "user_annotation"]
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((max(float(e["ts"]), t0),
                    min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                   for e in device)
    busy, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return {"window_ms": round((t1 - t0) / 1e3, 3),
            "busy_ms": round(busy / 1e3, 3),
            "busy_share": round(busy / (t1 - t0), 5),
            "kernel_events": sum(1 for e in device
                                 if e.get("cat") == "kernel"),
            "launches": sum(1 for e in device if e.get("cat") == "kernel"
                            and kernel in e.get("name", ""))}


def main_cli_full(tmp: pathlib.Path, cli_wall: float) -> dict:
    """Phase `main-cli-full`: the CLI made whole on the card.
    (1) A visualised 512² x 100-turn run (no -noVis; the native board,
    headless) with --check-invariants, --autosave-turns 50 and
    --profile-dir: the fixture's PGM, the turn-50 autosave equal to the
    plain version's turn 50, the board's final frame equal to the PGM,
    no invariant violation, and the trace holding exactly the kernel A
    launches the launcher counted (one a watched turn). (2) --resume from
    that autosave, -noVis: the fixture, resume gauge 50, kernel A
    chunks. (3) B2/S/C3 visualised in level mode with the invariants:
    the PGM of phase `main-gens-512`, one kernel C launch a turn. (4)
    `main-watched-512`'s glider board forced to a 4-word compact buffer
    under the invariants: 5 redos, no violation. (5) The device's busy
    share of the 512² headless and visualised runs from their captures,
    and each run's wall with and without the capture and with metrics
    off. (6) A fresh process's headless run with a capture, beside
    phase `cli`'s same run without one (`cli_wall`)."""
    import numpy as np

    from gol_tpu_torch import Params, obs
    from gol_tpu_torch.analysis import invariants
    from gol_tpu_torch.engine.distributor import _METRICS as em
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.parallel import make_stepper
    from gol_tpu_torch.visual import board as vboard

    vboard.build_native()  # raises when the native core does not build
    if vboard.native_lib() is None:
        raise AssertionError("the native visualiser core did not load")
    golden = (FIXTURES / "check/images/512x512x100.pgm").read_bytes()
    base = ["-w", "512", "-h", "512", "-turns", "100",
            "--images", str(FIXTURES / "images")]

    def visualised_board(boards, level: bool):
        cls = vboard.NativeLevelBoard if level else vboard.NativeBoard
        if len(boards) != 1 or type(boards[0]) is not cls:
            raise AssertionError(f"visualiser boards {boards}: not one "
                                 f"{cls.__name__}")
        return boards[0]

    # (1) The visualised run.
    out1 = tmp / "cli-vis"
    v0 = invariants.violations_total()
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    wall, boards, _ = cli_run(base + [
        "--out", str(out1), "--check-invariants", "--autosave-turns", "50",
        "--profile-dir", str(tmp / "prof-vis-checked")], frames=True)
    launches = cb.LAUNCHES["bitlife_resident"]
    if (out1 / "512x512x100.pgm").read_bytes() != golden:
        raise AssertionError("visualised 512²: PGM differs from the fixture")
    plain = make_stepper(height=512, width=512, backend="packed")
    want50 = plain.fetch(plain.step_n(
        plain.put(read_pgm(FIXTURES / "images/512x512.pgm")), 50)[0])
    if not np.array_equal(read_pgm(out1 / "512x512x50.pgm"), want50):
        raise AssertionError("visualised 512²: the turn-50 autosave differs "
                             "from the plain version's turn 50")
    frame = visualised_board(boards, level=False).frame
    if not np.array_equal(frame, read_pgm(out1 / "512x512x100.pgm")):
        raise AssertionError("visualised 512²: the native board's final "
                             "frame differs from the final PGM")
    violations = invariants.violations_total() - v0
    if violations:
        raise AssertionError(f"visualised 512²: {violations} invariant "
                             "violations")
    (trace,) = (tmp / "prof-vis-checked").glob("trace-*.json")
    prof = busy_share(trace, "bitlife_resident")
    if launches != 100 or prof["launches"] != launches:
        raise AssertionError(
            f"visualised 512²: {launches} bitlife_resident launches "
            f"counted, {prof['launches']} in the trace, 100 turns watched")
    phase("main-cli-full", f"visualised 512² x 100 (native board, "
                           f"--check-invariants, --autosave-turns 50, "
                           f"--profile-dir): fixture PGM, turn-50 autosave "
                           f"= plain turn 50, board frame = PGM, 0 "
                           f"violations, {launches} bitlife_resident "
                           f"launches = {prof['launches']} in the trace; "
                           f"{wall:.3f} s wall; {prof}")
    cli_launches = {"bitlife_resident": launches}

    # (2) --resume from the turn-50 autosave.
    for k in cb.LAUNCHES:
        cb.LAUNCHES[k] = 0
    chunk_turns = em.turns["chunk"].value
    wall, _, _ = cli_run(base + [
        "--out", str(tmp / "cli-resume"), "-noVis",
        "--resume", str(out1 / "512x512x50.pgm")])
    resume_turn = obs.registry().gauge("gol_tpu_resume_turn").value
    resumed = cb.LAUNCHES["bitlife_resident"]
    chunk_turns = em.turns["chunk"].value - chunk_turns
    if (tmp / "cli-resume/512x512x100.pgm").read_bytes() != golden:
        raise AssertionError("--resume 512²: PGM differs from the fixture")
    if resume_turn != 50 or resumed <= 0 or chunk_turns != 50:
        raise AssertionError(f"--resume 512²: resume turn {resume_turn}, "
                             f"{resumed} bitlife_resident launches, "
                             f"{chunk_turns} chunk turns")
    phase("main-cli-full", f"--resume 512x512x50.pgm -turns 100 -noVis: "
                           f"fixture PGM, gol_tpu_resume_turn {resume_turn:g}, "
                           f"{chunk_turns:g} turns in fused chunks, {resumed} "
                           f"bitlife_resident launches; {wall:.3f} s wall")

    # (3) B2/S/C3, visualised in level mode.
    for k in cg.LAUNCHES:
        cg.LAUNCHES[k] = 0
    v0 = invariants.violations_total()
    wall, boards, _ = cli_run(base + [
        "--rule", "B2/S/C3", "--out", str(tmp / "cli-gens"),
        "--check-invariants"], frames=True)
    gens = cg.LAUNCHES["bitgens_resident"]
    got = (tmp / "cli-gens/512x512x100.pgm").read_bytes()
    if got != (tmp / "gens512-auto/512x512x100.pgm").read_bytes():
        raise AssertionError("visualised B2/S/C3 512²: PGM differs from "
                             "phase main-gens-512's")
    frame = visualised_board(boards, level=True).frame
    if not np.array_equal(frame, read_pgm(tmp / "cli-gens/512x512x100.pgm")):
        raise AssertionError("visualised B2/S/C3 512²: the level board's "
                             "final frame differs from the PGM")
    if gens != 100 or invariants.violations_total() != v0:
        raise AssertionError(f"visualised B2/S/C3 512²: {gens} "
                             "bitgens_resident launches for 100 turns, "
                             f"{invariants.violations_total() - v0} "
                             "violations")
    phase("main-cli-full", f"visualised B2/S/C3 512² x 100 (level board, "
                           f"--check-invariants): PGM = main-gens-512's, "
                           f"frame = PGM, {gens} bitgens_resident launches, "
                           f"0 violations; {wall:.3f} s wall")
    cli_launches["bitgens_resident"] = gens

    # (4) The glider board, forced compact overflow, under the checker.
    write_world(tmp / "gliders/512x512.pgm", glider_world(512))
    glide = Params(image_width=512, image_height=512, turns=100, chunk=16,
                   image_dir=str(tmp / "gliders"),
                   out_dir=str(tmp / "cli-g512"))
    invariants.enable()
    try:
        name = make_stepper(height=512, width=512).name
        v0 = invariants.violations_total()
        _, wall, series = run_engine(glide, total_cap=4)
        violations = invariants.violations_total() - v0
    finally:
        invariants.enable(False)
    if (not name.startswith("checked-") or violations
            or series.get("compact_redos") != 5):
        raise AssertionError(f"checked 512² gliders: stepper {name}, "
                             f"{violations} violations, {series}")
    phase("main-cli-full", f"512² gliders, chunk 16, 4-word compact buffer, "
                           f"{name}: 5 compact redos, 0 violations; "
                           f"{wall:.3f} s wall")

    # (5) Busy shares and walls: plain, captured, metrics off, in turns.
    for kind, extra in (("headless", ["-noVis"]), ("visualised", [])):
        walls = {"plain": [], "capture": [], "metrics off": []}
        for i, how in enumerate(("plain", "capture", "metrics off",
                                 "metrics off", "capture", "plain")):
            argv = base + extra + ["--out", str(tmp / f"cli-{kind}-{i}")]
            if how == "capture":
                argv += ["--profile-dir", str(tmp / f"prof-{kind}-{i}")]
            wall, _, _ = cli_run(argv, metrics=how != "metrics off")
            walls[how].append(round(wall, 4))
            if (tmp / f"cli-{kind}-{i}/512x512x100.pgm").read_bytes() != golden:
                raise AssertionError(f"{kind} 512² ({how}): PGM differs")
        shares = [busy_share(t, "bitlife_resident")
                  for t in sorted(tmp.glob(f"prof-{kind}-*/trace-*.json"))]
        if any(s["launches"] <= 0 for s in shares):
            raise AssertionError(f"{kind} 512²: a capture holds no "
                                 f"bitlife_resident launch: {shares}")
        phase("main-cli-full", f"{kind} 512² x 100 walls (s; run order "
                               f"plain, capture, off, off, capture, plain): "
                               f"{walls}; busy share of the captures: "
                               f"{shares}")
    # (6) What a user's fresh process pays for a capture: the profiler's
    # first start (CUPTI) and the export.
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "gol_tpu_torch", *base, "-noVis",
                    "--out", str(tmp / "cli-fresh"),
                    "--profile-dir", str(tmp / "prof-fresh")],
                   check=True, cwd=REPO, capture_output=True, timeout=300)
    wall = time.perf_counter() - t0
    if (tmp / "cli-fresh/512x512x100.pgm").read_bytes() != golden:
        raise AssertionError("fresh-process 512² capture: PGM differs")
    (trace,) = (tmp / "prof-fresh").glob("trace-*.json")
    phase("main-cli-full", f"fresh process, python -m gol_tpu_torch 512² x "
                           f"100 -noVis --profile-dir: {wall:.3f} s wall "
                           f"(phase cli, the same without: {cli_wall:.3f} "
                           f"s); {busy_share(trace, 'bitlife_resident')}")
    return cli_launches


# --- the serving core (EngineServer, Controller, the wire) on the card ---


def counting_proxy(target) -> tuple:
    """A loopback proxy in front of `target` that accepts any number of
    clients and counts the bytes it carries toward them — the link cost
    of the watched wire, or the root's egress to N observers, measured
    outside both endpoints (bench.py's watched-wire and fan-out lanes
    count it the same way). Returns ((host, port), stats, close)."""
    import contextlib
    import socket
    import threading

    lsock = socket.create_server(("127.0.0.1", 0), backlog=1024)
    stats = {"down": 0}
    lock = threading.Lock()
    socks = []

    def pump(src, dst, count):
        while True:
            try:
                data = src.recv(1 << 16)
            except OSError:
                break
            if not data:
                break
            if count:
                with lock:
                    stats["down"] += len(data)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            with contextlib.suppress(OSError):
                s.shutdown(socket.SHUT_RDWR)

    def serve():
        while True:
            try:
                c, _ = lsock.accept()
            except OSError:
                return
            try:
                u = socket.create_connection(target)
            except OSError:
                c.close()
                continue
            socks.extend((c, u))
            threading.Thread(target=pump, args=(c, u, False),
                             daemon=True).start()
            threading.Thread(target=pump, args=(u, c, True),
                             daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()

    def close():
        lsock.close()
        for s in socks:
            with contextlib.suppress(OSError):
                s.close()

    return lsock.getsockname(), stats, close


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl

    for table in (cb.LAUNCHES, cg.LAUNCHES, cl.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches() -> dict:
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl

    return {**cb.LAUNCHES, **cg.LAUNCHES, **cl.LAUNCHES}


def packed_board(world):
    """A host {0,255} board packed on the card."""
    import numpy as np
    import torch

    from gol_tpu_torch.ops import bitlife, life

    return bitlife.pack(life.to_bits(torch.from_numpy(
        np.ascontiguousarray(world, np.uint8)).cuda()))


class PlainLife:
    """The plain packed Life step on the card from one board, at any
    turn: stepped turn by turn from the board up to `settle`, where the
    board's exact period (at most `max_period`) is found by comparing
    each next state with the state at `settle`; a later turn maps onto
    the period. The fixture's 512² board is periodic (period 2) by turn
    5000."""

    def __init__(self, world, settle: int = 5000, max_period: int = 64):
        self.p0 = packed_board(world)
        self.settle, self.max_period = settle, max_period
        self._anchor = None  # (settle state, period)

    def _step(self, p, n):
        from gol_tpu_torch.ops import bitlife

        return bitlife.step_n_packed_raw(p, n)

    def _period(self):
        import torch

        if self._anchor is None:
            s = self._step(self.p0, self.settle)
            q = s
            for m in range(1, self.max_period + 1):
                q = self._step(q, 1)
                if torch.equal(q, s):
                    self._anchor = (s, m)
                    break
            else:
                raise AssertionError(
                    f"the plain board has no period <= {self.max_period} "
                    f"at turn {self.settle}")
        return self._anchor

    def at(self, turns: int):
        if turns <= self.settle:
            return self._step(self.p0, turns)
        s, m = self._period()
        return self._step(s, (turns - self.settle) % m)


def wait_until(pred, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def consume(ctl, out: dict, stop_after: int = 0):
    """Drain a controller's events on a thread until its stream ends.
    `out["turns"]` counts TurnComplete events after the sync's; with
    `stop_after`, (turns, seconds, proxy bytes at each end) of the first
    `stop_after` of them land in `out["window"]` (`out["bytes"]` is read
    at both ends when a proxy counts it)."""
    import threading

    def run():
        out["turns"], t0 = 0, None
        for ev in ctl.events:
            if type(ev).__name__ != "TurnComplete":
                continue
            if ev.completed_turns <= ctl.sync_turn:
                continue
            if t0 is None:
                t0 = time.perf_counter()
                b0 = out["bytes"]() if "bytes" in out else 0
            out["turns"] += 1
            if stop_after and out["turns"] == stop_after + 1:
                out["window"] = (stop_after, time.perf_counter() - t0,
                                 (out["bytes"]() if "bytes" in out else 0)
                                 - b0)
        out["closed"] = True

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def join_all(threads, timeout: float = 120.0) -> None:
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise AssertionError("a controller's stream did not end")


def the_snapshot(out: pathlib.Path) -> tuple:
    """(turn, board) of the one PGM a 'k' left in `out`."""
    from gol_tpu_torch.io.pgm import read_pgm

    (snap,) = sorted(out.glob("*.pgm"))
    return int(snap.stem.split("x")[2]), read_pgm(snap)


def dispatch_kinds(before: dict) -> dict:
    return {k[len("dispatches["):-1]: int(v) for k, v in moved(before).items()
            if k.startswith("dispatches[")}


def serve_params(out: pathlib.Path, **kw):
    from gol_tpu_torch import Params

    base = dict(image_width=512, image_height=512, turns=10**9, chunk=0,
                tick_seconds=60.0, image_dir=str(FIXTURES / "images"),
                out_dir=str(out))
    base.update(kw)
    return Params(**base)


def serve_512(tmp: pathlib.Path, card: str, oracle: PlainLife,
              device=None) -> int:
    """Phase `main-serve-512`: README's deployment at the headline width.
    An EngineServer on the card over the 512² fixture, paused at turn 0
    while a batching binary delta driver (through the byte-counting
    proxy) and two observers attach; the driver resumes the run and
    watches 2000 turns; then 'k'. Every shadow board equals the
    snapshot, and the snapshot the plain version at its turn; the
    engine's dispatches and its enqueue / sync / host split. With
    `device="cpu"` the same run with the server's engine on this host's
    CPU (the plain versions), for comparison."""
    import numpy as np
    import torch

    from gol_tpu_torch.distributed import Controller, EngineServer

    where = "the host CPU" if device == "cpu" else "the card"
    out = tmp / f"serve512-{device or 'card'}"
    server = EngineServer(serve_params(out), port=0, device=device)
    server._keys.put("p")  # every peer syncs at turn 0
    reset_launches()
    before = engine_counters()
    server.start()
    ctls, threads, close_proxy = [], [], None
    try:
        wait_until(lambda: server.engine._paused, "the engine to pause")
        addr, stats, close_proxy = counting_proxy(server.address)
        drv = Controller(*addr, want_flips=True, batch=True, binary=True,
                         delta=True, timeout=60)
        ctls.append(drv)
        ctls += [Controller(*server.address, want_flips=True, batch=True,
                            observe=True, timeout=60) for _ in range(2)]
        for c in ctls:
            if not c.wait_sync(60):
                raise AssertionError("main-serve-512: a peer got no sync")
        seen = {"bytes": lambda: stats["down"]}
        threads = [consume(drv, seen, stop_after=2000)]
        threads += [consume(c, {}) for c in ctls[1:]]
        drv.send_key("p")
        wait_until(lambda: "window" in seen, "2000 watched turns", 300)
        drv.send_key("k")
        join_all(threads)
        if not server.wait(120):
            raise AssertionError("main-serve-512: the server did not stop")
    finally:
        for c in ctls:
            c.close()
        server.shutdown()
        if close_proxy is not None:
            close_proxy()
    launches = read_launches()["bitlife_resident"]
    series = moved(before)
    turns, secs, nbytes = seen["window"]
    t_end, world = the_snapshot(out)
    for i, c in enumerate(ctls):
        if not np.array_equal(c.board, world):
            raise AssertionError(f"main-serve-512: peer {i}'s shadow board "
                                 "differs from the snapshot")
    if not torch.equal(packed_board(world), oracle.at(t_end)):
        raise AssertionError("main-serve-512: the snapshot differs from the "
                             f"plain version at turn {t_end}")
    if device is None and launches <= 0:
        raise AssertionError("main-serve-512 never launched bitlife_resident")
    phase("main-serve-512", f"EngineServer 512² B3/S23 on {where}, a "
          f"batching binary delta driver through the proxy and 2 observers: "
          f"{turns / secs:.1f} delivered turns/s over {turns} watched turns "
          f"({secs:.3f} s), {nbytes / turns:.1f} link bytes/turn; 'k' at "
          f"turn {t_end}: 3 shadow boards = snapshot = plain version; "
          f"engine series {series}; {launches} bitlife_resident launches; "
          f"{card}")
    return launches


def serve_attach(tmp: pathlib.Path, card: str, oracle: PlainLife) -> int:
    """Phase `main-serve-attach`: one 512² run headless, watched by a
    driver that attaches with flips and detaches, headless again, then
    watched by an observer that reattaches; 'k'. The BoardSync is the
    committed world at a dispatch boundary; each leg's dispatches by
    kind; the final board the plain run's."""
    import dataclasses

    import numpy as np
    import torch

    from gol_tpu_torch.distributed import Controller, EngineServer

    out = tmp / "serve-attach"
    server = EngineServer(serve_params(out), port=0)
    eng = server.engine
    fetched = []
    real_fetch = eng.stepper.fetch

    def fetch(world):  # the engine thread's sync fetch, observed
        fetched.append((eng._committed[0], eng._pending_diffs is not None,
                        eng._emitting))
        return real_fetch(world)

    eng.stepper = dataclasses.replace(eng.stepper, fetch=fetch)
    reset_launches()
    legs = []

    def mark(name):
        legs.append((name, engine_counters(), read_launches(),
                     eng.completed_turns))

    ctls = []
    mark("start")
    server.start()
    try:
        wait_until(lambda: eng.completed_turns >= 4096, "headless turns")
        mark("headless")
        drv = Controller(*server.address, want_flips=True, batch=True,
                         timeout=60)
        ctls.append(drv)
        if not drv.wait_sync(60):
            raise AssertionError("main-serve-attach: no sync for the driver")
        sync_turn = drv.sync_turn
        sync_service = fetched[-1]
        mine = np.zeros((512, 512), np.uint8)
        for ev in drv.events:
            name = type(ev).__name__
            if name == "FlipBatch":
                mine[ev.cells[:, 1], ev.cells[:, 0]] ^= 255
            elif name == "TurnComplete" and ev.completed_turns == sync_turn + 1000:
                break
        if not drv.detach(60):
            raise AssertionError("main-serve-attach: the driver did not detach")
        mark("watched")
        # The in-flight diff chunk is flushed, then fused chunks resume.
        chunks = legs[-1][1]["dispatches[chunk]"]
        wait_until(lambda: engine_counters()["dispatches[chunk]"] >= chunks + 2,
                   "fused chunks after the detach")
        mark("flush")
        t = eng.completed_turns
        wait_until(lambda: eng.completed_turns >= t + 4096, "headless turns")
        mark("headless-2")
        ob = Controller(*server.address, want_flips=True, batch=True,
                        observe=True, timeout=60)
        ctls.append(ob)
        if not ob.wait_sync(60):
            raise AssertionError("main-serve-attach: no sync for the observer")
        seen = {}
        threads = [consume(ob, seen)]
        wait_until(lambda: seen.get("turns", 0) >= 500, "observed turns")
        mark("observed")
        killer = Controller(*server.address, want_flips=False, batch=True,
                            timeout=60)
        ctls.append(killer)
        if not killer.wait_sync(60):
            raise AssertionError("main-serve-attach: no sync for the 'k' driver")
        threads.append(consume(killer, {}))
        killer.send_key("k")
        join_all(threads)
        if not server.wait(120):
            raise AssertionError("main-serve-attach: the server did not stop")
    finally:
        for c in ctls:
            c.close()
        server.shutdown()
    mark("end")
    t_end, world = the_snapshot(out)
    if not torch.equal(packed_board(mine), oracle.at(sync_turn + 1000)):
        raise AssertionError("main-serve-attach: the driver's stream differs "
                             "from the plain run")
    if not np.array_equal(ob.board, world):
        raise AssertionError("main-serve-attach: the observer's board "
                             "differs from the snapshot")
    if not torch.equal(packed_board(world), oracle.at(t_end)):
        raise AssertionError("main-serve-attach: the snapshot differs from "
                             f"the plain run at turn {t_end}")
    if sync_service[0] != sync_turn or sync_service[2]:
        raise AssertionError(f"main-serve-attach: sync at {sync_turn}, "
                             f"served at {sync_service}")
    rows = []  # (leg, dispatches by kind, kernel A launches, turns)
    for (_, c0, l0, t0), (name, c1, l1, t1) in zip(legs, legs[1:]):
        kinds = {k[len("dispatches["):-1]: int(c1[k] - c0[k]) for k in c0
                 if k.startswith("dispatches[") and c1[k] != c0[k]}
        rows.append((name, kinds,
                     l1["bitlife_resident"] - l0["bitlife_resident"], t1 - t0))
    by = {r[0]: r for r in rows}
    if by["headless"][1].get("diffs") or not by["headless"][1].get("chunk"):
        raise AssertionError(f"main-serve-attach: headless leg {by['headless']}")
    if not by["watched"][1].get("diffs"):
        raise AssertionError(f"main-serve-attach: watched leg {by['watched']}")
    if by["headless-2"][1].get("diffs") or not by["headless-2"][1].get("chunk"):
        raise AssertionError(f"main-serve-attach: headless-2 leg "
                             f"{by['headless-2']}")
    if not by["observed"][1].get("diffs"):
        raise AssertionError(f"main-serve-attach: observed leg {by['observed']}")
    launches = legs[-1][2]["bitlife_resident"]
    if launches <= 0:
        raise AssertionError("main-serve-attach never launched bitlife_resident")
    phase("main-serve-attach", f"BoardSync at turn {sync_turn}, committed "
          f"turn when served {sync_service[0]} (diff chunk in flight: "
          f"{sync_service[1]}, mid-emission: {sync_service[2]}); legs "
          + "; ".join(f"{n}: {k}, {a} A launches, {d} turns"
                      for n, k, a, d in rows)
          + f"; 'k' at {t_end}: observer board = snapshot = plain run; "
          f"{launches} bitlife_resident launches; {card}")
    return launches


def serve_16384(tmp: pathlib.Path, card: str) -> int:
    """Phase `main-serve-16384`: a 16384² Life server, headless on kernel
    B's 2-D entry, paused a few chunks in while an observer attaches
    once: the BoardSync's bytes and seconds from hello to sync (waiting
    for the engine's boundary, the device fetch, the zlib compress, the
    send and the client's decode), equal to the plain version at its
    turn; then a driver's 'k' snapshot. The final frame of the board's
    alive cells is timed through the wire codec at its real size."""
    import dataclasses
    import socket
    import threading

    import numpy as np
    import torch

    from gol_tpu_torch.distributed import Controller, EngineServer
    from gol_tpu_torch.distributed import server as srv_mod
    from gol_tpu_torch.distributed import wire
    from gol_tpu_torch.ops import bitlife, life

    side = 16384
    world0 = life.random_world(side, side, seed=0)
    out = tmp / "serve16384"
    server = EngineServer(serve_params(out, image_width=side,
                                       image_height=side, chunk=64),
                          port=0, initial_world=world0)
    eng = server.engine
    legs = {}
    real_fetch = eng.stepper.fetch

    def fetch(world):
        t = time.perf_counter()
        host = real_fetch(world)
        legs.setdefault("fetch", []).append((t, time.perf_counter()))
        return host

    eng.stepper = dataclasses.replace(eng.stepper, fetch=fetch)
    real_frame = srv_mod.wire.board_to_frame

    def board_to_frame(turn, w, token=0):
        t = time.perf_counter()
        frame = real_frame(turn, w, token)
        legs.setdefault("compress", []).append((t, time.perf_counter(),
                                                len(frame)))
        return frame

    srv_mod.wire.board_to_frame = board_to_frame
    server._keys.put("p")
    reset_launches()
    ctls = []
    try:
        server.start()
        wait_until(lambda: eng._paused, "the engine to pause", 300)
        server._keys.put("p")
        wait_until(lambda: eng.completed_turns >= 128, "128 turns", 300)
        server._keys.put("p")
        wait_until(lambda: eng._paused, "the engine to pause again", 300)
        t_hello = time.perf_counter()
        ob = Controller(*server.address, want_flips=False, batch=True,
                        observe=True, timeout=60)
        ctls.append(ob)
        t_ack = time.perf_counter()
        if not ob.wait_sync(120):
            raise AssertionError("main-serve-16384: no sync")
        t_sync = time.perf_counter()
        sync_turn = ob.sync_turn
        (f0, f1), (c0, c1, nbytes) = legs["fetch"][-1], legs["compress"][-1]
        drv = Controller(*server.address, want_flips=False, batch=True,
                         timeout=60)
        ctls.append(drv)
        if not drv.wait_sync(120):
            raise AssertionError("main-serve-16384: no sync for the driver")
        got = {}

        def tail():
            for ev in drv.events:
                if type(ev).__name__ == "ImageOutputComplete":
                    got["image"] = time.perf_counter()
            got["end"] = time.perf_counter()

        threads = [threading.Thread(target=tail, daemon=True),
                   consume(ob, {})]
        threads[0].start()
        t_k = time.perf_counter()
        drv.send_key("k")
        join_all(threads, 300)
        if not server.wait(300):
            raise AssertionError("main-serve-16384: the server did not stop")
    finally:
        srv_mod.wire.board_to_frame = real_frame
        for c in ctls:
            c.close()
        server.shutdown()
    launches = read_launches()["bitlife_tiled"]
    want = bitlife.step_n_packed_raw(packed_board(world0), sync_turn)
    if not torch.equal(packed_board(ob.board), want):
        raise AssertionError("main-serve-16384: the synced board differs "
                             f"from the plain version at turn {sync_turn}")
    t_end, snap = the_snapshot(out)
    if t_end != sync_turn or not np.array_equal(snap, ob.board):
        raise AssertionError("main-serve-16384: the 'k' snapshot differs "
                             "from the paused board")
    if launches <= 0:
        raise AssertionError("main-serve-16384 never launched bitlife_tiled")
    phase("main-serve-16384", f"BoardSync of 16384² at turn {sync_turn}: "
          f"{nbytes} frame bytes ({side * side} raster bytes); hello -> sync "
          f"{t_sync - t_hello:.3f} s = ack {t_ack - t_hello:.3f} + wait for "
          f"the engine's boundary {f0 - t_ack:.3f} + fetch {f1 - f0:.3f} + "
          f"compress {c1 - c0:.3f} + send and decode {t_sync - c1:.3f} s; "
          f"equal to the plain version; 'k' -> snapshot written "
          f"{got['image'] - t_k:.3f} s, -> stream end {got['end'] - t_k:.3f} "
          f"s; {launches} bitlife_tiled launches; {card}")
    # The final frame: every alive cell of the board, through the codec
    # and a socket with the server's send timeout, at its real size.
    ys, xs = torch.nonzero(life.to_bits(torch.from_numpy(
        np.ascontiguousarray(snap)).cuda()), as_tuple=True)
    coords = torch.stack([xs, ys], 1).to(torch.int32).cpu().numpy()
    t0 = time.perf_counter()
    frame = wire.final_to_frame(t_end, coords)
    t1 = time.perf_counter()
    if len(frame) > wire.MAX_FRAME:
        raise AssertionError(f"final frame of {len(frame)} bytes exceeds "
                             f"MAX_FRAME {wire.MAX_FRAME}")
    a, b = socket.socketpair()
    a.settimeout(srv_mod._Conn.IO_TIMEOUT)  # the server's send timeout
    b.settimeout(60.0)
    sender = threading.Thread(target=wire.send_frame, args=(a, frame),
                              daemon=True)
    try:
        sender.start()
        msg = wire.recv_msg(b)
        t2 = time.perf_counter()
        sender.join(60)
    finally:
        a.close()
        b.close()
    if msg["turn"] != t_end or not np.array_equal(msg["coords"], coords):
        raise AssertionError("main-serve-16384: the final frame does not "
                             "round-trip")
    phase("main-serve-16384", f"final frame of {len(coords)} alive cells: "
          f"{len(frame)} bytes (MAX_FRAME {wire.MAX_FRAME}), encode "
          f"{t1 - t0:.3f} s, send + receive + decode {t2 - t1:.3f} s; {card}")
    return launches


def serve_gens(tmp: pathlib.Path, card: str) -> int:
    """Phase `main-serve-gens`: a B2/S/C3 512² server (kernel C) paused at
    turn 0 while a level-capable driver and an observer without levels
    attach; 300 watched turns, then 'k'. The driver's shadow gray levels
    equal the snapshot, the snapshot the plain planes at its turn, and
    the observer gets plain flips."""
    import threading

    import numpy as np

    from gol_tpu_torch.distributed import Controller, EngineServer
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitgens
    from gol_tpu_torch.parallel import make_stepper

    rule = "B2/S/C3"
    out = tmp / "serve-gens"
    server = EngineServer(serve_params(out, rule=rule), port=0)
    server._keys.put("p")
    reset_launches()
    before = engine_counters()
    server.start()
    ctls = []
    try:
        wait_until(lambda: server.engine._paused, "the engine to pause")
        drv = Controller(*server.address, want_flips=True, batch=True,
                         levels=True, timeout=60)
        ob = Controller(*server.address, want_flips=True, batch=True,
                        observe=True, timeout=60)
        ctls += [drv, ob]
        for c in ctls:
            if not c.wait_sync(60):
                raise AssertionError("main-serve-gens: a peer got no sync")
        seen, plain_flips = {}, []

        def watch_ob():
            for ev in ob.events:
                if type(ev).__name__ == "FlipBatch" and len(ev.cells):
                    plain_flips.append(ev.levels is None)

        threads = [consume(drv, seen),
                   threading.Thread(target=watch_ob, daemon=True)]
        threads[1].start()
        drv.send_key("p")
        wait_until(lambda: seen.get("turns", 0) >= 300, "300 watched turns")
        drv.send_key("k")
        join_all(threads)
        if not server.wait(120):
            raise AssertionError("main-serve-gens: the server did not stop")
    finally:
        for c in ctls:
            c.close()
        server.shutdown()
    launches = read_launches()["bitgens_resident"]
    kinds = dispatch_kinds(before)
    t_end, world = the_snapshot(out)
    if not np.array_equal(drv.board, world):
        raise AssertionError("main-serve-gens: the shadow gray levels "
                             "differ from the snapshot")
    ref = make_stepper(height=512, width=512, rule=rule, backend="packed")
    q = ref.put(read_pgm(FIXTURES / "images/512x512.pgm"))
    for _ in range(t_end):
        q = bitgens.step_packed_gens(q, get_rule(rule))
    if not np.array_equal(ref.fetch(q), world):
        raise AssertionError("main-serve-gens: the snapshot differs from the "
                             f"plain planes at turn {t_end}")
    if not plain_flips or not all(plain_flips):
        raise AssertionError("main-serve-gens: the observer without levels "
                             "got no plain flips")
    if launches <= 0:
        raise AssertionError("main-serve-gens never launched bitgens_resident")
    phase("main-serve-gens", f"EngineServer 512² {rule}: 'k' at turn {t_end}, "
          f"the level driver's gray board = snapshot = plain planes; the "
          f"observer without levels got {len(plain_flips)} plain flip "
          f"batches; dispatches {kinds}; {launches} bitgens_resident "
          f"launches; {card}")
    return launches


def serve_cli(tmp: pathlib.Path, card: str, oracle: PlainLife) -> dict:
    """Phase `cli-serve`: `python -m gol_tpu_torch --serve 0` in one
    process, `--connect -noVis` in another on a terminal (a pty), whose
    'k' ends both; the walls of both processes, the served engine's
    kernel A dispatches (its /metrics), the snapshot against the plain
    run."""
    import os
    import pty
    import re
    import urllib.request

    import torch

    out = tmp / "cli-serve"
    common = ["-w", "512", "-h", "512", "--images",
              str(FIXTURES / "images"), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    master, slave = pty.openpty()
    procs = []
    try:
        t0 = time.perf_counter()
        srv = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", "--serve", "0",
             "-turns", str(10**9), "--tick", "0.5", "--metrics-port", "0",
             *common],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO))
        procs.append(srv)
        port = metrics = None
        for line in srv.stdout:
            if line.startswith("engine serving on "):
                port = int(line.rsplit(":", 1)[1])
                t_listen = time.perf_counter()
            m = re.search(r"metrics serving on http://([^/]+)/metrics", line)
            if m:
                metrics = m.group(1)
                break
        if port is None or metrics is None:
            raise AssertionError("cli-serve: the server printed no address")
        t1 = time.perf_counter()
        con = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", "--connect",
             f"127.0.0.1:{port}", "-noVis", *common],
            stdin=slave, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(REPO))
        procs.append(con)
        lines = []
        for line in con.stdout:
            lines.append(line)
            if line.startswith("Completed Turns"):
                break
        t_attached = time.perf_counter()
        with urllib.request.urlopen(f"http://{metrics}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        dispatched = sum(float(ln.rsplit(" ", 1)[1])
                         for ln in text.splitlines()
                         if ln.startswith("gol_tpu_stepper_dispatches_total")
                         and 'entry="step_n"' in ln)
        os.write(master, b"k")
        rest, _ = con.communicate(timeout=120)
        t_con = time.perf_counter()
        srv_rest, _ = srv.communicate(timeout=120)
        t_srv = time.perf_counter()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        os.close(master)
        os.close(slave)
    if srv.returncode != 0 or con.returncode != 0:
        raise AssertionError(f"cli-serve: exit codes {srv.returncode}, "
                             f"{con.returncode}: {srv_rest[-2000:]} "
                             f"{rest[-2000:]}")
    t_end, world = the_snapshot(out)
    if not torch.equal(packed_board(world), oracle.at(t_end)):
        raise AssertionError("cli-serve: the snapshot differs from the plain "
                             f"run at turn {t_end}")
    if dispatched <= 0:
        raise AssertionError("cli-serve: the served engine dispatched no "
                             "step_n")
    phase("cli-serve", f"--serve 0 process: listening {t_listen - t0:.3f} s "
          f"after spawn, exit {t_srv - t0:.3f} s; --connect -noVis process: "
          f"attached {t_attached - t1:.3f} s after spawn, exit after 'k' "
          f"{t_con - t1:.3f} s; snapshot at turn {t_end} = plain run; "
          f"{int(dispatched)} step_n dispatches (kernel A launches) by the "
          f"served engine's /metrics before 'k'; {card}")
    return {"turn": t_end, "step_n": dispatched}


def serving(tmp: pathlib.Path, card: str) -> dict:
    """The serving phases; {kernel: {phase: launches}}."""
    from gol_tpu_torch.io.pgm import read_pgm

    oracle = PlainLife(read_pgm(FIXTURES / "images/512x512.pgm"))
    t0 = time.perf_counter()
    a1 = serve_512(tmp, card, oracle)
    serve_512(tmp, card, oracle, device="cpu")
    a2 = serve_attach(tmp, card, oracle)
    b = serve_16384(tmp, card)
    c = serve_gens(tmp, card)
    serve_cli(tmp, card, oracle)
    phase("serving", f"{time.perf_counter() - t0:.1f} s for the serving "
          "phases")
    return {"bitlife_resident": {"main-serve-512": a1,
                                 "main-serve-attach": a2},
            "bitlife_tiled": {"main-serve-16384": b},
            "bitgens_resident": {"main-serve-gens": c}}


#: The session lane (bench.py's `sessions_64x256`): boards, side, turns
#: per chunk, rounds.
LANE_SESSIONS, LANE_SIDE, LANE_K, LANE_ROUNDS = 64, 256, 16, 4
#: Phase `kernels`' bucket stacks of kernel A's batched entry: (boards,
#: height, width), and the turns of each launch.
BUCKET_STACKS = ((1, 256, 256), (16, 256, 256), (64, 256, 256),
                 (16, 64, 64), (16, 32, 512))
BUCKET_TURNS = (0, 1, 16, 256)


def bucket_soups(n: int, h: int, w: int, seed: int, zero_every: int = 0):
    """n seeded soups as an (n, h, w) {0,255} uint8 host stack; every
    `zero_every`-th slot an all-zero padding board."""
    import numpy as np

    from gol_tpu_torch.sessions.manager import seeded_board

    out = np.stack([seeded_board(h, w, seed + i) for i in range(n)])
    if zero_every:
        out[::zero_every] = 0
    return out


def check_session_kernels(errs: dict) -> None:
    """Phase `kernels`, the session buckets: kernel A's batched entry
    at the bucket shapes — 1, 16 and 64 boards of 256², 16 of 64², 16 of
    32 x 512, n = 0, 1, 16 and 256, every fourth slot a zero padding
    board — bit-exact against the batched plain step, one launch a
    stack; then the two per-slot routes of `make_batch_stepper` (kernel
    B on 2 x 4096², kernel E on 4 x 100²) against the plain steps, a
    launch per slot per pass; the padding slots stay zero."""
    import numpy as np
    import torch

    from gol_tpu_torch.ops import bitlife, life
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl
    from gol_tpu_torch.parallel.stepper import bucket_route, make_batch_stepper

    checked = 0
    for s, h, w in BUCKET_STACKS:
        if bucket_route(h, w) != "resident":
            raise AssertionError(f"{h}x{w}: no kernel-A cluster plan")
        host = bucket_soups(s, h, w, seed=s + h, zero_every=4)
        stack = torch.from_numpy(np.stack(
            [bitlife.pack_np(b) for b in host]).view(np.int32)).cuda()
        want = plain_turns(lambda x, k: bitlife.step_n_packed_raw(x, k),
                           stack, BUCKET_TURNS)
        for n in BUCKET_TURNS:
            before = cb.LAUNCHES["bitlife_resident"]
            got = cb.step_n_packed_batch_cuda_raw(stack, n)
            torch.cuda.synchronize()
            if cb.LAUNCHES["bitlife_resident"] - before != 1:
                raise AssertionError("a bucket step is not one launch")
            err = max_abs_err(got, want[n])
            errs["bitlife_resident_sessions"] = max(
                errs["bitlife_resident_sessions"], err)
            if err or got[::4].any():
                raise AssertionError(f"bucket {s} x {h}x{w} n={n}: mismatch "
                                     "or a padding slot woke")
            checked += 1
    for (s, h, w, route, kernel, table, ns) in (
            (2, 4096, 4096, "tiled2d", "bitlife_tiled", cb.LAUNCHES, (1, 64)),
            (4, 100, 100, "dense", "life_dense", cl.LAUNCHES, (1, 16))):
        if bucket_route(h, w) != route:
            raise AssertionError(f"{h}x{w} is not a {route} bucket")
        bs = make_batch_stepper(s, h, w)
        host = bucket_soups(s, h, w, seed=h, zero_every=2)
        stack = bs.put_all(list(host))
        for n in ns:
            before = table[kernel]
            got, counts = bs.step_n(stack, n)
            torch.cuda.synchronize()
            if table[kernel] - before < s:
                raise AssertionError(f"{route}: under a launch a slot")
            if bs.packed:
                want = bitlife.step_n_packed_raw(stack, n)
                wc = bitlife.popcount(want).sum(dim=(1, 2))
            else:
                want = torch.stack([life.step_n(b, n) for b in stack])
                wc = (want != 0).sum(dim=(1, 2))
            err = max_abs_err(got, want)
            errs[kernel] = max(errs[kernel], err)
            if err or got[::2].any() or not torch.equal(counts.long(),
                                                        wc.long()):
                raise AssertionError(f"{route} bucket {s} x {h}x{w} n={n}: "
                                     "mismatch")
            checked += 1
    phase("kernels", f"{checked} session-bucket runs bit-exact against the "
                     f"plain steps: kernel A batched on {BUCKET_STACKS} "
                     f"(boards, H, W), n = {BUCKET_TURNS}, one launch a "
                     f"stack; kernel B per slot on 2 x 4096², kernel E per "
                     f"slot on 4 x 100²; padding slots stay zero")


class ShadowSink:
    """A session sink applying the flip stream to a shadow board, as a
    watching client does: its final board and turn are checked against
    the manager's and the plain version."""

    want_flips = True
    ephemeral = False
    batch_turns = 0

    def __init__(self):
        self.board, self.turn, self.turns = None, None, 0

    def on_sync(self, sid, turn, board):
        import numpy as np

        self.board, self.turn = np.array(board), turn

    def on_flips(self, sid, turn, coords):
        import numpy as np

        xy = np.asarray(coords).reshape(-1, 2)
        self.board[xy[:, 1], xy[:, 0]] ^= np.uint8(255)

    def on_flip_chunk(self, sid, first_turn, counts, bitmaps, words):
        raise AssertionError("a per-turn sink got a chunk")

    def on_turn(self, sid, turn):
        self.turn = turn
        self.turns += 1

    def on_close(self, sid, reason):
        pass


def plain_stack(boards, turns):
    """The plain packed step on the card: each (H, W) host board of
    `boards` (one shape) `turns` turns on, as host {0,255} boards."""
    import numpy as np
    import torch

    from gol_tpu_torch.ops import bitlife

    h = boards[0].shape[0]
    p = torch.from_numpy(np.stack([bitlife.pack_np(b) for b in boards])
                         .view(np.int32)).cuda()
    p = bitlife.step_n_packed_raw(p, turns)
    return [bitlife.unpack_np(q.view(np.uint32), h)
            for q in p.cpu().numpy()]


def session_metrics() -> dict:
    from gol_tpu_torch import obs

    out = {}
    for path in ("fused", "diffs", "compact"):
        out[f"dispatches[{path}]"] = obs.counter(
            "gol_tpu_session_dispatches_total",
            labels={"path": path}).value
        out[f"seconds[{path}]"] = obs.histogram(
            "gol_tpu_session_dispatch_seconds",
            labels={"path": path}).snapshot_value()["sum"]
    out["compact_redos"] = obs.counter(
        "gol_tpu_session_compact_redos_total").value
    out["bucket_grows"] = obs.counter(
        "gol_tpu_session_bucket_grows_total").value
    return out


def session_moved(before: dict) -> dict:
    after = session_metrics()
    return {k: round(after[k] - before[k], 6) for k in after
            if after[k] != before[k]}


def main_sessions(tmp: pathlib.Path, card: str) -> dict:
    """Phase `main-sessions`: SessionManager + SessionEngine on the card,
    bucket capacity 16. Inline first (no engine thread): 64 sessions of
    256² from `seeded_board` (the bucket grows 16 -> 32 -> 64), 2 of
    4096² (kernel B) and 4 of 100² (kernel E); one unwatched 256-turn
    chunk (one kernel A launch for the 64 boards) and one watched
    16-turn chunk (16 launches); every board against the plain version
    from its birth. Then the engine thread free-runs: 1024 more turns,
    8 sinks watching 128 turns (plain diffs, then compact, then a dense
    soup swapped into a slot forcing a redo), one park and rehydrate.
    The card steps a 256² bucket far faster than the plain version can
    follow from birth, so under the engine each board is held against
    the plain version over a window: from a snapshot to the next one,
    and for each watcher from its attach to its detach, its shadow
    equal to the board. Returns the launches by kernel."""
    import numpy as np
    import torch

    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import life
    from gol_tpu_torch.sessions import SessionEngine, SessionManager
    from gol_tpu_torch.sessions.manager import seeded_board

    m = SessionManager(out_dir=str(tmp / "main-sessions"),
                       bucket_capacity=16)
    side, big_side = LANE_SIDE, 4096
    ids = [f"s{i:02d}" for i in range(LANE_SESSIONS)]
    # Sparse soups (gol_tpu's own session tests take 0.04): they settle
    # within a few chunks, so the watchers' bucket rides the compact
    # path once its cap is set.
    boards0 = {sid: seeded_board(side, side, 1000 + i, density=0.04)
               for i, sid in enumerate(ids)}
    big = {f"b{i}": seeded_board(big_side, big_side, 2000 + i)
           for i in range(2)}
    small = {f"e{i}": seeded_board(100, 100, 3000 + i) for i in range(4)}
    boards0.update(big)
    boards0.update(small)
    every = list(boards0)
    reset_launches()
    before = session_metrics()
    t0 = time.perf_counter()
    for sid, b in boards0.items():
        m.create(sid, width=b.shape[1], height=b.shape[0], board=b)
    bucket = m.get(ids[0]).bucket
    if bucket.bs.capacity != LANE_SESSIONS:
        raise AssertionError(f"bucket grew to {bucket.bs.capacity}")
    # Inline, no engine yet: one fused chunk and one watched chunk.
    a0 = read_launches()["bitlife_resident"]
    m._exec(lambda: m._dispatch_bucket(bucket, 256))
    fused_launches = read_launches()["bitlife_resident"] - a0
    probe = ShadowSink()
    m.attach(ids[0], probe)
    a0 = read_launches()["bitlife_resident"]
    m._exec(lambda: m._dispatch_bucket(bucket, 16))
    watched_launches = read_launches()["bitlife_resident"] - a0
    m.detach(ids[0], probe)
    if (fused_launches, watched_launches) != (1, 16):
        raise AssertionError(f"64 x 256² bucket: {fused_launches} launches "
                             f"a fused chunk, {watched_launches} a watched "
                             "16-turn chunk (want 1 and 16)")
    # The 4096² and 100² buckets catch up. Their routes launch once per
    # slot per pass, padding slots included: kernel B's 2-D entry runs
    # 32 turns a pass, kernel E `_dense_plan`'s depth; each bucket's
    # launches are held to capacity x passes.
    from gol_tpu_torch.ops import cuda_bitlife as cb, cuda_life

    per_slot = {}
    for b in (b for b in m._buckets.values() if b is not bucket):
        h, w = b.bs.height, b.bs.width
        kernel, per_pass = (
            ("bitlife_tiled", cb._tiled2d_geometry(h // 32, w, None).turns)
            if b.bs.packed else
            ("life_dense", cuda_life._dense_plan(h, w)[4]))
        n0 = read_launches()[kernel]
        stepped = m._exec(lambda b=b: [m._dispatch_bucket(b, k)
                                       for k in (256, 16)])
        got = read_launches()[kernel] - n0
        want = b.bs.capacity * sum(-(-k // per_pass) for k in stepped)
        if got != want:
            raise AssertionError(
                f"{b.live} x {h}x{w} bucket of capacity {b.bs.capacity}: "
                f"{got} {kernel} launches over chunks {stepped}, want "
                f"capacity x passes = {want}")
        per_slot[f"{h}x{w}"] = {
            "kernel": kernel, "live": b.live, "capacity": b.bs.capacity,
            "turns": stepped, "launches": got,
            "padding_factor": round(b.bs.capacity / b.live, 2)}

    def snapshot(sids):
        return m._exec(lambda: {
            sid: (m._by_id[sid].turn, m._fetch_board(sid)) for sid in sids})

    def plain_of(board, turns):
        if board.shape[0] % 32:
            return life.step_n(torch.from_numpy(board).cuda(),
                               turns).cpu().numpy()
        return plain_stack([board], turns)[0]

    def hold(s1, s2, what):
        """Every board of snapshot s2 is the plain version of s1's."""
        lanes = [sid for sid in s2 if boards0[sid].shape == (side, side)]
        for dt in {s2[sid][0] - s1[sid][0] for sid in lanes}:
            group = [sid for sid in lanes if s2[sid][0] - s1[sid][0] == dt]
            want = plain_stack([s1[sid][1] for sid in group], dt)
            for sid, w in zip(group, want):
                if not np.array_equal(s2[sid][1], w):
                    raise AssertionError(f"main-sessions ({what}): {sid} "
                                         "differs from the plain version")
        for sid in s2:
            if sid not in lanes and not np.array_equal(
                    s2[sid][1], plain_of(s1[sid][1],
                                         s2[sid][0] - s1[sid][0])):
                raise AssertionError(f"main-sessions ({what}): {sid} differs "
                                     f"from the plain version")

    birth = {sid: (0, b) for sid, b in boards0.items()}
    snap = snapshot(every)
    turns = {t for t, _ in snap.values()}
    if turns != {272}:
        raise AssertionError(f"main-sessions: boards at turns {turns}")
    hold(birth, snap, "inline, from birth")
    eng = SessionEngine(m).start()
    try:
        t_run = m.peek_turn(ids[0])
        wait_until(lambda: m.peek_turn(ids[0]) >= t_run + 1024,
                   "1024 turns")
        s1 = snapshot(every)
        wait_until(lambda: min(m.peek_turn(s) for s in every)
                   >= max(t for t, _ in s1.values()) + 256, "256 turns")
        hold(s1, snapshot(every), "engine, over a window")
        t_fused = time.perf_counter()
        # 8 watchers: plain diffs first, the compact path once the
        # bucket's cap is set, then a dense soup swapped into one slot.
        watched = ids[:8]
        sinks = {sid: ShadowSink() for sid in watched}

        def attach_all():
            for sid in watched:
                m._attach(sid, sinks[sid])
            return {sid: (m._by_id[sid].turn, m._fetch_board(sid))
                    for sid in watched}

        at_attach = m._exec(attach_all)
        t_attach = at_attach[watched[0]][0]
        wait_until(lambda: m.peek_turn(ids[0]) >= t_attach + 64,
                   "64 watched turns")
        burst = (np.random.default_rng(5).random((side, side)) < 0.45
                 ).astype(np.uint8) * np.uint8(255)

        def swap():
            s = m._by_id[watched[0]]
            b = s.bucket
            b.stack = b.bs.set_one(b.stack, s.slot, burst)
            # The watcher resyncs to the swapped board, as the
            # manager's own sync would hand it.
            sinks[watched[0]].on_sync(watched[0], s.turn, burst)
            return s.turn

        t_swap = m._exec(swap)
        wait_until(lambda: m.peek_turn(ids[0]) >= t_attach + 128,
                   "128 watched turns")

        def detach_all():
            out = {}
            for sid in watched:
                m._detach(sid, sinks[sid])
                out[sid] = (m._by_id[sid].turn, m._fetch_board(sid))
            return out

        done = m._exec(detach_all)
        t_watched = time.perf_counter()
        for sid in watched:
            t_s, board = done[sid]
            sk = sinks[sid]
            if sk.turn != t_s or not np.array_equal(sk.board, board):
                raise AssertionError(f"main-sessions: {sid}'s shadow at "
                                     f"turn {sk.turn} differs from the "
                                     f"board at {t_s}")
        hold({**at_attach, watched[0]: (t_swap, burst)}, done, "watched")
        # Park one unwatched session (its snapshot and the park in one
        # verb) and rehydrate it by attaching.
        sid = ids[40]

        def park():
            turn, board = m._by_id[sid].turn, m._fetch_board(sid)
            return turn, board, m._park(sid)

        turn_p, board_p, parked = m._exec(park)
        probe = ShadowSink()
        m.attach(sid, probe)
        if (parked["turn"] != turn_p or probe.turn != turn_p
                or not np.array_equal(read_pgm(parked["path"]), board_p)
                or not np.array_equal(probe.board, board_p)):
            raise AssertionError("main-sessions: the parked or rehydrated "
                                 "board differs from the live one")
        m.detach(sid, probe)
    finally:
        eng.stop()
        eng.join(60)
        m.close()
    if eng.error is not None:
        raise AssertionError(f"main-sessions: engine error {eng.error!r}")
    launches = read_launches()
    series = session_moved(before)
    for k in ("bitlife_resident", "bitlife_tiled", "life_dense"):
        if launches[k] <= 0:
            raise AssertionError(f"main-sessions never launched {k}")
    if series.get("compact_redos", 0) < 1 or series.get(
            "dispatches[compact]", 0) < 1:
        raise AssertionError(f"main-sessions: no compact chunk or no "
                             f"redo: {series}")
    dispatches = sum(v for k, v in series.items()
                     if k.startswith("dispatches["))
    per = {k: round(v / max(dispatches, 1), 2)
           for k, v in launches.items() if v}
    phase("main-sessions", f"64 x 256² soups at 0.04 (bucket 16 -> 32 -> "
          f"64), 2 x "
          f"{big_side}², 4 x 100²: 1 kernel A launch a fused 256-turn chunk "
          f"of the 64, {watched_launches} a watched 16-turn chunk; every "
          f"board = plain version at turn 272; per-slot buckets "
          f"(capacity x passes, padding included) {per_slot}; engine: "
          f"1024+ turns, a "
          f"window of 256+ turns = plain version, 8 watchers x 128 turns "
          f"with a forced compact redo ({t_watched - t_fused:.3f} s), "
          f"shadows = boards = plain version, park/rehydrate at turn "
          f"{turn_p} bit-exact; launches "
          f"{ {k: v for k, v in launches.items() if v} } over "
          f"{dispatches:.0f} dispatches ({per} a dispatch); dispatch series "
          f"{series}; {time.perf_counter() - t0:.1f} s; {card}")
    return {k: v for k, v in launches.items() if v}


def sessions_lane(card: str) -> dict:
    """Phase `sessions-lane`: bench.py's `sessions_64x256` on the card.
    64 boards of 256² stepped 4 rounds of 16 turns as ONE bucket (one
    kernel A launch and one count read a round) against 64 sequential
    single-board steppers (64 launches and reads a round), best of 2;
    aggregate turns/s, launches per round, and the device's busy share
    over the bucket's rounds (a torch.profiler capture)."""
    import numpy as np
    import torch

    from gol_tpu_torch.parallel.stepper import make_batch_stepper, make_stepper

    n, side, k, rounds = LANE_SESSIONS, LANE_SIDE, LANE_K, LANE_ROUNDS
    rng = np.random.default_rng(1234)
    boards = [((rng.random((side, side)) < 0.25) * 255).astype(np.uint8)
              for _ in range(n)]
    bs = make_batch_stepper(n, side, side)
    stack0 = bs.put_all(boards)
    bs.step_n(stack0, k)[1].cpu()  # warm

    def bucket_rounds():
        stack = stack0
        for _ in range(rounds):
            stack, c = bs.step_n(stack, k)
            c.cpu()
        return stack

    st = make_stepper(height=side, width=side)
    worlds0 = [st.put(b) for b in boards]
    int(st.step_n(worlds0[0], k)[1])  # warm

    def sequential_rounds():
        worlds = list(worlds0)
        for _ in range(rounds):
            for i in range(n):
                worlds[i], c = st.step_n(worlds[i], k)
                int(c)
        return worlds

    def best(fn):
        out = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            out = min(out, time.perf_counter() - t0)
        return out

    reset_launches()
    t_b = best(bucket_rounds)
    per_round_b = read_launches()["bitlife_resident"] / (2 * rounds)
    reset_launches()
    t_s = best(sequential_rounds)
    per_round_s = read_launches()["bitlife_resident"] / (2 * rounds)
    if (per_round_b, per_round_s) != (1, n):
        raise AssertionError(f"sessions-lane: {per_round_b} and "
                             f"{per_round_s} launches a round")
    final = bucket_rounds()
    want = plain_stack(boards, k * rounds)
    for i in (0, n // 2, n - 1):
        if not np.array_equal(bs.fetch_one(final, i), want[i]):
            raise AssertionError(f"sessions-lane: board {i} differs")
    trace = pathlib.Path(tempfile.mkdtemp(dir=REPO / "build")) / "lane.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("gol_tpu_torch.run"):
            bucket_rounds()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    busy = busy_share(trace, "bitlife_resident")
    agg, seq = n * k * rounds / t_b, n * k * rounds / t_s
    phase("sessions-lane", f"{n} x {side}², k = {k}, {rounds} rounds, best "
          f"of 2: bucket {agg:.1f} aggregate turns/s ({t_b * 1e3:.3f} ms), "
          f"{n} sequential steppers {seq:.1f} ({t_s * 1e3:.3f} ms), "
          f"x{agg / seq:.2f}; kernel A launches a round {per_round_b:.0f} "
          f"against {per_round_s:.0f}; the bucket's rounds busy the card "
          f"{busy}; {card}")
    return {"bitlife_resident": int(per_round_b * 2 * rounds)}


class SessionWatch:
    """A session client's consumed stream on a thread: the shadow board
    (flip batches applied as they are consumed, the sync a burst against
    zeros) and the last completed turn, with (turns, seconds, link bytes)
    of the first `stop_after` turns past the sync."""

    def __init__(self, ctl, side, stats=None, stop_after=0):
        import threading

        import numpy as np

        self.ctl, self.stats, self.stop_after = ctl, stats, stop_after
        self.board = np.zeros((side, side), bool)
        self.last, self.turns, self.window = None, 0, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import numpy as np

        t0 = b0 = None
        for ev in self.ctl.events:
            kind = type(ev).__name__
            if kind == "FlipBatch" and len(ev.cells):
                xy = np.asarray(ev.cells).reshape(-1, 2)
                self.board[xy[:, 1], xy[:, 0]] ^= True
            elif kind == "TurnComplete":
                self.last = ev.completed_turns
                if ev.completed_turns <= self.ctl.sync_turn:
                    continue
                if t0 is None:
                    t0 = time.perf_counter()
                    b0 = self.stats["down"] if self.stats else 0
                self.turns += 1
                if self.stop_after and self.turns == self.stop_after + 1:
                    self.window = (
                        self.stop_after, time.perf_counter() - t0,
                        (self.stats["down"] if self.stats else 0) - b0)


def serve_sessions(tmp: pathlib.Path, card: str, device=None,
                   watch: int = 2000) -> dict:
    """One leg of `main-sessions-serve`: a SessionServer with record=True
    (on the card, or with `device="cpu"` on the host CPU), 16 x 256²
    sessions created over SessionControl, a batching binary delta driver
    (through the byte-counting proxy) and an observer on one session,
    `watch` delivered turns; the driver's consumed shadow against the
    recording's board at its last turn; a live seek to turn 64 against
    the plain version. Returns the leg's numbers and its out tree."""
    import numpy as np

    from gol_tpu_torch.distributed import (Controller, SessionControl,
                                           SessionServer)
    from gol_tpu_torch.replay.log import board_at
    from gol_tpu_torch.sessions.manager import seeded_board

    side = LANE_SIDE
    out = tmp / f"serve-sessions-{device or 'card'}"
    srv = SessionServer(serve_params(out, image_width=side,
                                     image_height=side),
                        port=0, record=True, keyframe_turns=256,
                        device=device)
    reset_launches()
    before = session_metrics()
    srv.start()
    ctls, close_proxy = [], None
    try:
        with SessionControl(*srv.address, timeout=60) as sc:
            for i in range(16):
                sc.create(f"w{i:02d}", width=side, height=side, seed=500 + i)
        addr, stats, close_proxy = counting_proxy(srv.address)
        drv = Controller(*addr, session="w00", want_flips=True, batch=True,
                         binary=True, delta=True, timeout=60,
                         reconnect=False)
        obs_ = Controller(*srv.address, session="w00", want_flips=True,
                          batch=True, observe=True, timeout=60,
                          reconnect=False)
        ctls = [drv, obs_]
        for c in ctls:
            if not c.wait_sync(60):
                raise AssertionError("main-sessions-serve: no sync")
        w = SessionWatch(drv, side, stats, stop_after=watch)
        ob = SessionWatch(obs_, side)
        wait_until(lambda: w.window is not None, f"{watch} watched turns",
                   300)
        r = drv.seek(64, timeout=60)
        if not r.get("ok") or not r["keyframe"] <= 64 <= r["turn"]:
            raise AssertionError(f"main-sessions-serve: seek reply {r}")
        landed = r["turn"]
        seek_plain = plain_stack([seeded_board(side, side, 500)], landed)[0]
        wait_until(lambda: np.array_equal(drv.board != 0, seek_plain != 0),
                   "the seek's board", 60)
        if not drv.seek("live", timeout=60).get("ok"):
            raise AssertionError("main-sessions-serve: live rejoin failed")
        for c in ctls:
            c.detach(60)
        for x in (w, ob):
            x.thread.join(60)
    finally:
        for c in ctls:
            c.close()
        srv.shutdown()
        if close_proxy is not None:
            close_proxy()
    # After the detach the streams have ended: each client's board, and
    # the observer's consumed shadow, are the plain version's board at
    # the last turn each consumed (the served bucket path: kernel, compact
    # encoding, demux), and the recording's there (the recorder).
    rdir = out / "sessions" / "w00" / "replay"
    for name, c, x in (("driver", drv, w), ("observer", obs_, ob)):
        plain = plain_stack([seeded_board(side, side, 500)], x.last)[0]
        if not np.array_equal(c.board != 0, plain != 0):
            raise AssertionError(f"main-sessions-serve: the {name}'s board "
                                 f"at turn {x.last} differs from the "
                                 "plain version")
        t_rec, rec = board_at(rdir, x.last)
        if t_rec != x.last or not np.array_equal(c.board != 0, rec != 0):
            raise AssertionError(f"main-sessions-serve: the {name}'s board "
                                 f"at turn {x.last} differs from the "
                                 "recording's")
    if not np.array_equal(ob.board, board_at(rdir, ob.last)[1] != 0):
        raise AssertionError("main-sessions-serve: the observer's consumed "
                             "shadow differs from the recording")
    launches = read_launches()
    turns, secs, nbytes = w.window
    return {"turns_per_sec": turns / secs, "turns": turns, "secs": secs,
            "bytes_per_turn": nbytes / turns, "seek": r, "out": out,
            "launches": {k: v for k, v in launches.items() if v},
            "series": session_moved(before)}


def main_sessions_serve(tmp: pathlib.Path, card: str) -> dict:
    """Phase `main-sessions-serve`: the session server on the card and
    on the host CPU (`serve_sessions`), then a ReplayServer over the
    card leg's recorded tree: a cold observer seeks to turn 512 and its
    board is the plain version's there. Returns the card leg's launches
    by kernel."""
    import numpy as np

    from gol_tpu_torch.distributed import Controller
    from gol_tpu_torch.replay import ReplayServer
    from gol_tpu_torch.sessions.manager import seeded_board

    t0 = time.perf_counter()
    card_leg = serve_sessions(tmp, card)
    cpu_leg = serve_sessions(tmp, card, device="cpu")
    rs = ReplayServer(str(card_leg["out"] / "sessions"), port=0,
                      replay_rate=0).start()
    try:
        ctl = Controller(*rs.address, session="w03", want_flips=True,
                         batch=True, batch_turns=1024,
                         batch_flip_events=False, observe=True, timeout=60,
                         reconnect=False)
        try:
            if not ctl.wait_sync(60):
                raise AssertionError("main-sessions-serve: no replay sync")
            r = ctl.seek(512, timeout=60)
            want = plain_stack([seeded_board(LANE_SIDE, LANE_SIDE, 503)],
                               r["turn"])[0]
            wait_until(lambda: np.array_equal(ctl.board != 0, want != 0),
                       "the replayed board at the seek", 60)
        finally:
            ctl.close()
    finally:
        rs.shutdown()
    if card_leg["launches"].get("bitlife_resident", 0) <= 0:
        raise AssertionError("main-sessions-serve never launched kernel A")
    phase("main-sessions-serve", f"SessionServer --record, 16 x 256², a "
          f"batching binary delta driver through the proxy and an observer "
          f"on one session: on the card {card_leg['turns_per_sec']:.1f} "
          f"delivered turns/s over {card_leg['turns']} turns "
          f"({card_leg['secs']:.3f} s), {card_leg['bytes_per_turn']:.1f} "
          f"link bytes/turn; with the buckets on the host CPU "
          f"{cpu_leg['turns_per_sec']:.1f} turns/s "
          f"({cpu_leg['secs']:.3f} s), {cpu_leg['bytes_per_turn']:.1f} "
          f"bytes/turn; live seek to 64 landed at {card_leg['seek']['turn']} "
          f"= plain version; a cold replay client's seek to 512 landed at "
          f"{r['turn']} = plain version; card launches "
          f"{card_leg['launches']}, session series {card_leg['series']}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    return card_leg["launches"]


def cli_sessions(tmp: pathlib.Path, card: str) -> dict:
    """Phase `cli-sessions`: `python -m gol_tpu_torch --serve 0 --sessions
    --record` (on the card) with a session created over SessionControl
    and a `--connect --session ID -noVis` process attached to it (the
    server counts its watcher); then `--replay out/sessions --serve 0
    --replay-rate 0` and a `--connect --session ID --observe` process on
    it. ^C (SIGINT) ends each process; the servers exit 0."""
    import os
    import queue
    import re
    import signal
    import threading

    from gol_tpu_torch.distributed import SessionControl
    from gol_tpu_torch.replay.log import scan_segments

    out = tmp / "cli-sessions"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []

    def spawn(*args):
        p = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", *args],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
        p.lines = queue.Queue()
        p.log = []

        def pump():
            for line in p.stdout:
                p.log.append(line)
                p.lines.put(line)

        threading.Thread(target=pump, daemon=True).start()
        procs.append(p)
        return p

    def address(p, prefix):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                line = p.lines.get(timeout=0.1)
            except queue.Empty:
                if p.poll() is not None:
                    break
                continue
            m = re.match(prefix + r" on ([\d.]+):(\d+)", line)
            if m:
                return m.group(1), int(m.group(2))
        raise AssertionError(f"cli-sessions: no {prefix!r} line: "
                             f"{''.join(p.log)[-2000:]}")

    def stop(p):
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
        return p.wait(60)

    walls = {}
    try:
        t0 = time.perf_counter()
        srv = spawn("--serve", "0", "--sessions", "--record", "--out",
                    str(out))
        addr = address(srv, "session engine serving")
        walls["session server listening"] = time.perf_counter() - t0
        with SessionControl(*addr, timeout=60) as sc:
            sc.create("c1", width=256, height=256, seed=3)
            t1 = time.perf_counter()
            con = spawn("--connect", f"{addr[0]}:{addr[1]}", "--session",
                        "c1", "-noVis")
            wait_until(lambda: sc.list()[0]["watchers"] == 1,
                       "the --connect attach", 120)
            walls["connect attached"] = time.perf_counter() - t1
            turn = sc.list()[0]["turn"]
            wait_until(lambda: sc.list()[0]["turn"] > turn + 256,
                       "256 watched turns", 120)
            stop(con)
            wait_until(lambda: sc.list()[0]["watchers"] == 0,
                       "the --connect detach", 60)
        t2 = time.perf_counter()
        if stop(srv) != 0:
            raise AssertionError("cli-sessions: the session server exited "
                                 f"{srv.returncode}: "
                                 f"{''.join(srv.log)[-2000:]}")
        walls["session server exit after ^C"] = time.perf_counter() - t2
        segs = scan_segments(out / "sessions" / "c1" / "replay")
        if not segs:
            raise AssertionError("cli-sessions: nothing recorded")
        t3 = time.perf_counter()
        rep = spawn("--replay", str(out / "sessions"), "--serve", "0",
                    "--replay-rate", "0")
        addr = address(rep, "replay serving")
        walls["replay server listening"] = time.perf_counter() - t3
        con = spawn("--connect", f"{addr[0]}:{addr[1]}", "--session", "c1",
                    "-noVis", "--observe")
        time.sleep(2.0)
        if con.poll() is not None:
            raise AssertionError("cli-sessions: the replay --connect ended: "
                                 f"{''.join(con.log)[-2000:]}")
        stop(con)
        if stop(rep) != 0:
            raise AssertionError("cli-sessions: the replay server exited "
                                 f"{rep.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    phase("cli-sessions", f"--serve 0 --sessions --record and --connect "
          f"--session -noVis processes, then --replay --serve 0 "
          f"--replay-rate 0 and a --connect --observe: {len(segs)} "
          f"recorded segments; walls (s) "
          f"{ {k: round(v, 3) for k, v in walls.items()} }; {card}")
    return walls


# --- the broadcast tier, the telemetry planes and the fleet ---------------

#: Observers per fan-out point (direct off the root, then split across a
#: 2-level relay chain), and the seconds each point is measured for.
FANOUT_POINTS = (50, 500)
FANOUT_SECS = 4.0
#: Decoded observers per fan-out point (Controllers whose shadow rasters
#: are held against the plain version); the rest drain raw bytes.
FANOUT_CHECKED = 4


class RasterWatch:
    """Drain a Controller's events on a thread, keeping the turn of its
    last TurnComplete: with the engine paused, (its board, that turn) is
    a consistent pair."""

    def __init__(self, ctl):
        import threading

        self.ctl, self.last = ctl, ctl.sync_turn
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for ev in self.ctl.events:
            if type(ev).__name__ == "TurnComplete":
                self.last = ev.completed_turns


def fanout_point(settled, plain_at, n: int, levels: int,
                 out: pathlib.Path) -> dict:
    """One point of `relay-fanout`: the settled board served by an
    EngineServer on the card, paused at turn 0 while `n` raw binary
    batching observers (hello batch 1024) and FANOUT_CHECKED decoded
    ones attach — to the root through the counting proxy, or split
    across a `levels`-deep relay chain hung off the proxy; the run is
    resumed, the stream settles for 200 turns, and FANOUT_SECS are
    measured (longer if fewer than two chunks committed in them); then
    the engine is paused and every decoded observer's
    raster is held against the plain version at its turn."""
    import contextlib
    import selectors
    import socket

    import numpy as np

    from gol_tpu_torch.distributed import Controller, EngineServer, wire
    from gol_tpu_torch.distributed.server import _METRICS as SRV
    from gol_tpu_torch.relay import RelayNode

    server = EngineServer(serve_params(out), port=0, initial_world=settled)
    server._keys.put("p")
    reset_launches()
    server.start()
    eng = server.engine
    relays, socks, ctls, watches = [], [], [], []
    sel = selectors.DefaultSelector()
    proxy, stats, close_proxy = counting_proxy(server.address)

    def drain(secs: float) -> None:
        stop = time.monotonic() + secs
        while time.monotonic() < stop:
            for key, _ in sel.select(0.05):
                try:
                    while key.fileobj.recv(1 << 16):
                        pass
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    with contextlib.suppress(Exception):
                        sel.unregister(key.fileobj)

    try:
        wait_until(lambda: eng._paused, "the engine to pause")
        tiers = [proxy]
        for _ in range(levels):
            r = RelayNode(tiers[-1], port=0).start()
            relays.append(r)
            if not r.synced.wait(60):
                raise AssertionError("relay-fanout: a relay never synced")
            tiers.append(r.address)
        targets = tiers[1:] if levels else [proxy]
        for i in range(n):
            s = socket.create_connection(targets[i % len(targets)],
                                         timeout=60)
            s.settimeout(60)
            wire.send_msg(s, {"t": "hello", "want_flips": True,
                              "binary": True, "role": "observe",
                              "batch": 1024})
            s.setblocking(False)
            sel.register(s, selectors.EVENT_READ)
            socks.append(s)
        for i in range(FANOUT_CHECKED):
            c = Controller(*targets[i % len(targets)], want_flips=True,
                           batch=True, batch_turns=1024,
                           batch_flip_events=False, observe=True,
                           timeout=60, reconnect=False)
            ctls.append(c)
            if not c.wait_sync(60):
                raise AssertionError("relay-fanout: no sync")
            watches.append(RasterWatch(c))
        server._keys.put("p")
        mark = eng.completed_turns
        deadline = time.monotonic() + 120
        while eng.completed_turns < mark + 200:
            if time.monotonic() > deadline:
                raise AssertionError("relay-fanout: the stream never "
                                     "settled")
            drain(0.2)
        b0 = stats["down"]
        e0, c0 = SRV.chunk_encodes.value, SRV.chunks.value
        s0, o0 = SRV.shed_frames.value, SRV.overflows.value
        t0, w0 = eng.completed_turns, time.perf_counter()
        drain(FANOUT_SECS)
        # A chunk commits its turns at once: measure at least two.
        while (SRV.chunks.value - c0 < 2
               and time.perf_counter() - w0 < 60 * FANOUT_SECS):
            drain(0.2)
        turns = eng.completed_turns - t0
        secs = time.perf_counter() - w0

        root_bytes = stats["down"] - b0
        encodes = SRV.chunk_encodes.value - e0
        chunks = SRV.chunks.value - c0
        shed = SRV.shed_frames.value - s0
        overflows = SRV.overflows.value - o0
        server._keys.put("p")
        wait_until(lambda: eng._paused, "the engine to pause at the end")
        end = eng.completed_turns
        # The watched path dispatches one chunk ahead of its emission:
        # the paused engine may hold that chunk, launched, uncommitted.
        ahead = eng._pending_diffs["k"] if eng._pending_diffs else 0
        launches = read_launches()["bitlife_resident"]
        for w in watches:
            wait_until(lambda w=w: w.last == end,
                       f"a decoded observer to reach turn {end}", 120)
            want = plain_at(end)
            if not np.array_equal(w.ctl.board != 0, want != 0):
                raise AssertionError(f"relay-fanout: an observer's raster "
                                     f"at turn {end} differs from the "
                                     "plain version")
    finally:
        for s in socks:
            with contextlib.suppress(OSError):
                s.close()
        for c in ctls:
            c.close()
        for r in reversed(relays):
            r.shutdown()
        server.shutdown()
        close_proxy()
    if not turns or not chunks:
        raise AssertionError(f"relay-fanout: no stream in {FANOUT_SECS} s "
                             f"({turns} turns, {chunks} chunks)")
    if encodes != chunks:
        raise AssertionError(f"relay-fanout: {encodes} encodes for {chunks} "
                             "chunks at the root (want one a chunk)")
    if launches != end + ahead:
        raise AssertionError(f"relay-fanout: {launches} kernel A launches "
                             f"for {end} committed and {ahead} dispatched "
                             "engine turns (want one a turn)")
    return {"turns_per_sec": turns / secs, "turns": turns, "secs": secs,
            "root_bytes_per_observer_turn": root_bytes / turns / n,
            "root_encodes_per_chunk": encodes / chunks, "shed": shed,
            "overflows": overflows, "launches": launches,
            "engine_turns": end + ahead}


def relay_fanout(tmp: pathlib.Path, card: str) -> int:
    """Phase `relay-fanout`, gol_tpu's fan-out lane on the card: kernel A
    settles the 512² fixture for 10,000 turns, and each point of
    FANOUT_POINTS serves it to N observers direct and through a
    2-level relay chain. Returns kernel A's launches over the points."""
    import torch

    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.ops import cuda_bitlife as cb

    t_phase = time.perf_counter()
    world0 = read_pgm(FIXTURES / "images" / "512x512.pgm")
    p = cb.step_n_packed_cuda_raw(packed_board(world0), 10_000)
    settled = bitlife.unpack_np(p.cpu().numpy().view("uint32"), 512)
    if not torch.equal(bitlife.step_n_packed_raw(p, 2), p):
        raise AssertionError("relay-fanout: the settled board is not of "
                             "period 2")
    odd = bitlife.unpack_np(bitlife.step_n_packed_raw(p, 1).cpu().numpy()
                            .view("uint32"), 512)

    def plain_at(turn: int):
        return settled if turn % 2 == 0 else odd

    points, launches = {}, 0
    for n in FANOUT_POINTS:
        for levels, name in ((0, "direct"), (2, "relay2")):
            r = fanout_point(settled, plain_at, n, levels,
                             tmp / f"fanout-{name}-{n}")
            points[f"{name}_{n}"] = r
            launches += r["launches"]
            phase("relay-fanout", f"{name} N={n}: "
                  f"{r['turns_per_sec']:.1f} delivered turns/s "
                  f"({r['turns']} turns in {r['secs']:.3f} s), "
                  f"{r['root_bytes_per_observer_turn']:.3f} root bytes per "
                  f"observer-turn, {r['root_encodes_per_chunk']:.3f} root "
                  f"encodes per chunk, shed {r['shed']:.0f}, overflows "
                  f"{r['overflows']:.0f}, kernel A launches "
                  f"{r['launches']} / engine turns {r['engine_turns']}; "
                  f"{FANOUT_CHECKED} decoded rasters = plain version; "
                  f"{card}")
    big = max(FANOUT_POINTS)
    ratio = (points[f"direct_{big}"]["root_bytes_per_observer_turn"]
             / points[f"relay2_{big}"]["root_bytes_per_observer_turn"])
    phase("relay-fanout", f"root bytes per observer-turn at N={big}, direct "
          f"over 2-level relay chain: {ratio:.1f}; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def main_relay_16384(tmp: pathlib.Path, card: str, side: int = 16384) -> int:
    """Phase `main-relay-16384`: a 16384² board of 1024 gliders served
    on the card (kernel B's 2-D entry) through one relay with its
    WebSocket gateway. Past turn 128 the engine pauses, a binary
    observer attaches to the relay late and a WebSocket observer to its
    gateway: both BoardSyncs, encoded from the relay's shadow raster,
    are the plain version at the sync turn. Returns kernel B's
    launches."""
    import torch

    from gol_tpu_torch.distributed import Controller, EngineServer, wire
    from gol_tpu_torch.obs.canary import WSObserver
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.relay import RelayNode

    t_phase = time.perf_counter()
    world0 = glider_field(side, 1024, seed=5)
    out = tmp / "relay16384"
    server = EngineServer(serve_params(out, image_width=side,
                                       image_height=side, chunk=64),
                          port=0, initial_world=world0)
    eng = server.engine
    reset_launches()
    server.start()
    relay, ctls, legs = None, [], {}
    real_frame = wire.board_to_frame

    def board_to_frame(turn, w, token=0):
        t = time.perf_counter()
        frame = real_frame(turn, w, token)
        legs.setdefault("encode", []).append((t, time.perf_counter(),
                                              len(frame)))
        return frame

    try:
        relay = RelayNode(server.address, port=0, ws_port=0).start()
        if not relay.synced.wait(300):
            raise AssertionError("main-relay-16384: the relay never synced")
        wait_until(lambda: eng.completed_turns >= 128, "128 turns", 300)
        server._keys.put("p")
        wait_until(lambda: eng._paused, "the engine to pause", 300)
        wait_until(lambda: relay.turn == eng.completed_turns,
                   "the relay's shadow to reach the engine", 300)
        wire.board_to_frame = board_to_frame
        t_hello = time.perf_counter()
        ob = Controller(*relay.address, want_flips=False, batch=True,
                        observe=True, timeout=120, reconnect=False)
        ctls.append(ob)
        if not ob.wait_sync(300):
            raise AssertionError("main-relay-16384: no sync")
        t_sync = time.perf_counter()
        ws = WSObserver(*relay.ws_address, batch_turns=64, timeout=120)
        ctls.append(ws)
        if not ws.wait_sync(300):
            raise AssertionError("main-relay-16384: no WebSocket sync")
        t_ws = time.perf_counter()
        sync_turn = ob.sync_turn
        ws_turn = ws.freshness.applied_turn
    finally:
        wire.board_to_frame = real_frame
        for c in ctls:
            c.close()
        if relay is not None:
            relay.shutdown()
        server.shutdown()
    launches = read_launches()["bitlife_tiled"]
    want = bitlife.step_n_packed_raw(packed_board(world0), sync_turn)
    for name, board, turn in (("binary", ob.board, sync_turn),
                              ("WebSocket", ws.board, ws_turn)):
        if turn != sync_turn or not torch.equal(packed_board(board), want):
            raise AssertionError(f"main-relay-16384: the {name} observer's "
                                 f"BoardSync at turn {turn} differs from "
                                 "the plain version")
    if launches <= 0:
        raise AssertionError("main-relay-16384 never launched bitlife_tiled")
    (e0, e1, nbytes), = legs["encode"][:1]
    phase("main-relay-16384", f"relay BoardSync of {side}² at turn "
          f"{sync_turn} from its shadow raster: {nbytes} frame bytes; "
          f"hello -> sync {t_sync - t_hello:.3f} s = attach "
          f"{e0 - t_hello:.3f} + encode from the raster {e1 - e0:.3f} + "
          f"send and decode {t_sync - e1:.3f} s; the WebSocket observer "
          f"synced {t_ws - t_sync:.3f} s later; both = plain version; "
          f"{launches} bitlife_tiled launches; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def main_telemetry(tmp: pathlib.Path, card: str) -> int:
    """Phase `main-telemetry`: a SessionServer on the card, 16 x 256²
    soups in one bucket (one batched launch of kernel A a chunk), with
    the cost price published, the usage ledger on, an AlertEvaluator on
    the worst peer turn age, a RemoteWriter into an in-process
    CollectorServer and a relay with its WebSocket gateway on one
    session. A wedged observer fires the rule and draining it resolves
    it; `/usage` is conserved, `report usage` over the ledger equals the
    live totals, the collector's rate agrees with the engine's counter
    within 5%, a canary through the gateway reports a turn age, and the
    bucket's FLOPs charge is price x turns. Returns kernel A's
    launches."""
    import contextlib
    import io
    import json as _json
    import socket
    import urllib.request

    from gol_tpu_torch import obs
    from gol_tpu_torch.analysis.invariants import violations_total
    from gol_tpu_torch.distributed import SessionControl, SessionServer, wire
    from gol_tpu_torch.obs import accounting, canary, device, report
    from gol_tpu_torch.obs.collector import CollectorServer, RemoteWriter
    from gol_tpu_torch.obs.freshness import AlertEvaluator, parse_rules
    from gol_tpu_torch.obs.http import MetricsServer
    from gol_tpu_torch.obs.tsdb import TSDB
    from gol_tpu_torch.relay import RelayNode

    t_phase = time.perf_counter()
    side, n = LANE_SIDE, 16
    out = tmp / "telemetry"
    meter = accounting.meter()
    meter.configure_ledger(str(out / "usage"), flush_secs=0.5)
    device.enable_cost_probes()
    inv0 = violations_total()
    srv = SessionServer(serve_params(out, image_width=side,
                                     image_height=side),
                        port=0, heartbeat_secs=0.25, high_water=8,
                        drain_secs=120.0)
    reset_launches()
    srv.start()
    db = TSDB(str(out / "tsdb"))
    col = CollectorServer("127.0.0.1", 0, db).start()
    ev = AlertEvaluator(parse_rules(
        "age: max(gol_tpu_server_peer_turn_age_seconds) > 1 for 1s"))
    side_srv = MetricsServer(port=0, alerts=ev).start()
    rw = RemoteWriter(f"127.0.0.1:{col.address[1]}", source="telemetry")
    relay, wedged, states = None, None, []
    try:
        with SessionControl(*srv.address, timeout=60) as sc:
            for i in range(n):
                sc.create(f"t{i:02d}", width=side, height=side, seed=600 + i)
        fam = "gol_tpu_session_turns_total"
        local = []
        for _ in range(8):
            rw.push_once()
            local.append((time.time(), sum(
                m.value for m in obs.registry().metrics()
                if m.name == fam)))
            time.sleep(0.5)
        # A wedged observer: attached, never reading, its socket buffer
        # small — the server sheds its frames and its turn age grows.
        wedged = socket.create_connection(srv.address, timeout=60)
        wedged.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        wire.send_msg(wedged, {"t": "hello", "want_flips": True,
                               "binary": True, "role": "observe",
                               "session": "t00"})
        t_wedge = time.perf_counter()
        wait_until(lambda: ev.eval_once()["firing"] == 1,
                   "the turn-age rule to fire", 120)
        t_fire = time.perf_counter()
        states.append("firing")
        wedged.setblocking(False)

        def drained():
            with contextlib.suppress(BlockingIOError, InterruptedError):
                while wedged.recv(1 << 20):
                    pass
            return ev.eval_once()["firing"] == 0

        wait_until(drained, "the turn-age rule to resolve", 120)
        t_resolve = time.perf_counter()
        states.append("resolved")
        relay = RelayNode(srv.address, port=0, session="t01",
                          ws_port=0).start()
        if not relay.synced.wait(60):
            raise AssertionError("main-telemetry: the relay never synced")
        cout = io.StringIO()
        rc = canary.run_canary(
            f"{relay.ws_address[0]}:{relay.ws_address[1]}", interval=0.2,
            duration=2.0, use_ws=True, as_json=True, out=cout)
        summary = _json.loads(cout.getvalue())
        if rc != 0 or not summary["age"].get("samples"):
            raise AssertionError(f"main-telemetry: the canary reported "
                                 f"{summary}")
        relay.shutdown()
        relay = None
        # The dispatch loop stopped (the sessions still held), so /usage
        # and the ledger hold the same charges.
        srv.engine.stop()
        srv.engine.join(timeout=60)
        bucket = next(iter(srv.manager._buckets.values()))
        ticks = bucket.ticks
        price = meter.price_flops(f"bucket.step:{bucket.key}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{side_srv.address[1]}/usage",
                timeout=60) as r:
            usage = _json.loads(r.read())
    finally:
        if wedged is not None:
            wedged.close()
        if relay is not None:
            relay.shutdown()
        srv.shutdown()
        rw.close()
        side_srv.close()
        col.close()
    launches = read_launches()["bitlife_resident"]
    meter.close()
    device.enable_cost_probes(False)
    want_price = device.cost_of(side, side, "B3/S23", boards=16)["flops"]
    sessions = {p: v for p, v in usage["principals"].items()
                if p.startswith("t")}
    flops = sum(v["flops"] for v in sessions.values())
    if price != want_price or abs(flops - price * ticks) > 1e-9 * flops:
        raise AssertionError(f"main-telemetry: bucket FLOPs {flops} != "
                             f"price {price} x {ticks} turns")
    if violations_total() != inv0:
        raise AssertionError("main-telemetry: a bucket split was not "
                             "conserved")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["usage", str(out / "usage"), "--json"])
    bill = _json.loads(buf.getvalue())["principals"]
    for p, live in sessions.items():
        for res in ("flops", "turns", "dispatch_seconds"):
            if abs(bill[p].get(res, 0.0) - live[res]) > 1e-9 * max(
                    1.0, live[res]):
                raise AssertionError(f"main-telemetry: the ledger's {res} "
                                     f"of {p} differs from /usage")
    (t_a, v_a), (t_b, v_b) = local[1], local[-1]
    own = (v_b - v_a) / (t_b - t_a)
    # One step spanning the window: the collector's rate over it.
    ((_, got),) = db.query(f"rate({fam})", t_a, t_b, t_b - t_a)[
        "series"][0]["points"]
    db.close()
    if abs(got - own) > 0.05 * own:
        raise AssertionError(f"main-telemetry: the collector's rate {got:.1f}"
                             f" is not within 5% of the engine's {own:.1f}")
    if launches <= 0:
        raise AssertionError("main-telemetry never launched kernel A")
    phase("main-telemetry", f"SessionServer 16 x {side}²: rule fired "
          f"{t_fire - t_wedge:.3f} s after the wedge, resolved "
          f"{t_resolve - t_fire:.3f} s after the drain began; bucket price "
          f"{price:.0f} ops/turn x {ticks} turns = {flops:.0f} charged over "
          f"{len(sessions)} tenants (conserved), report usage = /usage; "
          f"collector rate({fam}) {got:.1f}/s vs the engine's {own:.1f}/s; "
          f"WS canary age p95 {summary['age']['p95_s']:.4f} s over "
          f"{summary['age']['samples']} samples; {launches} "
          f"bitlife_resident launches; {time.perf_counter() - t_phase:.1f} "
          f"s; {card}")
    return launches


def cli_fleet(tmp: pathlib.Path, card: str) -> dict:
    """Phase `cli-fleet`: processes. `--collector`; `--serve --sessions`
    on the card with `--remote-write` to it; relay A (`--relay ROOT
    --session c1 --ws-port 0`) and relay B under A; `--control SPEC`
    (relays.min 2, spawns `-m gol_tpu_torch --relay ... --session c1`).
    A raw observer under B; SIGKILL relay A: the controller spawns its
    replacement and re-points B, whose observer resumes by a BoardSync
    equal to the plain version. The console renders the tree from the
    scrapes. Returns the root process's kernel launches."""
    import json as _json
    import os
    import queue
    import re
    import signal
    import socket
    import threading

    import numpy as np

    from gol_tpu_torch.distributed import Controller, SessionControl, wire
    from gol_tpu_torch.obs import console
    from gol_tpu_torch.sessions.manager import seeded_board

    t_phase = time.perf_counter()
    out = tmp / "cli-fleet"
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    procs = []

    def spawn(*args):
        p = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", *args],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
        p.lines, p.log = queue.Queue(), []

        def pump():
            for line in p.stdout:
                p.log.append(line)
                p.lines.put(line)

        p.pump = threading.Thread(target=pump, daemon=True)
        p.pump.start()
        procs.append(p)
        return p

    def banner(p, pattern):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                line = p.lines.get(timeout=0.1)
            except queue.Empty:
                if p.poll() is not None:
                    break
                continue
            m = re.search(pattern, line)
            if m:
                return m.group(1)
        raise AssertionError(f"cli-fleet: no {pattern!r} line: "
                             f"{''.join(p.log)[-2000:]}")

    side = 256
    boards, keepers = [], []
    man = out / "ctl" / "controller.json"

    def healed():
        try:
            return _json.loads(man.read_text())["spawned"]["relays"]
        except (OSError, ValueError, KeyError):
            return {}

    try:
        colp = spawn("--collector", "0", "--out", str(out / "col"),
                     "--metrics-port", "0")
        col = banner(colp, r"collector serving on ([\d.]+:\d+)")
        col_m = banner(colp, r"metrics serving on http://([\d.]+:\d+)")
        root = spawn("--serve", "0", "--sessions", "--out",
                     str(out / "root"), "--metrics-port", "0",
                     "--remote-write", col)
        root_addr = banner(root, r"session engine serving on ([\d.]+:\d+)")
        root_m = banner(root, r"metrics serving on http://([\d.]+:\d+)")
        host, port = root_addr.split(":")
        with SessionControl(host, int(port), timeout=60) as sc:
            sc.create("c1", width=side, height=side, seed=9)
        # A watcher of c1 at the root for the whole phase: a watched
        # session steps turn by turn at the served rate, so its turn
        # stays within the plain version's reach; unwatched it would
        # free-run at the bucket's rate.
        keeper = Controller(host, int(port), session="c1",
                            want_flips=True, batch=True, batch_turns=16,
                            batch_flip_events=False, observe=True,
                            timeout=60, reconnect=False)
        keepers.append(keeper)
        if not keeper.wait_sync(60):
            raise AssertionError("cli-fleet: the keeper got no sync")
        RasterWatch(keeper)
        phase("cli-fleet", f"collector, root and session c1 up "
              f"{time.perf_counter() - t_phase:.1f} s; c1 at turn "
              f"{keeper.sync_turn}")
        a = spawn("--relay", root_addr, "--session", "c1", "--serve", "0",
                  "--ws-port", "0", "--metrics-port", "0")
        a_addr = banner(a, r"relay serving on ([\d.]+:\d+)")
        a_m = banner(a, r"metrics serving on http://([\d.]+:\d+)")
        b = spawn("--relay", a_addr, "--serve", "0", "--metrics-port", "0")
        b_addr = banner(b, r"relay serving on ([\d.]+:\d+)")
        b_m = banner(b, r"metrics serving on http://([\d.]+:\d+)")
        spec = {"root": root_addr, "scrape": [root_m, a_m, b_m],
                "relays": {"min": 2, "max": 4}, "interval_secs": 0.5,
                "down_rounds": 2, "stale_secs": 10.0,
                "spawn_args": ["--session", "c1"]}
        (out / "spec.json").write_text(_json.dumps(spec))
        ctl = spawn("--control", str(out / "spec.json"), "--out",
                    str(out / "ctl"), "--metrics-port", "0")
        ctl_m = banner(ctl, r"metrics serving on http://([\d.]+:\d+)")
        ob = socket.create_connection(tuple(
            (b_addr.split(":")[0], int(b_addr.split(":")[1]))), timeout=60)
        wire.send_msg(ob, {"t": "hello", "want_flips": True,
                           "binary": True, "role": "observe",
                           "batch": 1024})

        def read_boards():
            try:
                while True:
                    m = wire.recv_msg(ob)
                    if m is None:
                        return
                    if m.get("t") == "board":
                        turn, bd = wire.msg_to_board(m)
                        boards.append((time.perf_counter(), turn,
                                       np.array(bd, np.uint8)))
            except (OSError, wire.WireError):
                return

        reader = threading.Thread(target=read_boards, daemon=True)
        reader.start()
        wait_until(lambda: boards, "the observer's first BoardSync", 120)
        phase("cli-fleet", f"relays A, B and the controller up, B's "
              f"observer synced at turn {boards[0][1]}; "
              f"{time.perf_counter() - t_phase:.1f} s")
        time.sleep(2.0)
        t_kill = time.perf_counter()
        os.kill(a.pid, signal.SIGKILL)
        wait_until(lambda: healed(), "the controller's replacement relay",
                   120)
        t_spawn = time.perf_counter()
        phase("cli-fleet", f"replacement spawned {t_spawn - t_kill:.3f} s "
              "after the SIGKILL")
        wait_until(lambda: boards[-1][0] > t_kill,
                   "the observer's BoardSync after the heal", 120)
        t_resync = time.perf_counter()
        # The heal, and any growth back to relays.min the controller
        # planned beside it.
        spawned = healed()
        snap = console.fleet_snapshot([console.Endpoint(m) for m in (
            root_m, b_m, ctl_m, col_m,
            *(meta["metrics"] for meta in spawned.values()))])
        text = io_render(console, snap)
        tree_nodes = count_tree(snap["tree"])
        ob.close()
    except AssertionError as e:
        tails = "\n".join(f"--- {' '.join(p.args[3:6])}: "
                          f"{''.join(p.log)[-800:]}" for p in procs)
        raise AssertionError(f"{e}\n{tails}") from None
    finally:
        for c in keepers:
            c.close()
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in reversed(procs):
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)
            p.pump.join(30)
        # The controller leaves the relays it spawned running, by
        # design: stop them here.
        for meta in healed().values():
            try:
                os.kill(meta["pid"], signal.SIGKILL)
            except (OSError, TypeError):
                pass
    turn = boards[-1][1]
    want = plain_stack([seeded_board(side, side, 9)], turn)[0]
    if not np.array_equal(boards[-1][2] != 0, want != 0):
        raise AssertionError(f"cli-fleet: the resynced board at turn {turn} "
                             "differs from the plain version")
    first_turn, first = boards[0][1], boards[0][2]
    if not np.array_equal(first != 0, plain_stack(
            [seeded_board(side, side, 9)], first_turn)[0] != 0):
        raise AssertionError("cli-fleet: the first BoardSync differs from "
                             "the plain version")
    if tree_nodes < 3 or not any(addr in text for addr in spawned):
        raise AssertionError(f"cli-fleet: the console's tree lacks the "
                             f"healed relay:\n{text}")
    launches = {}
    for line in root.log:
        if line.startswith("kernel launches: "):
            launches = _json.loads(line[len("kernel launches: "):])
    if launches.get("bitlife_resident", 0) <= 0:
        raise AssertionError("cli-fleet: the root launched no kernel A")
    phase("cli-fleet", f"collector, --serve --sessions root, relays A and "
          f"B, --control (relays.min 2): SIGKILL A -> {len(spawned)} "
          f"relay(s) spawned, the first "
          f"{t_spawn - t_kill:.3f} s, B's observer resynced "
          f"{t_resync - t_kill:.3f} s after the kill at turn {turn} = plain "
          f"version; console tree of {tree_nodes} nodes; root launches "
          f"{ {k: v for k, v in launches.items() if v} }; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def io_render(console, snap) -> str:
    import io

    buf = io.StringIO()
    console.render(snap, out=buf)
    return buf.getvalue()


def count_tree(nodes) -> int:
    return sum(1 + count_tree(n.get("children", [])) for n in nodes)



# --- rings and meshes of shards ------------------------------------------

#: (height, width, shards) of the packed rings whose ghost-extended
#: blocks phase `kernels` holds against the plain versions: the main
#: path's 512² and 16384² over 4, the balanced split 1504 / 3 and
#: gol_tpu's wide-shard seam 3072 x 8192 / 2.
RING_SHAPES = ((512, 512, 4), (16384, 16384, 4), (1504, 512, 3),
               (3072, 8192, 2))
#: The dense ring of phase `main-ring-uneven` (kernel E): 100 rows over
#: 3 shards, the balanced split of 34, 33 and 33 rows.
DENSE_RING = (100, 512, 3)
#: Boards stepped by reused reference boards of the 16384² phases.
REUSE: dict = {}


def ring_plan(rule, h: int, w: int, k: int) -> tuple:
    """(h_ghost, mode, Sw, real) of a packed ring's local blocks on the
    card, as the steppers plan them."""
    from gol_tpu_torch.models.rules import GenRule
    from gol_tpu_torch.parallel import gens_halo, packed_halo

    size, real = packed_halo.balanced_words(h, k)
    if isinstance(rule, GenRule):
        plan = gens_halo.gens_local_block_mode(size, w, rule, True,
                                               max_h=min(real))
    else:
        plan = packed_halo.local_block_mode(size, w, True, max_h=min(real))
    return (*plan, size, real)


def ring_launches(plan: tuple, k: int, shards: int) -> int:
    """Launches of one `step_n(world, k)` of a packed ring with local
    block plan (h, mode): one a shard a deep block (h launches of 32
    turns for ``tiled2d``), the remainder as one partial block."""
    h, mode = plan[:2]
    big, rem = divmod(k, 32 * h)
    if mode == "tiled2d":
        return shards * (big * h + -(-rem // 32))
    return shards * (big + (1 if rem else 0))


def kernel_of(before: dict) -> str:
    """The one kernel whose launch count moved since `before`."""
    moved_ = {k: v - before[k] for k, v in read_launches().items()
              if v != before[k]}
    if len(moved_) != 1:
        raise AssertionError(f"expected one kernel to launch, got {moved_}")
    return next(iter(moved_))


def check_ring_kernels(errs: dict) -> dict:
    """Phase `kernels` (rings and meshes): each plan's local-block entry
    on the ring's ghost-extended blocks — a whole deep block, a partial
    one, and the per-turn block of one ghost word-row — for B3/S23
    (kernels A, B) and B2/S/C3 (C, D), at RING_SHAPES; kernel E on the
    dense ring's deep and per-turn strips; one-turn launches on the 2x2
    mesh's and the lane layout's extended blocks at 512². Each against
    its plain version on the same input on the card, bit-exact.
    Returns {shape: plan} for the record."""
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitgens, bitlife, cuda_life, life
    from gol_tpu_torch.parallel import halo, packed_halo

    gen = torch.Generator().manual_seed(15)
    plans, checked = {}, 0

    def held(tag, got, want):
        nonlocal checked
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        if err:
            raise AssertionError(f"{kernel} on {tag}: mismatch")
        checked += 1

    for notation in ("B3/S23", "B2/S/C3"):
        rule = get_rule(notation)
        gens = "/C" in notation
        plain = ((lambda x, n: bitgens.step_n_packed_gens_raw(x, n, rule))
                 if gens else
                 (lambda x, n: bitlife.step_n_packed_raw(x, n, rule)))

        def block(rows, w):
            if gens:
                return gens_planes(rule, rows * 32, w, gen)
            return torch.randint(-2**31, 2**31 - 1, (rows, w),
                                 dtype=torch.int32, generator=gen).cuda()

        for h, w, k in RING_SHAPES:
            g, mode, size, real = ring_plan(rule, h, w, k)
            plans[f"{notation} {h}x{w}/{k}"] = (size + 2 * g, w, g, mode)
            local = packed_halo.local_stepper(rule, mode, g)
            ext = block(size + 2 * g, w)
            for n in sorted({32 * g, 32 * g - 1, 33}):
                before = read_launches()
                got = local(ext, n)
                kernel = kernel_of(before)
                held(f"{notation} ext {tuple(ext.shape)} ({mode}, h={g}) "
                     f"n={n}", got, plain(ext, n))
            ext1 = block(size + 2, w)
            before = read_launches()
            got = packed_halo.turn_stepper(rule, mode)(ext1)
            kernel = kernel_of(before)
            held(f"{notation} per-turn ext {tuple(ext1.shape)}", got,
                 plain(ext1, 1))
            del ext, ext1
            torch.cuda.empty_cache()
        # The 2x2 mesh's blocks at 512² (8 word-rows x 256 columns plus
        # a ghost a side) and the lane layout's chunks (k = 2).
        for tag, rows, w in (("mesh 2x2", 8 + 2, 256 + 2),
                             ("lane-coupled", 16, 256 + 2)):
            if gens and tag == "lane-coupled":
                continue
            ext = block(rows, w)
            before = read_launches()
            got = packed_halo.turn_stepper(rule, "kernel")(ext)
            kernel = kernel_of(before)
            held(f"{notation} {tag} ext {tuple(ext.shape)}", got,
                 plain(ext, 1))
    # Kernel E on the dense ring's strips: a deep block of `deep` turns
    # and the per-turn strip.
    h, w, k = DENSE_RING
    size, real = halo.balanced_rows(h, k)
    deep = halo.dense_deep(h, k)
    for rule in (get_rule("B3/S23"), get_rule("B36/S23")):
        for rows, n in ((size + 2 * deep, deep), (size + 2, 1)):
            ext = (torch.randint(0, 2, (rows, w), generator=gen)
                   .to(torch.uint8) * 255).cuda()
            before = read_launches()
            got = cuda_life.step_n_cuda_dense(ext, n, rule)
            kernel = kernel_of(before)
            held(f"{rule} dense ring strip {rows}x{w} n={n}", got,
                 life.step_n(ext, n, rule))
    phase("kernels", f"{checked} ring / mesh / lane block runs bit-exact "
                     f"against the plain versions; local-block plans "
                     f"(ext rows, width, h, mode): {plans}")
    return plans


def recording(stepper) -> tuple:
    """The stepper with its `step_n` recording each chunk's turns, and
    the list it records into."""
    import dataclasses

    ks = []
    inner = stepper.step_n

    def step_n(world, k):
        ks.append(int(k))
        return inner(world, k)

    return dataclasses.replace(stepper, step_n=step_n), ks


def halo_counters(name: str) -> tuple:
    """(exchanges, bytes) of the gol_tpu_halo_* series of backend `name`."""
    from gol_tpu_torch import obs

    labels = {"backend": name}
    return (int(obs.counter("gol_tpu_halo_exchanges_total",
                            labels=labels).value),
            int(obs.counter("gol_tpu_halo_bytes_total",
                            labels=labels).value))


def ring_devices(k: int) -> list:
    import torch

    return [torch.device("cuda", 0)] * k


def stepper_wall(stepper, world, chunks, reps: int = 5) -> float:
    """Best seconds of `reps` runs of `chunks` through the stepper's
    `step_n` from one put board, each ended by reading the count."""
    import torch

    p0 = stepper.put(world)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        p = p0
        for k in chunks:
            p, count = stepper.step_n(p, k)
        int(count.item())
        best = min(best, time.perf_counter() - t0)
    return best


def main_ring_512(tmp: pathlib.Path) -> dict:
    """Phase `main-ring-512`: `Engine(Params(512², 100 turns))` with
    `make_stepper(threads=4, devices=[cuda:0] * 4)` injected — every
    shard's deep block one launch of kernel A — PGM byte-equal to the
    fixture and every AliveCellsCount equal to the CSV; then B2/S/C3
    the same way (kernel C) against the single-device stepper's run.
    Launches equal the plan's count for the chunks dispatched."""
    from gol_tpu_torch import AliveCellsCount, FinalTurnComplete, Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.parallel import make_stepper

    from gol_tpu_torch.io.pgm import read_pgm

    with open(FIXTURES / "check/alive/512x512.csv") as f:
        csv_alive = {int(r["completed_turns"]): int(r["alive_cells"])
                     for r in csv.DictReader(f)}
    # The CSV counts from turn 1; turn 0 is the input board's count.
    csv_alive[0] = int((read_pgm(FIXTURES / "images/512x512.pgm") != 0).sum())
    out_launches = {}
    boards = {}
    for notation, kernel, name in (
            ("B3/S23", "bitlife_resident", "packed-halo-ring-4"),
            ("B2/S/C3", "bitgens_resident", "gens-packed-halo-ring-4")):
        plan = ring_plan(get_rule(notation), 512, 512, 4)
        for tag, devs in (("ring", ring_devices(4)), ("single", None)):
            out = tmp / f"ring512-{notation.replace('/', '_')}-{tag}"
            params = Params(image_width=512, image_height=512, turns=100,
                            threads=4, rule=notation, chunk=0,
                            tick_seconds=0.002,
                            image_dir=str(FIXTURES / "images"),
                            out_dir=str(out))
            st = make_stepper(threads=4, height=512, width=512,
                              rule=notation, devices=devs)
            if tag == "ring" and st.name != name:
                raise AssertionError(f"ring stepper is {st.name}")
            st, ks = recording(st)
            reset_launches()
            halo0 = halo_counters(name)
            t0 = time.perf_counter()
            engine = Engine(params, stepper=st, emit_flips=False).start()
            evs = drain(engine.events)
            wall = time.perf_counter() - t0
            engine.join(timeout=60)
            if engine.error is not None:
                raise engine.error
            got = read_launches()
            final = [e for e in evs if isinstance(e, FinalTurnComplete)]
            if not final or final[0].completed_turns != 100:
                raise AssertionError(f"{tag} {notation}: no final turn 100")
            boards[notation, tag] = (out / "512x512x100.pgm").read_bytes()
            if notation == "B3/S23":
                ticks = [(e.completed_turns, e.cells_count) for e in evs
                         if isinstance(e, AliveCellsCount)]
                bad = [(t, c) for t, c in ticks if csv_alive.get(t) != c]
                if bad or len(final[0].alive) != csv_alive[100]:
                    raise AssertionError(f"{tag} 512²: counts {bad} against "
                                         "the CSV")
            if tag != "ring":
                continue
            want = sum(ring_launches(plan, k, 4) for k in ks)
            if got[kernel] != want or sum(got.values()) != want:
                raise AssertionError(f"ring 512² {notation}: launches {got}, "
                                     f"the plan {plan[:2]} over chunks {ks} "
                                     f"gives {want} of {kernel}")
            halo1 = halo_counters(name)
            out_launches[notation] = got[kernel]
            # The stepper alone, ring against one device, same chunks.
            start = read_pgm(FIXTURES / "images/512x512.pgm")
            walls = [stepper_wall(make_stepper(
                threads=4, height=512, width=512, rule=notation,
                devices=devs), start, ks) for devs in (ring_devices(4),
                                                       None)]
            phase("main-ring-512", f"{name} {notation} 512² x 100 on 4 "
                  f"shards of cuda:0: plan (h, mode) {plan[:2]}, chunks "
                  f"{ks}, {got[kernel]} {kernel} launches (= the plan's), "
                  f"gol_tpu_halo_exchanges_total +{halo1[0] - halo0[0]}, "
                  f"gol_tpu_halo_bytes_total +{halo1[1] - halo0[1]}; "
                  f"{wall:.3f} s engine wall; step_n over the chunks "
                  f"{walls[0] * 1e3:.3f} ms on the ring, "
                  f"{walls[1] * 1e3:.3f} ms on one device (best of 5, "
                  f"the shards one after another on one card)")
    golden = (FIXTURES / "check/images/512x512x100.pgm").read_bytes()
    if golden != boards["B3/S23", "ring"] or golden != boards["B3/S23",
                                                              "single"]:
        raise AssertionError("ring 512²: PGM differs from the fixture")
    if boards["B2/S/C3", "ring"] != boards["B2/S/C3", "single"]:
        raise AssertionError("ring 512² B2/S/C3: PGM differs from the "
                             "single-device stepper's")
    phase("main-ring-512", "Life PGM byte-equal to 512x512x100.pgm and "
          "every AliveCellsCount to 512x512.csv; B2/S/C3 PGM equal to the "
          "single-device stepper's")
    return {"bitlife_resident": out_launches["B3/S23"],
            "bitgens_resident": out_launches["B2/S/C3"]}


def main_ring_16384(card: str) -> dict:
    """Phase `main-ring-16384`: Life and B2/S/C3 at 16384² x 256 turns
    over 4 shards of the card, through the stepper (put, four 64-turn
    `step_n` chunks, count, fetch), bit-exact against the boards the
    single-device phases `main-16384` and `main-gens-16384` computed;
    the ring's wall beside the single-device stepper's for the same
    chunks, and the launches against the plan's."""
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitlife
    from gol_tpu_torch.parallel import make_stepper

    side, chunks = 16384, (64, 64, 64, 64)
    out = {}
    for notation, key, kernel in (("B3/S23", "life", "bitlife_tiled"),
                                  ("B2/S/C3", "gens", "bitgens_tiled")):
        world, want = REUSE[key]  # phase multihost pops it
        plan = ring_plan(get_rule(notation), side, side, 4)
        walls = {}
        for tag, devs in (("ring", ring_devices(4)), ("single", None)):
            st = make_stepper(threads=4, height=side, width=side,
                              rule=notation, devices=devs)
            t_put = time.perf_counter()
            p = st.put(world)
            torch.cuda.synchronize()
            t_put = time.perf_counter() - t_put
            reset_launches()
            t0 = time.perf_counter()
            for k in chunks:
                p, count = st.step_n(p, k)
            alive = int(count.item())
            walls[tag] = time.perf_counter() - t0
            if tag == "ring":
                got = read_launches()
                expect = sum(ring_launches(plan, k, 4) for k in chunks)
                if got[kernel] != expect or sum(got.values()) != expect:
                    raise AssertionError(
                        f"ring 16384² {notation}: launches {got}, the plan "
                        f"{plan[:2]} gives {expect} of {kernel}")
                if not torch.equal(p.gather(), want):
                    raise AssertionError(f"ring 16384² {notation}: words "
                                         "differ from the single-device run")
                want_alive = int(bitlife.count_packed(
                    want if key == "life" else want[0]).item())
                if alive != want_alive:
                    raise AssertionError(f"ring 16384² {notation}: count "
                                         f"{alive} != {want_alive}")
                t_fetch = time.perf_counter()
                host = st.fetch(p)
                t_fetch = time.perf_counter() - t_fetch
                if host.shape != (side, side):
                    raise AssertionError("ring 16384²: fetch shape")
                out[notation] = got[kernel]
                ring_put, ring_fetch = t_put, t_fetch
            del p
            torch.cuda.empty_cache()
        phase("main-ring-16384", f"{notation} {side}² x {sum(chunks)} turns "
              f"on 4 shards of one card, plan (h, mode) {plan[:2]}: words "
              f"and count ({alive}) equal to the single-device run; "
              f"{out[notation]} {kernel} launches (= the plan's); step_n "
              f"chunks {walls['ring']:.4f} s on the ring, "
              f"{walls['single']:.4f} s on the single-device stepper (the "
              f"4 shards run one after another on one card); ring put "
              f"{ring_put:.2f} s, fetch {ring_fetch:.2f} s; {card}")
    return {"bitlife_tiled": out["B3/S23"], "bitgens_tiled": out["B2/S/C3"]}


def main_ring_uneven() -> dict:
    """Phase `main-ring-uneven`: the balanced packed split 1504 x 512
    over 3 shards (16/16/15 word-rows), the even ring's narrowest strips
    128 x 64 over 2 and the dense balanced ring 100 x 512 over 3 (kernel
    E), Life and B2/S/C3, 100 turns, against the single-device
    steppers: boards and counts equal, the padding rows dead, the diff
    stacks through `fetch_diffs` stripped to the canonical rows and
    equal to the single-device scans'."""
    import numpy as np
    import torch

    from gol_tpu_torch.ops import life
    from gol_tpu_torch.parallel import make_stepper

    cases = [(1504, 512, 3, "B3/S23"), (1504, 512, 3, "B2/S/C3"),
             (128, 64, 2, "B3/S23"), (128, 64, 2, "B2/S/C3"),
             (*DENSE_RING, "B3/S23"), (*DENSE_RING, "B2/S/C3")]
    totals: dict = {}
    for h, w, k, notation in cases:
        world = life.random_world(h, w, seed=h + k)
        ring = make_stepper(threads=k, height=h, width=w, rule=notation,
                            devices=ring_devices(k))
        single = make_stepper(height=h, width=w, rule=notation)
        reset_launches()
        p, c = ring.step_n(ring.put(world), 100)
        got = read_launches()
        q, d = single.step_n(single.put(world), 100)
        if not np.array_equal(ring.fetch(p), single.fetch(q)) \
                or int(c.item()) != int(d.item()):
            raise AssertionError(f"{ring.name} {h}x{w}: board or count "
                                 "differs from the single-device stepper")
        pad = [bool(torch.any(part[..., r:, :]).item())
               for part, r in zip(p.parts, _ring_real(ring.name, h, k))]
        if any(pad):
            raise AssertionError(f"{ring.name}: padding rows came alive")
        _, rd, _ = ring.step_n_with_diffs(p, 5)
        _, sd, _ = single.step_n_with_diffs(q, 5)
        a = np.asarray(ring.fetch_diffs(rd))
        b = sd.cpu().numpy()
        b = b.view(np.uint32) if b.dtype == np.int32 else b
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{ring.name}: diff rows {a.shape} differ "
                                 f"from the single-device scan's {b.shape}")
        launched = {n: v for n, v in got.items() if v}
        for n, v in launched.items():
            totals[n] = totals.get(n, 0) + v
        phase("main-ring-uneven", f"{ring.name} {notation} {h}x{w}: 100 "
              f"turns equal to {single.name}, padding dead, diff rows "
              f"{a.shape} stripped; step_n launches {launched}")
    return totals


def _ring_real(name: str, h: int, k: int) -> list:
    """The owned rows of each shard of ring `name` (word-rows for the
    packed rings, rows for the dense ones)."""
    from gol_tpu_torch.parallel import halo, packed_halo

    if name.startswith(("halo-ring", "gens-halo-ring")):
        return halo.balanced_rows(h, k)[1]
    return packed_halo.balanced_words(h, k)[1]


def main_watched_ring(tmp: pathlib.Path) -> dict:
    """Phase `main-watched-ring`: watched Life 512² over 4 shards of the
    card through the engine's diff pipeline — level-free FlipBatches at
    chunk 7 (dense, then sparse and compact chunks as the board calms),
    then FlipChunks with the compact buffer forced to 4 words (every
    chunk overflows and is redone from its input) — each stream event
    for event the single-device stepper's. Every watched turn is one
    kernel A launch a shard."""
    import dataclasses

    from gol_tpu_torch import Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.parallel import make_stepper

    kinds = {}
    launches = 0
    for tag, kw, cap in (("batches", {"emit_flip_batches": True}, None),
                         ("chunks-redo", {"emit_flip_chunks": True}, 4)):
        streams = {}
        for who, devs in (("ring", ring_devices(4)), ("single", None)):
            params = Params(image_width=512, image_height=512, turns=100,
                            threads=4, chunk=7, tick_seconds=60.0,
                            image_dir=str(FIXTURES / "images"),
                            out_dir=str(tmp / f"wring-{tag}-{who}"))
            st = make_stepper(threads=4, height=512, width=512,
                              devices=devs)
            turns = []

            def counted(fn):
                def wrapper(world, k, *rest):
                    turns.append(int(k))
                    return fn(world, k, *rest)
                return wrapper

            st = dataclasses.replace(
                st,
                step_n_with_diffs=counted(st.step_n_with_diffs),
                step_n_with_diffs_sparse=counted(
                    st.step_n_with_diffs_sparse),
                step_n_with_diffs_compact=counted(
                    st.step_n_with_diffs_compact))
            engine = Engine(params, stepper=st, **kw)
            if cap is not None:
                engine._compact_total_cap = lambda k: cap
            before = engine_counters()
            reset_launches()
            engine.start()
            evs = drain(engine.events)
            engine.join(timeout=60)
            if engine.error is not None:
                raise engine.error
            got = read_launches()
            streams[who] = normalize(evs)
            if who == "ring":
                kinds[tag] = moved(before)
                ring_got = got["bitlife_resident"]
                want = 4 * sum(turns)
                if got["bitlife_resident"] != want \
                        or sum(got.values()) != want:
                    raise AssertionError(
                        f"watched ring {tag}: launches {got}, 4 shards x "
                        f"{sum(turns)} scanned turns give {want}")
                launches += want
        if streams["ring"] != streams["single"]:
            raise AssertionError(f"watched ring {tag}: stream differs from "
                                 "the single-device stepper's")
        phase("main-watched-ring", f"512² x 100 {tag} on 4 shards: "
              f"{len(streams['ring'])} events equal to the single-device "
              f"stream; dispatches {kinds[tag]}; "
              f"{ring_got} bitlife_resident launches, one a watched turn "
              f"a shard")
    return {"bitlife_resident": launches}


def main_mesh(tmp: pathlib.Path) -> dict:
    """Phase `main-mesh`: `make_stepper(mesh="2x2", devices=[cuda:0] *
    4)` for Life (fixture) and B2/S/C3 (single-device board) at 512² x
    100, one launch of kernel A (C) a block a turn; then
    `--partition-rule layout=lane-coupled` through `run()` at 512²
    against the fixture, two launches of kernel A a turn."""
    import numpy as np

    import gol_tpu_torch
    from gol_tpu_torch import Params
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.parallel import make_stepper

    world = read_pgm(FIXTURES / "images/512x512.pgm")
    golden = read_pgm(FIXTURES / "check/images/512x512x100.pgm")
    out = {}
    for notation, kernel in (("B3/S23", "bitlife_resident"),
                             ("B2/S/C3", "bitgens_resident")):
        st = make_stepper(height=512, width=512, rule=notation, mesh="2x2",
                          devices=ring_devices(4))
        reset_launches()
        p, c = st.step_n(st.put(world), 100)
        got = read_launches()
        ref = make_stepper(height=512, width=512, rule=notation)
        q, d = ref.step_n(ref.put(world), 100)
        want = golden if notation == "B3/S23" else ref.fetch(q)
        if not np.array_equal(st.fetch(p), want) or int(c.item()) != int(
                d.item()):
            raise AssertionError(f"{st.name} {notation}: board differs")
        if got[kernel] != 400 or sum(got.values()) != 400:
            raise AssertionError(f"{st.name}: launches {got}, 4 blocks x "
                                 "100 turns give 400")
        out[kernel] = got[kernel]
        phase("main-mesh", f"{st.name} {notation} 512² x 100 on 4 blocks "
              f"of cuda:0 equal to the {'fixture' if notation == 'B3/S23' else ref.name}; "
              f"{got[kernel]} {kernel} launches")
    params = Params(image_width=512, image_height=512, turns=100, chunk=0,
                    partition_rules="layout=lane-coupled",
                    image_dir=str(FIXTURES / "images"),
                    out_dir=str(tmp / "lanes"))
    reset_launches()
    drain(gol_tpu_torch.run(params, emit_flips=False))
    got = read_launches()
    if (tmp / "lanes/512x512x100.pgm").read_bytes() != (
            FIXTURES / "check/images/512x512x100.pgm").read_bytes():
        raise AssertionError("lane-coupled 512²: PGM differs from the fixture")
    if got["bitlife_resident"] != 200 or sum(got.values()) != 200:
        raise AssertionError(f"lane-coupled: launches {got}, 2 chunks x 100 "
                             "turns give 200")
    out["bitlife_resident"] += 200
    phase("main-mesh", "run(Params 512², partition_rules "
          "layout=lane-coupled) byte-equal to the fixture; 200 "
          "bitlife_resident launches (two chunks a turn)")
    return out


def cli_mesh(tmp: pathlib.Path) -> None:
    """Phase `cli-mesh`: on this one-card machine `--mesh 2x2` exits
    nonzero with gol_tpu's "needs 4 devices, have 1", and `-t 4` runs one
    shard, byte-equal to the fixture."""
    import torch

    base = [sys.executable, "-m", "gol_tpu_torch", "-w", "512", "-h", "512",
            "-turns", "100", "-noVis", "--images", str(FIXTURES / "images")]
    n = torch.cuda.device_count()
    r = subprocess.run(base + ["--mesh", "2x2", "--out", str(tmp / "climesh")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    want = f"mesh 2x2 needs 4 devices, have {n}"
    if n < 4 and (r.returncode == 0 or want not in r.stdout + r.stderr):
        raise AssertionError(f"--mesh 2x2 on {n} card(s): rc {r.returncode}, "
                             f"{r.stderr[-400:]}")
    r = subprocess.run(base + ["-t", "4", "--out", str(tmp / "clit4")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or (tmp / "clit4/512x512x100.pgm").read_bytes() != (
            FIXTURES / "check/images/512x512x100.pgm").read_bytes():
        raise AssertionError(f"-t 4: rc {r.returncode}, {r.stderr[-400:]}")
    phase("cli-mesh", f"--mesh 2x2 exits {'nonzero: ' + want if n < 4 else 'with a mesh'}; "
          f"-t 4 on {n} card(s) runs {min(4, n)} shard(s), byte-equal to "
          "the fixture")


def rings(tmp: pathlib.Path, card: str) -> dict:
    """The ring and mesh phases after the kernel checks, each phase's
    launches counted from 0; returns {phase: {kernel: launches}}."""
    t0 = time.perf_counter()
    out = {"main-ring-512": main_ring_512(tmp),
           "main-ring-16384": main_ring_16384(card),
           "main-ring-uneven": main_ring_uneven(),
           "main-watched-ring": main_watched_ring(tmp),
           "main-mesh": main_mesh(tmp)}
    cli_mesh(tmp)
    phase("rings", f"{time.perf_counter() - t0:.1f} s for the ring, mesh "
                   "and lane phases")
    return out


def measure(errs: dict, launches: dict, int_ops_per_s: float,
            slab: int) -> list:
    """Phase 7: ms per launch of each kernel at its main-path shape, the
    plain version's ms for the same work, and the bound. `slab` is the
    tiled main path's slab of T = 1024 ext blocks."""
    import numpy as np
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitgens, bitlife, life
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl

    brain = get_rule("B2/S/C3")
    star_wars = get_rule("B2/S345/C4")
    highlife = get_rule("B36/S23")

    def packed(side, seed):
        return bitlife.pack(life.to_bits(
            torch.from_numpy(life.random_world(side, side, seed=seed)).cuda()))

    def gens(side, rule=brain):
        return gens_planes(rule, side, side, torch.Generator().manual_seed(3))

    # Each bound form is held equal to the plain step before its count
    # is used.
    p = packed(512, 2)
    nxt, life_ops = life_fewest_instructions(p)
    if not torch.equal(nxt, bitlife.step_packed(p)):
        raise AssertionError("the bound's LOP3/SHF form does not compute Life")
    nxt, highlife_ops = highlife_fewest_instructions(p)
    if not torch.equal(nxt, bitlife.step_packed(p, highlife)):
        raise AssertionError("the bound's LOP3/SHF form does not compute "
                             "B36/S23")
    q = gens(512)
    nxt, gens_ops = gens_fewest_instructions(q)
    if not torch.equal(nxt, bitgens.step_packed_gens(q, brain)):
        raise AssertionError("the bound's LOP3/SHF form does not compute B2/S/C3")
    q = gens(512, star_wars)
    nxt, sw_ops = starwars_fewest_instructions(q)
    if not torch.equal(nxt, bitgens.step_packed_gens(q, star_wars)):
        raise AssertionError("the bound's LOP3/SHF form does not compute "
                             "B2/S345/C4")
    bits = life.to_bits(torch.from_numpy(life.random_world(512, 512, seed=2)).cuda())
    nxt, dense_ops = dense_fewest_instructions(bits)
    if not torch.equal(nxt, life.step_bits(bits)):
        raise AssertionError("the bound's byte-SIMD form does not compute Life")
    phase("measure", f"bound: {life_ops} (Life), {highlife_ops} (B36/S23), "
                     f"{gens_ops} (B2/S/C3) and {sw_ops} (B2/S345/C4) INT32 "
                     f"instructions per packed word per turn (LOP3/SHF form), "
                     f"{dense_ops} per 32-bit word of 4 dense cells (byte-SIMD "
                     f"form); each equal to the plain step")

    def star_wars_bound(x, turns):
        # Bytes: all three planes in and out; operations on one plane's
        # words.
        return bound_ms(2 * 4 * x.numel(), x[0].numel() * turns * sw_ops,
                        int_ops_per_s)[0]

    # (name, shape, what ms and the bound are per, input, timed call of
    #  the kernel, plain version of the same call, the call's bytes and
    #  INT32 instructions). A, C: one 64-turn chunk of the 512² board (the
    #  engine's first chunk). B, D: one 32-turn pass of the 16384² board.
    #  E: one 100-turn call on the 512² dense board (⌈100/k⌉ launches);
    #  its bound is the call's (the board read once and written once, 100
    #  turns of instructions). A batched: one 32-turn launch over the
    #  tiled main path's slab of T = 1024 ext blocks, each the 1088² soup
    #  board's words.
    w512 = torch.from_numpy(life.random_world(512, 512, seed=1)).cuda()
    specs = [
        ("bitlife_resident", "512x512 board, 64 turns per launch",
         "64-turn launch",
         lambda: packed(512, 1),
         lambda x: cb.step_n_packed_cuda_raw(x, 64),
         lambda x: bitlife.step_n_packed_raw(x, 64),
         lambda x: 2 * 4 * x.numel(), lambda x: x.numel() * 64 * life_ops),
        ("bitlife_tiled", "16384x16384 board, 32 turns per launch",
         "32-turn launch",
         lambda: packed(16384, 1),
         lambda x: cb.step_n_packed_tiled2d_raw(x, 32),
         lambda x: bitlife.step_n_packed_raw(x, 32),
         lambda x: 2 * 4 * x.numel(), lambda x: x.numel() * 32 * life_ops),
        ("bitgens_resident", "512x512 B2/S/C3 planes, 64 turns per launch",
         "64-turn launch",
         lambda: gens(512),
         lambda x: cg.step_n_packed_gens_cuda_raw(x, 64, brain),
         lambda x: bitgens.step_n_packed_gens_raw(x, 64, brain),
         lambda x: 2 * 4 * x.numel(), lambda x: x[0].numel() * 64 * gens_ops),
        ("bitgens_tiled", "16384x16384 B2/S/C3 planes, 32 turns per launch",
         "32-turn launch",
         lambda: gens(16384),
         lambda x: cg.step_n_packed_gens_tiled2d_raw(x, 32, brain),
         lambda x: bitgens.step_n_packed_gens_raw(x, 32, brain),
         lambda x: 2 * 4 * x.numel(), lambda x: x[0].numel() * 32 * gens_ops),
        ("life_dense", "512x512 dense board, one 100-turn call",
         "100-turn call",
         lambda: w512,
         lambda x: cl.step_n_cuda_dense(x, 100),
         lambda x: life.step_n(x, 100),
         lambda x: 2 * x.numel(), lambda x: x.numel() // 4 * 100 * dense_ops),
        ("bitlife_resident_batch",
         f"{slab} ext blocks of 34x1088 words (T = 1024), 32 turns per "
         "launch", "32-turn launch",
         lambda: torch.from_numpy(np.stack([
             bitlife.pack_np(soup_world(1088)[:1088, :1088])] * slab
         ).view(np.int32)).cuda(),
         lambda x: cb.step_n_packed_batch_cuda_raw(x, 32),
         lambda x: bitlife.step_n_packed_raw(x, 32),
         lambda x: 2 * 4 * x.numel(), lambda x: x.numel() * 32 * life_ops),
        ("bitlife_resident_sessions",
         f"a bucket of {LANE_SESSIONS} boards of {LANE_SIDE}², "
         f"{LANE_K} turns per launch", f"{LANE_K}-turn launch",
         lambda: torch.from_numpy(np.stack([
             bitlife.pack_np(b) for b in bucket_soups(
                 LANE_SESSIONS, LANE_SIDE, LANE_SIDE, seed=1)]
         ).view(np.int32)).cuda(),
         lambda x: cb.step_n_packed_batch_cuda_raw(x, LANE_K),
         lambda x: bitlife.step_n_packed_raw(x, LANE_K),
         lambda x: 2 * 4 * x.numel(),
         lambda x: x.numel() * LANE_K * life_ops),
    ]
    # The single-turn launch the watched path makes, on the same input.
    single = {
        "bitlife_resident": lambda x: cb.step_n_packed_cuda_raw(x, 1),
        "bitlife_tiled": lambda x: cb.step_n_packed_tiled2d_raw(x, 1),
        "bitgens_resident": lambda x: cg.step_n_packed_gens_cuda_raw(
            x, 1, brain),
        "bitgens_tiled": lambda x: cg.step_n_packed_gens_tiled2d_raw(
            x, 1, brain),
        "life_dense": lambda x: cl.step_n_cuda_dense(x, 1),
        "bitlife_resident_batch": lambda x: cb.step_n_packed_batch_cuda_raw(
            x, 1),
        "bitlife_resident_sessions":
            lambda x: cb.step_n_packed_batch_cuda_raw(x, 1),
    }
    rows = []
    for name, shape, per, make, kernel, plain, nbytes, ops in specs:
        x = make()
        ms = time_ms(lambda: kernel(x), 20)
        plain_ms = time_ms(lambda: plain(x), 3)
        n1_ms = time_ms(lambda: single[name](x), 50)
        b_ms, b_by = bound_ms(nbytes(x), ops(x), int_ops_per_s)
        rows.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "shape": shape,
            "per": per, "n1_ms": n1_ms,
        })
        phase("measure", f"{name} {shape}: {ms:.4f} ms per call, plain "
                         f"{plain_ms:.3f} ms, bound {b_ms:.4g} ms ({b_by}); "
                         f"{n1_ms:.4f} ms per single-turn launch")
        if name == "bitlife_tiled":
            # Kernel B through the strip entry point (gol_tpu's 1-D tiled
            # kernel's replacement) on the same board and pass, and its
            # run-time-mask instantiation (B36/S23) through both entries,
            # against B36/S23's bound.
            rows[-1]["share"] = b_ms / ms
            rows[-1]["strip_ms"] = time_ms(
                lambda: cb.step_n_packed_tiled_raw(x, 32), 20)
            hl_ops = x.numel() * 32 * highlife_ops
            hl = {"ms": time_ms(lambda: cb.step_n_packed_tiled2d_raw(
                      x, 32, highlife), 20),
                  "strip_ms": time_ms(lambda: cb.step_n_packed_tiled_raw(
                      x, 32, highlife), 20),
                  "bound_ms": bound_ms(nbytes(x), hl_ops, int_ops_per_s)[0]}
            hl["share"] = hl["bound_ms"] / hl["ms"]
            rows[-1]["B36/S23"] = hl
            phase("measure", f"bitlife_tiled B3/S23 (nine-cell-sum form): "
                             f"{ms:.4f} ms/launch via the 2-D entry, "
                             f"{rows[-1]['strip_ms']:.4f} via "
                             f"step_n_packed_tiled_raw, 16384² x32 turns; "
                             f"{rows[-1]['share']:.1%} of its bound")
            phase("measure", f"bitlife_tiled B36/S23 (run-time masks): "
                             f"{hl['ms']:.4f} ms/launch via the 2-D entry, "
                             f"{hl['strip_ms']:.4f} via the strip entry; "
                             f"bound {hl['bound_ms']:.4g} ms, "
                             f"{hl['share']:.1%} of it")
        if name == "bitgens_tiled":
            # Kernel D's B2/S/C3 form (column walkers) through the strip
            # entry on the same planes and pass, and its run-time-mask
            # form on B2/S345/C4 through the 2-D entry, against that
            # rule's bound.
            rows[-1]["share"] = b_ms / ms
            rows[-1]["strip_ms"] = time_ms(
                lambda: cg.step_n_packed_gens_tiled_raw(x, 32, brain), 20)
            q4 = gens(16384, star_wars)
            sw = {"ms": time_ms(
                lambda: cg.step_n_packed_gens_tiled2d_raw(q4, 32, star_wars),
                20), "bound_ms": star_wars_bound(q4, 32)}
            sw["share"] = sw["bound_ms"] / sw["ms"]
            rows[-1]["B2/S345/C4"] = sw
            del q4
            phase("measure", f"bitgens_tiled B2/S/C3 (column walkers): "
                             f"{ms:.4f} ms/launch via the 2-D entry, "
                             f"{rows[-1]['strip_ms']:.4f} via "
                             f"step_n_packed_gens_tiled_raw, 16384² x32 "
                             f"turns; {rows[-1]['share']:.1%} of its bound")
            phase("measure", f"bitgens_tiled B2/S345/C4 (run-time masks): "
                             f"{sw['ms']:.4f} ms/launch via the 2-D entry, "
                             f"16384² x32 turns; bound {sw['bound_ms']:.4g} "
                             f"ms, {sw['share']:.1%} of it")
        if name == "life_dense":
            dense_rows(rows[-1], x, nbytes, dense_ops, int_ops_per_s)
        del x
        torch.cuda.empty_cache()
    # Kernels A and C: the cluster plan at 512², the share of the bound
    # of a 64-turn launch, the per-turn time at the chunk a long 512² run
    # calibrates to (~0.1 s of turns) once the launch cost is amortized,
    # and the registers and spills of each form's build.
    from gol_tpu_torch.ops import _build

    by_name = {row["name"]: row for row in rows}
    p = packed(512, 1)
    q = gens(512)
    q4 = gens(512, star_wars)
    sw = {"ms": time_ms(lambda: cg.step_n_packed_gens_cuda_raw(
              q4, 64, star_wars), 20),
          "bound_ms": star_wars_bound(q4, 64),
          "plan": cb._cluster_plan(16, 512, star_wars.states),
          "us_per_turn": time_ms(lambda: cg.step_n_packed_gens_cuda_raw(
              q4, 16384, star_wars), 3) / 16384 * 1e3}
    sw["share"] = sw["bound_ms"] / sw["ms"]
    by_name["bitgens_resident"]["B2/S345/C4"] = sw
    for name, copies, run in (
            ("bitlife_resident", 2,
             lambda k: cb.step_n_packed_cuda_raw(p, k)),
            ("bitgens_resident", brain.states,
             lambda k: cg.step_n_packed_gens_cuda_raw(q, k, brain))):
        row = by_name[name]
        row["plan"] = cb._cluster_plan(16, 512, copies)
        row["share"] = row["bound_ms"] / row["ms"]
        row["us_per_turn"] = time_ms(lambda: run(16384), 3) / 16384 * 1e3
        row["registers"] = kernel_resources(_build.build_log, name)
        phase("measure", f"{name} 512² (blocks, slab_rows, halo) "
                         f"{row['plan']}: {row['ms']:.4f} ms per 64-turn "
                         f"launch, {row['share']:.2%} of its bound; "
                         f"{row['us_per_turn']:.3f} us/turn at 16384-turn "
                         f"launches; {row['registers']}")
    phase("measure", f"bitgens_resident 512² B2/S345/C4 (run-time masks, "
                     f"plan {sw['plan']}): {sw['ms']:.4f} ms per 64-turn "
                     f"launch, bound {sw['bound_ms']:.4g} ms, "
                     f"{sw['share']:.2%} of it; {sw['us_per_turn']:.3f} "
                     f"us/turn at 16384-turn launches")
    return rows


def host_ms(fn, reps: int) -> float:
    """Mean ms the host spends enqueueing one call of `fn` (perf_counter
    around the call, before any synchronise), after one warm-up; the
    card is idle at the start of each call."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def device_ms(fn, kernel: str, reps: int):
    """(ms of device time per call of `fn` in kernels named `kernel`,
    their launches per call), by torch.profiler's CUDA activity over
    `reps` calls after one warm-up; (None, 0) where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "device_time_total", 0) for e in mine)
    count = sum(e.count for e in mine)
    return (us / reps / 1e3 if us else None), count / reps


def dense_launches(fn, reps: int) -> tuple:
    """(launches of kernel E in one call of `fn`, as the C launcher
    reports them; the device's ms per call): the count held equal to the
    launches a call that `torch.profiler` sees over `reps` calls."""
    from gol_tpu_torch.ops import cuda_life as cl

    before = cl.LAUNCHES["life_dense"]
    fn()
    issued = cl.LAUNCHES["life_dense"] - before
    ms, seen = device_ms(fn, "life_dense", reps)
    if seen != issued:
        raise AssertionError(f"life_dense: the launcher reported {issued} "
                             f"launches a call, torch.profiler saw {seen}")
    return issued, ms


def dense_rows(row: dict, x, nbytes, dense_ops: int,
               int_ops_per_s: float) -> None:
    """Kernel E beyond its 512² row: ms per turn, launches per call (the
    launcher's count, held equal to torch.profiler's), the share of the
    bound, registers, the host's enqueue time and the device's time per
    call beside the CUDA-event time; both plans (depths 8 and 16) on the
    same 100-turn call, and a launch's fixed cost against a turn's; and
    a 16384² 32-turn call with its own bound, at both plans."""
    import torch

    from gol_tpu_torch.models.rules import LIFE
    from gol_tpu_torch.ops import _build, life
    from gol_tpu_torch.ops import cuda_life as cl

    row["plan"] = cl._dense_plan(*x.shape)
    k = row["plan"][4]
    row["ms_per_turn"] = row["ms"] / 100
    row["share"] = row["bound_ms"] / row["ms"]
    row["registers"] = kernel_resources(_build.build_log, "life_dense")
    row["host_ms"] = host_ms(lambda: cl.step_n_cuda_dense(x, 100), 20)
    row["launches_per_call"], row["device_ms"] = dense_launches(
        lambda: cl.step_n_cuda_dense(x, 100), 20)
    row["depths_ms"] = {d: time_ms(lambda: cl._run(
        x, 100, LIFE, cl._dense_plan(*x.shape, d)), 20)
        for d in sorted(cl.TILES)}
    # A launch's fixed cost against a turn's: 100 launches of one turn
    # each and 100 of k turns each, every one from a single C call.
    one = row["plan"][:4] + (1,) + row["plan"][5:]
    t1 = time_ms(lambda: cl._run(x, 100, LIFE, one), 10)
    tk = time_ms(lambda: cl._run(x, 100 * k, LIFE, row["plan"]), 10)
    row["turn_us"] = (tk - t1) / (100 * (k - 1)) * 1e3
    row["launch_us"] = t1 / 100 * 1e3 - row["turn_us"]
    phase("measure", f"life_dense 512² plan {row['plan']}: {row['ms']:.4f} "
                     f"ms per 100-turn call ({row['launches_per_call']} "
                     f"launches), {row['ms_per_turn'] * 1e3:.3f} us a turn, "
                     f"{row['share']:.2%} of its bound; host enqueue "
                     f"{row['host_ms']:.4f} ms per call, device "
                     f"{row['device_ms']} ms (torch.profiler, which saw "
                     f"the same launches); "
                     f"a launch {row['launch_us']:.3f} us fixed + "
                     f"{row['turn_us']:.3f} us a turn; by depth "
                     f"{row['depths_ms']}; {row['registers']}")
    side = 16384
    big = torch.from_numpy(life.random_world(side, side, seed=1)).cuda()
    r = {"ms": time_ms(lambda: cl.step_n_cuda_dense(big, 32), 10),
         "plan": cl._dense_plan(side, side),
         "bound_ms": bound_ms(nbytes(big), big.numel() // 4 * 32 * dense_ops,
                              int_ops_per_s)[0],
         "plain_ms": time_ms(lambda: life.step_n(big, 32), 1),
         "host_ms": host_ms(lambda: cl.step_n_cuda_dense(big, 32), 5),
         "depths_ms": {d: time_ms(lambda: cl._run(
             big, 32, LIFE, cl._dense_plan(side, side, d)), 10)
             for d in sorted(cl.TILES)},
         "per": "32-turn call"}
    r["launches_per_call"], r["device_ms"] = dense_launches(
        lambda: cl.step_n_cuda_dense(big, 32), 5)
    r["share"] = r["bound_ms"] / r["ms"]
    row["16384x16384 x32"] = r
    phase("measure", f"life_dense 16384² plan {r['plan']}: {r['ms']:.4f} ms "
                     f"per 32-turn call ({r['launches_per_call']} launches), "
                     f"bound {r['bound_ms']:.4g} ms, {r['share']:.2%} of it; "
                     f"plain {r['plain_ms']:.3f} ms; host enqueue "
                     f"{r['host_ms']:.4f} ms, device {r['device_ms']} ms "
                     f"(torch.profiler); by depth {r['depths_ms']}")
    del big


def ab_time(root: str) -> dict:
    """One side of `--ab`: kernels A-E of the package under `root` — ms
    per launch of one 32-turn pass of a 16384² board through B's and D's
    2-D entries, of one 64-turn launch of A and C on a 512² board, and
    ms per call of E's public `step_n_cuda_dense` on a 512² board (100
    turns) and a 16384² one (32 turns), and of the 512² call the host's
    enqueue and the device's time (torch.profiler) — the library's path
    and the registers of a fresh build (none from the cache)."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import _build, bitlife, life
    from gol_tpu_torch.ops import cuda_bitgens as cg
    from gol_tpu_torch.ops import cuda_bitlife as cb
    from gol_tpu_torch.ops import cuda_life as cl

    _build.load()
    brain, highlife = get_rule("B2/S/C3"), get_rule("B36/S23")
    star_wars = get_rule("B2/S345/C4")

    def board(side):
        return bitlife.pack(life.to_bits(torch.from_numpy(
            life.random_world(side, side, seed=1)).cuda()))

    def planes(rule, side):
        return gens_planes(rule, side, side, torch.Generator().manual_seed(3))

    x, p = board(16384), board(512)
    q, q4 = planes(brain, 16384), planes(star_wars, 16384)
    r, r4 = planes(brain, 512), planes(star_wars, 512)
    w, big = (torch.from_numpy(life.random_world(side, side, seed=1)).cuda()
              for side in (512, 16384))
    return {
        "package": str(pathlib.Path(cb.__file__).resolve().parents[2]),
        "A B3/S23": time_ms(lambda: cb.step_n_packed_cuda_raw(p, 64), 20),
        "B B3/S23": time_ms(lambda: cb.step_n_packed_tiled2d_raw(x, 32), 20),
        "B B36/S23": time_ms(
            lambda: cb.step_n_packed_tiled2d_raw(x, 32, highlife), 20),
        "C B2/S/C3": time_ms(
            lambda: cg.step_n_packed_gens_cuda_raw(r, 64, brain), 20),
        "C B2/S345/C4": time_ms(
            lambda: cg.step_n_packed_gens_cuda_raw(r4, 64, star_wars), 20),
        "D B2/S/C3": time_ms(
            lambda: cg.step_n_packed_gens_tiled2d_raw(q, 32, brain), 20),
        "D B2/S345/C4": time_ms(
            lambda: cg.step_n_packed_gens_tiled2d_raw(q4, 32, star_wars), 20),
        "E 512x512 x100": time_ms(
            lambda: cl.step_n_cuda_dense(w, 100), 20),
        "E 16384x16384 x32": time_ms(
            lambda: cl.step_n_cuda_dense(big, 32), 10),
        "E 512x512 x100 host": host_ms(
            lambda: cl.step_n_cuda_dense(w, 100), 20),
        "E 512x512 x100 device": device_ms(
            lambda: cl.step_n_cuda_dense(w, 100), "life_dense", 20)[0],
        "library": str(_build.library_path()),
        "registers": {k: kernel_resources(_build.build_log, k)
                      for k in ("bitlife_resident", "bitlife_tiled",
                                "bitgens_resident", "bitgens_tiled",
                                "life_dense")},
    }


def sass(library: str) -> dict:
    """{kernel instantiation: its SASS} of a built library, by the CUDA
    toolkit's `cuobjdump`, with the per-build hash of anonymous
    namespaces taken out of the names, so that two builds of one source
    compare equal."""
    tool = pathlib.Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    out = subprocess.run([str(tool / "bin" / "cuobjdump"), "-sass", library],
                         capture_output=True, text=True, check=True).stdout
    out = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", out)
    funcs, name = {}, None
    for ln in out.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(ln.strip())
    return funcs


def ab(other: str, card: str) -> int:
    """`--ab OTHER`: `ab_time` of the other checkout and of this one in
    the order other, this, this, other; then each kernel's mean per
    checkout and this one's ratio to the other's; then, for each kernel
    instantiation, whether the two builds compiled it to the same
    SASS."""
    times: dict = {}
    libraries: dict = {}
    for root in (other, str(REPO), str(REPO), other):
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "--ab-time", root],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        phase("ab", json.dumps(res))
        libraries[root] = res.pop("library")
        for k, v in res.items():
            if k not in ("package", "registers"):
                times.setdefault(k, {}).setdefault(root, []).append(v)
    for k, by_root in times.items():
        mine = sum(by_root[str(REPO)]) / 2
        theirs = sum(by_root[other]) / 2
        phase("ab", f"{k}: this {mine:.4f} ms, other {theirs:.4f} ms "
                    f"(means of two), ratio {mine / theirs:.4f}; {card}")
    theirs, mine = sass(libraries[other]), sass(libraries[str(REPO)])
    for name in sorted(set(theirs) | set(mine)):
        same = ("same SASS" if theirs.get(name) == mine.get(name) else
                "SASS differs" if name in theirs and name in mine else
                "in one build only")
        phase("ab", f"{name}: {same}")
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (REPO / "gol_tpu_torch" / "csrc").is_dir() or not FIXTURES.is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(gol_tpu_torch/ and fixtures/ beside this script)",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ab-time"]:
        print(json.dumps(ab_time(sys.argv[2])))
        return 0
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--mh-rank"]:
        return mh_rank(int(sys.argv[2]), int(sys.argv[3]),
                       pathlib.Path(sys.argv[4]))
    t_start = time.perf_counter()

    # Phase 1: environment.
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    phase("env", f"{card}; torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}; {sms} SMs at {clock_mhz:.0f} MHz max "
                 f"-> INT32 peak {int_ops_per_s / 1e12:.2f} Tops/s")
    if sys.argv[1:2] == ["--ab"]:
        return ab(str(pathlib.Path(sys.argv[2]).resolve()), card)

    # Phase 2: build.
    from gol_tpu_torch.ops import _build

    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    phase("build", f"nvcc {_build.build_seconds:.2f} s -> "
                   f"{_build.library_path().name}; {regs}")
    # The two instantiations of kernels A-E (ILi0E: A's, B's and E's
    # B3/S23 and C's and D's B2/S/C3 column walkers, ILi1E: the run-time
    # masks, E's table), registers and spills.
    for name in ("bitlife_resident", "bitlife_tiled", "bitgens_resident",
                 "bitgens_tiled", "life_dense"):
        phase("build", f"{name}: {kernel_resources(_build.build_log, name)}")

    errs = {name: 0 for name in KERNELS}
    check_kernels(errs)
    check_gens_kernels(errs)
    check_dense_kernel(errs)
    check_batch_kernel(errs)
    check_session_kernels(errs)
    check_ring_kernels(errs)
    diffs_launches = check_diffs()
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        tmp = pathlib.Path(d)
        launches = {"bitlife_resident": main_path_512(tmp),
                    "bitlife_tiled": main_path_16384(tmp, card)}
        main_gens_64(tmp)
        launches["bitgens_resident"] = main_gens_512(tmp)
        launches["bitgens_tiled"] = main_gens_16384(tmp, card)
        launches["life_dense"] = main_dense_512(tmp)
        # The rings and meshes of shards on the card, each phase's
        # launches counted from 0.
        ring = rings(tmp, card)
        watched = {"bitlife_resident": main_watched_512(tmp),
                   "bitgens_resident": main_watched_gens_512(tmp),
                   "bitlife_tiled": main_watched_16384(tmp, card)}
        tiled_ab(card, int_ops_per_s)
        launches["bitlife_resident_batch"], slab = main_tiled_16384(tmp, card)
        watched["bitlife_resident_batch"] = main_watched_tiled(tmp, card)
        cli_wall = cli(tmp)
        cli_watcher(tmp, cli_wall)
        cli_tiled(tmp, card)
        # The session bucket's main path: its kernel A launches are the
        # row's; kernels B and E step the buckets with no cluster plan.
        sessions = {"main-sessions": main_sessions(tmp, card)}
        launches["bitlife_resident_sessions"] = (
            sessions["main-sessions"]["bitlife_resident"])
        kernels = measure(errs, launches, int_ops_per_s, slab)
        # After `measure`, whose torch.profiler sessions then run as they
        # did before this phase's captures existed.
        cli_full = main_cli_full(tmp, cli_wall)
        served = serving(tmp, card)
        t_sessions = time.perf_counter()
        sessions["sessions-lane"] = sessions_lane(card)
        sessions["main-sessions-serve"] = main_sessions_serve(tmp, card)
        cli_sessions(tmp, card)
        phase("sessions", f"{time.perf_counter() - t_sessions:.1f} s for "
              "sessions-lane, main-sessions-serve and cli-sessions")
        # The broadcast tier, the telemetry planes and the fleet, each
        # phase's launches counted from 0 (by the row that owns them).
        t_fleet = time.perf_counter()
        relay = {"relay-fanout": {"bitlife_resident": relay_fanout(tmp,
                                                                   card)},
                 "main-relay-16384": {"bitlife_tiled": main_relay_16384(
                     tmp, card)},
                 "main-telemetry": {"bitlife_resident_sessions":
                                    main_telemetry(tmp, card)}}
        root = cli_fleet(tmp, card)
        fleet = {"bitlife_resident_sessions": root.pop("bitlife_resident"),
                 **{k: v for k, v in root.items() if v}}
        phase("fleet", f"{time.perf_counter() - t_fleet:.1f} s for "
              "relay-fanout, main-relay-16384, main-telemetry and "
              "cli-fleet")
        # Multi-process jobs and the chaos harness, each phase's
        # launches counted in its own processes.
        mh = multihost_phase(tmp, card)
        t_chaos = time.perf_counter()
        chaos_fused = chaos_phase(tmp, card)
        phase("chaos", f"{time.perf_counter() - t_chaos:.1f} s for the "
              "phase")
    for row in kernels:
        # Launches of the watched phases (one a turn), of `diffs` and of
        # the visualised CLI runs.
        row["watched_launches"] = watched.get(row["name"])
        row["diffs_launches"] = diffs_launches.get(row["name"])
        row["cli_launches"] = cli_full.get(row["name"])
        # Launches on each serving path, the counts set to 0 before it.
        row["serve_launches"] = served.get(row["name"])
        # Launches on each session path (the counts set to 0 before it),
        # by the kernel the row launches.
        # Kernel A's session launches stand on row 1c only, so that
        # row A does not count them a second time.
        kernel = {"bitlife_resident_sessions": "bitlife_resident",
                  "bitlife_resident": None}.get(row["name"], row["name"])
        row["sessions_launches"] = {
            ph: got.get(kernel) for ph, got in sessions.items()
            if isinstance(got.get(kernel), (int, float))} or None
        # Launches on the broadcast, telemetry and fleet paths.
        row["relay_launches"] = {
            ph: got[row["name"]] for ph, got in relay.items()
            if row["name"] in got} or None
        row["fleet_launches"] = fleet.get(row["name"])
        # Launches on the ring, mesh and lane paths, by phase.
        row["ring_launches"] = {
            ph: got[row["name"]] for ph, got in ring.items()
            if row["name"] in got} or None
        # Launches of each rank of the 2-process job, by leg.
        row["multihost_launches"] = mh.get(row["name"])
        # The chaos server's fused session dispatches (kernel A's batched
        # entry in the child), both boots.
        row["chaos_fused_dispatches"] = (
            chaos_fused if row["name"] == "bitlife_resident_sessions"
            else None)
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
