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
FlipBatches, FlipChunks at 16384²) — runs the CLI, headless and (phase
`main-cli-full`) visualised on the native board with
`--check-invariants`, `--autosave-turns`, `--resume` and
`--profile-dir`, whose `torch.profiler` captures give the device's busy
share of a run — and prints
the `kernels` JSON line, the card's name and power limit, and a last
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


def measure(errs: dict, launches: dict, int_ops_per_s: float) -> list:
    """Phase 7: ms per launch of each kernel at its main-path shape, the
    plain version's ms for the same work, and the bound."""
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
    #  turns of instructions).
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
        watched = {"bitlife_resident": main_watched_512(tmp),
                   "bitgens_resident": main_watched_gens_512(tmp),
                   "bitlife_tiled": main_watched_16384(tmp, card)}
        cli_wall = cli(tmp)
        kernels = measure(errs, launches, int_ops_per_s)
        # After `measure`, whose torch.profiler sessions then run as they
        # did before this phase's captures existed.
        cli_full = main_cli_full(tmp, cli_wall)
    for row in kernels:
        # Launches of the watched phases (one a turn), of `diffs` and of
        # the visualised CLI runs.
        row["watched_launches"] = watched.get(row["name"])
        row["diffs_launches"] = diffs_launches[row["name"]]
        row["cli_launches"] = cli_full.get(row["name"])
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
