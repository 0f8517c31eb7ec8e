"""Chip smoke test of the PyTorch / CUDA port (`gol_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It
builds the hand-written CUDA kernels from `gol_tpu_torch/csrc`, holds
each kernel bit-exact against its plain PyTorch version, drives the
port's main path (`gol_tpu_torch.run` at 512² against the golden
fixtures and at 16384² against the plain version), runs the CLI, and
prints the `kernels` JSON line, the card's name and power limit, and a
last line `{"ok": true, "device": {...}}`. Any failed phase raises, so
the script exits nonzero and prints no result. Without a CUDA device,
or without the repository beside it, it exits nonzero at once.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import csv
import json
import pathlib
import random
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
}

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


def bound_ms(words: int, turns: int, ops_per_word: int,
             int_ops_per_s: float) -> tuple:
    """(least ms, what bounds it) for `turns` turns of a `words`-word
    board: input read once and output written once (8 bytes per word),
    against `ops_per_word` INT32 instructions per word per turn."""
    byte_s = 2 * 4 * words / HBM_BYTES_PER_S
    op_s = words * turns * ops_per_word / int_ops_per_s
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


def check_kernels(errs: dict) -> None:
    """Phase 3: every kernel against its plain version on the card,
    bit-exact, at the main path's shapes and the listed seams."""
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

    def plains(p, ns, rule):
        out, q, at = {}, p, 0
        for n in sorted(set(ns)):
            q = bitlife.step_n_packed_raw(q, n - at, rule)
            at = n
            out[n] = q
        return out

    checked = 0
    for rule in rules:
        for side in (64, 512):
            p = board(side, side)
            ns = (1, 7, 8, 9, 31, 32, 33, 100)
            want = plains(p, ns, rule)
            for n in ns:
                got = cb.step_n_packed_cuda_raw(p, n, rule)
                torch.cuda.synchronize()
                err = max_abs_err(got, want[n])
                errs["bitlife_resident"] = max(errs["bitlife_resident"], err)
                if err:
                    raise AssertionError(
                        f"bitlife_resident {side}² n={n} {rule}: mismatch")
                checked += 1
        for side in (4096, 16384):
            p = board(side, side)
            variants = [
                ("tiled2d", {}, 32),
                ("tiled2d", {"tile_rows": 8}, 32),
                ("tiled", {}, 32),
                ("tiled", {"strip_rows": 8, "halo_words": 2}, 64),
            ]
            want = plains(p, [n for _, _, k in variants
                              for n in (k - 1, k, k + 1, 2 * k + 3)], rule)
            for entry, kw, k in variants:
                fn = (cb.step_n_packed_tiled2d_raw if entry == "tiled2d"
                      else cb.step_n_packed_tiled_raw)
                for n in (k - 1, k, k + 1, 2 * k + 3):
                    got = fn(p, n, rule, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want[n])
                    errs["bitlife_tiled"] = max(errs["bitlife_tiled"], err)
                    if err:
                        raise AssertionError(
                            f"bitlife_tiled via {entry}{kw} {side}² n={n} "
                            f"{rule}: mismatch")
                    checked += 1
            del p, want
            torch.cuda.empty_cache()
    phase("kernels", f"{checked} kernel runs bit-exact against the plain "
                     f"version (rules {[str(r) for r in rules]}, "
                     f"max_abs_err {max(errs.values())})")


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
    from gol_tpu_torch import FinalTurnComplete, ImageOutputComplete, Params
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.obs import flight
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
    # Where the wall time went, from the engine's own flight notes (one
    # per committed dispatch) and the arrival of the tail events.
    commits = [ts for ts, kind, _ in flight.FLIGHT.entries
               if kind == "engine.commit" and ts >= t0]
    t_image = next(t for t, e in timed if isinstance(e, ImageOutputComplete))
    t_final = next(t for t, e in timed if isinstance(e, FinalTurnComplete))
    split = (f"start->turn-0 commit (put) {commits[0] - t0:.3f} s, "
             f"{len(commits) - 1} chunk dispatches {commits[-1] - commits[0]:.3f} s, "
             f"->snapshot written (device drain, fetch, PGM write) "
             f"{t_image - commits[-1]:.3f} s, ->FinalTurnComplete (fetch, "
             f"alive list) {t_final - t_image:.3f} s")
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


def cli(tmp: pathlib.Path) -> None:
    """Phase 6: the CLI writes the golden PGM."""
    out = tmp / "cli"
    subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "512", "-h", "512",
         "-turns", "100", "-noVis", "--images", str(FIXTURES / "images"),
         "--out", str(out)],
        check=True, cwd=REPO, capture_output=True, timeout=300,
    )
    got = (out / "512x512x100.pgm").read_bytes()
    if got != (FIXTURES / "check/images/512x512x100.pgm").read_bytes():
        raise AssertionError("CLI PGM differs from the fixture")
    phase("cli", "python -m gol_tpu_torch -w 512 -h 512 -turns 100 -noVis: "
                 "PGM byte-equal to the fixture")


def measure(errs: dict, launches: dict, int_ops_per_s: float) -> list:
    """Phase 7: ms per launch of each kernel at its main-path shape, the
    plain version's ms for the same work, and the bound."""
    import torch

    from gol_tpu_torch.ops import bitlife, life
    from gol_tpu_torch.ops import cuda_bitlife as cb

    p = bitlife.pack(life.to_bits(
        torch.from_numpy(life.random_world(512, 512, seed=2)).cuda()))
    nxt, ops_per_word = life_fewest_instructions(p)
    if not torch.equal(nxt, bitlife.step_packed(p)):
        raise AssertionError("the bound's LOP3/SHF form does not compute Life")
    phase("measure", f"bound: {ops_per_word} INT32 instructions per word per "
                     f"turn (LOP3/SHF form, equal to the plain step)")
    rows = []
    # Kernel A: one 64-turn chunk of the 512² board (the engine's
    # first chunk size). Kernel B: one 32-turn pass of the 16384² board.
    for name, side, turns, kernel in (
        ("bitlife_resident", 512, 64,
         lambda p: cb.step_n_packed_cuda_raw(p, 64)),
        ("bitlife_tiled", 16384, 32,
         lambda p: cb.step_n_packed_tiled2d_raw(p, 32)),
    ):
        p = bitlife.pack(life.to_bits(
            torch.from_numpy(life.random_world(side, side, seed=1)).cuda()))
        ms = time_ms(lambda: kernel(p), 20)
        plain_ms = time_ms(lambda: bitlife.step_n_packed_raw(p, turns), 3)
        words = p.numel()
        b_ms, b_by = bound_ms(words, turns, ops_per_word, int_ops_per_s)
        rows.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"{side}x{side} board, {turns} turns per launch",
        })
        phase("measure", f"{name} {side}² x{turns} turns: {ms:.4f} ms/launch, "
                         f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
                         f"({b_by})")
    # Kernel B through the strip entry point (gol_tpu's 1-D tiled
    # kernel's replacement) on the same board and pass.
    ms = time_ms(lambda: cb.step_n_packed_tiled_raw(p, 32), 20)
    phase("measure", f"bitlife_tiled via step_n_packed_tiled_raw 16384² x32 "
                     f"turns: {ms:.4f} ms/launch")
    # Kernel A at the chunk a long 512² run calibrates to (~0.1 s of
    # turns): per-turn time once the launch cost is amortized.
    p = bitlife.pack(life.to_bits(
        torch.from_numpy(life.random_world(512, 512, seed=1)).cuda()))
    ms = time_ms(lambda: cb.step_n_packed_cuda_raw(p, 16384), 3)
    phase("measure", f"bitlife_resident 512² x16384 turns: {ms:.3f} ms/launch, "
                     f"{ms / 16384 * 1e3:.3f} us/turn")
    return rows


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

    # Phase 2: build.
    from gol_tpu_torch.ops import _build

    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    phase("build", f"nvcc {_build.build_seconds:.2f} s -> "
                   f"{_build.library_path().name}; {regs}")

    errs = {name: 0 for name in KERNELS}
    check_kernels(errs)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        tmp = pathlib.Path(d)
        launches = {"bitlife_resident": main_path_512(tmp),
                    "bitlife_tiled": main_path_16384(tmp, card)}
        cli(tmp)
    kernels = measure(errs, launches, int_ops_per_s)
    phase("done", f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
