"""Kernel E (csrc/life.cu, ops/cuda_life.py) on the CPU: its tiled
schedule — a grid of tiles, each loaded with its ghost frame (toroidal
indices modulo the board), stepped k turns on its own torus as the
column walkers wrap within the extended tile, its interior kept, ⌈n/k⌉
passes — written in plain torch around a mirror of the kernel's
byte-SIMD step in both forms (B3/S23 at compile time, every other rule
through the 18-bit table), equals the port's plain version, gol_tpu's
Pallas kernel (interpret mode) where that takes the shape and gol_tpu's
plain step elsewhere; the byte-SIMD step equals `life.step_bits`; the
plan keeps the kernel's limits; the wrapper hands the plan to the
launcher in the C signature's order. Every comparison is bit-exact (the
automaton is integer-deterministic). The kernel itself runs on the card
(chip_smoke.py)."""

import contextlib
import pathlib
import random
import re

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import life as jl
from gol_tpu.ops import pallas_life as jpl
from gol_tpu_torch.models.rules import Rule
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import _build, life
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops import cuda_life as cl
from gol_tpu_torch.ops.bitlife import lsr

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "gol_tpu_torch" / "csrc"

#: (height, width): the Pallas kernel's shape, a width that is not a
#: multiple of 4, a board smaller than the ghost frame, ragged last
#: tiles in both directions.
BOARDS = [(64, 128), (37, 45), (5, 7), (100, 260)]
RULES = ["B3/S23", "B36/S23"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ones(x):
    return x & 0x01010101


def dense_next(nn, mm, ss, rule):
    """The kernel's `dense_next` on int32 words of four {0,1} byte cells
    (lists [west, centre, east] of rows north, mid, south): the form the
    launcher picks for `rule`, line for line."""
    ns = nn[1] + ss[1]
    vw = nn[0] + mm[0] + ss[0]
    vc = ns + mm[1]
    ve = nn[2] + mm[2] + ss[2]
    left = (vc << 8) | lsr(vw, 24)      # __funnelshift_l(vw, vc, 8)
    right = lsr(vc, 8) | (ve << 24)     # __funnelshift_r(vc, ve, 8)
    count = left + right + ns
    birth, survive = cb.rule_bits(rule)
    if (birth, survive) == cb.rule_bits(trule("B3/S23")):
        x = (count | mm[1]) ^ 0x03030303
        return _ones(~lsr(x + 0x0F0F0F0F, 4))
    table = torch.tensor(birth | (survive << 9), dtype=torch.int64)
    at = count + mm[1] * 9
    out = torch.zeros_like(at)
    for b in range(4):
        idx = (lsr(at, 8 * b) & 0xFF).to(torch.int64)
        out |= (((table >> idx) & 1).to(torch.int32)) << (8 * b)
    return out


def step_words(w, rule):
    """One turn of the walkers on an (er, ec) int32 extended tile: every
    word's 3x3 window, wrapping within the tile."""
    rows = [torch.roll(w, 1, 0), w, torch.roll(w, -1, 0)]
    win = [[torch.roll(r, 1, 1), r, torch.roll(r, -1, 1)] for r in rows]
    return dense_next(*win, rule)


def schedule(world, n, rule, plan):
    """Kernel E's passes in plain torch: {0,255} uint8 (H, W) in, out."""
    tile_rows, tile_words, halo, ghost, turns, _, _ = plan
    h, w = world.shape
    er, eb = tile_rows + 2 * halo, 4 * (tile_words + 2 * ghost)
    cells = 4 * tile_words
    bits = life.to_bits(world)
    done = 0
    while done < n:
        t = min(turns, n - done)
        out = torch.empty_like(bits)
        for r0 in range(0, h, tile_rows):
            for c0 in range(0, 4 * (-(-w // 4)), cells):
                rr = torch.arange(r0 - halo, r0 - halo + er) % h
                cc = torch.arange(c0 - 4 * ghost, c0 - 4 * ghost + eb) % w
                tile = bits[rr][:, cc].contiguous().view(torch.int32)
                for _ in range(t):
                    tile = step_words(tile, rule)
                inner = tile.view(torch.uint8)[halo:halo + tile_rows,
                                               4 * ghost:4 * ghost + cells]
                hh, ww = min(tile_rows, h - r0), min(cells, w - c0)
                out[r0:r0 + hh, c0:c0 + ww] = inner[:hh, :ww]
        bits = out
        done += t
    return life.from_bits(bits)


def random_world(h, w, seed):
    return (np.random.default_rng(seed).random((h, w)) < 0.35).astype(
        np.uint8) * np.uint8(255)


# --- the schedule against the port's plain version and gol_tpu ---


@pytest.mark.parametrize("notation", RULES)
@pytest.mark.parametrize("height,width", BOARDS)
def test_schedule_matches_references(height, width, notation):
    """The default plan at n in {0, 1, k-1, k, k+1, 2k+1, 100}: equal to
    `life.step_n`, and to gol_tpu's `step_n_pallas` in interpret mode
    where `fits_pallas` takes the board, else gol_tpu's `step_n`."""
    world = random_world(height, width, seed=height * width)
    plan = cl._dense_plan(height, width)
    k = plan[4]
    rule = trule(notation)
    pallas = jpl.fits_pallas(height, width)
    for n in (0, 1, k - 1, k, k + 1, 2 * k + 1, 100):
        got = schedule(torch.from_numpy(world), n, rule, plan)
        np.testing.assert_array_equal(
            got.numpy(), life.step_n(torch.from_numpy(world), n, rule).numpy())
        if pallas and n in (k + 1, 100):
            want = jpl.step_n_pallas(world, n, jrule(notation), interpret=True)
        elif not pallas:
            want = jl.step_n(world, n, jrule(notation))
        else:
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [16])
@pytest.mark.parametrize("height,width", BOARDS)
def test_deeper_plans_match(height, width, depth):
    """The deeper plan on boards whose default is the shallow one (as
    `measure` times it): k-1, k and k+1 turns equal the plain
    version."""
    world = torch.from_numpy(random_world(height, width, seed=depth))
    plan = cl._dense_plan(height, width, depth)
    assert plan[4] == depth
    for n in (depth - 1, depth, depth + 1):
        np.testing.assert_array_equal(schedule(world, n, trule("B3/S23"),
                                               plan).numpy(),
                                      life.step_n(world, n).numpy())


def test_turns_past_the_light_cone_go_wrong():
    """One turn more a pass than the ghost frame buys lets the
    extended tile's wrap into the interior: the schedule sees it."""
    world = torch.from_numpy(random_world(64, 128, seed=3))
    tr, tw, halo, ghost, k, threads, seg = cl._dense_plan(64, 128)
    over = (tr, tw, halo, ghost, k + 1, threads, seg)
    assert not torch.equal(schedule(world, k + 1, trule("B3/S23"), over),
                           life.step_n(world, k + 1))


# --- the byte-SIMD step ---


def _window_of(bits):
    """The 3x3 window of every word of a {0,1} uint8 board (W % 4 ==
    0) on its torus."""
    w = bits.contiguous().view(torch.int32)
    rows = [torch.roll(w, 1, 0), w, torch.roll(w, -1, 0)]
    return [[torch.roll(r, 1, 1), r, torch.roll(r, -1, 1)] for r in rows]


@pytest.mark.parametrize("notation", RULES + ["B0/S8", "B1357/S1357"])
def test_step_mirror_equals_step_bits(notation):
    rule = trule(notation)
    bits = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2, (24, 64)).astype(np.uint8))
    got = dense_next(*_window_of(bits), rule).view(torch.uint8)
    assert torch.equal(got, life.step_bits(bits, rule))


def test_step_mirror_with_byte_3_live():
    """Words whose byte 3 is live, so the carries across words (byte 3
    of the west word's triple, shifted right by 24; byte 0 of the east
    word's, shifted left) are in play; a block of live cells puts every
    count up to 8 in play."""
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (32, 32)).astype(np.uint8)
    bits[:, 3::4] = 1
    bits[:8] = 1
    bits = torch.from_numpy(bits)
    win = _window_of(bits)
    assert (win[1][1] & 0x01000000).all()
    for notation in RULES:
        rule = trule(notation)
        got = dense_next(*win, rule).view(torch.uint8)
        assert torch.equal(got, life.step_bits(bits, rule))


def nonzero_bytes(x):
    """The kernel's load transform: 1 in each nonzero byte."""
    return _ones(lsr(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x, 7))


def to_255(x):
    """The kernel's store transform on {0,1} bytes."""
    return (x << 8) - x


def test_load_and_store_transforms():
    """On words of any bytes, {0,255} and arbitrary values with the
    sign bit set among them: the load gives [byte != 0], the store of
    that gives {0,255}."""
    rng = np.random.default_rng(10)
    raw = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    raw[rng.random((64, 64)) < 0.3] = 0
    raw[:, 3::4][rng.random((64, 16)) < 0.5] = 255
    for b in (torch.from_numpy(raw),
              torch.from_numpy(random_world(64, 64, seed=2))):
        words = b.view(torch.int32)
        assert (words < 0).any()
        got = nonzero_bytes(words)
        assert torch.equal(got.view(torch.uint8), life.to_bits(b))
        assert torch.equal(to_255(got).view(torch.uint8),
                           life.from_bits(life.to_bits(b)))


def test_random_rules_through_the_table():
    rng = random.Random(11)
    bits = torch.from_numpy(np.random.default_rng(9).integers(
        0, 2, (16, 32)).astype(np.uint8))
    for i in range(8):
        rule = Rule(name=f"random-{i}",
                    birth=frozenset(rng.sample(range(9), rng.randint(0, 4))),
                    survive=frozenset(rng.sample(range(9), rng.randint(0, 4))))
        got = dense_next(*_window_of(bits), rule).view(torch.uint8)
        assert torch.equal(got, life.step_bits(bits, rule)), rule


# --- the plan ---


def _sampled_shapes():
    rng = random.Random(5)
    shapes = [(1, 1), (1, 4096), (4096, 1), (5, 7), (512, 512),
              (512, 1024), (48, 40), (16384, 16384), (4096, 4000),
              (1023, 1021), (2**15, 2**16 - 4), (5_000_000, 4),
              (5_000_000, 3), (2**31 - 1, 1), (1, 2**31 - 1)]
    shapes += [(rng.randint(1, 5000), rng.randint(1, 5000))
               for _ in range(40)]
    return shapes


@pytest.mark.parametrize("depth", [None, 8, 16])
def test_plan_keeps_the_kernel_limits(depth):
    """Two copies of the extended tile within one block's shared memory,
    threads within the walkers' block, the light cone, a grid width CUDA
    launches (the launcher splits the rows of tiles into grids of at
    most 65,535), and tiles that cover every cell exactly once."""
    for h, w in _sampled_shapes():
        plan = cl._dense_plan(h, w, depth)
        tr, tw, halo, ghost, turns, threads, seg = plan
        er, ec = tr + 2 * halo, tw + 2 * ghost
        assert 2 * 4 * er * ec <= cb.SMEM_BYTES
        assert 32 <= threads <= cb.WALK_THREADS and threads % 32 == 0
        assert 1 <= turns <= min(halo, 4 * ghost)
        assert (threads, seg) == cb._walk_plan(
            cb.TileGeometry(tr, tw, halo, ghost))
        words = -(-w // 4)
        gy, gx = -(-h // tr), -(-words // tw)
        assert gx <= 2**31 - 1
        # Each cell in exactly one tile interior: the tiles start at
        # multiples of the tile, the last one reaching the edge.
        assert (gy - 1) * tr < h <= gy * tr
        assert (gx - 1) * tw * 4 < w <= gx * tw * 4
        assert tr <= h and tw <= words


def test_plan_seams():
    assert cl._dense_plan(512, 512) == (32, 32, 8, 2, 8, 224, 8)
    assert cl._dense_plan(16384, 16384) == (64, 128, 16, 4, 16, 544, 24)
    # Boards with more rows of tiles than one grid holds run too.
    for shape in [(512, 512), (512, 1024), (48, 40), (16384, 16384),
                  (37, 45), (5, 7), (1, 1), (2**23, 1), (5_000_000, 4),
                  (3_000_000, 8), (2**31 - 1, 1), (1, 2**31 - 1)]:
        assert cl.fits_cuda_dense(*shape)
    # Over the cell cap, and empty.
    for shape in [(65536, 65536), (0, 5), (5, 0), (2**16, 2**15 + 1),
                  (2**31, 1)]:
        assert not cl.fits_cuda_dense(*shape)
        with pytest.raises(ValueError):
            cl._dense_plan(*shape)


# --- the wrapper and the launcher ---


def _patch_launch(monkeypatch, lib):
    monkeypatch.setattr(cl, "_check_world", lambda w: None)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(cb, "_stream", lambda p: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def _code(text):
    return re.sub(r"//[^\n]*", "", text)


def test_launcher_takes_the_plan_in_order():
    """life_dense_launch's parameters: the buffers, the board, n, the
    rule's masks, then `_dense_plan`'s tuple in its order, the stream
    last; as many as `_SIGNATURES` gives ctypes."""
    src = _code((CSRC / "life.cu").read_text())
    params = re.search(r"int life_dense_launch\(([^)]*)\)", src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["in", "buf0", "buf1", "rows", "cols", "n", "birth",
                     "survive", "tile_rows", "tile_words", "halo", "ghost",
                     "turns", "threads", "seg_rows", "launched", "stream"]
    assert len(names) == len(_build._SIGNATURES["life_dense_launch"])


@pytest.mark.parametrize("height,width,n,notation", [
    (512, 512, 1, "B3/S23"),
    (512, 512, 64, "B3/S23"),
    (512, 512, 36, "B36/S23"),
    (48, 40, 100, "B3/S23"),
    (16384, 16384, 32, "B3/S23"),
    (16384, 16384, 33, "B36/S23"),
    (5_000_000, 4, 33, "B3/S23"),
])
def test_wrapper_hands_the_plan_to_the_launcher(monkeypatch, height, width,
                                                n, notation):
    """A tensor on the card (a meta tensor here, its checks skipped)
    goes to life_dense_launch once, with the plan in the C signature's
    order, two buffers apart from the input; LAUNCHES adds the launches
    the launcher reports (here as the C code issues them: ⌈n/k⌉ passes,
    each one launch a 65,535 rows of tiles)."""
    seen = []
    plan = cl._dense_plan(height, width)
    passes = -(-n // plan[4])
    issued = passes * -(-(-(-height // plan[0])) // 65_535)

    class Lib:
        def life_dense_launch(self, *args):
            seen.append(args)
            args[15]._obj.value = issued
            return 0

    _patch_launch(monkeypatch, Lib())
    monkeypatch.setitem(cl.LAUNCHES, "life_dense", 5)
    world = torch.empty((height, width), dtype=torch.uint8, device="meta")
    rule = trule(notation)
    out = cl.step_n_cuda_dense(world, n, rule)
    (args,) = seen
    assert args[3:6] == (height, width, n)
    assert args[6:8] == cb.rule_bits(rule)
    assert args[8:15] == plan
    assert args[16] == 7
    assert len(args) == len(_build._SIGNATURES["life_dense_launch"])
    assert cl.LAUNCHES["life_dense"] == 5 + issued
    assert (height > 65_535 * plan[0]) == (issued == 2 * passes)
    assert out.shape == world.shape and out.dtype == torch.uint8


def test_wrapper_counts_what_the_launcher_reports(monkeypatch):
    """A launcher that fails after some launches: LAUNCHES adds the
    launches it reports, not the plan's passes, and the wrapper
    raises."""

    class Lib:
        def life_dense_launch(self, *args):
            args[15]._obj.value = 3
            return 700

        def bitlife_error_string(self, code):
            return b"an illegal memory access was encountered"

    _patch_launch(monkeypatch, Lib())
    monkeypatch.setitem(cl.LAUNCHES, "life_dense", 0)
    world = torch.empty((512, 512), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cl.step_n_cuda_dense(world, 100)
    assert cl.LAUNCHES["life_dense"] == 3


def test_cpu_route_is_the_plain_version():
    world = torch.from_numpy(random_world(37, 45, seed=1))
    keep = world.clone()
    before = cl.LAUNCHES["life_dense"]
    got = cl.step_n_cuda_dense(world, 9, "B36/S23")
    assert torch.equal(got, life.step_n(world, 9, trule("B36/S23")))
    assert torch.equal(world, keep)
    assert cl.LAUNCHES["life_dense"] == before
