"""The walk plans of kernels B and D on the CPU: their strip walkers
(ops/cuda_bitlife._strip_plan) and the column walkers of kernels A, C
and E (ops/cuda_bitlife._walk_plan), their work items enumerated as
csrc/strip.cuh, csrc/walk.cuh and the launchers enumerate them, cover
every word of the extended tile exactly once at every geometry the
entry points build; the block size and segment lengths keep the
kernels' limits; the strip layout (strip pitch, pads that nothing
writes, no wrap within the tile), emulated word for word for kernel B's
B3/S23 and kernel D's B2/S/C3, keeps a launch's interior exact; the
wrapper hands the plan to the launcher in the C signature's order. The
bulk form's load and store (csrc/strip.cuh: 16-byte row pieces),
emulated unit by unit, read and write the words the per-word load_tile
and store_interior do, aligned, at every seam block; the wrappers pick
that form only where its pieces align, and count each launch's form
once. The kernels themselves run on the card (chip_smoke.py)."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from gol_tpu_torch.models.rules import get_rule
from gol_tpu_torch.ops import _build, bitgens, bitlife, life
from gol_tpu_torch.ops import cuda_bitgens as cg
from gol_tpu_torch.ops import cuda_bitlife as cb

REPO = pathlib.Path(__file__).resolve().parents[1]

#: (name, geometry) of every shape class the two entry points build:
#: the 16384² main path, each strip halo depth (h = 8 is 768 columns), a
#: remainder pass's shortened halo, a ragged board (its last tile 160 of
#: 256 columns), boards narrower than one tile, the benchmark's 5120²
#: board and a 4096 x 131 one, whose extended width (195 columns; 643 at
#: h = 8) is no whole number of strips; then kernel D's B2/S/C3 tiles,
#: planned for three copies.
GEOMETRIES = [
    ("main-2d", cb._tiled2d_geometry(512, 16384, None)),
    *((f"strip-h{h}", cb._tile_plan(512, 16384, 8, h)) for h in range(1, 9)),
    ("strip-h3-remainder", dataclasses.replace(cb._tile_plan(512, 16384, 8, 3),
                                               halo=2)),
    ("ragged-2d", cb._tiled2d_geometry(128, 4000, None)),
    ("ragged-strip", cb._tile_plan(128, 4000, None, None)),
    ("ragged-2d-rows8", cb._tiled2d_geometry(128, 4000, 8)),
    ("narrow-2d", cb._tiled2d_geometry(16, 64, None)),
    ("narrow-strip", cb._tile_plan(24, 100, 8, 2)),
    ("short-board", cb._tiled2d_geometry(3, 300, None)),
    ("cell-5120-2d", cb._tiled2d_geometry(160, 5120, None)),
    ("padded-pitch-2d", cb._tiled2d_geometry(128, 131, None)),
    ("padded-pitch-strip", cb._tile_plan(128, 131, None, None)),
    ("padded-pitch-strip-h8", cb._tile_plan(128, 131, 8, 8)),
    ("gens-main-2d", cb._tiled2d_geometry(512, 16384, None, 3)),
    ("gens-strip-h8", cb._tile_plan(128, 4096, 8, 8, 3)),
    ("gens-ragged-2d", cb._tiled2d_geometry(128, 4000, None, 3)),
    ("gens-ragged-strip", cb._tile_plan(128, 4000, None, None, 3)),
]


#: Kernel B's geometries (two copies) and kernel D's (planned for three):
#: both walk strips; the column walkers' plan, kernels A, C and E's, is
#: held on kernel D's tiles as well.
LIFE = [g for g in GEOMETRIES if g[1].copies == 2]
GENS = [g for g in GEOMETRIES if g[1].copies != 2]


def extended(geom):
    return (geom.tile_rows + 2 * geom.halo, geom.tile_cols + 2 * geom.ghost)


def walk_cover(geom, threads, seg_rows):
    """How often each word of the extended tile is written in one turn,
    and the segment lengths, with the kernel's loop: each thread starts
    at item threadIdx.x and steps by the launcher's (dcol, drow), no
    division inside the turn."""
    er, ec = extended(geom)
    dcol, drow = threads % ec, threads // ec * seg_rows
    hits = np.zeros((er, ec), dtype=np.int64)
    lengths = set()
    for tid in range(threads):
        c, r = tid % ec, tid // ec * seg_rows
        while r < er:
            end = min(r + seg_rows, er)
            hits[r:end, c] += 1
            lengths.add(end - r)
            c += dcol
            r += drow
            if c >= ec:
                c -= ec
                r += seg_rows
    return hits, lengths


def strip_cover(geom, threads, segs):
    """How often each word of the extended tile at the strip pitch is
    written in one turn, and the segment lengths, with the strip
    walkers' loop (csrc/strip.cuh strip_turns): each thread starts at
    item threadIdx.x and steps by the launcher's (dstrip, dseg), no
    division inside the turn; segment g starts at word-row g * q +
    min(g, rem); an item writes STRIP_COLS columns of each row of its
    segment."""
    er = extended(geom)[0]
    pitch = cb._strip_pitch(geom)
    strips = pitch // cb.STRIP_COLS
    q, rem = er // segs, er % segs
    dstrip, dseg = threads % strips, threads // strips
    hits = np.zeros((er, pitch), dtype=np.int64)
    lengths = set()
    for tid in range(threads):
        s, g = tid % strips, tid // strips
        while g < segs:
            r0 = g * q + min(g, rem)
            r1 = r0 + q + (g < rem)
            hits[r0:r1, cb.STRIP_COLS * s:cb.STRIP_COLS * (s + 1)] += 1
            lengths.add(r1 - r0)
            s += dstrip
            g += dseg
            if s >= strips:
                s -= strips
                g += 1
    return hits, lengths


@pytest.mark.parametrize("name,geom", LIFE + GENS,
                         ids=[g[0] for g in LIFE + GENS])
def test_strip_plan_covers_tile_once(name, geom):
    threads, segs = cb._strip_plan(geom)
    er, ec = extended(geom)
    pitch = cb._strip_pitch(geom)
    assert pitch % cb.STRIP_COLS == 0 and ec <= pitch < ec + cb.STRIP_COLS
    assert threads % 32 == 0 and 32 <= threads <= cb.STRIP_THREADS
    hits, lengths = strip_cover(geom, threads, segs)
    assert (hits == 1).all(), name
    # Whole strips, or segments of at least MIN_STRIP_ROWS word-rows,
    # their lengths within one row of each other.
    assert lengths == {er} or min(lengths) >= cb.MIN_STRIP_ROWS
    assert max(lengths) - min(lengths) <= 1
    # Never a whole warp of idle threads.
    items = pitch // cb.STRIP_COLS * segs
    assert threads - items < 32 or items > cb.STRIP_THREADS
    # The layout of two copies and three pads fits one block, within
    # what the plan that chose the tile counted.
    assert cb._strip_smem_bytes(geom) <= cb._smem_need(geom) <= cb.SMEM_BYTES


@pytest.mark.parametrize("threads", [32, 96, 160])
def test_strip_walkers_stride_over_more_items_than_threads(threads):
    """The strip walkers' stride, forced below the item count (deepest
    halo, 192 strips x 3 segments), still writes each word once."""
    geom = cb._tile_plan(512, 16384, 8, 8)
    _, segs = cb._strip_plan(geom)
    hits, _ = strip_cover(geom, threads, segs)
    assert (hits == 1).all()


@pytest.mark.parametrize("name,geom", GENS, ids=[g[0] for g in GENS])
def test_walk_plan_covers_tile_once(name, geom):
    threads, seg_rows = cb._walk_plan(geom)
    er, ec = extended(geom)
    assert threads % 32 == 0 and 32 <= threads <= cb.WALK_THREADS
    hits, lengths = walk_cover(geom, threads, seg_rows)
    assert (hits == 1).all(), name
    # Whole columns, or segments of at least MIN_SEG_ROWS word-rows.
    assert lengths == {er} or min(lengths) >= cb.MIN_SEG_ROWS
    # Never a whole warp of idle threads.
    items = ec * -(-er // seg_rows)
    assert threads - items < 32 or items > cb.WALK_THREADS


def test_walk_plan_main_geometry():
    """34 x 320 words at 16384² and 5120²: the strip walkers of kernels
    B and D take 80 strips x 8 segments (2 of 5 word-rows, 6 of 4), 640
    threads, two blocks of 90,928 bytes per SM (two copies of 34 x 320
    words and three pads of 324); kernel D's tile, planned for three
    copies (130,560 bytes), is the same tile; the column walkers' plan of
    the same tile is 320 columns x 2 segments of 17 word-rows, 640
    threads."""
    for rows, width in ((512, 16384), (160, 5120)):
        geom = cb._tiled2d_geometry(rows, width, None)
        assert extended(geom) == (34, 320)
        assert cb._strip_plan(geom) == (640, 8)
        assert strip_cover(geom, 640, 8)[1] == {4, 5}
        assert cb._strip_smem_bytes(geom) == 4 * (2 * 34 * 320 + 3 * 324)
        assert 2 * cb._strip_smem_bytes(geom) <= 232_448 - 2 * 1024
        assert cb._walk_plan(geom) == (640, 17)
        gens = cb._tiled2d_geometry(rows, width, None, 3)
        assert dataclasses.replace(gens, copies=2) == geom
        assert cb._smem_need(gens) == 3 * 4 * 34 * 320
        assert cb._strip_plan(gens) == (640, 8)
    assert cb._strip_plan(cb._tile_plan(512, 16384, None, None)) == (640, 8)


def test_walk_plan_more_items_than_threads():
    """The deepest halo's 24 x 768 words: the column walkers have more
    items than threads; the strip walkers' 192 strips x 3 segments of 8
    word-rows fill 576 threads."""
    geom = cb._tile_plan(512, 16384, 8, 8)
    er, ec = extended(geom)
    assert (er, ec) == (24, 768)
    assert cb._walk_plan(dataclasses.replace(geom, copies=3)) == (640, 24)
    assert cb._strip_plan(geom) == (576, 3)


def test_strip_pitch_pads_to_whole_strips():
    """4096 x 131: 195 extended columns a row, padded to 196 (49
    strips); the 2-D entry keeps its 131-column tile."""
    geom = cb._tiled2d_geometry(128, 131, None)
    assert extended(geom) == (34, 195) and geom.tile_cols == 131
    assert cb._strip_pitch(geom) == 196
    assert cb._strip_plan(geom) == (416, 8)


def sums_of_window(win, pitch):
    """(z0, c0, a, w4) of the nine-cell sums of the words `win(0, dc)`
    for dc = 0 — `win(dr, dc)` the words dr rows and dc words away in
    memory — in csrc/swar.cuh's form: each column's (sum, carry), then
    sum9 = z0 + 2 (c0 + a) + 4 w4 (bit 3, a sum of 8 or 9, not formed)."""
    def col_sum(dc):
        n, m, s = win(-pitch, dc), win(0, dc), win(pitch, dc)
        up = (m << np.uint32(1)) | (n >> np.uint32(31))
        down = (m >> np.uint32(1)) | (s << np.uint32(31))
        return up ^ m ^ down, (up & m) | (up & down) | (m & down)

    (ws, wc), (xs, xc), (es, ec) = col_sum(-1), col_sum(0), col_sum(1)
    z0 = ws ^ xs ^ es
    c0 = (ws & xs) | (ws & es) | (xs & es)
    a = wc ^ xc ^ ec
    w4 = (wc & xc) | (wc & ec) | (xc & ec)
    return z0, c0, a, w4


def life_of_window(win, pitch):
    """Next B3/S23 words of `win`, as csrc/strip.cuh life_of_sums."""
    z0, c0, a, w4 = sums_of_window(win, pitch)
    b1 = a ^ c0
    b2 = w4 ^ (a & c0)
    g = (z0 & b1 & ~b2) | (~z0 & ~b1 & b2)
    return g & (win(0, 0) | z0)


def brain_of_window(win, pitch, dying):
    """Next B2/S/C3 alive words of `win` given their dying words, as
    csrc/strip.cuh brain_of_sums: [sum9 == 2] on a dead cell."""
    z0, c0, a, w4 = sums_of_window(win, pitch)
    return (c0 ^ a) & ~w4 & ~z0 & ~win(0, 0) & ~dying


def strip_launch(p, geom, n, seed, brain=False):
    """One launch of a strip walkers' form on the CPU in its shared-
    memory layout (csrc/strip.cuh): kernel B's B3/S23 on a packed board,
    or (`brain`) kernel D's B2/S/C3 on a stack of (alive, dying) planes.
    For each tile, random words in the pads (and, for B3/S23, the second
    copy), the extended tile of plane q loaded into copy q at the strip
    pitch (toroidal indices modulo the board), n turns in which every
    word of the copy at word `cur` is stepped from the 3 x 3 words around
    it in memory — no wrap within the tile, pads and the neighbouring
    rows read as they are; B2/S/C3 also reads the word it overwrites as
    its dying word — into the other copy, then the interior of the copy
    turn n wrote (and, for B2/S/C3, of the other, the dying plane) stored
    where it lies on the board."""
    rng = np.random.default_rng(seed)
    planes = p.numpy().view(np.uint32)
    if not brain:
        planes = planes[None]
    _, rows, cols = planes.shape
    er = geom.tile_rows + 2 * geom.halo
    pitch = cb._strip_pitch(geom)
    words, pad = er * pitch, pitch + cb.STRIP_COLS
    out = np.zeros_like(planes)
    at = np.arange(words)
    # A copy's reads stay within its own pads, away from the other copy.
    assert -pad <= -pitch - 1 and words + pitch + 1 <= words + pad
    copies = (pad, 2 * pad + words)
    for r0 in range(0, rows, geom.tile_rows):
        for c0 in range(0, cols, geom.tile_cols):
            mem = rng.integers(0, 2**32, 2 * words + 3 * pad,
                               dtype=np.uint32)
            assert mem.size * 4 == cb._strip_smem_bytes(geom)
            tr = (r0 - geom.halo + np.arange(er)) % rows
            tc = (c0 - geom.ghost + np.arange(pitch)) % cols
            for q, plane in enumerate(planes):
                mem[copies[q]:copies[q] + words] = plane[np.ix_(tr, tc)].ravel()
            cur, nxt = copies
            for _ in range(n):
                def win(dr, dc):
                    return mem[cur + at + dr + dc]

                mem[nxt + at] = (brain_of_window(win, pitch, mem[nxt + at])
                                 if brain else life_of_window(win, pitch))
                cur, nxt = nxt, cur
            h = min(geom.tile_rows, rows - r0)
            w = min(geom.tile_cols, cols - c0)
            for q, copy in enumerate((cur, nxt)[:len(planes)]):
                tile = mem[copy:copy + words].reshape(er, pitch)
                out[q, r0:r0 + h, c0:c0 + w] = tile[
                    geom.halo:geom.halo + h, geom.ghost:geom.ghost + w]
    return torch.from_numpy(out.view(np.int32) if brain
                            else out[0].view(np.int32))


#: (name, packed rows, width, geometry) of the emulated launches: a
#: pitch padded by 3 columns, ragged tiles in both directions, tiles
#: wider than the board, a deep halo.
STRIP_LAUNCHES = [
    ("padded-pitch", 8, 13, cb._tiled2d_geometry(8, 13, None)),
    ("ragged", 36, 300, cb._tiled2d_geometry(36, 300, None)),
    ("strip-h2", 16, 40, cb._tile_plan(16, 40, 8, 2)),
]


@pytest.mark.parametrize("turns", ["one", "cone"])
@pytest.mark.parametrize("name,rows,width,geom", STRIP_LAUNCHES,
                         ids=[x[0] for x in STRIP_LAUNCHES])
def test_strip_layout_keeps_the_interior_exact(name, rows, width, geom,
                                               turns):
    """Garbage in the pads, the second copy and the unwrapped edges
    never reaches a launch's interior within its light cone: the
    emulated launch equals the plain packed step, after one turn and
    after the whole cone (`geom.turns`)."""
    n = 1 if turns == "one" else geom.turns
    gen = torch.Generator().manual_seed(rows * width)
    p = torch.randint(-2**31, 2**31 - 1, (rows, width), dtype=torch.int32,
                      generator=gen)
    want = bitlife.step_n_packed_raw(p, n, get_rule("B3/S23"))
    assert torch.equal(strip_launch(p, geom, n, seed=n), want)


#: Kernel D's launches of the same shapes: its B2/S/C3 tiles are planned
#: for three copies.
BRAIN_LAUNCHES = [
    (name, rows, width, cb._tile_plan(rows, width, 8, 2, 3)
     if name == "strip-h2" else cb._tiled2d_geometry(rows, width, None, 3))
    for name, rows, width, _ in STRIP_LAUNCHES
]


@pytest.mark.parametrize("turns", ["one", "cone"])
@pytest.mark.parametrize("name,rows,width,geom", BRAIN_LAUNCHES,
                         ids=[x[0] for x in BRAIN_LAUNCHES])
def test_brain_strip_layout_keeps_the_interior_exact(name, rows, width,
                                                     geom, turns):
    """Kernel D's B2/S/C3 form in the strip layout: the alive plane in
    copy 0, the dying plane in copy 1, each word's dying word read from
    the copy its step overwrites; garbage in the pads and the unwrapped
    edges never reaches the interior of either plane within the light
    cone, after one turn and after the whole cone."""
    n = 1 if turns == "one" else geom.turns
    assert geom.copies == 3
    gen = torch.Generator().manual_seed(rows * width + 1)
    states = torch.randint(0, 3, (rows * 32, width), generator=gen)
    p = torch.stack([bitlife.pack(states == s) for s in (1, 2)])
    want = bitgens.step_n_packed_gens_raw(p, n, get_rule("B2/S/C3"))
    assert torch.equal(strip_launch(p, geom, n, seed=n, brain=True), want)


def test_tiled_pass_hands_the_plan_to_the_launcher(monkeypatch):
    """A tensor on the card goes to `bitlife_tiled_launch` with the walk
    plan last, in the order and number of the C signature (less the
    stream, which `_launch` adds)."""
    seen = []
    monkeypatch.setattr(cb, "_check_pass", lambda src, dst, check: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append((name, args)))
    src = torch.empty((512, 16384), dtype=torch.int32, device="meta")
    geom = cb._tiled2d_geometry(512, 16384, None)
    cb._tiled_pass(src, torch.empty_like(src), 32, get_rule("B36/S23"), geom)
    (name, args), = seen
    assert name == "bitlife_tiled"
    assert len(args) + 1 == len(_build._SIGNATURES["bitlife_tiled_launch"])
    assert args[2:9] == (512, 16384, 32, 256, 1, 32, 32)
    assert args[-2:] == cb._strip_plan(geom) == (640, 8)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_highlife_bound_form_computes_b36_s23():
    """chip_smoke.py's bound for kernel B's run-time-mask instantiation
    (timed on B36/S23) counts this form; it must compute B36/S23."""
    world = torch.from_numpy(life.random_world(256, 96, seed=7))
    p = bitlife.pack(life.to_bits(world))
    got, per_word = _smoke().highlife_fewest_instructions(p)
    assert torch.equal(got, bitlife.step_packed(p, get_rule("B36/S23")))
    assert per_word == 12


def test_kernel_resources_reads_ptxas_log():
    """The build phase's register line for kernel B's instantiations."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4_GLOBAL__N_113bitlife_tiledILi0EEEvPKjPj' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_1",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN4_GLOBAL__N_116bitlife_residentEPKjPj' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 37 registers, used 1 barriers",
    ])
    assert _smoke().kernel_resources(log, "bitlife_tiled") == {
        "bitlife_tiledILi0E":
            "32 registers, 0 bytes spill stores, 0 bytes spill loads"}


def test_walk_threads_is_the_kernels_launch_bound():
    """`_walk_plan` plans within WALK_THREADS; the kernels' walkers are
    built for at most kWalkThreads a block and the launchers refuse more,
    so the two constants must be one number."""
    src = (REPO / "gol_tpu_torch/csrc/walk.cuh").read_text()
    assert f"constexpr int kWalkThreads = {cb.WALK_THREADS};" in src


def test_strip_constants_are_the_kernels():
    """`_strip_plan` plans within STRIP_THREADS and pads to STRIP_COLS;
    kernel B's strip walkers are built for kStripThreads a block and
    kStripCols columns a strip, and its launcher refuses more threads."""
    src = (REPO / "gol_tpu_torch/csrc/strip.cuh").read_text()
    assert f"constexpr int kStripThreads = {cb.STRIP_THREADS};" in src
    assert f"constexpr int kStripCols = {cb.STRIP_COLS};" in src


#: (name, packed rows, width, geometry) of the shapes whose tiles kernels
#: B and D move in the bulk form (16-byte row pieces, csrc/strip.cuh):
#: the 2-D entry at 5120², 16384² and 4096², the strip entry's halo
#: depths, a ring's ghost-extended block of 132 x 16384 words (its last
#: tile 4 of 32 word-rows), a board whose last tile is 160 of 256
#: columns, and kernel D's tiles planned for three copies.
BULK_SHAPES = [
    ("cell-5120-2d", 160, 5120, cb._tiled2d_geometry(160, 5120, None)),
    ("main-2d", 512, 16384, cb._tiled2d_geometry(512, 16384, None)),
    ("square-4096-2d", 128, 4096, cb._tiled2d_geometry(128, 4096, None)),
    *((f"strip-h{h}", 512, 16384, cb._tile_plan(512, 16384, 8, h))
      for h in (1, 2, 8)),
    ("ring-block-2d", 132, 16384, cb._tiled2d_geometry(132, 16384, None)),
    ("ragged-2d", 128, 4000, cb._tiled2d_geometry(128, 4000, None)),
    ("ragged-strip-h8", 128, 4000, cb._tile_plan(128, 4000, 8, 8)),
    ("gens-cell-5120-2d", 160, 5120,
     cb._tiled2d_geometry(160, 5120, None, 3)),
    ("gens-ring-block-2d", 132, 16384,
     cb._tiled2d_geometry(132, 16384, None, 3)),
]


def edge_blocks(rows, cols, geom):
    """The blocks (bx, by) of a grid over the board at its seams: the
    first two and the last of each axis (the last tile ragged where the
    board is), every pairing of them."""
    nx = -(-cols // geom.tile_cols)
    ny = -(-rows // geom.tile_rows)
    return [(bx, by) for bx in sorted({0, 1, nx - 1} & set(range(nx)))
            for by in sorted({0, 1, ny - 1} & set(range(ny)))]


def bulk_load(geom, rows, cols, bx, by, planes):
    """{(shared word, (plane, board word))} of one block's load in the
    bulk form, with csrc/strip.cuh bulk_load_tile's arithmetic: each
    warp a row, its first board column wrapped once a block and the row
    once, the row's words before the board's east edge the first piece
    and the rest from column 0; each lane a 16-byte unit of the row,
    asserted aligned in both memories and within one piece; and the
    pieces a row."""
    er = geom.tile_rows + 2 * geom.halo
    pitch = cb._strip_pitch(geom)
    words, pad = er * pitch, pitch + cb.STRIP_COLS
    r0 = by * geom.tile_rows - geom.halo
    c = (bx * geom.tile_cols - geom.ghost) % cols
    first = min(pitch, cols - c)
    assert first % cb.BULK_WORDS == 0 and pitch - first < pitch
    got = {}
    for q in range(planes):
        for tr in range(er):
            row = (q * rows + (r0 + tr) % rows) * cols
            east = row + c
            to = pad + q * (words + pad) + tr * pitch
            for j in range(0, pitch, cb.BULK_WORDS):
                src = east + j if j < first else row + (j - first)
                assert src % cb.BULK_WORDS == (to + j) % cb.BULK_WORDS == 0
                # A unit never straddles the board's east edge.
                assert j + cb.BULK_WORDS <= first or j >= first
                for u in range(cb.BULK_WORDS):
                    got[to + j + u] = divmod(src + u, rows * cols)
    return got


def word_load(geom, rows, cols, bx, by, planes):
    """The same map for walk.cuh load_tile (word i of copy q from board
    row r0 - halo + i / pitch and column c0 - ghost + i % pitch, each
    modulo the board), the form the bulk form replaces."""
    er = geom.tile_rows + 2 * geom.halo
    pitch = cb._strip_pitch(geom)
    words, pad = er * pitch, pitch + cb.STRIP_COLS
    got = {}
    for q in range(planes):
        for i in range(words):
            tr, tc = divmod(i, pitch)
            gr = (by * geom.tile_rows - geom.halo + tr) % rows
            gc = (bx * geom.tile_cols - geom.ghost + tc) % cols
            got[pad + q * (words + pad) + i] = (q, gr * cols + gc)
    return got


@pytest.mark.parametrize("name,rows,cols,geom", BULK_SHAPES,
                         ids=[s[0] for s in BULK_SHAPES])
def test_bulk_pieces_load_the_words_load_tile_reads(name, rows, cols, geom):
    """The bulk form's row pieces (emulated unit by unit) fill every word
    of the extended tile, the pitch's padding columns included, from the
    board word walk.cuh's load_tile reads there, in every copy a plane
    loads, at every seam block; every unit is 16-byte aligned in both
    memories, and a row is at most two pieces."""
    planes = 2 if geom.copies == 3 else 1
    assert cb._strip_pitch(geom) <= cols
    for bx, by in edge_blocks(rows, cols, geom):
        assert (bulk_load(geom, rows, cols, bx, by, planes)
                == word_load(geom, rows, cols, bx, by, planes)), (bx, by)


@pytest.mark.parametrize("name,rows,cols,geom", BULK_SHAPES,
                         ids=[s[0] for s in BULK_SHAPES])
def test_bulk_store_writes_each_interior_word_once(name, rows, cols, geom):
    """The bulk form's store (csrc/strip.cuh bulk_store_interior: each
    warp an interior row, clipped to the board at a ragged last tile,
    each lane a 16-byte unit) writes every board word exactly once over
    the whole grid, from the word walk.cuh's store_interior reads, each
    unit 16-byte aligned in both memories."""
    er = geom.tile_rows + 2 * geom.halo
    pitch = cb._strip_pitch(geom)
    pad = pitch + cb.STRIP_COLS
    hits = np.zeros(rows * cols, dtype=np.int64)
    for by in range(-(-rows // geom.tile_rows)):
        for bx in range(-(-cols // geom.tile_cols)):
            r0, c0 = by * geom.tile_rows, bx * geom.tile_cols
            words = min(geom.tile_cols, cols - c0)
            assert words % cb.BULK_WORDS == 0
            for tr in range(min(geom.tile_rows, rows - r0)):
                frm = pad + (geom.halo + tr) * pitch + geom.ghost
                to = (r0 + tr) * cols + c0
                assert frm % cb.BULK_WORDS == 0 and to % cb.BULK_WORDS == 0
                assert frm + words <= pad + er * pitch
                hits[to:to + words] += 1
    assert (hits == 1).all()


def offset_board(rows, cols, offset_words):
    """A contiguous CPU board whose storage starts `offset_words` words
    into its buffer."""
    flat = torch.zeros(rows * cols + offset_words, dtype=torch.int32)
    return flat[offset_words:].view(rows, cols)


@pytest.mark.parametrize("name,rows,cols,geom", BULK_SHAPES,
                         ids=[s[0] for s in BULK_SHAPES])
def test_tile_form_bulk_where_the_pieces_align(name, rows, cols, geom):
    """Every shape above, in buffers 16-byte aligned, takes the bulk form
    for the rules the strip walkers run, and the words form for the
    others."""
    src = offset_board(rows, cols, 0)
    dst = offset_board(rows, cols, cb.BULK_WORDS)
    assert src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
    assert cb._tile_form(src, dst, geom, True) == "bulk"
    assert cb._tile_form(src, dst, geom, False) == "words"


#: (name, packed rows, width, geometry, offset of the input in words) of
#: shapes the bulk form does not take: a width of no whole 16 bytes (the
#: 4096 x 131 board, a 2x2 mesh's block of 258 words), ghost columns of
#: no whole 16 bytes, a pitch wider than the board (three pieces a row),
#: and an input whose storage starts one word past 16-byte alignment.
WORD_SHAPES = [
    ("width-131", 128, 131, cb._tiled2d_geometry(128, 131, None), 0),
    ("width-131-strip-h8", 128, 131, cb._tile_plan(128, 131, 8, 8), 0),
    ("mesh-block-258", 10, 258, cb._tiled2d_geometry(10, 258, None), 0),
    ("ghost-34", 160, 5120,
     dataclasses.replace(cb._tiled2d_geometry(160, 5120, None), ghost=34),
     0),
    ("pitch-wider-than-board", 16, 64, cb._tiled2d_geometry(16, 64, None),
     0),
    ("offset-input", 160, 5120, cb._tiled2d_geometry(160, 5120, None), 1),
]


@pytest.mark.parametrize("name,rows,cols,geom,offset", WORD_SHAPES,
                         ids=[s[0] for s in WORD_SHAPES])
def test_tile_form_words_where_a_piece_would_not_align(name, rows, cols,
                                                       geom, offset):
    src = offset_board(rows, cols, offset)
    assert cb._tile_form(src, offset_board(rows, cols, 0), geom,
                         True) == "words"
    # The output's alignment counts as much as the input's.
    if offset:
        assert cb._tile_form(offset_board(rows, cols, 0), src, geom,
                             True) == "words"


@pytest.mark.parametrize("notation,form", [
    ("B3/S23", "bulk"), ("B36/S23", "words"),
    ("B2/S/C3", "bulk"), ("B2/S345/C4", "words")])
def test_tile_loads_counts_each_launch_once(monkeypatch, notation, form):
    """Each launch of kernel B (B/S rules) or D (B/S/C rules) adds one to
    its wrapper's TILE_LOADS under the form the pass picked, and hands
    the launcher its flag (1 for the bulk form) before the strip plan:
    two of each for a 64-turn run of the 2-D entry at 5120²."""
    rule = get_rule(notation)
    gens = hasattr(rule, "states")
    mod = cg if gens else cb
    seen = []
    monkeypatch.setattr(cb, "_check_pass", lambda src, dst, check: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append(args))
    monkeypatch.setattr(mod, "TILE_LOADS", {"bulk": 0, "words": 0})
    shape = ((rule.states - 1,) if gens else ()) + (160, 5120)
    src = torch.empty(shape, dtype=torch.int32, device="meta")
    if gens:
        cg.step_n_packed_gens_tiled2d_raw(src, 64, rule)
    else:
        cb.step_n_packed_tiled2d_raw(src, 64, rule)
    assert mod.TILE_LOADS == {form: 2,
                              ({"bulk", "words"} - {form}).pop(): 0}
    assert [args[-3] for args in seen] == [int(form == "bulk")] * 2
