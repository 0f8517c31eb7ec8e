"""The walk plan of kernels B and D (ops/cuda_bitlife._walk_plan) on
the CPU: the column walkers' work items, enumerated as csrc/walk.cuh
and the launchers enumerate them, cover every word of the extended
tile exactly once at every geometry the entry points build; the block
size and segment lengths keep the kernel's limits; the wrapper hands
the plan to the launcher in the C signature's order. The kernels
themselves run on the card (chip_smoke.py)."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from gol_tpu_torch.models.rules import get_rule
from gol_tpu_torch.ops import _build, bitlife, life
from gol_tpu_torch.ops import cuda_bitlife as cb

REPO = pathlib.Path(__file__).resolve().parents[1]

#: (name, geometry) of every shape class the two entry points build:
#: the 16384² main path, each strip halo depth (h = 8 is 768 columns,
#: more work items than threads), a remainder pass's shortened halo, a
#: ragged board (its last tile 160 of 256 columns) and boards narrower
#: than one tile; then kernel D's B2/S/C3 tiles, planned for three
#: copies.
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
    ("gens-main-2d", cb._tiled2d_geometry(512, 16384, None, 3)),
    ("gens-strip-h8", cb._tile_plan(128, 4096, 8, 8, 3)),
    ("gens-ragged-2d", cb._tiled2d_geometry(128, 4000, None, 3)),
    ("gens-ragged-strip", cb._tile_plan(128, 4000, None, None, 3)),
]


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


@pytest.mark.parametrize("name,geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
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
    """34 x 320 words: 320 columns x 2 segments of 17 word-rows, 640
    threads, two blocks of 87,040 bytes per SM."""
    geom = cb._tiled2d_geometry(512, 16384, None)
    assert extended(geom) == (34, 320)
    assert cb._walk_plan(geom) == (640, 17)
    assert 2 * geom.smem_bytes <= 232_448 - 2 * 1024
    assert cb._walk_plan(cb._tile_plan(512, 16384, None, None)) == (640, 17)


def test_walk_plan_more_items_than_threads():
    geom = cb._tile_plan(512, 16384, 8, 8)
    threads, seg_rows = cb._walk_plan(geom)
    er, ec = extended(geom)
    assert (er, ec) == (24, 768) and (threads, seg_rows) == (640, 24)


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
    assert args[-2:] == cb._walk_plan(geom) == (640, 17)


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
