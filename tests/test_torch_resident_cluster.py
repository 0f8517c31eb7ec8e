"""Kernels A and C as one thread-block cluster of row slabs (csrc/walk.cuh
"the resident cluster", csrc/bitlife.cu, csrc/bitgens.cu) on the CPU:
the cluster's schedule — `blocks` extended slabs, each stepped on its
own torus, rounds of 32 turns, every plane's ghost rows exchanged
between rounds — written in plain torch, equals the port's plain
version and gol_tpu's Pallas kernels (interpret mode); the cluster plan
keeps the kernels' limits; the wrappers hand the plan to the launchers
in the C signatures' order. The kernels themselves run on the card
(chip_smoke.py)."""

import importlib.util
import pathlib
import random
import re

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitgens as jbg
from gol_tpu.ops import bitlife as jb
from gol_tpu.ops import life as jl
from gol_tpu.ops import pallas_bitgens as jpg
from gol_tpu.ops import pallas_bitlife as jp
from gol_tpu_torch import interop
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import _build, bitgens, bitlife
from gol_tpu_torch.ops import cuda_bitgens as cg
from gol_tpu_torch.ops import cuda_bitlife as cb

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "gol_tpu_torch" / "csrc"

RULES = ["B3/S23", "B36/S23", "B2/S/C3", "B2/S345/C4"]
TURNS = [0, 1, 31, 32, 33, 64, 100]
#: (height, width) of boards whose plans have 1, 3 and 8 blocks (the
#: last one-word-row slabs), small enough for interpret mode.
BOARDS = [(32, 64), (96, 64), (256, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _is_gens(notation):
    return notation.count("/") == 2


def _copies(notation):
    """Shared-memory copies the wrapper plans for: two ping-pong copies
    for kernel A, C for kernel C."""
    return trule(notation).states if _is_gens(notation) else 2


def board_np(notation, h, w, seed):
    """gol_tpu's packed board, or its packed planes for a B/S/C rule."""
    if _is_gens(notation):
        rule = jrule(notation)
        state = np.random.default_rng(seed).integers(0, rule.states, (h, w))
        return np.asarray(jbg.pack_states(state.astype(np.uint8), rule))
    world = jl.random_world(h, w, density=0.3, seed=seed)
    return np.asarray(jb.pack(jl.to_bits(world)))


def to_port(notation, x):
    if _is_gens(notation):
        return interop.planes_from_numpy(x)
    return interop.packed_from_numpy(x)


def plain(notation, x, n):
    """The port's plain version: `n` toroidal turns of `x`."""
    rule = trule(notation)
    if _is_gens(notation):
        return bitgens.step_n_packed_gens_raw(x, n, rule)
    return bitlife.step_n_packed_raw(x, n, rule)


def cluster_schedule(notation, x, n, planes=slice(None)):
    """What the cluster computes: the plan's extended slabs (word-rows
    [b*slab - halo, (b+1)*slab + halo) modulo the board, every column,
    every plane), each stepped by the plain version on its own torus, in
    rounds of 32*halo turns (all n in one round without a halo); between
    rounds each slab's top ghost rows take the last interior rows of
    slab b-1 and its bottom ghost rows the first of slab b+1, on every
    plane (on `planes` of a Generations stack, to show what a partial
    exchange breaks). Returns the slabs' interiors, stacked."""
    rows, cols = x.shape[-2:]
    blocks, slab, halo = cb._cluster_plan(rows, cols, _copies(notation))
    slabs = [x[..., torch.arange(b * slab - halo, (b + 1) * slab + halo)
               % rows, :] for b in range(blocks)]
    per = cb.TILE_TURNS * halo if halo else n
    done = 0
    while True:
        t = min(per, n - done)
        slabs = [plain(notation, s, t) for s in slabs]
        done += t
        if done == n:
            break
        fresh = [s.clone() for s in slabs]
        for b, s in enumerate(fresh):
            own = s[planes]  # a view: writing it writes the slab
            north = slabs[(b - 1) % blocks][planes]
            south = slabs[(b + 1) % blocks][planes]
            own[..., :halo, :] = north[..., slab:slab + halo, :]
            own[..., slab + halo:, :] = south[..., halo:2 * halo, :]
        slabs = fresh
    return torch.cat([s[..., halo:halo + slab, :] for s in slabs], dim=-2)


def _seed(notation, h, n):
    return RULES.index(notation) * 1000 + h + n


@pytest.mark.parametrize("n", TURNS)
@pytest.mark.parametrize("h,w", BOARDS)
@pytest.mark.parametrize("notation", RULES)
def test_cluster_schedule_matches_plain(notation, h, w, n):
    x = to_port(notation, board_np(notation, h, w, _seed(notation, h, n)))
    assert torch.equal(cluster_schedule(notation, x, n), plain(notation, x, n))


def _pallas(notation, x, n):
    if _is_gens(notation):
        return jpg.step_n_packed_gens_pallas_raw(x, n, jrule(notation),
                                                 interpret=True)
    return jp.step_n_packed_pallas_raw(x, n, jrule(notation), interpret=True)


#: Interpret mode compiles once per (board, turns, rule), so the 8-block
#: board (the main path's plan) takes the turns either side of each
#: exchange, the others one count each; `test_cluster_schedule_matches_plain`
#: holds the schedule to the port's plain version at every count.
PALLAS_TURNS = {256: (0, 33, 64, 100), 96: (33,), 32: (100,)}
PALLAS_CASES = [(notation, h, w, n) for notation in RULES
                for h, w in BOARDS for n in PALLAS_TURNS[h]]


@pytest.mark.parametrize("notation,h,w,n", PALLAS_CASES)
def test_cluster_schedule_matches_pallas(notation, h, w, n):
    x = board_np(notation, h, w, _seed(notation, h, n))
    got = cluster_schedule(notation, to_port(notation, x), n)
    want = np.asarray(_pallas(notation, x, n))
    if _is_gens(notation):
        np.testing.assert_array_equal(interop.planes_to_numpy(got), want)
    else:
        np.testing.assert_array_equal(interop.packed_to_numpy(got), want)


def test_exchange_of_the_alive_plane_alone_is_wrong():
    """B2/S/C3's dying plane crosses the exchange too: refreshing only
    the alive plane's ghost rows breaks the schedule after its second
    round (the walkers keep the dying plane in the alive plane's
    ping-pong partner, so the kernel exchanges both copies)."""
    notation = "B2/S/C3"
    x = to_port(notation, board_np(notation, 256, 64, 7))
    for n in (33, 64):
        want = plain(notation, x, n)
        assert torch.equal(cluster_schedule(notation, x, n), want)
        alive_only = cluster_schedule(notation, x, n, planes=slice(0, 1))
        assert torch.equal(alive_only, want) == (n == 33)


# --- the plan ---


def test_cluster_plan_at_the_main_path():
    """512² is 16 word-rows: 8 blocks of 2-row slabs, a 4 x 512-word
    extended slab, for kernel A and for kernel C at B2/S/C3 and at C=7
    (7 copies, 56 KiB a block); the walkers' plan of that slab is 512
    threads of one 4-row segment each."""
    for copies in (2, trule("B2/S/C3").states, 7):
        assert cb._cluster_plan(16, 512, copies) == (8, 2, 1)
    assert cb.TileGeometry(2, 512, 1, 0, 7).smem_bytes == 56 * 1024
    assert cb._resident_args(16, 512, 2) == (8, 2, 1, 512, 4)
    assert cg.fits_cuda_gens(512, 512, trule("B2/S/C7"))


def _sampled_boards():
    """(height, width, copies) of boards kernel A or C accepts: the test
    boards, the widest one-word-row board, boards whose row count 8 does
    not divide, a two-row board whose halo would not fit, and C = 7 at
    512²; then a sweep of row counts at the widest width that fits."""
    cases = [(h, w, 2) for h, w in BOARDS + [(512, 512), (64, 64)]]
    cases += [(32, cb.SMEM_BYTES // 8, 2), (896, 1024, 2), (352, 800, 2),
              (64, 14000, 2), (512, 512, 3), (512, 512, 4), (512, 512, 7),
              (96, 96, 5), (224, 1024, 3)]
    rng = random.Random(11)
    for rows in range(1, 41):
        copies = rng.choice([2, 3, 4, 7])
        width = cb.SMEM_BYTES // (4 * copies * rows)
        cases.append((32 * rows, rng.randint(1, width), copies))
        cases.append((32 * rows, width, copies))
    return cases


def _accepts(h, w, copies):
    if copies == 2:
        return cb.fits_cuda_packed(h, w)
    return cg.fits_cuda_gens(h, w, trule(f"B2/S/C{copies}"))


def test_cluster_plan_keeps_the_kernels_limits():
    """Every sampled board the gates accept has a plan: blocks divides
    the row count and is at most 8, halo is 0 exactly when one block
    holds the board, and `copies` copies of the extended slab fit one
    block's shared memory; blocks is the largest such divisor."""
    for h, w, copies in _sampled_boards():
        assert _accepts(h, w, copies), (h, w, copies)
        rows = h // 32
        blocks, slab, halo = cb._cluster_plan(rows, w, copies)
        assert 1 <= blocks <= cb.CLUSTER_BLOCKS and blocks * slab == rows
        assert (blocks == 1) == (halo == 0) and halo <= 1
        assert copies * 4 * (slab + 2 * halo) * w <= cb.SMEM_BYTES
        for more in range(blocks + 1, min(cb.CLUSTER_BLOCKS, rows) + 1):
            assert (rows % more
                    or copies * 4 * (rows // more + 2) * w > cb.SMEM_BYTES)


def test_cluster_plan_seams():
    assert cb._cluster_plan(1, cb.SMEM_BYTES // 8, 2) == (1, 1, 0)
    assert cb._cluster_plan(2, 14000, 2) == (1, 2, 0)  # halo would not fit
    assert cb._cluster_plan(3, 64, 2) == (3, 1, 1)
    assert cb._cluster_plan(28, 1024, 2) == (7, 4, 1)
    assert cb._cluster_plan(11, 800, 2) == (1, 11, 0)
    assert not cb.fits_cuda_packed(32, cb.SMEM_BYTES // 8 + 1)
    with pytest.raises(ValueError, match="shared memory"):
        cb._cluster_plan(1, cb.SMEM_BYTES // 8 + 1, 2)


def test_plan_constants_are_the_kernels():
    """The plan's cluster cap and round length are the kernels'."""
    src = (CSRC / "walk.cuh").read_text()
    assert f"constexpr int kClusterBlocks = {cb.CLUSTER_BLOCKS};" in src
    assert f"constexpr int kRoundTurns = {cb.TILE_TURNS};" in src


# --- the wrappers and launchers ---


@pytest.mark.parametrize("notation", RULES + ["B2/S/C7"])
def test_wrapper_hands_the_plan_to_the_launcher(monkeypatch, notation):
    """A stack on the card (kernel A's batched entry, here of one board;
    a single board takes the grid, tests/test_torch_resident_grid.py) or
    a Generations board (kernel C) goes to the resident launcher with
    the cluster plan and the slab's walk plan last, in the order and
    number of the C signature (less the stream, which `_launch` adds)."""
    seen = []
    monkeypatch.setattr(cb, "_check_cuda", lambda p, dims=2: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append((name, args)))
    rule = trule(notation)
    if _is_gens(notation):
        x = torch.empty((rule.states - 1, 16, 512), dtype=torch.int32,
                        device="meta")
        cg.step_n_packed_gens_cuda_raw(x, 100, rule)
        (name, args), = seen
        assert name == "bitgens_resident"
        assert args[2:6] == (rule.states - 1, 16, 512, 100)
        assert args[6:8] == cb.rule_bits(rule)
    else:
        x = torch.empty((1, 16, 512), dtype=torch.int32, device="meta")
        cb.step_n_packed_batch_cuda_raw(x, 100, rule)
        (name, args), = seen
        assert name == "bitlife_resident"
        assert args[2:6] == (1, 16, 512, 100)  # a batch of one board
        assert args[6:9] == cb.rule_args(rule)
    assert len(args) + 1 == len(_build._SIGNATURES[f"{name}_launch"])
    assert args[-5:] == (8, 2, 1, 512, 4)


def _code(text):
    """C++ source without comments."""
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("source,name", [
    ("bitlife.cu", "bitlife_resident_launch"),
    ("bitlife.cu", "bitlife_tiled_launch"),
    ("bitgens.cu", "bitgens_resident_launch"),
    ("bitgens.cu", "bitgens_tiled_launch"),
    ("life.cu", "life_dense_launch"),
])
def test_launcher_arity_matches_signature(source, name):
    """Each C launcher takes as many parameters as `_SIGNATURES` gives
    ctypes, pointers where it declares pointers."""
    src = _code((CSRC / source).read_text())
    params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
    assert len(params) == len(_build._SIGNATURES[name])
    for param, ctype in zip(params, _build._SIGNATURES[name]):
        assert ("*" in param) == (ctype is _build._VP), (name, param)


def _launcher(source, name):
    src = _code((CSRC / source).read_text())
    start = src.index(f"int {name}(")
    return src[start:src.index("\n}\n", start)]


def test_resident_launchers_pick_the_walker_forms_of_b_and_d():
    """Kernel A runs the walkers for B3/S23 and kernel C for B2/S/C3, by
    the same test of the rule's kernel arguments as kernels B and D."""
    life = "birth == (1u << 3) && survive == ((1u << 2) | (1u << 3))"
    brain = "planes == 2 && birth == (1u << 2) && survive == 0"
    assert life in _launcher("bitlife.cu", "bitlife_resident_launch")
    assert life in _launcher("bitlife.cu", "bitlife_tiled_launch")
    assert brain in _launcher("bitgens.cu", "bitgens_resident_launch")
    assert brain in _launcher("bitgens.cu", "bitgens_tiled_launch")
    assert cb.rule_args(trule("B3/S23"))[:2] == (1 << 3, (1 << 2) | (1 << 3))
    for name in ("bitlife_resident_launch", "bitgens_resident_launch"):
        body = _launcher(name.split("_")[0] + ".cu", name)
        assert "cluster_plan_ok(rows, blocks, slab_rows, halo)" in body
        assert "launch_cluster(" in body


def test_exchange_covers_every_copy():
    """Kernel C exchanges every shared-memory copy it holds: two for the
    B2/S/C3 walkers (the dying plane in the alive plane's partner), C for
    the masks ring; kernel A its two."""
    src = _code((CSRC / "bitgens.cu").read_text())
    body = src[src.index("bitgens_resident(const u32*"):]
    assert "cluster_turns(k, n, slab_rows, halo, 2," in body
    assert "cluster_turns(k, n, slab_rows, halo, planes + 1," in body
    src = _code((CSRC / "bitlife.cu").read_text())
    body = src[src.index("bitlife_resident(const u32*"):]
    assert "cluster_turns(k, n, slab_rows, halo, 2," in body


# --- chip_smoke.py's bound form for B2/S345/C4 ---


def test_starwars_bound_form_computes_b2_s345_c4():
    """chip_smoke.py's bound for the B2/S345/C4 rows of kernels C and D
    counts this form; it must compute B2/S345/C4."""
    rule = trule("B2/S345/C4")
    planes = to_port("B2/S345/C4", board_np("B2/S345/C4", 256, 96, 8))
    got, per_word = _smoke().starwars_fewest_instructions(planes)
    assert torch.equal(got, bitgens.step_packed_gens(planes, rule))
    assert per_word == 15
