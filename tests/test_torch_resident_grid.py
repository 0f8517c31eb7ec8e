"""Kernel A on one board as a persistent grid of small tiles
(csrc/grid.cuh, csrc/bitlife.cu `bitlife_resident_grid`) on the CPU: the
grid's schedule — every tile of `cuda_bitlife._grid_plan` loaded with one
ghost word-row and 32 ghost columns a side from the round's source board,
stepped on its own torus for a round of up to 32 turns, its interior
stored to the round's destination, the two boards ping-ponged so that
the last round writes the output — written in plain torch, equals the
port's plain version and gol_tpu's Pallas kernel (interpret mode); the
plan covers the board within the card's SMs; the wrapper hands the plan
to the launcher in the C signature's order; the cluster plan stays with
the batched entry and kernel C; kernel A's launches by plan reach the
registry. The kernel itself runs on the card (chip_smoke.py)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from gol_tpu.ops import bitlife as jb
from gol_tpu.ops import life as jl
from gol_tpu.ops import pallas_bitlife as jp
from gol_tpu_torch import interop, obs
from gol_tpu_torch.engine import distributor
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import _build, bitlife
from gol_tpu_torch.ops import cuda_bitgens as cg
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.parallel.stepper import bucket_route

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "gol_tpu_torch" / "csrc"

#: Packed shapes (word-rows, columns) the plan is held on: 512², 960²,
#: 32 word-rows x 512, 64², the 4-card ring's 12 x 512-word block, the
#: 2x2 mesh's 10 x 258-word block, and one word-row.
PLAN_SHAPES = [(16, 512), (30, 960), (32, 512), (2, 64), (12, 512),
               (10, 258), (1, 512)]
TURNS = [0, 1, 31, 32, 33, 64, 100]
RULES = ["B3/S23", "B36/S23"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def board(rows, cols, seed):
    """gol_tpu's packed soup of `rows` word-rows x `cols` columns."""
    world = jl.random_world(32 * rows, cols, density=0.3, seed=seed)
    return np.asarray(jb.pack(jl.to_bits(world)))


def plain(notation, x, n):
    return bitlife.step_n_packed_raw(x, n, trule(notation))


def grid_schedule(notation, x, n, plan):
    """What the grid computes: ⌈n / 32⌉ rounds (one for n = 0), round k
    reading the board round k - 1 wrote (the input first) and writing
    the output when the rounds left after it are even, else the scratch
    board. A round loads each tile's extended block (word-rows
    [r0 - 1, r0 + tile_rows + 1) and columns [c0 - 32, c0 + tile_cols +
    32), modulo the board), steps it on its own torus for min(32, turns
    left) turns and stores the part of its interior inside the board.
    Returns the output board."""
    rows, cols = x.shape
    rounds = max(1, -(-n // cb.TILE_TURNS))
    boards = {"out": torch.full_like(x, -1), "scratch": torch.full_like(x, -1)}
    src, done = x, 0
    for k in range(rounds):
        dst = boards["scratch" if (rounds - 1 - k) % 2 else "out"]
        assert dst is not src
        t = min(cb.TILE_TURNS, n - done)
        stored = []
        for ty in range(plan.tiles_y):
            for tx in range(plan.tiles_x):
                r0, c0 = ty * plan.tile_rows, tx * plan.tile_cols
                ri = torch.arange(r0 - 1, r0 + plan.tile_rows + 1) % rows
                ci = torch.arange(c0 - cb.GRID_GHOST,
                                  c0 + plan.tile_cols + cb.GRID_GHOST) % cols
                ext = plain(notation, src[ri][:, ci], t)
                inner = ext[1:1 + plan.tile_rows,
                            cb.GRID_GHOST:cb.GRID_GHOST + plan.tile_cols]
                h = min(plan.tile_rows, rows - r0)
                w = min(plan.tile_cols, cols - c0)
                stored.append((r0, c0, inner[:h, :w]))
        # Every tile loads before any stores: the barrier's order.
        for r0, c0, inner in stored:
            dst[r0:r0 + inner.shape[0], c0:c0 + inner.shape[1]] = inner
        done += t
        src = dst
    assert src is boards["out"]
    return boards["out"]


def _plan_cases():
    cases = []
    for shape in [(16, 512), (2, 64), (1, 512), (10, 258), (3, 100)]:
        for n in TURNS:
            cases.append((shape, None, n))
    for tile in [(1, 64), (1, 128), (2, 64)]:
        for n in (33, 64):
            cases.append(((16, 512), tile, n))
    cases.append(((5, 130), (2, 48), 65))  # ragged both ways
    return cases


@pytest.mark.parametrize("notation", RULES)
@pytest.mark.parametrize("shape,tile,n", _plan_cases())
def test_grid_schedule_matches_plain(notation, shape, tile, n):
    rows, cols = shape
    x = interop.packed_from_numpy(board(rows, cols, rows * 1000 + cols + n))
    plan = (cb._grid_plan(rows, cols) if tile is None
            else cb.GridPlan(rows, cols, *tile))
    assert torch.equal(grid_schedule(notation, x, n, plan),
                       plain(notation, x, n))


@pytest.mark.parametrize("n", [33, 100])
def test_grid_schedule_matches_pallas(n):
    x = board(2, 64, 7 + n)
    plan = cb._grid_plan(2, 64)
    got = grid_schedule("B3/S23", interop.packed_from_numpy(x), n, plan)
    want = np.asarray(jp.step_n_packed_pallas_raw(x, n, interpret=True))
    np.testing.assert_array_equal(interop.packed_to_numpy(got), want)


def test_a_round_needs_its_ghost_columns(monkeypatch):
    """The light cone is what the ghost frame buys: a quarter of the
    ghost columns breaks a full round (a disturbance of a soup spreads
    slower than a column a turn, so one column fewer may not show)."""
    rows, cols = 4, 256
    x = interop.packed_from_numpy(board(rows, cols, 3))
    plan = cb.GridPlan(rows, cols, 1, 64)
    want = plain("B3/S23", x, 32)
    assert torch.equal(grid_schedule("B3/S23", x, 32, plan), want)
    monkeypatch.setattr(cb, "GRID_GHOST", cb.GRID_GHOST // 4)
    assert not torch.equal(grid_schedule("B3/S23", x, 32, plan), want)


# --- the plan ---


@pytest.mark.parametrize("rows,cols", PLAN_SHAPES)
def test_grid_plan_covers_the_board(rows, cols):
    """The automatic plan's tiles cover the board, every word once, in
    at most SMS blocks; widths are whole 16-byte units where the board's
    width is; each tile has one ghost word-row and 32 ghost columns a
    side; no tile lies wholly outside the board."""
    plan = cb._grid_plan(rows, cols)
    assert 1 <= plan.blocks <= cb.SMS
    assert plan.tiles_y * plan.tile_rows >= rows
    assert (plan.tiles_y - 1) * plan.tile_rows < rows
    assert plan.tiles_x * plan.tile_cols >= cols
    assert (plan.tiles_x - 1) * plan.tile_cols < cols
    if cols % 4 == 0:
        assert plan.tile_cols % 4 == 0
    assert plan.ext_words == ((plan.tile_rows + 2)
                              * (plan.tile_cols + 2 * 32))
    covered = torch.zeros(rows, cols, dtype=torch.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            covered[ty * plan.tile_rows:(ty + 1) * plan.tile_rows,
                    tx * plan.tile_cols:(tx + 1) * plan.tile_cols] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("rows,cols", PLAN_SHAPES)
def test_grid_plan_takes_the_fewest_words_a_block(rows, cols):
    """No tiling the plan allows (at most SMS tiles, widths of whole
    16-byte units of at least 32 words or the whole width) steps fewer
    extended words a block."""
    plan = cb._grid_plan(rows, cols)
    unit = 4 if cols % 4 == 0 else 1
    for tr in range(1, rows + 1):
        for tc in list(range(max(unit, 32), cols, unit)) + [cols]:
            other = cb.GridPlan(rows, cols, tr, tc)
            if tc % unit == 0 and other.blocks <= cb.SMS:
                assert other.ext_words >= plan.ext_words, other


def test_grid_plan_at_the_main_path():
    """512² is 16 x 512 words: 128 tiles of 1 x 64 words, 3 x 128 = 384
    extended words a block, one thread a word; the kernel's launch count
    reads the grid's blocks."""
    plan = cb._grid_plan(16, 512)
    assert (plan.tile_rows, plan.tile_cols, plan.blocks) == (1, 64, 128)
    assert plan.ext_words == 384 <= cb.GRID_THREADS
    assert cb.kernel_plan(16, 512) == ("bitlife_resident", plan.blocks)


def test_one_word_row_wraps_onto_itself():
    """A board of one word-row takes its own row as its ghost rows."""
    plan = cb._grid_plan(1, 512)
    assert plan.tile_rows == 1 and plan.tiles_y == 1
    x = interop.packed_from_numpy(board(1, 512, 5))
    for n in (1, 32, 33):
        assert torch.equal(grid_schedule("B3/S23", x, n, plan),
                           plain("B3/S23", x, n))


def test_grid_plan_of_every_accepted_board_fits_a_block():
    """Boards kernel A accepts, sampled to the gate's edge: each plan's
    extended tile fits one block's shared memory in two copies (the
    masks form's stride), and is stepped one word a thread where it has
    at most GRID_THREADS words."""
    rng = np.random.default_rng(4)
    shapes = [(1, cb.SMEM_BYTES // 8), (cb.SMEM_BYTES // 8, 1), (907, 32),
              (11, 800)]
    for rows in rng.integers(1, 120, 20):
        shapes.append((int(rows), int(rng.integers(1, cb.SMEM_BYTES
                                                   // (8 * rows) + 1))))
    for rows, cols in shapes:
        assert cb.fits_cuda_packed(32 * rows, cols)
        plan = cb._grid_plan(rows, cols)
        assert plan.blocks <= cb.SMS
        assert 2 * 4 * plan.ext_words <= cb.SMEM_BYTES


def test_grid_constants_are_the_kernels():
    src = (CSRC / "grid.cuh").read_text()
    assert f"constexpr int kGridThreads = {cb.GRID_THREADS};" in src
    assert "constexpr int kGridGhost = kRoundTurns;" in src
    assert cb.GRID_GHOST == cb.TILE_TURNS


def test_cluster_plan_stays_with_the_batch_and_kernel_c():
    """The batched entry and kernel C keep the cluster: 8 slabs of 2
    word-rows at 512², for any number of copies; the buckets route to
    it as before."""
    for copies in (2, 3, 7):
        assert cb._cluster_plan(16, 512, copies) == (8, 2, 1)
    assert cb._resident_args(16, 512, 2) == (8, 2, 1, 512, 4)
    assert bucket_route(256, 256) == "resident"
    for source, name in (("bitlife.cu", "bitlife_resident_launch"),
                         ("bitgens.cu", "bitgens_resident_launch")):
        src = _code((CSRC / source).read_text())
        start = src.index(f"int {name}(")
        body = src[start:src.index("\n}\n", start)]
        assert "cluster_plan_ok(rows, blocks, slab_rows, halo)" in body
        assert "launch_cluster(" in body and "launch_grid(" not in body


# --- the wrapper, the launcher and the counters ---


def _capture(monkeypatch):
    seen = []
    monkeypatch.setattr(cb, "_check_cuda", lambda p, dims=2: None)

    def launch(launches, name, like, *args, entry=None):
        seen.append((name, entry, args))
    monkeypatch.setattr(cb, "_launch", launch)
    monkeypatch.setattr(cb, "RESIDENT_PLANS", {"grid": 0, "cluster": 0})
    return seen


@pytest.mark.parametrize("n,scratch", [(0, False), (32, False),
                                       (33, True), (65536, True)])
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_wrapper_hands_the_grid_plan_to_the_launcher(monkeypatch, notation,
                                                     n, scratch):
    """A single board on the card goes to `bitlife_resident_grid_launch`
    counted as `bitlife_resident`, with the buffers, the board, n, the
    rule and the tile in the C signature's order (less the stream, which
    `_launch` adds); a scratch board only when n takes more than one
    round."""
    seen = _capture(monkeypatch)
    rule = trule(notation)
    x = torch.empty((16, 512), dtype=torch.int32, device="meta")
    cb.step_n_packed_cuda_raw(x, n, rule)
    (name, entry, args), = seen
    assert (name, entry) == ("bitlife_resident", "bitlife_resident_grid")
    assert len(args) + 1 == len(_build._SIGNATURES[f"{entry}_launch"])
    assert (args[2] is not None) == scratch
    assert args[3:6] == (16, 512, n)
    assert args[6:9] == cb.rule_args(rule)
    assert args[9:] == (1, 64, 4)
    assert cb.RESIDENT_PLANS == {"grid": 1, "cluster": 0}


def test_batched_entry_counts_the_cluster(monkeypatch):
    seen = _capture(monkeypatch)
    x = torch.empty((3, 16, 512), dtype=torch.int32, device="meta")
    monkeypatch.setattr(cb, "_check_pass", lambda *a: None)
    cb.step_n_packed_batch_cuda_raw(x, 100,
                                    out=torch.empty_like(x))
    (name, entry, args), = seen
    assert (name, entry) == ("bitlife_resident", None)
    assert args[-5:] == cb._resident_args(16, 512, 2)
    assert cb.RESIDENT_PLANS == {"grid": 0, "cluster": 1}


def _code(text):
    return re.sub(r"//[^\n]*", "", text)


def test_grid_launcher_runs_cooperatively():
    """The grid's launcher takes the rule forms of kernel A, launches
    cooperatively, meets the grid's barrier between rounds, and refuses a
    multi-round launch without its scratch; its kernel names hold
    `bitlife_resident`, which the trace reader matches."""
    src = _code((CSRC / "bitlife.cu").read_text())
    start = src.index("int bitlife_resident_grid_launch(")
    body = src[start:src.index("\n}\n", start)]
    assert "birth == (1u << 3) && survive == ((1u << 2) | (1u << 3))" in body
    assert "gol::launch_grid(" in body and "scratch == nullptr" in body
    assert "if (k + 1 < rounds) cooperative_groups::this_grid().sync();" \
        in src
    assert "cudaLaunchAttributeCooperative" in _code(
        (CSRC / "grid.cuh").read_text())
    for width in cb.GRID_WIDTHS:
        assert f"bitlife_resident_grid<FORM_LIFE, {width}>" in src
    params = re.search(r"int bitlife_resident_grid_launch\(([^)]*)\)",
                       src).group(1).split(",")
    sig = _build._SIGNATURES["bitlife_resident_grid_launch"]
    assert len(params) == len(sig)
    for param, ctype in zip(params, sig):
        assert ("*" in param) == (ctype is _build._VP), param


def test_resident_plans_reach_the_registry(monkeypatch):
    monkeypatch.setitem(cb.RESIDENT_PLANS, "grid", 41)
    monkeypatch.setitem(cb.RESIDENT_PLANS, "cluster", 7)
    snap = obs.registry().snapshot()
    name = "gol_tpu_stepper_resident_plan_launches_total"
    for plan, n in (("grid", 41), ("cluster", 7)):
        entry = snap[f'{name}{{plan="{plan}"}}']
        assert entry["type"] == "counter" and entry["value"] == n
    assert [c.value for c in distributor._METRICS.resident_plans] == [41, 7]


def test_plain_version_is_untouched():
    """The CPU path of every kernel A entry is the plain step."""
    x = interop.packed_from_numpy(board(2, 64, 9))
    for n in (0, 1, 40):
        assert torch.equal(cb.step_n_packed_cuda_raw(x, n),
                           bitlife.step_n_packed_raw(x, n))
    assert cg.step_n_packed_gens_cuda_raw is not None
