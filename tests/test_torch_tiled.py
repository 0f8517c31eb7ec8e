"""The activity-driven tiled stepper of the port (gol_tpu_torch/parallel/
tiled.py) against gol_tpu's (gol_tpu/parallel/tiled.py), on the CPU.

Every case of tests/test_tiled.py runs through both packages on the same
numpy input, with the runtime invariants on in both: the host universes'
words, the alive counts, the per-turn XOR stacks, the event streams and
the activity accounting (tile steps, rides and skips per chunk) are
bit-identical. Also: the batched plain step against `jax.vmap` of
gol_tpu's packed step, the batched kernel-A entry's plans and launch
arguments, the TopKGauge exposition, the capacity arithmetic, and the
CLI's `--tile`. Exact comparisons throughout: the automaton is
integer-deterministic. On the CPU the slab is stepped by the batched
plain step; the kernels themselves run on the card (chip_smoke.py).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu import obs as jobs
from gol_tpu.engine import distributor as jd
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.obs import device as jdev
from gol_tpu.ops import bitlife as jb
from gol_tpu.parallel import tiled as jt
from gol_tpu.parallel.stepper import make_stepper as jmake
from gol_tpu_torch import obs as tobs
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.obs import device as tdev
from gol_tpu_torch.ops import bitlife as tb
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.parallel import tiled as tt
from gol_tpu_torch.parallel.stepper import make_stepper as tmake

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _invariants_on(monkeypatch):
    """Both packages' runtime invariant checkers on (the same variable),
    and neither may count a violation."""
    monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
    from gol_tpu.analysis.invariants import violations_total as jv
    from gol_tpu_torch.analysis.invariants import violations_total as tv

    before = (jv(), tv())
    yield
    assert (jv(), tv()) == before, "an invariant violation was counted"


def _soup(seed: int, h: int, w: int, density: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < density) * 255).astype(np.uint8)


def _pair(h, w, tile, **kw):
    """(gol_tpu's, the port's) tiled steppers of one geometry."""
    if kw:
        return (jt.tiled_stepper("B3/S23", h, w, tile, **kw),
                tt.tiled_stepper("B3/S23", h, w, tile, device="cpu", **kw))
    return (jmake(threads=1, height=h, width=w, tile=tile),
            tmake(height=h, width=w, tile=tile, device="cpu"))


def _oracle(board: np.ndarray, turns: int) -> tuple:
    """gol_tpu's dense packed stepper: (board, count) after `turns`."""
    h, w = board.shape
    d = jmake(threads=1, height=h, width=w, backend="packed")
    world, count = d.step_n(d.put(board), turns)
    return d.fetch(world), int(count)


_ACTIVITY = ("tile_steps", "tile_rides", "tile_skips", "dispatches")


def _activity(mod) -> dict:
    m = mod._METRICS
    out = {k: getattr(m, k).value for k in _ACTIVITY}
    out["active"] = m.active.value
    out["paged_out"] = m.paged["out"].value
    return out


def _moved(mod, before) -> dict:
    now = _activity(mod)
    return {k: now[k] - (0 if k == "active" else before[k]) for k in now}


def _step_both(j, t, jw, tw, k, diffs=False):
    """One step_n (or step_n_with_diffs) of k turns through both
    packages; asserts equal words, counts and activity, and returns the
    new worlds (and the port's diff stack, with `diffs`)."""
    jb0, tb0 = _activity(jt), _activity(tt)
    td_ = None
    if diffs:
        jw, jd_, jc = j.step_n_with_diffs(jw, k)
        tw, td_, tc = t.step_n_with_diffs(tw, k)
        assert np.array_equal(np.asarray(jd_), td_)
        assert td_.dtype == np.uint32
    else:
        jw, jc = j.step_n(jw, k)
        tw, tc = t.step_n(tw, k)
    assert int(jc) == int(tc)
    assert np.array_equal(jw.words, tw.words)
    assert np.array_equal(jw.tile_alive, tw.tile_alive)
    assert np.array_equal(jw.changed, tw.changed)
    assert _moved(jt, jb0) == _moved(tt, tb0), "activity accounting differs"
    return (jw, tw, td_) if diffs else (jw, tw)


PULSAR = [
    (0, 2), (0, 3), (0, 4), (0, 8), (0, 9), (0, 10),
    (2, 0), (2, 5), (2, 7), (2, 12), (3, 0), (3, 5), (3, 7), (3, 12),
    (4, 0), (4, 5), (4, 7), (4, 12),
    (5, 2), (5, 3), (5, 4), (5, 8), (5, 9), (5, 10),
    (7, 2), (7, 3), (7, 4), (7, 8), (7, 9), (7, 10),
    (8, 0), (8, 5), (8, 7), (8, 12), (9, 0), (9, 5), (9, 7), (9, 12),
    (10, 0), (10, 5), (10, 7), (10, 12),
    (12, 2), (12, 3), (12, 4), (12, 8), (12, 9), (12, 10),
]


def _stamp(board: np.ndarray, cells, at) -> None:
    r0, c0 = at
    h, w = board.shape
    for r, c in cells:
        board[(r0 + r) % h, (c0 + c) % w] = 255


# --- the stepper against gol_tpu's ---


def test_full_soup_matches_through_mixed_chunks():
    """Mixed chunk sizes (the (mode, k) reactivation rule): words,
    counts, flags and per-chunk activity equal gol_tpu's after every
    call, and the end state equals the dense oracle."""
    h = w = 128
    board = _soup(1, h, w)
    j, t = _pair(h, w, 64)
    assert t.name == j.name == "checked-tiled-64" and t.tiled is not None
    assert t.capabilities() == j.capabilities()
    jw, tw = j.put(board), t.put(board)
    assert tw.words.dtype == np.uint32
    assert np.array_equal(jw.words, tw.words)
    total = 0
    for k in (1, 3, 32, 5, 64, 2, 32):
        jw, tw = _step_both(j, t, jw, tw, k)
        total += k
    want, want_count = _oracle(board, total)
    assert tw.alive == want_count
    assert np.array_equal(t.fetch(tw), want)


@pytest.mark.parametrize("at", [
    (0, 0),          # grid origin
    (62, 62),        # straddles the first tile corner (tile=64)
    (63, 64),        # astride a vertical tile seam
    (64, 63),        # astride a horizontal tile seam
    (126, 126),      # straddles the torus wrap corner
    (30, 126),       # wrap seam, row interior
])
def test_soup_across_tile_corners_and_edges(at):
    h = w = 128
    board = np.zeros((h, w), np.uint8)
    r0, c0 = at
    patch = _soup(at[0] * 131 + at[1], 8, 8, 0.5)
    for r in range(8):
        for c in range(8):
            if patch[r, c]:
                board[(r0 + r) % h, (c0 + c) % w] = 255
    j, t = _pair(h, w, 64)
    jw, tw = _step_both(j, t, j.put(board), t.put(board), 96)
    want, want_count = _oracle(board, 96)
    assert tw.alive == want_count
    assert np.array_equal(t.fetch(tw), want)


def test_per_turn_diff_stack_matches():
    """step_n_with_diffs emits gol_tpu's uint32 (k, H/32, W) XOR stack,
    per turn, across fused <-> diffs mode switches; the port's dense
    packed stepper's stack is the same words."""
    h = w = 128
    board = _soup(2, h, w, 0.25)
    j, t = _pair(h, w, 64)
    d = tmake(height=h, width=w, backend="packed", device="cpu")
    jw, tw, dw = j.put(board), t.put(board), d.put(board)
    jw, tw = _step_both(j, t, jw, tw, 32)
    dw, _ = d.step_n(dw, 32)
    for k in (7, 1, 16):
        jw, tw, td_ = _step_both(j, t, jw, tw, k, diffs=True)
        dw, dd, dc = d.step_n_with_diffs(dw, k)
        assert int(dc) == tw.alive
        assert np.array_equal(dd.numpy().view(np.uint32), td_)
    jw, tw = _step_both(j, t, jw, tw, 48)
    assert np.array_equal(t.fetch(tw), d.fetch(d.step_n(dw, 48)[0]))


@pytest.mark.parametrize("max_resident", [1, 3])
def test_paging_sub_batches_stay_exact(max_resident):
    """An active set larger than the residency bound pages through in
    several slabs, all gathered from chunk-start state."""
    h = w = 128
    board = _soup(3, h, w, 0.35)
    j, t = _pair(h, w, 32, max_resident=max_resident)
    jw, tw = _step_both(j, t, j.put(board), t.put(board), 70)
    want, want_count = _oracle(board, 70)
    assert tw.alive == want_count
    assert np.array_equal(t.fetch(tw), want)
    assert t.tiled.max_resident == max_resident
    assert t.tiled._pool_cap <= max_resident
    assert t.tiled.cache_sizes() == {
        "slabs": [(max_resident, 3, 96)]}


def test_settled_board_leaves_the_dispatch_set():
    h = w = 128
    board = np.zeros((h, w), np.uint8)
    for r0, c0 in ((10, 10), (10, 90), (90, 10), (90, 90)):
        board[r0:r0 + 2, c0:c0 + 2] = 255
    j, t = _pair(h, w, 64)
    jw, tw = _step_both(j, t, j.put(board), t.put(board), 64)
    steps0 = tt._METRICS.tile_steps.value
    rides0 = tt._METRICS.tile_rides.value
    jw, tw = _step_both(j, t, jw, tw, 256)
    assert tt._METRICS.tile_steps.value == steps0
    assert tt._METRICS.tile_rides.value == rides0
    assert tw.alive == 16
    assert np.array_equal(t.fetch(tw), _oracle(board, 320)[0])


def test_oscillating_island_rides_without_launch(monkeypatch):
    """A period-3 pulsar: after one warm period the ride cache replays
    it, with no slab stepped at all — no call of the batched entry."""
    h = w = 128
    board = np.zeros((h, w), np.uint8)
    _stamp(board, PULSAR, (20, 20))
    j, t = _pair(h, w, 64)
    jw, tw = _step_both(j, t, j.put(board), t.put(board), 32 * 4)
    calls = []
    real = cb.step_n_packed_batch_cuda_raw
    monkeypatch.setattr(cb, "step_n_packed_batch_cuda_raw",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    rides0 = tt._METRICS.tile_rides.value
    jw, tw = _step_both(j, t, jw, tw, 32 * 8)
    assert tt._METRICS.tile_rides.value > rides0
    assert not calls, "a warmed oscillating island launched a slab"
    want, want_count = _oracle(board, 32 * 12)
    assert tw.alive == want_count
    assert np.array_equal(t.fetch(tw), want)
    assert t.tiled.activity()["ride_entries"] == j.tiled.activity()[
        "ride_entries"]


def test_broken_halo_carry_fails_the_gate():
    """The oracle must be able to lose: a dropped ghost word-row in the
    gather makes the port's committed world diverge."""
    h = w = 128
    board = np.zeros((h, w), np.uint8)
    board[62:66, 60:70] = _soup(9, 4, 10, 0.6)
    t = tmake(height=h, width=w, tile=64, device="cpu")
    impl = t.tiled
    real_gather = impl._gather

    def broken(words, r, c):
        ext = real_gather(words, r, c).copy()
        ext[0, :] = 0
        return ext

    impl._gather = broken
    world, _ = t.step_n(t.put(board), 64)
    assert not np.array_equal(t.fetch(world), _oracle(board, 64)[0])


def test_warm_pool_allocates_no_new_slab():
    """Once the slab capacity is warm, dispatches with any active-set
    shape allocate no new slab buffers."""
    h = w = 128
    t = tmake(height=h, width=w, tile=32, device="cpu")
    impl = t.tiled
    world, _ = t.step_n(t.put(_soup(4, h, w, 0.3)), 64)
    census = impl.cache_sizes()
    assert census["slabs"][-1] == (16, 3, 96)
    world, _ = t.step_n(t.put(np.zeros((h, w), np.uint8)), 32)
    b2 = np.zeros((h, w), np.uint8)
    b2[5:8, 5:8] = 255
    world, _ = t.step_n(t.put(b2), 64)
    world, _ = t.step_n(t.put(_soup(5, h, w, 0.3)), 96)
    assert impl.cache_sizes() == census


@pytest.mark.parametrize("band", [1024, 96])
def test_put_fetch_on_host_and_split_timed_on_request(monkeypatch, band):
    """put packs on the host byte for byte as gol_tpu's does, fetch
    unpacks it back, in one band or in bands of 96 rows and a last of
    32; the chunk's leg split is taken only when asked."""
    monkeypatch.setattr(tt, "HOST_BAND_ROWS", band)
    h = w = 128
    board = _soup(6, h, w)
    j, t = _pair(h, w, 32)
    tw = t.put(board)
    assert tw.words.dtype == np.uint32
    assert np.array_equal(tw.words, j.put(board).words)
    assert np.array_equal(t.fetch(tw), board)
    impl = t.tiled
    assert not impl.time_split
    t.step_n(tw, 32)
    assert impl.last_split == dict.fromkeys(tt.SPLIT_LEGS, 0.0)
    impl.time_split = True
    t.step_n(tw, 32)
    split = impl.last_split
    assert set(split) == set(tt.SPLIT_LEGS)
    assert min(split.values()) >= 0.0
    assert split["gather"] > 0.0 and split["launch"] > 0.0


def test_per_tile_labels_bounded_under_churn():
    h = w = 512
    t = tmake(height=h, width=w, tile=32, device="cpu")  # 256 tiles
    n_before = len(tobs.registry().metrics())
    world, _ = t.step_n(t.put(_soup(6, h, w, 0.3)), 32)
    assert len(tobs.registry().metrics()) == n_before
    lines = [ln for ln in tobs.registry().prometheus_text().splitlines()
             if ln.startswith("gol_tpu_engine_tile_active_chunks")]
    cap = tt._METRICS.per_tile.cap
    assert tt._METRICS.per_tile.child_count() == 256
    assert len(lines) <= cap + 2
    world, _ = t.step_n(t.put(np.zeros((h, w), np.uint8)), 32)
    assert tt._METRICS.per_tile.child_count() == 0
    assert len(tobs.registry().metrics()) == n_before


def test_tiled_world_is_held_strongly_by_the_checker():
    """TiledWorld has __slots__ and no __weakref__, so the dispatch
    checker keeps a strong reference; the checked stepper still runs
    (it returns the same handle, mutated in place)."""
    from gol_tpu_torch.analysis.invariants import invariants_enabled

    assert invariants_enabled()
    t = tmake(height=64, width=64, tile=32, device="cpu")
    world = t.put(_soup(8, 64, 64))
    with pytest.raises(TypeError):
        weakref.ref(world)
    again, _ = t.step_n(world, 33)
    assert again is world
    again, _, _ = t.step_n_with_diffs(again, 2)
    assert again is world


# --- the engine ---


def test_engine_runs_tiled_backend_detectors_off(tmp_path):
    """Params(tile=...) steps bit-exactly in both packages' engines,
    both stand their cycle detectors down, and the snapshots equal."""
    h = w = 128
    board = _soup(7, h, w, 0.25)
    engines = []
    for pkg, mod in ((gol_tpu, jd), (gol_tpu_torch, td)):
        p = pkg.Params(turns=100, threads=1, image_width=w, image_height=h,
                       chunk=0, out_dir=str(tmp_path / pkg.__name__),
                       cycle_detect=True, tile=64)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        eng = mod.Engine(p, emit_flips=False, initial_world=board, **extra)
        assert eng._cycles is None and eng._ride_cycles is None
        eng.run()
        assert eng.error is None
        engines.append(eng)
    jeng, teng = engines
    want, _ = _oracle(board, 100)
    assert np.array_equal(teng.stepper.fetch(teng._committed[1]), want)
    assert (sorted(p.read_bytes() for p in (tmp_path / "gol_tpu").iterdir())
            == sorted(p.read_bytes()
                      for p in (tmp_path / "gol_tpu_torch").iterdir()))


def _normalize(evs) -> list:
    out = []
    for e in evs:
        name = type(e).__name__
        if name == "AliveCellsCount":
            continue
        if name == "CellFlipped":
            payload = tuple(e.cell)
        elif name == "FinalTurnComplete":
            payload = tuple(map(tuple, e.alive))
        elif name in ("ImageOutputComplete",):
            payload = e.filename
        elif name == "StateChange":
            payload = e.new_state.name
        elif name == "FlipBatch":
            payload = np.asarray(e.cells).tolist()
        elif name == "FlipChunk":
            payload = (e.first_turn, np.asarray(e.counts).tolist(),
                       np.asarray(e.bitmaps).tolist(),
                       np.asarray(e.words).tolist())
        else:
            payload = None
        out.append((name, e.completed_turns, payload))
    return out


@pytest.mark.parametrize("consumer", [
    {}, {"emit_flip_batches": True},
    {"emit_flip_batches": True, "emit_flip_chunks": True},
])
def test_watched_tiled_run_matches_gol_tpu(tmp_path, consumer):
    """A watched tiled run takes the engine's `_run_diff_chunk` branch
    (the stepper fetches its own diff stacks) in both packages: per-cell
    flips, FlipBatches or FlipChunks, event for event equal, and the
    port counted diff dispatches."""
    h = w = 128
    world = np.zeros((h, w), np.uint8)
    world[40:72, 40:72] = _soup(11, 32, 32, 0.4)
    runs = []
    before = td._METRICS.dispatches["diffs"].value
    for pkg, mod in ((gol_tpu, jd), (gol_tpu_torch, td)):
        p = pkg.Params(turns=40, threads=1, image_width=w, image_height=h,
                       chunk=16, tile=32, tick_seconds=60.0,
                       out_dir=str(tmp_path / pkg.__name__))
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        eng = mod.Engine(p, initial_world=world, **consumer, **extra)
        assert eng.stepper.offers("fetch_diffs")
        eng.start()
        evs = list(eng.events)
        eng.join(60)
        assert eng.error is None, eng.error
        runs.append(_normalize(evs))
    assert runs[1] == runs[0]
    assert td._METRICS.dispatches["diffs"].value - before == 3


# --- the batched step and kernel A's batched entry ---


@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
@pytest.mark.parametrize("batch,n", [(1, 1), (3, 31), (5, 32)])
def test_batched_plain_step_matches_vmap(notation, batch, n):
    rng = np.random.default_rng(batch * 100 + n)
    stack = rng.integers(0, 2**32, size=(batch, 4, 128),
                         dtype=np.uint64).astype(np.uint32)
    jrule_ = jrule(notation)
    want = np.asarray(jax.vmap(
        lambda p: jb.step_n_packed_raw(p, n, jrule_))(stack))
    got = tb.step_n_packed_raw(torch.from_numpy(stack.view(np.int32)), n,
                               trule(notation))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # Through the batched entry on a CPU tensor: the plain step.
    got = cb.step_n_packed_batch_cuda_raw(
        torch.from_numpy(stack.view(np.int32)), n, trule(notation))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # Each board alone, as a 2-D board, is the same step.
    one = tb.step_n_packed_raw(torch.from_numpy(stack[0].view(np.int32)), n,
                               trule(notation))
    assert np.array_equal(one.numpy().view(np.uint32), want[0])


@pytest.mark.parametrize("tile,ext,plan,smem", [
    (32, (3, 96), (3, 1, 1), 2 * 4 * 3 * 96),
    (64, (4, 128), (4, 1, 1), 2 * 4 * 3 * 128),
    (512, (18, 576), (6, 3, 1), 2 * 4 * 5 * 576),
    (1024, (34, 1088), (2, 17, 1), 165_376),
    (2048, (66, 2112), (6, 11, 1), 219_648),
])
def test_ext_block_cluster_plans(tile, ext, plan, smem):
    """The ext block of tile T at g = 1 and kernel A's cluster plan for
    it: one-row slabs at T = 32 and 64, and each plan's walkers."""
    s = tt.TiledStepper("B3/S23", tile, tile, tile, device="cpu")
    assert (s.ext_h, s.ext_w) == ext
    assert tt.slab_route(tile) == s.route == "resident"
    assert cb._cluster_plan(*ext, 2) == plan
    blocks, slab_rows, halo = plan
    assert 2 * 4 * (slab_rows + 2 * halo) * ext[1] == smem <= cb.SMEM_BYTES
    args = cb._resident_args(*ext, 2)
    assert args[:3] == plan
    threads, seg_rows = args[3:]
    assert 0 < threads <= cb.WALK_THREADS and threads % 32 == 0
    assert seg_rows >= 1


@pytest.mark.parametrize("tile,ext", [(3072, (98, 3136)),
                                      (4096, (130, 4160))])
def test_large_tiles_route_to_kernel_b(tile, ext):
    with pytest.raises(ValueError, match="shared memory"):
        cb._cluster_plan(*ext, 2)
    assert tt.slab_route(tile) == "tiled2d"
    s = tt.TiledStepper("B3/S23", tile, tile, tile, device="cpu",
                        max_resident=2)
    assert s.activity()["route"] == "tiled2d"
    assert (s.ext_h, s.ext_w) == ext


def test_kernel_b_route_steps_exactly(monkeypatch):
    """The per-block kernel-B route (forced on small tiles) gives the
    same worlds as the batched route."""
    h = w = 128
    board = _soup(12, h, w, 0.3)
    a = tmake(height=h, width=w, tile=32, device="cpu")
    b = tmake(height=h, width=w, tile=32, device="cpu")
    b.tiled.route = "tiled2d"
    calls = []
    real = cb.step_n_packed_tiled2d_raw
    monkeypatch.setattr(cb, "step_n_packed_tiled2d_raw",
                        lambda *x, **kw: calls.append(x) or real(*x, **kw))
    aw, ac = a.step_n(a.put(board), 45)
    bw, bc = b.step_n(b.put(board), 45)
    assert ac == bc and np.array_equal(aw.words, bw.words)
    assert calls and all(x[0].shape == (3, 96) for x in calls)


def test_batch_wrapper_hands_the_launcher_its_batch(monkeypatch):
    """A stack on the card goes to kernel A's launcher once, with the
    batch, the board shape and the ext block's cluster plan, in the
    order and number of the C signature; the wrapper refuses a batch
    over CUDA's grid z limit and a 2-D board."""
    from gol_tpu_torch.ops import _build

    seen = []
    monkeypatch.setattr(cb, "_check_cuda", lambda p, dims=2: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append((name, args)))
    x = torch.empty((16, 34, 1088), dtype=torch.int32, device="meta")
    cb.step_n_packed_batch_cuda_raw(x, 32)
    (name, args), = seen
    assert name == "bitlife_resident"
    assert args[2:6] == (16, 34, 1088, 32)
    assert args[6:9] == cb.rule_args(trule("B3/S23"))
    assert args[9:] == cb._resident_args(34, 1088, 2)
    assert len(args) + 1 == len(_build._SIGNATURES["bitlife_resident_launch"])
    big = torch.empty((cb.MAX_BATCH + 1, 3, 96), dtype=torch.int32,
                      device="meta")
    with pytest.raises(ValueError, match="65535"):
        cb.step_n_packed_batch_cuda_raw(big, 1)
    with pytest.raises(ValueError, match="3-D"):
        cb.step_n_packed_batch_cuda_raw(torch.zeros((3, 96), dtype=torch.int32), 1)
    src = (REPO / "gol_tpu_torch/csrc/walk.cuh").read_text()
    assert f"constexpr int kMaxGridZ = {cb.MAX_BATCH};" in src


# --- factory, capacity, metrics ---


def test_factory_validation():
    from gol_tpu_torch.params import Params

    for h, w, tile, g in ((128, 128, 64, 1), (128, 128, 48, 1),
                          (130, 128, 64, 1), (128, 128, 32, 2)):
        assert tt.tileable(h, w, tile, g) == jt.tileable(h, w, tile, g)
    assert tt.tileable(128, 128, 64)
    with pytest.raises(ValueError, match="tile"):
        tt.tiled_stepper("B3/S23", 128, 128, 48, device="cpu")
    with pytest.raises(ValueError, match="two-state"):
        tt.tiled_stepper("B2/S/C4", 128, 128, 64, device="cpu")
    with pytest.raises(ValueError, match="B0|births"):
        tt.TiledStepper("B0123478/S01234678", 128, 128, 64, device="cpu")
    with pytest.raises(ValueError):
        Params(turns=1, image_width=64, image_height=64, tile=33)
    assert Params(turns=1, tile=64).tile == gol_tpu.Params(
        turns=1, tile=64).tile


def test_fits_resident_tiles_matches_paging_policy(monkeypatch):
    budget = 512 * 1024 * 1024
    monkeypatch.setenv("GOL_TPU_DEVICE_BUDGET_BYTES", str(budget))
    ext = tdev.tile_ext_bytes(1024, 1)
    assert ext == jdev.tile_ext_bytes(1024, 1) == 34 * 1088 * 4
    cap = tdev.max_resident_tiles(1024, 1)
    assert cap == jdev.max_resident_tiles(1024, 1) == budget // (ext * 3)
    for kw in ({"sessions": 1}, {"sessions": 3, "resident_tiles": cap,
                                 "tile": 1024}):
        assert tdev.fits(8192, 8192, **kw) == jdev.fits(8192, 8192, **kw)
    with pytest.raises(ValueError, match="tile"):
        tdev.fits(512, 512, resident_tiles=4)
    t = tt.TiledStepper("B3/S23", 2048, 2048, 1024, device="cpu")
    assert t.max_resident == jt.TiledStepper(
        "B3/S23", 2048, 2048, 1024).max_resident == min(cap, 4)
    monkeypatch.delenv("GOL_TPU_DEVICE_BUDGET_BYTES")
    if not torch.cuda.is_available():
        assert tdev.device_budget() is None
        assert tdev.max_resident_tiles(1024) is None
        assert tdev.fits(512, 512)["fits"] is None
    assert tdev.device_budget("cpu") is None


def test_topk_exposition_matches_gol_tpu():
    """The same metric operations on private registries of both
    packages expose the same Prometheus text and snapshot."""
    regs = (jobs.Registry(), tobs.Registry())
    for reg in regs:
        g = reg.topk_gauge("x_streak", "streaks", label="tile", cap=3)
        for i in range(7):
            g.set_child(f"{i},0", i % 4)
        g.remove_child("6,0")
        reg.counter("x_total", "things", {"dir": "in"}).inc(5)
        reg.gauge("x_gauge", "level").set(2.5)
        reg.histogram("x_seconds", "time", buckets=(0.1, 1.0)).observe(0.5)
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].snapshot() == regs[1].snapshot()


# --- the CLI and the public names ---


def test_cli_tile_matches_gol_tpu(golden_root, tmp_path):
    """`--tile 32` on the CPU writes the same PGM as gol_tpu's CLI (and
    the golden board)."""
    from gol_tpu import cli as jcli

    args = ["-w", "64", "-h", "64", "-turns", "100", "-noVis", "--tile",
            "32", "--images", str(golden_root / "images")]
    assert jcli.main(args + ["--platform", "cpu",
                             "--out", str(tmp_path / "jax")]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *args, "--platform", "cpu",
         "--out", str(tmp_path / "torch")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    got = (tmp_path / "torch" / "64x64x100.pgm").read_bytes()
    assert got == (tmp_path / "jax" / "64x64x100.pgm").read_bytes()
    assert got == (golden_root / "check/images/64x64x100.pgm").read_bytes()
    bad = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *args[:-4], "--tile", "48",
         "--platform", "cpu", "--images", str(golden_root / "images"),
         "--out", str(tmp_path / "bad")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert bad.returncode != 0 and "tile" in bad.stderr


def test_public_names_match_gol_tpu():
    from gol_tpu import ops as jops
    from gol_tpu.ops import life as jl
    from gol_tpu_torch import ops as tops
    from gol_tpu_torch.ops import life as tl

    assert gol_tpu_torch.__version__ == gol_tpu.__version__
    world = _soup(13, 64, 64)
    assert tops.alive_cells(world) == jops.alive_cells(world)
    assert tops.alive_cells(torch.from_numpy(world)) == jops.alive_cells(world)
    mask = _soup(14, 64, 64) != 0
    assert tl.flipped_cells(mask) == jl.flipped_cells(mask)
    for notation in ("B3/S23", "B36/S23"):
        want = np.asarray(jb.step_n_packed(world, 9, jrule(notation)))
        got = tb.step_n_packed(torch.from_numpy(world), 9, trule(notation))
        assert np.array_equal(got.numpy(), want)
        jw, jc = jb.step_n_counted_packed(world, 9, jrule(notation))
        tw, tc = tb.step_n_counted_packed(torch.from_numpy(world), 9,
                                          trule(notation))
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert int(tc) == int(jc)


def test_stepper_dataclass_replace_keeps_tiled():
    """The instrumented and checked wrappers keep `tiled`, so the engine
    sees the capability (its guard reads `offers("tiled")`)."""
    t = tmake(height=64, width=64, tile=32, device="cpu")
    assert t.offers("tiled") and t.offers("fetch_diffs")
    assert not t.offers("step_n_with_diffs_sparse")
    bare = dataclasses.replace(t, tiled=None)
    assert not bare.offers("tiled")
