"""The port's session-bucket backend (gol_tpu_torch/parallel/stepper.py,
`BatchStepper` / `make_batch_stepper`) against gol_tpu's vmapped one
(gol_tpu/parallel/stepper.py), on the CPU.

The same numpy boards, made from seeds, go into both packages' buckets;
boards, per-session alive counts, per-turn XOR stacks and dense masks,
and the compact encoding's headers and value buffers (after the uint32
view) must be bit-identical — including a bucket where one session
overflows the value buffer and the others do not. Also: the host
contract of put / fetch / set / clear on packed and dense buckets,
padding slots, the refusals and their messages, the route function, and
each route's launches on the card through a fake library (the kernels
themselves run on the card, chip_smoke.py). Exact comparisons: the
automaton is integer-deterministic.
"""

import contextlib

import numpy as np
import pytest
import torch

from gol_tpu.parallel.stepper import make_batch_stepper as jmake
from gol_tpu_torch.ops import _build
from gol_tpu_torch.ops import cuda_bitlife as cb
from gol_tpu_torch.ops import cuda_life as cl
from gol_tpu_torch.parallel import stepper as ts
from gol_tpu_torch.parallel.stepper import bucket_route
from gol_tpu_torch.parallel.stepper import make_batch_stepper as tmake


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _soup(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8) * np.uint8(255)


def _glider(h, w, y=1, x=1):
    b = np.zeros((h, w), np.uint8)
    for dy, dx in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        b[y + dy, x + dx] = 255
    return b


def _boards(cap, h, w, seed, live=None):
    """`live` seeded soups, the rest all-zero padding slots."""
    live = cap - 1 if live is None else live
    return ([_soup(h, w, seed + i) for i in range(live)]
            + [np.zeros((h, w), np.uint8)] * (cap - live))


def _pair(cap, h, w, notation="B3/S23"):
    return jmake(cap, h, w, notation), tmake(cap, h, w, notation,
                                             device="cpu")


def _u32(x):
    """Host uint32 (or bool / uint8) view of either package's array."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


#: (capacity, height, width, rule): packed, dense (H % 32 != 0), a
#: packed bucket under another rule.
SHAPES = [(4, 64, 64, "B3/S23"), (3, 40, 48, "B3/S23"),
          (2, 32, 96, "B36/S23")]


@pytest.mark.parametrize("cap,h,w,notation", SHAPES)
@pytest.mark.parametrize("k", [0, 1, 7])
def test_step_n_matches_gol_tpu(cap, h, w, notation, k):
    jb, tb = _pair(cap, h, w, notation)
    boards = _boards(cap, h, w, seed=10 + k)
    js, jc = jb.step_n(jb.put_all(boards), k)
    tst, tc = tb.step_n(tb.put_all(boards), k)
    assert np.array_equal(_u32(tst), _u32(js))
    assert tc.dtype == torch.int32 and np.array_equal(tc.numpy(), np.asarray(jc))
    for slot in range(cap):
        assert np.array_equal(tb.fetch_one(tst, slot), jb.fetch_one(js, slot))
    # The padding slot stays an all-zero board.
    assert not tb.fetch_one(tst, cap - 1).any()


@pytest.mark.parametrize("cap,h,w,notation", SHAPES)
def test_step_n_with_diffs_matches_gol_tpu(cap, h, w, notation):
    jb, tb = _pair(cap, h, w, notation)
    boards = _boards(cap, h, w, seed=3)
    js, jd, jc = jb.step_n_with_diffs(jb.put_all(boards), 5)
    tst, td, tc = tb.step_n_with_diffs(tb.put_all(boards), 5)
    assert np.array_equal(_u32(tst), _u32(js))
    assert td.shape == jd.shape and np.array_equal(_u32(td), _u32(jd))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    if tb.packed:
        assert td.dtype == torch.int32
    else:
        assert td.dtype == torch.bool


def test_diffs_of_zero_turns_keep_the_layout():
    jb, tb = _pair(2, 64, 64)
    boards = _boards(2, 64, 64, seed=1)
    _, jd, _ = jb.step_n_with_diffs(jb.put_all(boards), 0)
    _, td, _ = tb.step_n_with_diffs(tb.put_all(boards), 0)
    assert td.shape == jd.shape == (2, 0, 2, 64)
    _, jh, jv, _ = jb.step_n_with_diffs_compact(jb.put_all(boards), 0, 64)
    _, th, tv, _ = tb.step_n_with_diffs_compact(tb.put_all(boards), 0, 64)
    assert th.shape == jh.shape and tv.shape == jv.shape
    assert np.array_equal(_u32(tv), _u32(jv))


@pytest.mark.parametrize("total_cap", [64, 200, 4096])
def test_compact_matches_gol_tpu_with_one_session_overflowing(total_cap):
    """Slot 0 is a dense soup, slot 1 a glider, slot 2 padding: at
    total_cap 64 and 200 the soup overflows its buffer while the glider
    does not; at 4096 neither does. Headers, values (after the uint32
    view, padding value included), counts and stacks are gol_tpu's."""
    h = w = 64
    jb, tb = _pair(3, h, w)
    boards = [_soup(h, w, 7, 0.4), _glider(h, w, 5, 9),
              np.zeros((h, w), np.uint8)]
    k = 6
    js, jh, jv, jc = jb.step_n_with_diffs_compact(jb.put_all(boards), k,
                                                  total_cap)
    tst, th, tv, tc = tb.step_n_with_diffs_compact(tb.put_all(boards), k,
                                                   total_cap)
    assert th.shape == jh.shape == (3, k, 1 + ts.sparse_bitmap_words(2 * w))
    assert tv.shape == jv.shape == (3, total_cap)
    assert np.array_equal(_u32(th), _u32(jh))
    assert np.array_equal(_u32(tv), _u32(jv))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(_u32(tst), _u32(js))
    totals = _u32(th)[:, :, 0].sum(axis=1)
    if total_cap < 4096:
        assert totals[0] > total_cap >= totals[1]
    assert totals[2] == 0 and not _u32(tv)[2].any()
    # Each session's own chunk decodes to its own dense XOR rows.
    _, dense, _ = tb.step_n_with_diffs(tb.put_all(boards), k)
    rows = list(ts.compact_decode_rows(_u32(th)[1], _u32(tv)[1],
                                       tb.total_words))
    assert np.array_equal(np.stack(rows), _u32(dense)[1].reshape(k, -1))


def test_compact_is_offered_on_packed_buckets_only():
    for (cap, h, w, notation) in SHAPES:
        jb, tb = _pair(cap, h, w, notation)
        for entry in ("step_n_with_diffs", "step_n_with_diffs_compact",
                      "step_n_with_diffs_sparse", "fetch_diffs"):
            assert tb.offers(entry) == jb.offers(entry), (h, w, entry)
        assert (tb.name, tb.capacity, tb.packed, tb.total_words) == (
            jb.name, jb.capacity, jb.packed, jb.total_words)
        assert str(tb.rule) == str(jb.rule)
    with pytest.raises(KeyError):
        tb.offers("no_such_entry")


@pytest.mark.parametrize("h,w", [(64, 64), (40, 48)])
def test_host_contract_put_fetch_set_clear(h, w):
    """set_one / clear_one write a slot in place (the same stack comes
    back), fetch_one answers {0,255} (H, W) uint8, and the results
    equal gol_tpu's functional updates."""
    jb, tb = _pair(4, h, w)
    boards = _boards(4, h, w, seed=21, live=2)
    js, tst = jb.put_all(boards), tb.put_all(boards)
    for slot in range(4):
        got = tb.fetch_one(tst, slot)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        assert np.array_equal(got, jb.fetch_one(js, slot))
    new = _soup(h, w, 99)
    js = jb.set_one(js, 3, new)
    assert tb.set_one(tst, 3, new) is tst
    js = jb.clear_one(js, 0)
    assert tb.clear_one(tst, 0) is tst
    assert np.array_equal(_u32(tst), _u32(js))
    assert np.array_equal(tb.fetch_one(tst, 3), new)
    assert not tb.fetch_one(tst, 0).any()
    js2, _ = jb.step_n(js, 4)
    tst2, _ = tb.step_n(tst, 4)
    assert np.array_equal(_u32(tst2), _u32(js2))
    with pytest.raises(ValueError, match="board shape"):
        tb.set_one(tst, 1, np.zeros((h + 1, w), np.uint8))
    with pytest.raises(ValueError, match="put_all needs 4 boards, got 3"):
        tb.put_all(boards[:3])


def test_steps_leave_the_input_stack_alone():
    """Every step returns a new stack: the pre-dispatch stack stays
    valid for the compact overflow redo."""
    tb = tmake(2, 64, 64, device="cpu")
    st = tb.put_all(_boards(2, 64, 64, seed=4))
    keep = st.clone()
    for out in (tb.step_n(st, 3)[0], tb.step_n_with_diffs(st, 3)[0],
                tb.step_n_with_diffs_compact(st, 3, 64)[0]):
        assert out.data_ptr() != st.data_ptr()
    assert torch.equal(st, keep)


def test_warm_bucket_census_stays_put():
    """The census (gol_tpu's jit-cache pin): slot churn inside a warm
    bucket adds no stack shape."""
    tb = tmake(4, 64, 64, device="cpu")
    st = tb.put_all(_boards(4, 64, 64, seed=2))
    st, _ = tb.step_n(st, 2)
    st, _, _ = tb.step_n_with_diffs(st, 2)
    st, _, _, _ = tb.step_n_with_diffs_compact(st, 2, 128)
    before = tb.cache_sizes()
    assert before == {"stacks": [(4, 2, 64, "resident")]}
    for slot in range(4):
        st = tb.clear_one(st, slot)
        st = tb.set_one(st, slot, _soup(64, 64, slot))
        tb.fetch_one(st, slot)
        st, _ = tb.step_n(st, 1)
        st, _, _, _ = tb.step_n_with_diffs_compact(st, 1, 128)
    assert tb.cache_sizes() == before
    assert tmake(2, 40, 40, device="cpu").cache_sizes() == {"stacks": []}


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("args", [
    (4, 64, 64, "B2/S/C3"),
    (4, 64, 64, "B0123478/S01234678"),
    (0, 64, 64, "B3/S23"),
])
def test_refusals_match_gol_tpu(args):
    assert _error(lambda: tmake(*args, device="cpu")) == _error(
        lambda: jmake(*args))


def test_capacity_over_one_launch_raises():
    msg = _error(lambda: tmake(cb.MAX_BATCH + 1, 64, 64, device="cpu"))
    assert str(cb.MAX_BATCH) in msg and "MAX_BATCH" in msg


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmake(4, 64, 64)


# --- routes ---


@pytest.mark.parametrize("h,w,route", [
    (256, 256, "resident"), (64, 64, "resident"), (32, 512, "resident"),
    (2048, 2048, "resident"), (4096, 4096, "tiled2d"),
    (100, 100, "dense"), (40, 48, "dense"),
])
def test_route_function(h, w, route):
    """Packable boards whose two copies fit a cluster plan take kernel
    A's batched entry; packable ones with no plan kernel B per slot;
    the others kernel E per slot."""
    assert bucket_route(h, w) == route
    if route == "tiled2d":
        with pytest.raises(ValueError):
            cb._cluster_plan(h // 32, w, 2)
        assert 2 * 4 * (h // 32 // 8 + 2) * w > cb.SMEM_BYTES
    elif route == "resident":
        cb._cluster_plan(h // 32, w, 2)


def _meta_bucket(monkeypatch, cap, h, w):
    """A bucket whose stack lies on the meta device: every wrapper takes
    its card path, with the launches caught."""
    seen = []
    monkeypatch.setattr(cb, "_check_cuda", lambda p, dims=2: None)
    monkeypatch.setattr(cb, "_check_pass", lambda s, d, c: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append((name, args)))
    monkeypatch.setattr(cl, "_check_world", lambda w: None)
    monkeypatch.setattr(cb, "_stream", lambda p: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class Lib:
        def life_dense_launch(self, *args):
            seen.append(("life_dense", args))
            args[15]._obj.value = 1
            return 0

    monkeypatch.setattr(_build, "load", lambda: Lib())
    tb = tmake(cap, h, w, device="cpu")
    shape = (cap, h // 32, w) if tb.packed else (cap, h, w)
    dtype = torch.int32 if tb.packed else torch.uint8
    return tb, torch.empty(shape, dtype=dtype, device="meta"), seen


def test_resident_route_is_one_launch_a_chunk(monkeypatch):
    tb, st, seen = _meta_bucket(monkeypatch, 16, 256, 256)
    tb.step_n(st, 256)
    (name, args), = seen
    assert name == "bitlife_resident"
    assert args[2:6] == (16, 8, 256, 256)
    assert args[9:] == cb._resident_args(8, 256, 2)
    seen.clear()
    tb.step_n_with_diffs(st, 5)
    assert [(n, a[2:6]) for n, a in seen] == [
        ("bitlife_resident", (16, 8, 256, 1))] * 5
    seen.clear()
    tb.step_n_with_diffs_compact(st, 3, 1024)
    assert len(seen) == 3


def test_tiled2d_route_is_kernel_b_per_slot(monkeypatch):
    tb, st, seen = _meta_bucket(monkeypatch, 2, 4096, 4096)
    tb.step_n(st, 64)
    assert {n for n, _ in seen} == {"bitlife_tiled"}
    geom = cb._tiled2d_geometry(128, 4096, None)
    assert len(seen) == 2 * (64 // geom.turns)
    assert all(a[2:4] == (128, 4096) for _, a in seen)


def test_dense_route_is_kernel_e_per_slot(monkeypatch):
    tb, st, seen = _meta_bucket(monkeypatch, 4, 100, 100)
    tb.step_n(st, 16)
    assert [n for n, _ in seen] == ["life_dense"] * 4
    assert all(a[3:6] == (100, 100, 16) for _, a in seen)
    seen.clear()
    tb.step_n_with_diffs(st, 2)
    assert [(n, a[5]) for n, a in seen] == [("life_dense", 1)] * 8
