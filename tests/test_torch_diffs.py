"""The port's diff scans and watched diff-chunk pipeline against gol_tpu's.

Every single-device backend pair offers the same capability set, and
its `step_n_with_diffs` / `_sparse` / `_compact` outputs are
byte-identical to gol_tpu's (gol_tpu's Pallas backends built in
interpret mode, as its own tests run them on the CPU); each package's
host decoders read the other's rows; and the engine's watched streams —
mask, sparse, compact, overflow → redo, level-mode FlipBatch, FlipChunk
and the cycle ride — equal gol_tpu's `run()` event for event. The
"cuda-*" backends run their kernels' plain versions here, because their
tensors lie on the CPU.
"""

import dataclasses
import queue
import shutil
import time

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu.engine import distributor as jd
from gol_tpu.ops import life as jl
from gol_tpu.parallel import stepper as js
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.parallel import stepper as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host(x) -> np.ndarray:
    """A diff output of either package as numpy, int32 rows viewed as
    the uint32 words they carry."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def same_bytes(a, b) -> bool:
    a, b = host(a), host(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# (port backend, gol_tpu backend, rule, height, width): every pair of
# single-device backends, gol_tpu's Pallas ones in interpret mode on
# boards their kernels take.
PAIRS = [
    ("dense", "dense", "B3/S23", 64, 64),
    ("dense", "dense", "B36/S23", 64, 64),
    ("packed", "packed", "B3/S23", 64, 64),
    ("packed", "packed", "B36/S23", 64, 64),
    ("cuda-packed", "packed", "B3/S23", 64, 64),
    ("cuda-packed", "packed", "B36/S23", 64, 64),
    ("cuda-packed", "pallas-packed", "B3/S23", 256, 256),
    ("cuda-dense", "pallas", "B3/S23", 64, 128),
    ("cuda-dense", "pallas", "B36/S23", 64, 128),
    ("dense", "dense", "B2/S345/C4", 64, 64),
    ("packed", "packed", "B2/S345/C4", 64, 64),
    ("cuda-packed", "packed", "B2/S345/C4", 64, 64),
    ("cuda-packed", "packed", "B2/S/C3", 64, 64),
]
NAMES = {
    ("dense", False): "single", ("packed", False): "single-packed",
    ("cuda-packed", False): "single-cuda-packed",
    ("cuda-dense", False): "single-cuda-dense",
    ("dense", True): "generations-1", ("packed", True): "generations-packed-1",
    ("cuda-packed", True): "generations-cuda-packed-1",
}
KS = (0, 1, 7)

_JAX_RUNS: dict = {}


def caps(h, w) -> tuple:
    """A cap that overflows on this board at any k >= 1, and one that
    fits every turn of every k (sparse) and every chunk (compact)."""
    return 8, h // 32 * w * max(KS)


def jax_outputs(jback, rule, h, w):
    """gol_tpu's diff outputs for one (backend, rule, board), computed
    once per module: the port's packed and cuda-packed backends share
    one gol_tpu counterpart (and its compiled programs)."""
    key = (jback, rule, h, w)
    if key not in _JAX_RUNS:
        st = js.make_stepper(threads=1, height=h, width=w, rule=rule,
                             backend=jback)
        world = np.asarray(jl.random_world(h, w, density=0.3, seed=h + w))
        out = {"caps": st.capabilities(), "name": st.name, "world": world}
        for k in KS:
            out["dense", k] = st.step_n_with_diffs(st.put(world), k)
            if st.offers("step_n_with_diffs_sparse"):
                for cap in caps(h, w):
                    out["sparse", k, cap] = st.step_n_with_diffs_sparse(
                        st.put(world), k, cap)
                    out["compact", k, cap] = st.step_n_with_diffs_compact(
                        st.put(world), k, cap)
        _JAX_RUNS[key] = (st, out)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("backend,jback,rule,h,w", PAIRS,
                         ids=lambda v: str(v).replace("/", ""))
def test_diff_entries_match_gol_tpu(backend, jback, rule, h, w):
    jst, want = jax_outputs(jback, rule, h, w)
    tst = ts.make_stepper(height=h, width=w, rule=rule, backend=backend,
                          device="cpu")
    assert tst.name == NAMES[backend, "/C" in rule]
    assert tst.capabilities() == want["caps"]
    for entry in ("fetch_diffs", "step_n_with_diffs_redo",
                  "fetch_compact_values"):
        assert not tst.offers(entry) and not jst.offers(entry)
    world = want["world"]
    for k in KS:
        tn, td_, tc = tst.step_n_with_diffs(tst.put(world), k)
        jn, jd_, jc = want["dense", k]
        assert same_bytes(td_, jd_), (k, td_.dtype, td_.shape)
        assert np.array_equal(tst.fetch(tn), jst.fetch(jn))
        assert int(tc) == int(jc)
        if not tst.offers("step_n_with_diffs_sparse"):
            continue
        for cap in caps(h, w):
            _, trows, tc = tst.step_n_with_diffs_sparse(tst.put(world), k,
                                                        cap)
            _, jrows, jc = want["sparse", k, cap]
            assert same_bytes(trows, jrows), (k, cap)
            assert int(tc) == int(jc)
            tn, thdr, tvals, tc = tst.step_n_with_diffs_compact(
                tst.put(world), k, cap)
            jn, jhdr, jvals, jc = want["compact", k, cap]
            assert same_bytes(thdr, jhdr), (k, cap)
            assert same_bytes(tvals, jvals), (k, cap)
            assert np.array_equal(tst.fetch(tn), jst.fetch(jn))
            assert int(tc) == int(jc)
            # The small cap overflowed (row counts and the summed counts
            # past it), the large one fit.
            overflow = int(host(trows)[:, 0].max(initial=0)) > cap
            assert overflow == (k > 0 and cap == 8)
            assert (int(host(thdr)[:, 0].sum()) > cap) == overflow


def test_entries_and_capabilities_tables():
    assert ts.entries() == ts.ENTRY_TABLE
    for kind in ("core", "diff", "fetch", "meta"):
        assert ([e.name for e in ts.entries(kind)]
                == [e.name for e in js.entries(kind)])


def _blinker_world(h, w, x, y=1):
    """A horizontal blinker centred on (x, y)."""
    world = np.zeros((h, w), np.uint8)
    world[y, x - 1:x + 2] = 255
    return world


def test_sparse_pads_with_word_zero():
    """jnp.nonzero(size=cap, fill_value=0) pads with index 0, so the
    unused value slots of a sparse row hold d[0] — on a row where word
    0 changed and fewer than `cap` words did, they are not zero."""
    world = _blinker_world(64, 64, 1)  # columns 0..2 of word-row 0
    jst = js.make_stepper(threads=1, height=64, width=64, backend="packed")
    tst = ts.make_stepper(height=64, width=64, backend="packed",
                          device="cpu")
    cap = 16
    _, jrows, _ = jst.step_n_with_diffs_sparse(jst.put(world), 2, cap)
    _, trows, _ = tst.step_n_with_diffs_sparse(tst.put(world), 2, cap)
    assert same_bytes(trows, jrows)
    rows = host(trows)
    nb = ts.sparse_bitmap_words(2 * 64)
    for row in rows:
        m = int(row[0])
        assert 0 < m < cap and row[1] & 1  # word 0 changed
        d0 = row[1 + nb]  # word 0's value, the first in the list
        assert d0 != 0
        assert (row[1 + nb + m:] == d0).all()


def test_bitmap_bit_31():
    """A changed word at flat index 31 sets bit 31 of bitmap word 0: the
    int32 row holds the two's-complement pattern, never an overflowed
    or int64-promoted sum, in the sparse rows and compact headers."""
    world = _blinker_world(64, 64, 31)  # changes words 30, 31, 32
    jst = js.make_stepper(threads=1, height=64, width=64, backend="packed")
    tst = ts.make_stepper(height=64, width=64, backend="packed",
                          device="cpu")
    _, trows, _ = tst.step_n_with_diffs_sparse(tst.put(world), 3, 8)
    _, jrows, _ = jst.step_n_with_diffs_sparse(jst.put(world), 3, 8)
    assert trows.dtype == torch.int32 and same_bytes(trows, jrows)
    _, thdr, _, _ = tst.step_n_with_diffs_compact(tst.put(world), 3, 64)
    _, jhdr, _, _ = jst.step_n_with_diffs_compact(jst.put(world), 3, 64)
    assert thdr.dtype == torch.int32 and same_bytes(thdr, jhdr)
    for bitmap_word in (host(trows)[:, 1], host(thdr)[:, 1]):
        assert (bitmap_word & np.uint32(1 << 31)).all()
    assert (trows[:, 1] < 0).all()  # bit 31 is the int32 sign bit


@pytest.mark.parametrize("rule", ["B3/S23", "B2/S345/C4"])
def test_decoders_read_each_others_rows(rule):
    """Each package's host decoders fed the other's rows give the same
    words, and both raise on the same truncated row."""
    h = w = 64
    jst = js.make_stepper(threads=1, height=h, width=w, rule=rule,
                          backend="packed")
    tst = ts.make_stepper(height=h, width=w, rule=rule, backend="packed",
                          device="cpu")
    world = np.asarray(jl.random_world(h, w, density=0.2, seed=5))
    total = h // 32 * w
    k = 5
    jrows = host(jst.step_n_with_diffs_sparse(jst.put(world), k, total)[1])
    trows = host(tst.step_n_with_diffs_sparse(tst.put(world), k, total)[1])
    for rows in (jrows, trows):
        a = list(js.sparse_decode_rows(rows, total))
        b = list(ts.sparse_decode_rows(rows, total))
        assert len(a) == len(b) == k
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    short = host(tst.step_n_with_diffs_sparse(tst.put(world), k, 4)[1])
    for decode in (js.sparse_decode_rows, ts.sparse_decode_rows):
        with pytest.raises(ValueError, match="truncated"):
            list(decode(short, total))
    _, jh, jv, _ = jst.step_n_with_diffs_compact(jst.put(world), k, 4096)
    _, th, tv, _ = tst.step_n_with_diffs_compact(tst.put(world), k, 4096)
    for hdr, vals in ((host(jh), jv), (host(th), tv)):
        n = int(hdr[:, 0].sum())
        for prefix in (js.compact_value_prefix, ts.compact_value_prefix):
            v = prefix(vals, n)
            assert v.dtype == np.uint32 and len(v) >= n
            a = list(js.compact_decode_rows(hdr, v, total))
            b = list(ts.compact_decode_rows(hdr, v, total))
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        for decode in (js.compact_decode_rows, ts.compact_decode_rows):
            with pytest.raises(ValueError, match="truncated"):
                list(decode(hdr, host(vals)[:n - 1], total))
            bad = hdr.copy()
            bad[0, 0] += 1
            with pytest.raises(ValueError, match="bitmap pops"):
                list(decode(bad, host(vals), total))


def test_value_bucket_and_chunk_from_dense_match():
    for total in list(range(0, 3000, 7)) + [4097, 8192, 115_000, 262_145]:
        assert ts.compact_value_bucket(total) == js.compact_value_bucket(total)
    rng = np.random.default_rng(9)
    for shape in ((3, 2, 64), (4, 1, 40), (1, 2, 64)):
        stack = rng.integers(0, 2**32, shape, dtype=np.uint32)
        stack[rng.random(shape) < 0.7] = 0
        for x in (stack, stack.view(np.int32)):
            a, b = js.sparse_chunk_from_dense(x), ts.sparse_chunk_from_dense(x)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype and np.array_equal(u, v)


# --- the engine --------------------------------------------------------


def normalize(evs) -> list:
    """Package-neutral event tuples with every flip payload
    (AliveCellsCount is timing-dependent and left out)."""
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


def glider_world(h, w):
    """Two gliders and a blinker (gol_tpu's tests/test_diffs.py board):
    a few dozen changed words a turn, the compact chunks' steady state."""
    world = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2)):
        world[4 + dy, 4 + dx] = 255
        world[40 + dy, 40 + dx] = 255
    world[20, 20:23] = 255
    return world


def run_pair(tmp_path, mode="auto", engine_kw=None, world=None, **kw):
    """The same watched run through both packages' Engine; returns
    ((gol_tpu events, engine), (port events, engine)). `mode` strips
    encodings from both steppers ("mask": no sparse or compact, "sparse":
    no compact) or forces the compact buffer to 4 words ("overflow")."""
    out = []
    for pkg, eng_mod, tag in ((gol_tpu, jd, "jax"),
                              (gol_tpu_torch, td, "torch")):
        p = pkg.Params(out_dir=str(tmp_path / tag), tick_seconds=60.0,
                       threads=1, **kw)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        engine = eng_mod.Engine(p, initial_world=world,
                                **(engine_kw or {}), **extra)
        if mode == "mask":
            engine.stepper = dataclasses.replace(
                engine.stepper, step_n_with_diffs_sparse=None,
                step_n_with_diffs_compact=None)
        elif mode == "sparse":
            engine.stepper = dataclasses.replace(
                engine.stepper, step_n_with_diffs_compact=None)
        elif mode == "overflow":
            engine._compact_total_cap = lambda k: 4
        engine.start()
        evs = list(engine.events)
        engine.join(60)
        assert engine.error is None, engine.error
        out.append((evs, engine))
    return out


def metric_values():
    m = td._METRICS
    return {"diffs": m.dispatches["diffs"].value,
            "ride": m.dispatches["ride"].value,
            "sparse": m.sparse_chunks.value,
            "compact": m.compact_chunks.value,
            "sparse_redos": m.sparse_redos.value,
            "compact_redos": m.compact_redos.value}


@pytest.mark.parametrize("mode,rises", [
    ("mask", ()), ("sparse", ("sparse",)), ("auto", ("compact",)),
    ("overflow", ("compact", "compact_redos")),
])
def test_engine_streams_match_gol_tpu(tmp_path, mode, rises):
    """A watched 256² glider board at chunk 7 through the mask path, the
    sparse rows, the compact chunks and a forced compact overflow (redo
    from the truncated chunk's input): the port's stream equals
    gol_tpu's, and the port took the path asked for."""
    before = metric_values()
    (jevs, _), (tevs, _) = run_pair(
        tmp_path, mode, world=glider_world(256, 256), turns=61,
        image_width=256, image_height=256, chunk=7)
    assert normalize(tevs) == normalize(jevs)
    after = metric_values()
    assert after["diffs"] > before["diffs"]
    for key in ("sparse", "compact", "compact_redos"):
        assert (after[key] > before[key]) == (key in rises), key


@pytest.mark.parametrize("backend", ["dense", "cuda-dense"])
def test_dense_mask_streams_match_gol_tpu(golden_root, tmp_path, backend):
    """The dense backends' bool-mask stacks give gol_tpu's stream (its
    counterparts "dense" and "pallas" scan the same XLA dense step)."""
    from gol_tpu.io.pgm import read_pgm

    world = read_pgm(golden_root / "images" / "64x64.pgm")
    out = []
    for pkg, eng_mod, tag, b in ((gol_tpu, jd, "jax", "dense"),
                                 (gol_tpu_torch, td, "torch", backend)):
        p = pkg.Params(turns=30, image_width=64, image_height=64, chunk=0,
                       backend=b, out_dir=str(tmp_path / tag),
                       tick_seconds=60.0)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        engine = eng_mod.Engine(p, initial_world=world, **extra)
        engine.start()
        out.append(normalize(list(engine.events)))
        engine.join(60)
        assert engine.error is None
    assert out[0] == out[1]


def test_autosave_mid_chunk_matches_gol_tpu(tmp_path):
    """Autosave boundaries fall inside what would be one diff chunk: the
    dispatch is clipped at each, the snapshots land exactly, and the
    stream (ImageOutputComplete included) equals gol_tpu's."""
    world = np.asarray(jl.random_world(64, 64, density=0.3, seed=2))
    (jevs, _), (tevs, _) = run_pair(
        tmp_path, world=world, turns=20, image_width=64, image_height=64,
        chunk=0, autosave_turns=6)
    # The IO thread reports a write when its bytes land: its event's
    # place in the stream is the thread's, so it is compared apart.
    got, want = normalize(tevs), normalize(jevs)
    for evs in (got, want):
        evs.sort(key=lambda e: e[0] == "ImageOutputComplete")
    assert got == want
    saved = sorted(int(f.stem.split("x")[-1])
                   for f in (tmp_path / "torch").glob("*.pgm"))
    assert saved == [6, 12, 18, 20]


def test_keys_serviced_between_chunks(tmp_path):
    """'q' lands at a chunk boundary: the run stops early with the
    snapshot and a clean close, every turn up to the stop emitted once
    and in order."""
    keys: queue.Queue = queue.Queue()
    world = glider_world(64, 64)
    p = gol_tpu_torch.Params(turns=10_000_000, image_width=64,
                             image_height=64, chunk=16,
                             out_dir=str(tmp_path), tick_seconds=60.0)
    engine = td.Engine(p, keypresses=keys, initial_world=world,
                       device="cpu")
    engine.start()
    deadline = time.monotonic() + 60
    while engine.completed_turns < 64 and time.monotonic() < deadline:
        time.sleep(0.01)
    keys.put("q")
    engine.join(60)
    assert engine.error is None
    evs = normalize(list(engine.events))
    final = engine.completed_turns
    assert 64 <= final < 10_000_000
    turns = [t for name, t, _ in evs if name == "TurnComplete"]
    assert turns == list(range(1, final + 1))
    assert evs[-1] == ("StateChange", final, "QUITTING")
    assert (tmp_path / f"64x64x{final}.pgm").exists()


@pytest.mark.parametrize("backend", ["packed", "dense"])
def test_level_mode_batches_match_gol_tpu(golden_root, tmp_path, backend):
    """B2/S345/C4 with FlipBatches: level mode, each batch carrying the
    changed cells' gray levels, identical to gol_tpu's."""
    from gol_tpu.io.pgm import read_pgm

    world = read_pgm(golden_root / "images" / "64x64.pgm")
    (jevs, _), (tevs, teng) = run_pair(
        tmp_path, world=world, engine_kw={"emit_flip_batches": True},
        turns=40, image_width=64, image_height=64, chunk=0,
        rule="B2/S345/C4", backend=backend)
    assert teng._gens_levels is not None
    got = normalize(tevs)
    assert got == normalize(jevs)
    batches = [payload for name, _, payload in got if name == "FlipBatch"]
    assert len(batches) == 41 and all(lv is not None for _, lv in batches)


def expand_chunks(evs) -> list:
    """Per-turn (turn, changed-word bitmap, words) of every FlipChunk —
    the payload independent of where chunks (and rides) were cut."""
    out = []
    for e in evs:
        if type(e).__name__ != "FlipChunk":
            continue
        off = 0
        for i, m in enumerate(np.asarray(e.counts)):
            m = int(m)
            out.append((e.first_turn + i,
                        np.asarray(e.bitmaps[i], np.uint32).tolist(),
                        np.asarray(e.words[off:off + m], np.uint32).tolist()))
            off += m
        assert off == len(e.words)
    return out


def test_flip_chunks_match_gol_tpu(tmp_path):
    """FlipChunk mode on the glider board: the same chunks as gol_tpu's,
    and the port took the chunk path (diffs dispatches and compact
    chunks rose)."""
    before = metric_values()
    (jevs, _), (tevs, _) = run_pair(
        tmp_path, world=glider_world(256, 256),
        engine_kw={"emit_flip_batches": True, "emit_flip_chunks": True},
        turns=61, image_width=256, image_height=256, chunk=7)
    got = normalize(tevs)
    assert got == normalize(jevs)
    assert [n for n, *_ in got].count("FlipChunk") == 9
    after = metric_values()
    assert after["diffs"] > before["diffs"]
    assert after["compact"] > before["compact"]


def test_cycle_ride_flip_chunks_match_gol_tpu(tmp_path):
    """A blinker board with cycle detection rides its proven period: no
    device dispatch for the ridden turns, and the FlipChunk payloads,
    expanded per turn, equal gol_tpu's (where each package cut its
    chunks depends on the wall clock)."""
    world = _blinker_world(64, 64, 10, 10)
    turns = 6_000
    before = metric_values()
    (jevs, _), (tevs, _) = run_pair(
        tmp_path, world=world,
        engine_kw={"emit_flip_batches": True, "emit_flip_chunks": True,
                   "cycle_check_seconds": 0.01},
        turns=turns, image_width=64, image_height=64, chunk=0,
        cycle_detect=True)
    after = metric_values()
    assert after["diffs"] > before["diffs"]
    assert after["compact"] > before["compact"]
    assert after["ride"] > before["ride"], "the ride never engaged"
    got, want = expand_chunks(tevs), expand_chunks(jevs)
    assert [t for t, *_ in got] == list(range(1, turns + 1))
    assert got == want
    rest = [e for e in normalize(tevs) if e[0] != "FlipChunk"]
    assert rest == [e for e in normalize(jevs) if e[0] != "FlipChunk"]
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_event_queue_batches():
    q = td.EventQueue()
    q.put_many(list(range(5)))
    assert q.get_batch(3) == [0, 1, 2]
    q.close()
    assert q.get_batch() == [3, 4]
    assert q.get_batch() is None
    assert q.consumed == 5


def test_chunk_sizing_and_cap_policy_match_gol_tpu(tmp_path):
    """The chunk budget (raised by a batching watcher's hint), the stack
    cap from the packed or dense row size, the sparse ceiling and the
    adaptive cap's sequence are gol_tpu's, on boards where each limit
    binds (16384²: 2 packed turns a pipelined chunk)."""
    peaks = (100, 300, 257, 60, 10**9, 0, 2000, 1300, 1000)
    for h, w, rule in ((512, 512, "B3/S23"), (480, 640, "B3/S23"),
                       (16384, 16384, "B3/S23"), (96, 64, "B2/S/C3")):
        engines = []
        for pkg, eng_mod in ((gol_tpu, jd), (gol_tpu_torch, td)):
            p = pkg.Params(turns=1, threads=1, image_width=w,
                           image_height=h, rule=rule,
                           out_dir=str(tmp_path), tick_seconds=60.0)
            extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
            engine = eng_mod.Engine(p, emit_flips=False, **extra)
            engine.batch_turns_hint = 512
            engines.append(engine)
        got = []
        for engine in engines:
            seen = [engine._diff_chunk_budget(), engine._sparse_cap_ceiling(),
                    engine._diff_chunk_cap(False), engine._diff_chunk_cap(True)]
            for peak in peaks:
                engine._adapt_sparse_cap(peak)
                seen.append(engine._sparse_cap)
            got.append(seen)
            engine.io.stop()
            engine.events.close()
        assert got[0] == got[1], (h, w)
        assert got[1][0] == 512
    engine = td.Engine(gol_tpu_torch.Params(turns=1, out_dir=str(tmp_path)),
                       device="cpu", batch_turns_hint=1024)
    assert engine._diff_chunk_budget() == 1024
    engine.io.stop()
    engine.events.close()
