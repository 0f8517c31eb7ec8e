"""The port's rings of shards (gol_tpu_torch/parallel/{halo,packed_halo,
gens_halo}.py) against gol_tpu's, on the CPU.

gol_tpu's rings run over its forced host devices (`jax.devices()[:k]`);
the port's over ``["cpu"] * k``. From the same numpy soup both step the
same schedule of chunks at gol_tpu's seams — the packed Life ring at
512/4, 1024/4, 3072/2 and 128/2 shards, its balanced split at 1504/3,
the dense ring at 64/4 and 100/3 rows (the balanced split), the packed
Generations ring at 512/4 and its balanced split at 1504/3, the dense
Generations ring at 100/3 — and the boards, the alive counts, the
global placed states (padding included), the single-turn diff masks,
the diff scans (dense stacks through `fetch_diffs`, sparse rows,
compact headers and values, caps that fit and overflow) and the
engine's watched event streams are bit-identical. Also the local-block
planner's modes with `force_local_kernel` against gol_tpu's
`force_local_pallas`, `halo_cost` where both run the same plan, the
mid-run state carried across (`interop.sharded_from_numpy`), and the
build errors. Exact comparisons throughout: the automaton is
integer-deterministic. The kernels themselves run on the card
(chip_smoke.py); here their wrappers run the plain versions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu.engine import distributor as jd
from gol_tpu.parallel import packed_halo as jph
from gol_tpu.parallel.stepper import make_stepper as jmake
from gol_tpu_torch import interop
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.parallel import gens_halo as tgh
from gol_tpu_torch.parallel import packed_halo as tph
from gol_tpu_torch.parallel.stepper import make_stepper as tmake


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def soup(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < 0.35) * 255).astype(np.uint8)


def host(x) -> np.ndarray:
    """A device output of either package as numpy, int32 rows viewed as
    the uint32 words they carry."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def pair(k, h, w, rule="B3/S23", backend="auto", **kw):
    """gol_tpu's and the port's stepper for one request."""
    j = jmake(threads=k, height=h, width=w, rule=rule, backend=backend,
              devices=jax.devices()[:k])
    t = tmake(threads=k, height=h, width=w, rule=rule, backend=backend,
              devices=["cpu"] * k, **kw)
    return j, t


#: (shards, height, width, rule, backend, gol_tpu's stepper name).
SEAMS = [
    (4, 512, 64, "B3/S23", "auto", "packed-halo-ring-4"),
    (4, 1024, 64, "B3/S23", "auto", "packed-halo-ring-4"),
    (2, 3072, 64, "B3/S23", "auto", "packed-halo-ring-2"),
    (3, 1504, 64, "B3/S23", "auto", "packed-halo-ring-uneven-3"),
    (2, 128, 64, "B3/S23", "auto", "packed-halo-ring-2"),
    (4, 64, 64, "B3/S23", "dense", "halo-ring-4"),
    (3, 100, 64, "B36/S23", "auto", "halo-ring-uneven-3"),
    (4, 512, 64, "B2/S/C3", "auto", "gens-packed-halo-ring-4"),
    (3, 1504, 64, "B2/S345/C4", "auto", "gens-packed-halo-ring-uneven-3"),
    (3, 100, 64, "B2/S/C3", "auto", "gens-halo-ring-uneven-3"),
]
#: Chunks stepped in order: none, one turn, each side of a 32-turn
#: block, and each side of four — at one seam of each family (the
#: first four below); the others step one turn, a block and a bit, and
#: four blocks and a bit (gol_tpu compiles a program per chunk length).
TURNS = (0, 1, 31, 32, 33, 128, 129)
SHORT = (1, 33, 129)
FULL = {(4, 512, "B3/S23"), (3, 1504, "B3/S23"), (3, 100, "B36/S23"),
        (4, 512, "B2/S/C3")}


def seam_id(seam) -> str:
    k, h, w, rule, backend, _ = seam
    return f"{h}x{w}-{k}-{rule.replace('/', '')}-{backend}"


@pytest.mark.parametrize("seam", SEAMS, ids=seam_id)
def test_ring_boards_match_gol_tpu(seam):
    k, h, w, rule, backend, name = seam
    j, t = pair(k, h, w, rule, backend)
    assert j.name == t.name == name
    assert t.shards == j.shards == k
    assert t.capabilities() == j.capabilities()
    world = soup(h, w, seed=h + k)
    jp, tp = j.put(world), t.put(world)
    assert tp.shape == jp.shape
    done = 0
    for n in TURNS if (k, h, rule) in FULL else SHORT:
        jp, jc = j.step_n(jp, n)
        tp, tc = t.step_n(tp, n)
        done += n
        assert int(tc) == int(jc), (done, int(tc), int(jc))
        np.testing.assert_array_equal(t.fetch(tp), j.fetch(jp),
                                      err_msg=f"after {done} turns")
        np.testing.assert_array_equal(interop.sharded_to_numpy(tp),
                                      np.asarray(jp))
    assert int(t.alive_count_async(tp)) == int(j.alive_count_async(jp))
    jn, jm, jc = j.step_with_diff(jp)
    tn, tm, tc = t.step_with_diff(tp)
    np.testing.assert_array_equal(t.fetch(tm), j.fetch(jm))
    np.testing.assert_array_equal(t.fetch(tn), j.fetch(jn))
    np.testing.assert_array_equal(t.fetch(t.step(tp)), j.fetch(j.step(jp)))
    assert int(tc) == int(jc)
    if t.alive_mask is not None:
        levels = t.fetch(tn)
        np.testing.assert_array_equal(t.alive_mask(levels),
                                      j.alive_mask(levels))


#: Boards of the diff scans: each family's even and balanced ring.
SCAN_SEAMS = [SEAMS[0], SEAMS[3], SEAMS[6], SEAMS[7], SEAMS[8]]


@pytest.mark.parametrize("seam", SCAN_SEAMS, ids=seam_id)
def test_ring_diff_scans_match_gol_tpu(seam):
    """Every diff entry of the ring, 5 turns from a soup: the dense stack
    through `fetch_diffs` (padding stripped), and on the packed rings the
    sparse rows and the compact headers and value buffer at a cap that
    overflows and one that fits."""
    k, h, w, rule, backend, _ = seam
    j, t = pair(k, h, w, rule, backend)
    world = soup(h, w, seed=7)
    jn, jd_, jc = j.step_n_with_diffs(j.put(world), 5)
    tn, td_, tc = t.step_n_with_diffs(t.put(world), 5)
    np.testing.assert_array_equal(host(t.fetch_diffs(td_)),
                                  host(j.fetch_diffs(jd_)))
    np.testing.assert_array_equal(t.fetch(tn), j.fetch(jn))
    assert int(tc) == int(jc)
    if not t.offers("step_n_with_diffs_sparse"):
        return
    words = h // 32 * w
    for cap in (8, words):
        _, jr, _ = j.step_n_with_diffs_sparse(j.put(world), 5, cap)
        _, tr, _ = t.step_n_with_diffs_sparse(t.put(world), 5, cap)
        np.testing.assert_array_equal(host(tr), host(jr))
        _, jh, jv, _ = j.step_n_with_diffs_compact(j.put(world), 5, cap)
        _, th, tv, _ = t.step_n_with_diffs_compact(t.put(world), 5, cap)
        np.testing.assert_array_equal(host(th), host(jh))
        np.testing.assert_array_equal(host(tv), host(jv))


def test_mid_run_state_crosses_packages():
    """gol_tpu's balanced ring steps 37 turns; its global state (padding
    included) is placed as the port's world, and both step 40 more."""
    j, t = pair(3, 1504, 64)
    world = soup(1504, 64, seed=3)
    jp, _ = j.step_n(j.put(world), 37)
    tp = interop.sharded_from_numpy(np.asarray(jp), like=t.put(world))
    jp, jc = j.step_n(jp, 40)
    tp, tc = t.step_n(tp, 40)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(interop.sharded_to_numpy(tp),
                                  np.asarray(jp))
    with pytest.raises(ValueError, match="does not match"):
        interop.sharded_from_numpy(np.zeros((3, 64), np.uint32), like=tp)


@pytest.mark.parametrize("h,w,k,force,want", [
    (1504, 128, 3, True, (4, "whole")),
    (3072, 8192, 2, True, (2, "tiled2d")),
])
def test_force_local_kernel_matches_force_local_pallas(h, w, k, force,
                                                       want):
    """The kernel plans on the CPU (their wrappers' plain versions)
    against gol_tpu's Pallas local blocks in interpret mode, at the
    smallest seams gol_tpu's own tests take each mode at: whole blocks
    on the balanced split (1504/3) and 2-D tiled blocks on wide shards
    (3072/2 at 8192 columns); 34 turns are one partial block."""
    from gol_tpu.models.rules import LIFE as JLIFE
    from gol_tpu_torch.models.rules import LIFE

    size, real = tph.balanced_words(h, k)
    assert tph.local_block_mode(size, w, on_card=False, force=force,
                                max_h=min(real)) == want
    build_j = (jph.packed_sharded_stepper_uneven if h % (32 * k)
               else jph.packed_sharded_stepper)
    build_t = (tph.packed_sharded_stepper_uneven if h % (32 * k)
               else tph.packed_sharded_stepper)
    j = build_j(JLIFE, jax.devices()[:k], h, force_local_pallas=True)
    t = build_t(LIFE, ["cpu"] * k, h, w, force_local_kernel=True)
    world = soup(h, w, seed=11)
    jp, jc = j.step_n(j.put(world), 34)
    tp, tc = t.step_n(t.put(world), 34)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(interop.sharded_to_numpy(tp),
                                  np.asarray(jp))


def test_tiled_mode_gens_ring_matches_gol_tpu():
    """The strip entry of kernel D (``tiled``) on a Generations ring:
    the planner's pick for B2/S345/C4 on 8-word strips 1024 columns
    wide, forced on the CPU, against gol_tpu's ring."""
    rule = trule("B2/S345/C4")
    assert tgh.gens_local_block_mode(8, 1024, rule, on_card=False,
                                     force=True) == (4, "tiled")
    j, _ = pair(2, 512, 1024, "B2/S345/C4")
    t = tgh.packed_gens_sharded_stepper(rule, ["cpu"] * 2, 512, 1024,
                                        force_local_kernel=True)
    world = soup(512, 1024, seed=5)
    jp, jc = j.step_n(j.put(world), 160)
    tp, tc = t.step_n(t.put(world), 160)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(t.fetch(tp), j.fetch(jp))


def test_planner_modes_and_refusals():
    """None: plain on the CPU, the kernel plan on a CUDA device; False
    is refused on a CUDA device; h never passes the strip or the
    shortest shard; a block no kernel takes raises, naming its shape."""
    assert tph.local_block_mode(8, 128, on_card=False) == (1, "plain")
    assert tph.local_block_mode(8, 128, on_card=True) == (4, "whole")
    assert tph.local_block_mode(8, 128, on_card=False,
                                force=False) == (1, "plain")
    with pytest.raises(ValueError, match="CPU only"):
        tph.local_block_mode(8, 128, on_card=True, force=False)
    assert tph.local_block_mode(2, 64, on_card=True) == (2, "whole")
    assert tph.local_block_mode(16, 512, on_card=True,
                                max_h=3) == (3, "whole")
    assert tph.local_block_mode(128, 16384, on_card=True)[1] in (
        "tiled", "tiled2d")
    with pytest.raises(ValueError, match="fits no kernel plan"):
        tph.plan_local_blocks(8, 128, True, None, 2,
                              lambda h, w: False, max_h=0)


@pytest.mark.parametrize("h,k,backend,force", [
    (512, 4, "auto", False), (1504, 3, "auto", False),
    (64, 4, "dense", None), (100, 3, "auto", None),
    (1024, 4, "auto", True),
])
def test_halo_cost_matches_gol_tpu(h, k, backend, force):
    """Where both packages run the same plan — one-word ghosts off the
    kernels (gol_tpu's ``xla``, the port's ``plain``), the dense rings'
    deep rows, and 4-word ``whole`` blocks on 8-word strips — the
    priced exchanges and bytes are equal for every chunk and per-turn."""
    w = 128
    if force is None:
        j, t = pair(k, h, w, backend=backend)
    else:
        size, real = tph.balanced_words(h, k)
        jb = (jph.packed_sharded_stepper_uneven if h % (32 * k)
              else jph.packed_sharded_stepper)
        tb = (tph.packed_sharded_stepper_uneven if h % (32 * k)
              else tph.packed_sharded_stepper)
        from gol_tpu.models.rules import LIFE as JLIFE
        from gol_tpu_torch.models.rules import LIFE

        j = jb(JLIFE, jax.devices()[:k], h, force_local_pallas=force)
        t = tb(LIFE, ["cpu"] * k, h, w, force_local_kernel=force)
    world = soup(h, w, seed=1)
    jw, tw = j.put(world), t.put(world)
    for n in TURNS + (1000,):
        for per_turn in (False, True):
            assert (t.halo_cost(tw, n, per_turn)
                    == j.halo_cost(jw, n, per_turn)), (n, per_turn)


def test_ring_build_errors_match_gol_tpu():
    """The explicit impossible requests fail with gol_tpu's texts."""
    cases = [
        dict(threads=3, height=100, width=64, backend="packed"),
        dict(threads=4, height=96, width=64, rule="B2/S/C3",
             backend="packed"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as je:
            jmake(devices=jax.devices()[:kw["threads"]], **kw)
        with pytest.raises(ValueError) as te:
            tmake(devices=["cpu"] * kw["threads"], **kw)
        assert str(te.value) == str(je.value)
    for backend in ("cuda-packed", "cuda-dense"):
        with pytest.raises(ValueError, match="single-device only"):
            tmake(threads=2, height=64, width=64, backend=backend,
                  devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not balance-packable"):
        tph.packed_sharded_stepper_uneven(trule("B3/S23"), ["cpu"] * 2,
                                          128, 64)
    with pytest.raises(ValueError, match="whole-word strips"):
        tgh.packed_gens_sharded_stepper(trule("B2/S/C3"), ["cpu"] * 3,
                                        128, 64)
    # One device, or the CPU without a device list: one shard.
    assert tmake(threads=8, height=64, width=64,
                 device="cpu").name == "single-packed"


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
    world = np.zeros((h, w), np.uint8)
    for dx, dy in ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2)):
        world[4 + dy, 4 + dx] = 255
        world[40 + dy, 40 + dx] = 255
    world[20, 20:23] = 255
    return world


@pytest.mark.parametrize("case", [
    dict(k=4, h=256, w=64, rule="B3/S23", engine={}, mode="auto"),
    dict(k=3, h=224, w=64, rule="B3/S23",
         engine={"emit_flip_chunks": True}, mode="overflow"),
    dict(k=3, h=100, w=64, rule="B3/S23", engine={}, mode="auto"),
    dict(k=3, h=224, w=64, rule="B2/S/C3",
         engine={"emit_flip_batches": True}, mode="auto"),
], ids=["packed", "balanced-chunks-redo", "dense", "gens-levels"])
def test_engine_ring_streams_match_gol_tpu(tmp_path, case):
    """A watched run through each package's Engine with its ring
    injected: the per-cell stream (dense, sparse and compact chunks),
    FlipChunks with a forced compact overflow redone from the chunk's
    input, the dense ring's masks and level-mode FlipBatches are event
    for event gol_tpu's."""
    streams = []
    for pkg, eng_mod, devs, make in (
            (gol_tpu, jd, jax.devices()[:case["k"]], jmake),
            (gol_tpu_torch, td, ["cpu"] * case["k"], tmake)):
        p = pkg.Params(out_dir=str(tmp_path / pkg.__name__),
                       tick_seconds=60.0, threads=case["k"], turns=45,
                       image_width=case["w"], image_height=case["h"],
                       rule=case["rule"], chunk=7)
        st = make(threads=case["k"], height=case["h"], width=case["w"],
                  rule=case["rule"], devices=devs)
        if case["mode"] == "mask":
            st = dataclasses.replace(st, step_n_with_diffs_sparse=None,
                                     step_n_with_diffs_compact=None)
        engine = eng_mod.Engine(p, stepper=st,
                                initial_world=glider_world(case["h"],
                                                           case["w"]),
                                **case["engine"])
        if case["mode"] == "overflow":
            engine._compact_total_cap = lambda k: 4
        engine.start()
        evs = list(engine.events)
        engine.join(60)
        assert engine.error is None, engine.error
        streams.append(normalize(evs))
    assert streams[1] == streams[0]
    assert any(name == "FinalTurnComplete" for name, _, _ in streams[1])
