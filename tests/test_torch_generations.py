"""The port's Generations (B/S/C) path against gol_tpu's: the dense state
functions (ops/generations.py), the packed one-hot planes
(ops/bitgens.py), the Generations steppers, and the engine — rules
goldens, resume from a snapshot, state-1 alive payloads and per-turn
CellFlipped streams. Inputs are made from a seed with numpy and handed
to both packages; every comparison is exact (assert_array_equal)."""

import dataclasses
import queue
import random

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu.models.rules import GenRule as JGenRule
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitgens as jbg
from gol_tpu.ops import generations as jgen
from gol_tpu.ops import life as jl
from gol_tpu.parallel import stepper as js
from gol_tpu_torch import interop
from gol_tpu_torch.engine.distributor import Engine
from gol_tpu_torch.events import CellFlipped, FinalTurnComplete
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models.rules import GenRule as TGenRule
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import bitgens as tbg
from gol_tpu_torch.ops import generations as tgen
from gol_tpu_torch.parallel import stepper as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_rules(n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        birth = frozenset(k for k in range(9) if rng.random() < 0.3)
        survive = frozenset(k for k in range(9) if rng.random() < 0.3)
        out.append((f"r{i}", birth, survive, rng.randint(2, 9)))
    return out


#: (gol_tpu rule, port rule) pairs: the named rules, C = 2, 8 and 12,
#: and random rules (B0 included when drawn).
RULES = [(jrule(n), trule(n)) for n in (
    "B2/S/C3", "B2/S345/C4", "B3/S23/C2", "B36/S23/C8", "B3/S23/C12")] + [
    (JGenRule(*r), TGenRule(*r)) for r in _random_rules(4, seed=7)]
RULE_IDS = [str(j) for j, _ in RULES]


def random_states(rule, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, rule.states, (h, w)).astype(np.uint8)


# --- dense state functions ---


@pytest.mark.parametrize("jr,tr", RULES, ids=RULE_IDS)
def test_dense_state_functions_match(jr, tr):
    state = random_states(jr, 48, 40, seed=jr.states)
    t = torch.from_numpy(state)
    np.testing.assert_array_equal(
        tgen.step_states(t, tr).numpy(), np.asarray(jgen.step_states(state, jr)))
    jn, jc = jgen.step_n_counted_states(state, 9, jr)
    tn, tc = tgen.step_n_counted_states(t, 9, tr)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(tgen.step_n_states(t, 9, tr).numpy(),
                                  np.asarray(jn))
    jw, jm, jc1 = jgen.step_with_diff_states(jn, jr)
    tw, tm, tc1 = tgen.step_with_diff_states(tn, tr)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tc1) == int(jc1)


@pytest.mark.parametrize("jr,tr", RULES, ids=RULE_IDS)
def test_levels_match(jr, tr):
    np.testing.assert_array_equal(tgen.levels(tr), jgen.levels(jr))
    state = random_states(jr, 16, 24, seed=1)
    lv = jgen.levels_from_states(state, jr)
    np.testing.assert_array_equal(tgen.levels_from_states(state, tr), lv)
    np.testing.assert_array_equal(tgen.states_from_levels(lv, tr),
                                  jgen.states_from_levels(lv, jr))
    odd = np.random.default_rng(3).integers(0, 256, (16, 24)).astype(np.uint8)
    np.testing.assert_array_equal(tgen.states_from_levels(odd, tr),
                                  jgen.states_from_levels(odd, jr))


# --- packed one-hot planes ---


@pytest.mark.parametrize("jr,tr", RULES, ids=RULE_IDS)
def test_packed_planes_match(jr, tr):
    state = random_states(jr, 64, 48, seed=jr.states + 1)
    jp = np.asarray(jbg.pack_states(state, jr))
    tp = tbg.pack_states(state, tr)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tbg.unpack_states(tp, 64, tr),
                                  jbg.unpack_states(jp, 64, jr))
    planes = interop.planes_from_numpy(jp)
    np.testing.assert_array_equal(
        interop.planes_to_numpy(tbg.step_packed_gens(planes, tr)),
        np.asarray(jbg.step_packed_gens(jp, jr)))
    jn, jc = jbg.step_n_packed_gens(jp, 13, jr)
    tn, tc = tbg.step_n_packed_gens(planes, 13, tr)
    np.testing.assert_array_equal(interop.planes_to_numpy(tn), np.asarray(jn))
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(
        interop.planes_to_numpy(tbg.step_n_packed_gens_raw(planes, 13, tr)),
        np.asarray(jn))
    # ... and both equal the dense state step.
    np.testing.assert_array_equal(
        tbg.unpack_states(interop.planes_to_numpy(tn), 64, tr),
        np.asarray(jgen.step_n_states(state, 13, jr)))


def test_packable_and_planes_interop():
    assert tbg.packable_gens(64, 7) and not tbg.packable_gens(48, 64)
    assert not tbg.packable_gens(0, 64)
    rule = jrule("B2/S345/C4")
    planes = np.asarray(jbg.pack_states(random_states(rule, 64, 33, 4), rule))
    planes[0, 0, 0] = 0x80000000
    t = interop.planes_from_numpy(planes)
    assert t.dtype == torch.int32 and int(t[0, 0, 0]) == -(2**31)
    back = interop.planes_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, planes)
    with pytest.raises(ValueError):
        interop.planes_from_numpy(planes[0])
    with pytest.raises(TypeError):
        interop.planes_to_numpy(t[0])


# --- steppers ---


@pytest.mark.parametrize("notation,backend,h,name", [
    ("B2/S/C3", "auto", 64, "generations-packed-1"),
    ("B2/S/C3", "packed", 64, "generations-packed-1"),
    ("B2/S/C3", "cuda-packed", 64, "generations-cuda-packed-1"),
    ("B2/S/C3", "dense", 64, "generations-1"),
    ("B2/S/C3", "auto", 48, "generations-1"),       # unpackable height
    ("B3/S23/C12", "auto", 64, "generations-1"),    # auto keeps high C dense
    ("B3/S23/C12", "packed", 64, "generations-packed-1"),
])
def test_gens_stepper_names(notation, backend, h, name):
    s = ts.make_stepper(height=h, width=64, rule=notation, backend=backend,
                        device="cpu")
    assert s.name == name
    assert s.offers("alive_mask")


@pytest.mark.parametrize("kw", [
    {"rule": "B2/S/C3", "backend": "cuda-dense"},
    {"rule": "B2/S/C3", "backend": "pallas"},
    {"rule": "B2/S/C3", "backend": "packed", "height": 48},
    {"rule": "B2/S/C3", "backend": "cuda-packed", "height": 48},
    {"rule": "B3/S23", "backend": "pallas"},
])
def test_gens_and_dense_backend_errors(kw):
    kw = {"height": 64, "width": 64, **kw}
    with pytest.raises(ValueError):
        ts.make_stepper(device="cpu", **kw)
    if kw["backend"] in ("pallas", "packed") and "/C" in kw["rule"]:
        # gol_tpu refuses the same Generations requests.
        with pytest.raises(ValueError):
            js.make_stepper(threads=1, **kw)


def test_cuda_dense_backend_name_and_params():
    assert ts.make_stepper(height=48, width=40, backend="cuda-dense",
                           device="cpu").name == "single-cuda-dense"
    gol_tpu_torch.Params(backend="cuda-dense")
    with pytest.raises(ValueError, match="unknown backend"):
        gol_tpu_torch.Params(backend="pallas")


@pytest.mark.parametrize("backend", ["dense", "packed", "cuda-packed"])
@pytest.mark.parametrize("notation", ["B2/S/C3", "B2/S345/C4"])
def test_gens_core_entries_match_gol_tpu(backend, notation):
    jst = js.make_stepper(threads=1, height=64, width=64, rule=notation,
                          backend={"cuda-packed": "packed"}.get(backend, backend))
    tst = ts.make_stepper(height=64, width=64, rule=notation, backend=backend,
                          device="cpu")
    rule = jrule(notation)
    levels = jgen.levels_from_states(random_states(rule, 64, 64, 9), rule)
    jp, tp = jst.put(levels), tst.put(levels)
    np.testing.assert_array_equal(tst.fetch(tp), jst.fetch(jp))
    np.testing.assert_array_equal(tst.fetch(tst.step(tp)),
                                  jst.fetch(jst.step(jp)))
    jn, jc = jst.step_n(jp, 21)
    tn, tc = tst.step_n(tp, 21)
    np.testing.assert_array_equal(tst.fetch(tn), jst.fetch(jn))
    assert int(tc) == int(jc)
    jw, jm, jc1 = jst.step_with_diff(jn)
    tw, tm, tc1 = tst.step_with_diff(tn)
    np.testing.assert_array_equal(tst.fetch(tw), jst.fetch(jw))
    np.testing.assert_array_equal(tst.fetch(tm), np.asarray(jm))
    assert tst.fetch(tm).dtype == np.bool_   # masks pass through fetch
    assert int(tc1) == int(jc1)
    assert tst.alive_count(tw) == jst.alive_count(jw)
    host = tst.fetch(tw)
    np.testing.assert_array_equal(tst.alive_mask(host), jst.alive_mask(host))
    assert tst.alive_mask(host).sum() == int(tc1)


# --- engine ---


def params_kw(golden_root, out, **kw):
    d = dict(image_dir=str(golden_root / "images"), out_dir=str(out),
             tick_seconds=60.0, image_width=64, image_height=64)
    d.update(kw)
    return d


def run_engine(params, **kw):
    engine = Engine(params, emit_flips=False, device="cpu", **kw)
    engine.start()
    evs = list(engine.events)
    engine.join(timeout=120)
    assert not engine._thread.is_alive()
    if engine.error is not None:
        raise engine.error
    return evs


@pytest.mark.parametrize("turns", [1, 100])
@pytest.mark.parametrize("notation", ["B2/S/C3", "B2/S345/C4"])
def test_cpu_run_matches_rules_goldens(golden_root, tmp_path, notation, turns):
    p = gol_tpu_torch.Params(**params_kw(golden_root, tmp_path, turns=turns,
                                         rule=notation))
    evs = run_engine(p)
    name = f"64x64x{turns}"
    got = (tmp_path / f"{name}.pgm").read_bytes()
    golden = golden_root / "check" / "rules" / f"{name}_{notation.replace('/', '_')}.pgm"
    assert got == golden.read_bytes()
    # FinalTurnComplete lists the state-1 cells only, not the dying ones.
    final = [e for e in evs if isinstance(e, FinalTurnComplete)][0]
    levels = read_pgm(golden)
    alive = {(c.x, c.y) for c in final.alive}
    assert alive == {(int(x), int(y)) for y, x in zip(*np.nonzero(levels == 255))}
    if turns == 1:  # one turn in, the board holds dying cells too
        assert len(alive) < int(np.count_nonzero(levels))


@pytest.mark.parametrize("backend", ["auto", "cuda-packed", "dense"])
def test_run_then_resume_is_byte_identical(golden_root, tmp_path, backend):
    """A gray-level snapshot is a complete checkpoint: a 40-turn run
    equals a 20-turn run resumed from its snapshot for 20 more."""
    kw = dict(turns=40, rule="B2/S/C3", chunk=4, backend=backend)
    run_engine(gol_tpu_torch.Params(**params_kw(golden_root, tmp_path / "full", **kw)))
    run_engine(gol_tpu_torch.Params(**params_kw(
        golden_root, tmp_path / "half", **{**kw, "turns": 20})))
    snap = read_pgm(tmp_path / "half" / "64x64x20.pgm")
    run_engine(gol_tpu_torch.Params(**params_kw(golden_root, tmp_path / "res", **kw)),
               initial_world=snap, start_turn=20)
    direct = (tmp_path / "full" / "64x64x40.pgm").read_bytes()
    assert (tmp_path / "res" / "64x64x40.pgm").read_bytes() == direct
    want = tgen.levels_from_states(np.asarray(jgen.step_n_states(
        jgen.states_from_levels(read_pgm(golden_root / "images" / "64x64.pgm"),
                                jrule("B2/S/C3")), 40, jrule("B2/S/C3"))),
        jrule("B2/S/C3"))
    np.testing.assert_array_equal(read_pgm(tmp_path / "full" / "64x64x40.pgm"), want)


def _normalize(evs):
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
        else:
            payload = None
        out.append((name, e.completed_turns, payload))
    return out


@pytest.mark.parametrize("notation", ["B2/S/C3", "B2/S345/C4"])
def test_per_turn_flip_streams_equal_gol_tpu(golden_root, tmp_path, notation):
    """emit_flips: the opening burst lists the state-1 cells, then one
    CellFlipped per CHANGED cell each turn — event for event as gol_tpu
    emits them."""
    streams = []
    for pkg, tag in ((gol_tpu, "jax"), (gol_tpu_torch, "torch")):
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        p = pkg.Params(**params_kw(golden_root, tmp_path / tag, turns=12,
                                   threads=1, rule=notation))
        streams.append(_normalize(pkg.run(p, keypresses=queue.Queue(), **extra)))
    jevs, tevs = streams
    assert tevs == jevs
    flips = [(t, c) for n, t, c in tevs if n == "CellFlipped"]
    opening = {c for t, c in flips if t == 0}
    world = read_pgm(golden_root / "images" / "64x64.pgm")
    assert len(opening) == int(np.count_nonzero(world == 255))
    assert any(t > 0 for t, _ in flips)
    assert (tmp_path / "torch" / "64x64x12.pgm").read_bytes() == (
        tmp_path / "jax" / "64x64x12.pgm").read_bytes()


def test_cuda_dense_backend_run_matches_golden(golden_root, tmp_path):
    p = gol_tpu_torch.Params(**params_kw(golden_root, tmp_path, turns=100,
                                         backend="cuda-dense"))
    run_engine(p)
    assert (tmp_path / "64x64x100.pgm").read_bytes() == (
        golden_root / "check" / "images" / "64x64x100.pgm").read_bytes()


# --- CLI ---


def test_cli_rule_errors_exit_cleanly(tmp_path):
    from gol_tpu_torch import cli

    with pytest.raises(SystemExit, match="^error: bad B/S rule"):
        cli.main(["-w", "64", "-h", "64", "-turns", "1", "-noVis",
                  "--platform", "cpu", "--rule", "B9/S23",
                  "--out", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="^error: generations rule"):
        cli.main(["-noVis", "--platform", "cpu", "--rule", "B2/S/C300",
                  "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    help_text = cli.build_parser().format_help()
    assert "B/S/C" in help_text and "cuda-dense" in help_text


def test_cli_generations_run_on_cpu(golden_root, tmp_path, capsys):
    from gol_tpu_torch import cli

    rc = cli.main(["-w", "64", "-h", "64", "-turns", "100", "-noVis",
                   "--rule", "B2/S345/C4", "--platform", "cpu",
                   "--images", str(golden_root / "images"),
                   "--out", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "64x64x100.pgm").read_bytes() == (
        golden_root / "check" / "rules" / "64x64x100_B2_S345_C4.pgm").read_bytes()


def test_rule_objects_agree():
    for j, t in RULES:
        assert dataclasses.astuple(j) == dataclasses.astuple(t)


def test_cycle_fast_forward_compares_plane_stacks(golden_root, tmp_path):
    """engine/cycles.py compares whole (C-1, H/32, W) plane stacks: a
    Brian's Brain board that has died out is provably periodic, so a
    10**9-turn run ends at once with the board it reached at turn 100."""
    p = gol_tpu_torch.Params(**params_kw(golden_root, tmp_path, turns=10**9,
                                         rule="B2/S/C3", cycle_detect=True))
    engine = Engine(p, emit_flips=False, device="cpu", cycle_check_seconds=0.05)
    assert engine.stepper.name == "generations-packed-1"
    engine.start()
    list(engine.events)
    engine.join(timeout=120)
    assert engine.error is None and engine.skipped_turns > 0
    assert (tmp_path / f"64x64x{10**9}.pgm").read_bytes() == (
        golden_root / "check" / "rules" / "64x64x100_B2_S_C3.pgm").read_bytes()
