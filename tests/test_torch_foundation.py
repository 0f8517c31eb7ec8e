"""The port's backend-free foundation against gol_tpu: rule models and the
rule compiler, PGM codec and IO service, events, cells, Params and the
numpy interop. Everything here is integer or byte data, so every
comparison is exact."""

import dataclasses
import queue
import threading

import numpy as np
import pytest

from gol_tpu import events as jev
from gol_tpu import params as jparams
from gol_tpu.io import pgm as jpgm
from gol_tpu.models import rules as jrules
from gol_tpu.ops import rulecomp as jrc
from gol_tpu.utils import cell as jcell
from gol_tpu_torch import events as tev
from gol_tpu_torch import interop
from gol_tpu_torch import params as tparams
from gol_tpu_torch.io import pgm as tpgm
from gol_tpu_torch.io.service import IOService
from gol_tpu_torch.models import rules as trules
from gol_tpu_torch.ops import rulecomp as trc
from gol_tpu_torch.utils import cell as tcell


def _random_rules(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        birth = frozenset(int(c) for c in np.flatnonzero(rng.random(9) < 0.35))
        survive = frozenset(int(c) for c in np.flatnonzero(rng.random(9) < 0.35))
        out.append((f"r{i}", birth, survive))
    return out


# --- rules and the rule compiler ---


@pytest.mark.parametrize("notation", sorted(jrules.RULES))
def test_named_rules_parse_equal(notation):
    j, t = jrules.get_rule(notation), trules.get_rule(notation)
    assert type(j).__name__ == type(t).__name__
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    assert str(j) == str(t)


@pytest.mark.parametrize("notation", ["b3/s23", " B36/S23 ", "B/S", "B2/S/C3"])
def test_rule_notation_variants_equal(notation):
    assert (dataclasses.astuple(jrules.get_rule(notation))
            == dataclasses.astuple(trules.get_rule(notation)))


@pytest.mark.parametrize("bad", ["B9/S23", "life", "B3S23", "B2/S/C1"])
def test_bad_rule_notation_raises_in_both(bad):
    with pytest.raises(ValueError):
        jrules.get_rule(bad)
    with pytest.raises(ValueError):
        trules.get_rule(bad)


def _plan_tuple(plan):
    return (plan.survive, plan.birth, plan.needed, plan.combine,
            plan.mask_cost())


@pytest.mark.parametrize(
    "notation",
    sorted(k for k, v in jrules.RULES.items() if isinstance(v, jrules.Rule)),
)
def test_compile_rule_named_equal(notation):
    j = jrc.compile_rule(jrules.get_rule(notation))
    t = trc.compile_rule(trules.get_rule(notation))
    assert _plan_tuple(j) == _plan_tuple(t)


@pytest.mark.parametrize("seed", range(4))
def test_compile_rule_random_sweep_equal(seed):
    for name, birth, survive in _random_rules(40, seed):
        j = jrc.compile_rule(jrules.Rule(name, birth, survive))
        t = trc.compile_rule(trules.Rule(name, birth, survive))
        assert _plan_tuple(j) == _plan_tuple(t), (birth, survive)
        for c in range(9):
            assert trc.evaluate_cover(t.birth, c) == (c in birth)
            assert trc.evaluate_cover(t.survive, c) == (c in survive)


# --- PGM codec and IO service ---


def _fixture_pgms(golden_root):
    return sorted((golden_root / "images").glob("*.pgm")) + sorted(
        (golden_root / "check" / "images").glob("*.pgm"))


def test_pgm_round_trip_byte_equal(golden_root, tmp_path):
    paths = _fixture_pgms(golden_root)
    assert paths
    for path in paths:
        raw = path.read_bytes()
        world = tpgm.read_pgm(path)
        assert np.array_equal(world, jpgm.read_pgm(path))
        assert tpgm.encode_pgm(world) == raw == jpgm.encode_pgm(world)
        out = tmp_path / "sub" / path.name
        tpgm.write_pgm(out, world)
        assert out.read_bytes() == raw
    # Crash-atomic write: no temp file is left behind.
    assert not [p for p in (tmp_path / "sub").iterdir()
                if p.name.startswith(".")]


def test_alive_cells_from_pgm_equal(golden_root):
    for path in _fixture_pgms(golden_root):
        assert (list(map(tuple, tpgm.alive_cells_from_pgm(path)))
                == list(map(tuple, jpgm.alive_cells_from_pgm(path))))


@pytest.mark.parametrize("bad", [b"P2\n2 2\n255\n\0\0\0\0", b"P5\n2 2\n15\n\0\0\0\0",
                                 b"P5\n2 2\n255\n\0\0", b"P5\n2"])
def test_pgm_rejects_bad_headers_like_gol_tpu(tmp_path, bad):
    path = tmp_path / "bad.pgm"
    path.write_bytes(bad)
    with pytest.raises(ValueError):
        jpgm.read_pgm(path)
    with pytest.raises(ValueError):
        tpgm.read_pgm(path)


def test_io_service_read_write(golden_root, tmp_path):
    io = IOService(str(golden_root / "images"), str(tmp_path))
    try:
        world = io.read("64x64")
        done: queue.Queue = queue.Queue()
        io.write("copy", world, lambda name, exc: done.put((name, exc)))
        assert done.get(timeout=10) == ("copy", None)
        assert io.check_idle()
        assert ((tmp_path / "copy.pgm").read_bytes()
                == (golden_root / "images" / "64x64.pgm").read_bytes())
        with pytest.raises(FileNotFoundError):
            io.read("missing")
    finally:
        io.stop()


# --- events and cells ---


def _scripted_events(ev, cell_mod):
    Cell = cell_mod.Cell
    return [
        ev.AliveCellsCount(3, 17),
        ev.ImageOutputComplete(5, "64x64x5"),
        ev.StateChange(7, ev.State.PAUSED),
        ev.StateChange(7, ev.State.EXECUTING),
        ev.StateChange(9, ev.State.QUITTING),
        ev.CellFlipped(2, Cell(3, 4)),
        ev.FlipBatch(2),
        ev.TurnComplete(8),
        ev.FinalTurnComplete(9, [Cell(1, 2)]),
        ev.BoardSync(4),
    ]


def test_event_strings_equal():
    j = _scripted_events(jev, jcell)
    t = _scripted_events(tev, tcell)
    assert [type(e).__name__ for e in j] == [type(e).__name__ for e in t]
    assert [str(e) for e in j] == [str(e) for e in t]
    assert [e.completed_turns for e in j] == [e.completed_turns for e in t]
    assert str(t[0]) == "17 Cells Alive"
    assert str(t[2]) == "State change to Paused"


def test_cells_from_mask_equal():
    mask = np.random.default_rng(5).random((37, 29)) < 0.3
    assert (list(map(tuple, tcell.cells_from_mask(mask)))
            == list(map(tuple, jcell.cells_from_mask(mask))))
    assert np.array_equal(tcell.xy_from_mask(mask), jcell.xy_from_mask(mask))


# --- Params ---


INVALID_PARAMS = [
    {"image_width": 0},
    {"image_height": -1},
    {"turns": -1},
    {"threads": 0},
    {"chunk": -1},
    {"tick_seconds": 0},
    {"backend": "nope"},
    {"autosave_turns": -1},
    {"autosave_seconds": -0.5},
    {"tile": 31},
    {"tile": -32},
]


@pytest.mark.parametrize("kw", INVALID_PARAMS, ids=lambda kw: str(kw))
def test_params_reject_the_same_inputs(kw):
    with pytest.raises(ValueError):
        jparams.Params(**kw)
    with pytest.raises(ValueError):
        tparams.Params(**kw)


def test_params_fields_and_names_equal():
    names = [f.name for f in dataclasses.fields(jparams.Params)]
    assert names == [f.name for f in dataclasses.fields(tparams.Params)]
    j = jparams.Params(turns=100, image_width=64, image_height=32)
    t = tparams.Params(turns=100, image_width=64, image_height=32)
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    assert (j.input_name, j.output_name(), j.output_name(7)) == (
        t.input_name, t.output_name(), t.output_name(7))


@pytest.mark.parametrize("kw", [{"mesh": "1x2"}, {"mesh": "2x2"},
                                {"partition_rules": "x=rows"},
                                {"tile": 64, "mesh": "2x2"}])
def test_params_unported_features_raise(kw):
    # Meshes and partition rules are ported: the same requests build
    # Params equal to gol_tpu's (make_stepper refuses what it cannot
    # build, as gol_tpu's does), as tiled stepping does.
    assert (dataclasses.astuple(tparams.Params(**kw))
            == dataclasses.astuple(jparams.Params(**kw)))
    assert tparams.Params(tile=64).tile == jparams.Params(tile=64).tile == 64


# --- interop ---


def test_packed_interop_is_bit_identical():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(4, 33), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0x80000000
    words[1, 1] = 0xFFFFFFFF
    t = interop.packed_from_numpy(words)
    assert str(t.dtype) == "torch.int32"
    back = interop.packed_to_numpy(t)
    assert back.dtype == np.uint32 and np.array_equal(back, words)
    assert int(t[0, 0]) == -(2**31)
    with pytest.raises(ValueError):
        interop.packed_from_numpy(words.astype(np.int64))


def test_world_and_rule_interop():
    world = (np.random.default_rng(2).random((8, 9)) < 0.5).astype(np.uint8) * 255
    assert np.array_equal(interop.world_from_numpy(world).numpy(), world)
    assert (dataclasses.astuple(interop.rule_from_spec("B36/S23"))
            == dataclasses.astuple(jrules.get_rule("B36/S23")))


# --- lock factory ---


def test_make_lock_plain_when_off():
    from gol_tpu_torch.analysis.concurrency import lockcheck

    lock = lockcheck.make_lock("T._plain")
    assert type(lock) is type(threading.Lock())
    with lock:
        assert lock.locked()
    assert not lock.locked()
