"""The port's runtime invariant checker against gol_tpu's.

The same synthetic event streams and dispatch chains go through both
packages' `EventStreamChecker` and `DispatchLinearityChecker`, and the
verdicts (accepted, or the violation's message) must be equal; a real
`checked_stepper` of each package raises on a stale world and on a
wrong redo input; and an engine run under GOL_TPU_CHECK_INVARIANTS=1 —
per-cell flips, FlipBatch, a forced compact overflow (redo), the cycle
ride — builds a `checked-` stepper in both packages, observes no
violation, and emits gol_tpu's event stream.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu import events as jev
from gol_tpu.analysis import invariants as ji
from gol_tpu.engine import distributor as jd
from gol_tpu.parallel import stepper as js
from gol_tpu_torch import events as tev
from gol_tpu_torch.analysis import invariants as ti
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.parallel import stepper as ts
from test_torch_diffs import (
    _blinker_world,
    expand_chunks,
    glider_world,
    normalize,
)

PACKAGES = ((ji, jev), (ti, tev))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _event(ev, item):
    kind, turn, *rest = item
    if kind == "batch":
        return ev.FlipBatch(turn, np.zeros((rest[0] if rest else 1, 2),
                                           np.int32))
    if kind == "cell":
        return ev.CellFlipped(turn, (rest or [(0, 0)])[0])
    if kind == "tc":
        return ev.TurnComplete(turn)
    if kind == "sync":
        return ev.BoardSync(turn, None, 1)
    if kind == "chunk":
        return ev.FlipChunk(rest[0], first_turn=turn)
    if kind == "final":
        return ev.FinalTurnComplete(turn, [])
    raise ValueError(kind)


def _stream_verdict(inv, ev, stream):
    """(events observed, None) or (index of the rejected event, the
    violation's message)."""
    c = inv.EventStreamChecker()
    for i, item in enumerate(stream):
        try:
            c.observe(_event(ev, item))
        except inv.InvariantViolation as e:
            return i, str(e)
    return c.observed, None


# (name, stream, the rejection's message fragment or None): gol_tpu's
# tests/test_analysis.py cases, plus FlipChunk and FinalTurnComplete.
STREAMS = [
    ("reference-stream",
     [("batch", 0, 5)] + [x for t in range(1, 6)
                          for x in (("batch", t), ("tc", t))]
     + [("sync", 5), ("batch", 6), ("tc", 6)], None),
    ("per-cell", [("cell", 0), ("cell", 1), ("cell", 1, (1, 1)), ("tc", 1)],
     None),
    ("chunks", [("batch", 0, 3), ("chunk", 1, 4), ("chunk", 5, 9),
                ("final", 9)], None),
    ("flipbatch-after-sync", [("sync", 5), ("batch", 5)],
     "already in the synced"),
    ("flips-straddling-sync", [("tc", 2), ("batch", 3), ("sync", 3)],
     "straddle"),
    ("broken-adjacency", [("tc", 2), ("batch", 3), ("tc", 4)], "adjacency"),
    ("stale-turn", [("tc", 5), ("tc", 7), ("tc", 6)], "non-monotone"),
    ("stale-per-cell-flip", [("cell", 1), ("tc", 1), ("cell", 1, (1, 1))],
     "stale"),
    ("stale-chunk", [("tc", 5), ("chunk", 3, 8)], "stale FlipChunk"),
    ("chunk-over-pending", [("tc", 1), ("batch", 2), ("chunk", 3, 4)],
     "unflushed"),
    ("malformed-chunk", [("chunk", 5, 4)], "malformed FlipChunk"),
    ("stale-final", [("tc", 7), ("final", 6)], "stale final"),
]


@pytest.mark.parametrize("stream,fragment",
                         [s[1:] for s in STREAMS], ids=[s[0] for s in STREAMS])
def test_stream_checker_verdicts_match_gol_tpu(stream, fragment):
    (jn, jmsg), (tn, tmsg) = (_stream_verdict(inv, ev, stream)
                              for inv, ev in PACKAGES)
    assert (tn, tmsg) == (jn, jmsg)
    if fragment is None:
        assert tmsg is None and tn == len(stream)
    else:
        assert fragment in tmsg and tn == len(stream) - 1


def _w():
    return torch.zeros(2)


# Scripted dispatch chains over worlds w0..w5: ("put", i), ("dispatch",
# i, j), ("sparse", i, j), ("redo", i) or ("foreign",) — gol_tpu's
# tests/test_analysis.py chains.
CHAINS = [
    ("linear-and-pipelined",
     [("put", 0), ("dispatch", 0, 1), ("sparse", 1, 2), ("sparse", 2, 3),
      ("redo", 1), ("redo", 2)], None),
    ("stale-cap-double-redo",
     [("put", 0), ("sparse", 0, 1), ("sparse", 1, 2), ("redo", 0),
      ("dispatch", 2, 3), ("redo", 1)], None),
    ("foreign-world",
     [("put", 0), ("dispatch", 0, 1), ("foreign",)], "no recent dispatch"),
    ("retired-sparse-pair",
     [("put", 0), ("sparse", 0, 1), ("dispatch", 1, 2), ("dispatch", 2, 3),
      ("redo", 0)], "no sparse"),
    ("redo-without-sparse", [("put", 0), ("redo", 0)], "no sparse"),
    ("redo-of-output", [("put", 0), ("sparse", 0, 1), ("redo", 1)], "exact"),
    ("stale-beyond-window",
     [("put", 0)] + [("dispatch", i, i + 1) for i in range(5)]
     + [("dispatch", 0, 1)], "no recent dispatch"),
]


def _chain_verdict(inv, chain):
    worlds = [_w() for _ in range(6)]
    c = inv.DispatchLinearityChecker()
    for i, op in enumerate(chain):
        try:
            if op[0] == "put":
                c.put(worlds[op[1]])
            elif op[0] == "dispatch":
                c.dispatch(worlds[op[1]], worlds[op[2]], "step_n")
            elif op[0] == "sparse":
                c.sparse(worlds[op[1]], worlds[op[2]])
            elif op[0] == "redo":
                c.redo(worlds[op[1]])
            else:
                c.dispatch(_w(), None, "step_n")
        except inv.InvariantViolation as e:
            # Object ids differ between runs: compare the message's text.
            return i, str(e).split(" (")[0]
    return len(chain), None


@pytest.mark.parametrize("chain,fragment", [c[1:] for c in CHAINS],
                         ids=[c[0] for c in CHAINS])
def test_dispatch_checker_verdicts_match_gol_tpu(chain, fragment):
    jv, tv = (_chain_verdict(inv, chain) for inv, _ in PACKAGES)
    assert tv == jv
    if fragment is None:
        assert tv == (len(chain), None)
    else:
        assert tv[0] == len(chain) - 1 and fragment in tv[1]


def test_dispatch_checker_does_not_pin_tensors():
    c = ti.DispatchLinearityChecker()
    w0, w1 = _w(), _w()
    c.put(w0)
    c.dispatch(w0, w1, "step_n")
    refs = weakref.ref(w0), weakref.ref(w1)
    del w0, w1
    gc.collect()
    assert all(r() is None for r in refs)


def _dummy_stepper(mod, arr):
    """A host-only Stepper of package `mod` whose dispatches return
    fresh arrays (`arr` builds a world) — gol_tpu's
    tests/test_analysis.py dummy."""
    return mod.Stepper(
        name="dummy", shards=1,
        put=lambda w: arr(w),
        fetch=np.asarray,
        step=lambda w: w + 0,
        step_n=lambda w, k: (w + 0, 0),
        step_with_diff=lambda w: (w + 0, w != w, 0),
        alive_count_async=lambda w: 0,
        step_n_with_diffs=lambda w, k: (w + 0, "dense", 0),
        step_n_with_diffs_sparse=lambda w, k, cap: (w + 0, "sparse", 0),
    )


@pytest.mark.parametrize("mod,inv,arr", [
    (js, ji, lambda w: np.asarray(w, np.uint8)),
    (ts, ti, lambda w: torch.as_tensor(np.asarray(w, np.uint8))),
], ids=["gol_tpu", "port"])
def test_checked_stepper_enforces_redo_contract(mod, inv, arr):
    s = inv.checked_stepper(_dummy_stepper(mod, arr))
    w0 = s.put(np.zeros((4, 4)))
    w1, _, _ = s.step_n_with_diffs_sparse(w0, 4, 16)
    with pytest.raises(inv.InvariantViolation):
        s.step_n_with_diffs_redo(w1, 4)  # redo must consume w0, not w1
    s2 = inv.checked_stepper(_dummy_stepper(mod, arr))
    w0 = s2.put(np.zeros((4, 4)))
    s2.step_n_with_diffs_sparse(w0, 4, 16)
    out, _, _ = s2.step_n_with_diffs_redo(w0, 4)
    s2.step_n_with_diffs(out, 4)  # chain continues from the redo result


@pytest.mark.parametrize("misuse", ["stale-world", "wrong-redo"])
def test_real_checked_steppers_raise_alike(monkeypatch, misuse):
    """Each package's own packed stepper under the checker: a world from
    outside the live window and a redo of a sparse chunk's OUTPUT raise
    InvariantViolation in the port exactly as in gol_tpu."""
    monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
    world = glider_world(64, 64)
    verdicts = []
    for inv, s in (
        (ji, js.make_stepper(threads=1, height=64, width=64,
                             backend="packed")),
        (ti, ts.make_stepper(height=64, width=64, backend="packed",
                             device="cpu")),
    ):
        assert s.name == "checked-single-packed"
        v0 = inv.violations_total()
        w0 = s.put(world)
        with pytest.raises(inv.InvariantViolation) as exc:
            if misuse == "stale-world":
                w = w0
                for _ in range(5):
                    w = s.step_n(w, 1)[0]
                s.step_n(w0, 1)  # w0 is no longer among the live worlds
            else:
                w1 = s.step_n_with_diffs_sparse(w0, 2, 64)[0]
                s.step_n_with_diffs_redo(w1, 2)
        assert inv.violations_total() == v0 + 1
        verdicts.append(str(exc.value).split(" (")[0])
    assert verdicts[0] == verdicts[1]


def _blinker(h, w):
    return _blinker_world(h, w, 10, 10)


# (variant, world, Params fields, Engine keywords, forced compact cap).
VARIANTS = [
    ("per-cell", glider_world, dict(turns=12, chunk=3), {}, None),
    ("flip-batch", glider_world, dict(turns=12, chunk=3),
     {"emit_flip_batches": True}, None),
    ("compact-redo", glider_world, dict(turns=40, chunk=7), {}, 4),
    ("cycle-ride", _blinker, dict(turns=3000, chunk=0, cycle_detect=True),
     {"emit_flip_batches": True, "emit_flip_chunks": True,
      "cycle_check_seconds": 0.01}, None),
]


@pytest.mark.parametrize("make_world,fields,engine_kw,total_cap",
                         [v[1:] for v in VARIANTS], ids=[v[0] for v in VARIANTS])
def test_checked_engine_runs_match_gol_tpu(tmp_path, monkeypatch, make_world,
                                           fields, engine_kw, total_cap):
    monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
    redos = td._METRICS.compact_redos.value
    rides = td._METRICS.dispatches["ride"].value
    out = []
    for pkg, eng_mod, inv, tag in ((gol_tpu, jd, ji, "jax"),
                                   (gol_tpu_torch, td, ti, "torch")):
        p = pkg.Params(image_width=64, image_height=64, threads=1,
                       tick_seconds=60.0, out_dir=str(tmp_path / tag),
                       **fields)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        engine = eng_mod.Engine(p, initial_world=make_world(64, 64),
                                **engine_kw, **extra)
        assert engine.stepper.name.startswith("checked-")
        if total_cap is not None:
            engine._compact_total_cap = lambda k: total_cap
        v0 = inv.violations_total()
        stream = inv.EventStreamChecker(tag)
        engine.start()
        evs = []
        for ev in engine.events:
            stream.observe(ev)
            evs.append(ev)
        engine.join(60)
        assert engine.error is None, engine.error
        assert inv.violations_total() == v0
        out.append(evs)
    jevs, tevs = out
    if "emit_flip_chunks" in engine_kw:
        # Where a ride cuts its chunks depends on the wall clock.
        assert expand_chunks(tevs) == expand_chunks(jevs)
        assert [t for t, *_ in expand_chunks(tevs)] == list(
            range(1, fields["turns"] + 1))
        assert td._METRICS.dispatches["ride"].value > rides
    else:
        assert normalize(tevs) == normalize(jevs)
    if total_cap is not None:
        assert td._METRICS.compact_redos.value > redos
