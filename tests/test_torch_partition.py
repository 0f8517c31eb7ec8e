"""The port's partition tables, placement and kernel layouts
(gol_tpu_torch/parallel/partition.py, gol_tpu_torch/ops/lanes.py)
against gol_tpu's, on the CPU.

The override grammar, the mesh strings, the family tables, the layout
registry and every error text are gol_tpu's, over a list of good and
bad strings; `Params` and the CLI refuse what gol_tpu refuses with its
messages; the placement splits and gathers a global array losslessly;
and the lane-coupled layout steps bit-identically to gol_tpu's
`make_lane_coupled` for k = 2 and 4.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gol_tpu import params as jparams
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitlife as jb
from gol_tpu.ops import lanes as jlanes
from gol_tpu.parallel import partition as jp
from gol_tpu.parallel.stepper import make_stepper as jmake
from gol_tpu_torch import params as tparams
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import lanes as tlanes
from gol_tpu_torch.parallel import partition as tp
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


def outcome(fn, *args, **kw):
    """("ok", result) or (exception class name, message)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the texts are compared
        return type(e).__name__, str(e)


MESHES = ["2x4", " 1X8 ", "3x3", "2x", "0x4", "4x0", "x", "2x2x2", "", "-1x2"]


@pytest.mark.parametrize("text", MESHES)
def test_parse_mesh_equals_gol_tpu(text):
    assert outcome(tp.parse_mesh, text) == outcome(jp.parse_mesh, text)


OVERRIDES = [
    "world=rows,cols;sparse_rows=-",
    "layout=lane-coupled",
    ";layout=lane-coupled;",
    "world=rows, * ;diffs=*,rows,cols",
    "world=",
    "world",
    "world=rows,depth",
    "layout=nope",
    "([=rows",
    "world=none,.;mask=-",
]


def rules_of(parsed):
    rules, layout = parsed
    return [(r.pattern, r.axes) for r in rules], layout


@pytest.mark.parametrize("text", OVERRIDES)
def test_parse_overrides_equals_gol_tpu(text):
    t, j = outcome(tp.parse_overrides, text), outcome(jp.parse_overrides,
                                                      text)
    if t[0] == "ok":
        assert j[0] == "ok" and rules_of(t[1]) == rules_of(j[1])
    else:
        assert t == j


FAMILIES = ["dense_ring", "packed_ring", "gens_ring", "gens_packed_ring",
            "packed_mesh2d", "gens_mesh2d", "single", "torus9d"]
ARRAYS = [("world", 2), ("world", 1), ("planes", 3), ("diffs", 3),
          ("diffs", 2), ("sparse_rows", None), ("stack", None),
          ("unknown_array", None)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("overrides", [None, "world=rows", "mask=rows"])
def test_tables_resolve_as_gol_tpu(family, overrides):
    t = outcome(tp.table_for, family, overrides)
    j = outcome(jp.table_for, family, overrides)
    assert (t[0] == "ok") == (j[0] == "ok")
    if t[0] != "ok":
        assert t == j
        return
    assert t[1].name == j[1].name and t[1].layout == j[1].layout
    for name, ndim in ARRAYS:
        a = outcome(t[1].resolve, name, ndim)
        b = outcome(j[1].resolve, name, ndim)
        if a[0] == "ok":
            assert b[0] == "ok" and a[1] == tuple(b[1])
        else:
            assert a == b


def test_rules_layouts_and_params_equal_gol_tpu():
    assert sorted(tp.LAYOUTS) == sorted(jp.LAYOUTS) == ["lane-coupled"]
    assert outcome(tp.get_layout, "x")[1] == outcome(jp.get_layout, "x")[1]
    assert outcome(tp.Rule, "w", ("depth",)) == outcome(jp.Rule, "w",
                                                        ("depth",))
    for kw in ({"mesh": "2x4"}, {"mesh": "2x"}, {"mesh": "0x1"},
               {"partition_rules": "world=rows"},
               {"partition_rules": "layout=lane-coupled"},
               {"partition_rules": "world=depth"},
               {"partition_rules": "layout=nope"}):
        t = outcome(tparams.Params, **kw)
        j = outcome(jparams.Params, **kw)
        assert t[0] == j[0], kw
        if t[0] != "ok":
            assert t[1] == j[1]
        else:
            assert (t[1].mesh, t[1].partition_rules) == (
                j[1].mesh, j[1].partition_rules)


def test_placement_splits_and_gathers():
    """A 2x4 mesh of one repeated device: each cell holds its block, the
    gather restores the global array, a replicated spec gives every
    cell the whole array, and a mesh needing more devices raises."""
    mesh = tp.mesh2d(["cpu"] * 8, 2, 4)
    words = np.arange(4 * 16 * 8, dtype=np.uint32).reshape(4, 16, 8)
    world = tp.Sharding(mesh, tp.spec(None, "rows", "cols")).place(words)
    assert len(world.parts) == 8 and world.shape == (4, 16, 8)
    np.testing.assert_array_equal(world.parts[5].numpy().view(np.uint32),
                                  words[:, 8:, 2:4])
    np.testing.assert_array_equal(world.numpy(), words)
    assert world.equal(world.replace(list(world.parts)))
    rep = tp.Sharding(mesh, tp.REPLICATED).place(words)
    assert all(p.shape == (4, 16, 8) for p in rep.parts)
    with pytest.raises(tp.PartitionError, match="needs 4 devices, got 3"):
        tp.mesh2d(["cpu"] * 3, 2, 2)
    with pytest.raises(tp.PartitionError, match="equal blocks"):
        tp.Sharding(mesh, tp.spec("rows")).place(np.zeros((3, 4)))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("rule", ["B3/S23", "B36/S23"])
def test_lane_coupled_equals_gol_tpu(k, rule):
    rng = np.random.default_rng(k)
    world = ((rng.random((64, 128)) < 0.35) * 255).astype(np.uint8)
    packed = jb.pack_np(world)
    want = np.asarray(jlanes.make_lane_coupled(jrule(rule), k)(packed, 9))
    got = tlanes.make_lane_coupled(trule(rule), k)(
        torch.from_numpy(packed.view(np.int32)), 9)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError) as te:
        tlanes.make_lane_coupled(trule(rule), 3)(
            torch.zeros((2, 128), dtype=torch.int32), 1)
    with pytest.raises(ValueError) as je:
        jlanes.make_lane_coupled(jrule(rule), 3)(
            np.zeros((2, 128), np.uint32), 1)
    assert str(te.value) == str(je.value)


def test_layout_override_selects_lane_coupled():
    """`layout=lane-coupled` reaches the single-device packed constructor in
    both packages, bit-exact against the default layout."""
    rng = np.random.default_rng(5)
    world = ((rng.random((128, 128)) < 0.35) * 255).astype(np.uint8)
    j = jmake(height=128, width=128, partition_rules="layout=lane-coupled")
    t = tmake(height=128, width=128, device="cpu",
              partition_rules="layout=lane-coupled")
    assert t.name == j.name == "single-packed-lane-coupled"
    assert t.capabilities() == j.capabilities()
    a, ca = j.step_n(j.put(world), 16)
    b, cb = t.step_n(t.put(world), 16)
    assert int(ca) == int(cb)
    np.testing.assert_array_equal(t.fetch(b), j.fetch(a))


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "2x2"], "mesh 2x2 needs 4 devices, have 1"),
    (["--mesh", "2x"], "mesh spec '2x' is not ROWSxCOLS (e.g. 2x4)"),
    (["--mesh", "2x2", "--tile", "32"],
     "--mesh and --tile are exclusive"),
    (["--mesh", "1x2", "--backend", "dense"],
     "mesh backends are packed-only (backend auto/packed, not 'dense')"),
    (["--partition-rule", "layout=nope"], "unknown layout 'nope'"),
])
def test_cli_mesh_guards(tmp_path, argv, want):
    """The CLI's --mesh / --partition-rule refusals, with gol_tpu's
    texts, on the CPU's one device."""
    r = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "64", "-h", "64",
         "-turns", "1", "-noVis", "--platform", "cpu", "--images",
         str(REPO / "fixtures" / "images"), "--out", str(tmp_path), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode != 0
    assert want in r.stdout + r.stderr


def test_mesh_device_count_text_equals_gol_tpu():
    import jax

    with pytest.raises(ValueError) as je:
        jmake(height=64, width=64, mesh="2x2", devices=jax.devices()[:1])
    with pytest.raises(ValueError) as te:
        tmake(height=64, width=64, mesh="2x2", device="cpu")
    assert str(te.value) == str(je.value)
