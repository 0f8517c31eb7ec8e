"""The B2/S/C3 form of kernels C and D (csrc/bitgens.cu: C on the
column walkers of csrc/walk.cuh, D on the strip walkers of
csrc/strip.cuh, whose layout tests/test_torch_tiled_walk.py emulates)
on the CPU: the two-copy recurrence both run, written in plain torch,
equals the port's plain planes and gol_tpu's plain and Pallas
(interpret mode) planes; the wrapper hands kernel D's strip plan to the
launcher; the launcher's choice of form matches the rule's kernel
arguments; neither walk's turn loop divides. The kernels themselves run
on the card (chip_smoke.py)."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitgens as jbg
from gol_tpu.ops import pallas_bitgens as jpg
from gol_tpu_torch import interop
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import _build, bitgens
from gol_tpu_torch.ops import cuda_bitgens as cg
from gol_tpu_torch.ops import cuda_bitlife as cb

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "gol_tpu_torch" / "csrc"
TURNS = [0, 1, 31, 32, 33]


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


def brain_planes(h, w, seed):
    """gol_tpu's packed (alive, dying) planes of a random B2/S/C3 grid."""
    rule = jrule("B2/S/C3")
    state = np.random.default_rng(seed).integers(0, 3, (h, w))
    return np.asarray(jbg.pack_states(state.astype(np.uint8), rule))


def two_copy(planes, n):
    """The kernel's recurrence: copy 0 holds alive(0), copy 1 dying(0);
    each turn writes born(alive, the other copy's own word) over the
    other copy, in the form of chip_smoke.gens_fewest_instructions, and
    the copies swap roles. The copy written last is the alive plane,
    the other the dying plane."""
    born = _smoke().gens_fewest_instructions
    copies = [planes[0].clone(), planes[1].clone()]
    cur = 0
    for _ in range(n):
        nxt = 1 - cur
        copies[nxt] = born(torch.stack([copies[cur], copies[nxt]]))[0][0]
        cur = nxt
    return torch.stack([copies[cur], copies[1 - cur]])


@pytest.mark.parametrize("n", TURNS)
def test_two_copy_recurrence_matches_plain_planes(n):
    planes = brain_planes(64, 64, seed=n)
    got = two_copy(interop.planes_from_numpy(planes), n)
    want = bitgens.step_n_packed_gens_raw(interop.planes_from_numpy(planes),
                                          n, trule("B2/S/C3"))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        interop.planes_to_numpy(got),
        np.asarray(jbg.step_n_packed_gens_raw(planes, n, jrule("B2/S/C3"))))


@pytest.mark.parametrize("n", TURNS)
def test_two_copy_recurrence_matches_pallas_tiled2d(n):
    """256 x 4096 at 8-row tiles, the smallest board gol_tpu's 2-D gens
    kernel tiles (two 2048-column tiles), across one light cone."""
    planes = brain_planes(256, 4096, seed=10 + n)
    want = np.asarray(jpg.step_n_packed_gens_pallas_tiled2d_raw(
        planes, n, jrule("B2/S/C3"), interpret=True, tile_rows=8))
    got = two_copy(interop.planes_from_numpy(planes), n)
    np.testing.assert_array_equal(interop.planes_to_numpy(got), want)


@pytest.mark.parametrize("notation", ["B2/S/C3", "B2/S345/C4"])
def test_tiled_pass_hands_the_plan_to_the_launcher(monkeypatch, notation):
    """A tensor on the card goes to `bitgens_tiled_launch` with the strip
    walkers' plan last, in the order and number of the C signature (less
    the stream, which `_launch` adds); the launcher runs the masks form
    of every rule but B2/S/C3 on its own block size, and reads the plan
    for B2/S/C3 alone."""
    seen = []
    monkeypatch.setattr(cb, "_check_pass", lambda src, dst, check: None)
    monkeypatch.setattr(cb, "_launch", lambda launches, name, like, *args:
                        seen.append((name, args)))
    rule = trule(notation)
    src = torch.empty((rule.states - 1, 512, 16384), dtype=torch.int32,
                      device="meta")
    geom = cb._tiled2d_geometry(512, 16384, None, rule.states)
    cg._tiled_pass(src, torch.empty_like(src), 32, rule, geom)
    (name, args), = seen
    assert name == "bitgens_tiled"
    assert len(args) + 1 == len(_build._SIGNATURES["bitgens_tiled_launch"])
    assert args[2:10] == (rule.states - 1, 512, 16384, 32, 256, 1, 32, 32)
    assert args[10:12] == cb.rule_bits(rule)
    assert args[-2:] == cb._strip_plan(geom) == (640, 8)


def test_launcher_picks_the_walkers_for_brians_brain_only():
    """The launcher's test for the B2/S/C3 form is the rule's kernel
    arguments: two planes, birth mask {2}, survive mask empty."""
    src = (CSRC / "bitgens.cu").read_text()
    assert ("planes == 2 && birth == (1u << 2) && survive == 0" in src)
    assert cb.rule_bits(trule("B2/S/C3")) == (1 << 2, 0)
    assert trule("B2/S/C3").states - 1 == 2
    for other in ("B2/S/C4", "B2/S345/C4", "B23/S/C3", "B2/S1/C3"):
        rule = trule(other)
        assert (rule.states - 1, *cb.rule_bits(rule)) != (2, 1 << 2, 0)


def _code(text):
    """C++ source without comments."""
    return re.sub(r"//[^\n]*", "", text)


def _body(text, head):
    """The braced body that follows `head` in `text`."""
    start = text.index("{", text.index(head))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"unbalanced body after {head!r}")


def test_walk_turn_loop_divides_nothing():
    """A walker step and the turn loop hold no division or modulo (the
    plan's strides come in from the launcher)."""
    src = _code((CSRC / "walk.cuh").read_text())
    walk = _body(src, "__device__ __forceinline__ void walk(")
    turns = _body(src, "for (int t = 0; t < n; ++t)")
    for body in (walk, turns):
        assert "/" not in body and "%" not in body


def test_strip_turn_loop_divides_nothing():
    """Kernel D's strip walkers likewise: a step, B2/S/C3's finishing
    form and the turn loop hold no division or modulo."""
    src = _code((CSRC / "strip.cuh").read_text())
    for head in ("__device__ __forceinline__ void strip_walk(",
                 "for (int t = 0; t < n; ++t)", "struct BrainStrip",
                 "u32 brain_of_sums("):
        body = _body(src, head)
        assert "/" not in body and "%" not in body, head
