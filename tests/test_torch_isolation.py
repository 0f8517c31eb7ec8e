"""The port stands alone: `gol_tpu_torch` and `chip_smoke.py` import
neither JAX nor anything of `gol_tpu`, and its entry points refuse to run
without a GPU unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
#: One intra-op thread for the children's torch (tiny boards).
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
PORT_FILES = sorted((REPO / "gol_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "gol_tpu"


def test_ast_scan_finds_no_jax_or_gol_tpu_import():
    bad = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert len(PORT_FILES) > 20
    assert not bad, bad


def test_scan_covers_every_port_module():
    """The scan reads every module of the package, the Generations and
    dense-kernel modules, the invariant checker, the visualiser, the
    checkpoint and trace utilities and chip_smoke.py among them; the
    native core's directory holds its sources only (it builds under
    build/gol_tpu_torch/)."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for want in ("gol_tpu_torch/ops/generations.py",
                 "gol_tpu_torch/ops/bitgens.py",
                 "gol_tpu_torch/ops/cuda_bitgens.py",
                 "gol_tpu_torch/ops/cuda_life.py",
                 "gol_tpu_torch/ops/cuda_bitlife.py",
                 "gol_tpu_torch/analysis/invariants.py",
                 "gol_tpu_torch/visual/board.py",
                 "gol_tpu_torch/visual/loop.py",
                 "gol_tpu_torch/utils/check.py",
                 "gol_tpu_torch/utils/trace.py",
                 "gol_tpu_torch/utils/visualise.py",
                 "gol_tpu_torch/checkpoint.py",
                 "chip_smoke.py"):
        assert want in names
    native = sorted(p.name for p in (REPO / "gol_tpu_torch" / "native")
                    .iterdir() if p.name != "__pycache__")
    assert native == ["Makefile", "board.cpp"]


def test_full_cpu_run_loads_no_jax(golden_root, tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import gol_tpu_torch
from gol_tpu_torch import FinalTurnComplete, Params
p = Params(turns=100, image_width=64, image_height=64,
           image_dir={str(golden_root / 'images')!r}, out_dir={str(tmp_path)!r},
           tick_seconds=0.05)
evs = list(gol_tpu_torch.run(p, device="cpu"))
assert any(isinstance(e, FinalTurnComplete) for e in evs)
import dataclasses
for kw in ({{"rule": "B2/S/C3"}}, {{"rule": "B2/S/C3", "backend": "cuda-packed"}},
           {{"backend": "cuda-dense"}}):
    q = dataclasses.replace(p, turns=3, **kw)
    assert any(isinstance(e, FinalTurnComplete)
               for e in gol_tpu_torch.run(q, device="cpu"))
import gol_tpu_torch.interop, gol_tpu_torch.cli, gol_tpu_torch.checkpoint
import gol_tpu_torch.analysis, gol_tpu_torch.visual, gol_tpu_torch.utils.trace
import gol_tpu_torch.utils.check
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    assert ((tmp_path / "64x64x100.pgm").read_bytes()
            == (golden_root / "check" / "images" / "64x64x100.pgm").read_bytes())


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")


def test_make_stepper_without_gpu_raises(no_cuda):
    from gol_tpu_torch.parallel import make_stepper

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_stepper(height=64, width=64)
    assert make_stepper(height=64, width=64, device="cpu").name == "single-packed"


def test_run_without_gpu_raises(no_cuda, golden_root, tmp_path):
    import gol_tpu_torch

    p = gol_tpu_torch.Params(turns=1, image_width=64, image_height=64,
                             image_dir=str(golden_root / "images"),
                             out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="GPU"):
        gol_tpu_torch.run(p)
    assert not list(tmp_path.iterdir())


def test_cli_without_gpu_exits_nonzero(no_cuda, golden_root, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "64", "-h", "64",
         "-turns", "1", "-noVis", "--images", str(golden_root / "images"),
         "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=ENV)
    assert r.returncode != 0
    assert "no CUDA GPU" in r.stderr
    assert not list(tmp_path.iterdir())


def test_unported_requests_raise():
    from gol_tpu_torch.parallel import make_stepper

    for kw in ({"tile": 32}, {"mesh": "2x2"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            make_stepper(height=64, width=64, device="cpu", **kw)
    with pytest.raises(ValueError):
        make_stepper(height=48, width=64, device="cpu", backend="cuda-packed")
    # Generations rules and the dense kernel are ported: gol_tpu's
    # "pallas" is an unknown backend, as "pallas-packed" is.
    assert make_stepper(height=64, width=64, device="cpu",
                        rule="B2/S/C3").name == "generations-packed-1"
    for kw in ({"backend": "pallas"}, {"backend": "pallas-packed"},
               {"rule": "B2/S/C3", "backend": "cuda-dense"}):
        with pytest.raises(ValueError, match="backend"):
            make_stepper(height=64, width=64, device="cpu", **kw)
