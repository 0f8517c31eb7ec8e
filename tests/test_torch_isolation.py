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
    checkpoint and trace utilities, the serving core (wire, server,
    client, writer pool, freshness, the metrics sidecar, the fault
    injector, lockcheck), the session plane (manager, engine) and the
    replay plane (log, recorder, server) and chip_smoke.py among them; the
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
                 "gol_tpu_torch/parallel/tiled.py",
                 "gol_tpu_torch/obs/registry.py",
                 "gol_tpu_torch/obs/device.py",
                 "gol_tpu_torch/obs/freshness.py",
                 "gol_tpu_torch/obs/http.py",
                 "gol_tpu_torch/distributed/wire.py",
                 "gol_tpu_torch/distributed/server.py",
                 "gol_tpu_torch/distributed/client.py",
                 "gol_tpu_torch/relay/writerpool.py",
                 "gol_tpu_torch/testing/faults.py",
                 "gol_tpu_torch/testing/leaks.py",
                 "gol_tpu_torch/analysis/concurrency/lockcheck.py",
                 "gol_tpu_torch/obs/accounting.py",
                 "gol_tpu_torch/sessions/__init__.py",
                 "gol_tpu_torch/sessions/manager.py",
                 "gol_tpu_torch/sessions/engine.py",
                 "gol_tpu_torch/replay/__init__.py",
                 "gol_tpu_torch/replay/log.py",
                 "gol_tpu_torch/replay/recorder.py",
                 "gol_tpu_torch/replay/server.py",
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
q = dataclasses.replace(p, turns=40, tile=32)
evs = list(gol_tpu_torch.run(q, device="cpu", emit_flip_batches=True))
assert any(isinstance(e, FinalTurnComplete) for e in evs)
import gol_tpu_torch.parallel.tiled
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

    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_stepper(height=64, width=64, device="cpu", mesh="2x2")
    # Tiled stepping is ported (parallel/tiled.py).
    assert make_stepper(height=64, width=64, device="cpu",
                        tile=32).tiled is not None
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


def test_cpu_serve_connect_round_loads_no_jax(golden_root, tmp_path):
    """A full serving round on the CPU — EngineServer, a batching driver
    and an observer, the metrics sidecar, 'k' — loads no JAX and nothing
    of gol_tpu."""
    code = f"""
import sys, urllib.request
sys.path.insert(0, {str(REPO)!r})
from gol_tpu_torch.distributed import Controller, EngineServer
from gol_tpu_torch.obs.http import MetricsServer
from gol_tpu_torch.params import Params
from gol_tpu_torch.testing import faults
p = Params(turns=10**9, image_width=64, image_height=64,
           image_dir={str(golden_root / 'images')!r}, out_dir={str(tmp_path)!r},
           tick_seconds=0.05)
srv = EngineServer(p, port=0, device="cpu").start()
side = MetricsServer(port=0, health=srv.health).start()
drv = Controller(*srv.address, want_flips=True, batch=True, batch_turns=8,
                 timeout=10)
ob = Controller(*srv.address, want_flips=True, observe=True, timeout=10)
assert drv.wait_sync(10) and ob.wait_sync(10)
url = "http://%s:%d/healthz" % tuple(side.address)
assert urllib.request.urlopen(url, timeout=10).status == 200
drv.send_key("k")
assert srv.wait(10)
for c in (drv, ob):
    c.close()
side.close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    assert any(f.suffix == ".pgm" for f in tmp_path.iterdir())


def test_engine_server_without_gpu_raises(no_cuda, golden_root, tmp_path):
    """No card and no CPU request: the server refuses at construction,
    before it binds a port or starts a thread."""
    import threading

    from gol_tpu_torch.distributed import EngineServer
    from gol_tpu_torch.params import Params

    before = {t.ident for t in threading.enumerate()}
    p = Params(turns=1, image_width=64, image_height=64,
               image_dir=str(golden_root / "images"), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        EngineServer(p, port=0)
    assert {t.ident for t in threading.enumerate()} <= before
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--sessions", "--serve", "0"], "no CUDA GPU",
                 id="--sessions"),
    pytest.param(["--relay", "x:1", "--serve", "0", "--platform", "cpu"],
                 "not yet ported", id="--relay"),
    pytest.param(["--record", "--serve", "0", "--platform", "cpu"],
                 "--record applies to --serve --sessions", id="--record"),
    pytest.param(["--replay", "x:1", "--serve", "0"], "no CUDA GPU",
                 id="--replay"),
    pytest.param(["--sessions", "--serve", "0", "--platform", "cpu",
                  "--session-budget-flops", "1e9"], "not yet ported",
                 id="--session-budget-flops"),
    pytest.param(["--sessions", "--serve", "0", "--platform", "cpu",
                  "--session-budget-bytes", "1e6"], "not yet ported",
                 id="--session-budget-bytes"),
])
def test_unported_serving_flags_refused(argv, match, no_cuda):
    """The relay and the session budgets are still refused as not yet
    ported; `--sessions`, `--record` and `--replay` are ported, so they
    reach their own guards — and, without --platform cpu, the card."""
    from gol_tpu_torch import cli

    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_session_server_without_gpu_raises(no_cuda, tmp_path):
    """No card and no CPU request: the session server (and its manager)
    refuse at construction, before a port is bound or a thread starts."""
    import threading

    from gol_tpu_torch.distributed import SessionServer
    from gol_tpu_torch.params import Params
    from gol_tpu_torch.sessions import SessionManager

    before = {t.ident for t in threading.enumerate()}
    p = Params(turns=1, image_width=64, image_height=64,
               out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SessionServer(p, port=0, record=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SessionManager(out_dir=str(tmp_path))
    assert {t.ident for t in threading.enumerate()} <= before
    assert not list(tmp_path.iterdir())


def test_cpu_session_round_loads_no_jax(tmp_path):
    """A session round on the CPU — SessionServer with --record, a
    SessionControl create, a session driver, a seek, a ReplayServer over
    the recording — loads no JAX and nothing of gol_tpu."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from gol_tpu_torch.distributed import Controller, SessionControl, SessionServer
from gol_tpu_torch.params import Params
from gol_tpu_torch.replay import ReplayServer
p = Params(turns=10**9, image_width=64, image_height=64,
           out_dir={str(tmp_path)!r})
srv = SessionServer(p, port=0, device="cpu", record=True,
                    keyframe_turns=16).start()
with SessionControl(*srv.address, timeout=10) as sc:
    sc.create("s1", width=64, height=64, seed=5)
drv = Controller(*srv.address, session="s1", want_flips=True, batch=True,
                 timeout=10)
assert drv.wait_sync(10)
for i, ev in enumerate(drv.events):
    if i > 40:
        break
assert drv.seek(0, timeout=10)["ok"]
drv.close()
srv.shutdown()
rs = ReplayServer({str(tmp_path / 'sessions')!r}, port=0).start()
rs.shutdown()
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    assert (tmp_path / "sessions" / "s1" / "replay").is_dir()
