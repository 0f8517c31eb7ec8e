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
    injector, lockcheck), the session plane (manager, engine), the
    replay plane (log, recorder, server), the broadcast tier (relay
    node, WebSocket gateway), the telemetry planes (scrape, console,
    tsdb, collector, report, canary), the fleet controller (spec,
    manifest, controller), the static analysis plane (core, torchlint,
    the CLI, the eight checks, the concurrency passes, the corpus
    runner) and chip_smoke.py among them; the native
    core's directory holds its sources only (it builds under
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
                 "gol_tpu_torch/parallel/partition.py",
                 "gol_tpu_torch/parallel/halo.py",
                 "gol_tpu_torch/parallel/packed_halo.py",
                 "gol_tpu_torch/parallel/gens_halo.py",
                 "gol_tpu_torch/parallel/mesh2d.py",
                 "gol_tpu_torch/ops/lanes.py",
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
                 "gol_tpu_torch/analysis/core.py",
                 "gol_tpu_torch/analysis/torchlint.py",
                 "gol_tpu_torch/analysis/__main__.py",
                 "gol_tpu_torch/analysis/checks/__init__.py",
                 "gol_tpu_torch/analysis/checks/host_sync.py",
                 "gol_tpu_torch/analysis/checks/tracer_branch.py",
                 "gol_tpu_torch/analysis/checks/recompile.py",
                 "gol_tpu_torch/analysis/checks/dtype_drift.py",
                 "gol_tpu_torch/analysis/checks/donation.py",
                 "gol_tpu_torch/analysis/checks/obs_in_jit.py",
                 "gol_tpu_torch/analysis/checks/blocking_io.py",
                 "gol_tpu_torch/analysis/checks/partition_spec.py",
                 "gol_tpu_torch/analysis/concurrency/graph.py",
                 "gol_tpu_torch/analysis/concurrency/lock_order.py",
                 "gol_tpu_torch/analysis/concurrency/lock_blocking.py",
                 "gol_tpu_torch/analysis/concurrency/guarded_field.py",
                 "gol_tpu_torch/analysis/concurrency/ownership.py",
                 "gol_tpu_torch/analysis/concurrency/corpus.py",
                 "gol_tpu_torch/obs/accounting.py",
                 "gol_tpu_torch/sessions/__init__.py",
                 "gol_tpu_torch/sessions/manager.py",
                 "gol_tpu_torch/sessions/engine.py",
                 "gol_tpu_torch/replay/__init__.py",
                 "gol_tpu_torch/replay/log.py",
                 "gol_tpu_torch/replay/recorder.py",
                 "gol_tpu_torch/replay/server.py",
                 "gol_tpu_torch/relay/node.py",
                 "gol_tpu_torch/relay/ws.py",
                 "gol_tpu_torch/obs/scrape.py",
                 "gol_tpu_torch/obs/console.py",
                 "gol_tpu_torch/obs/tsdb.py",
                 "gol_tpu_torch/obs/collector.py",
                 "gol_tpu_torch/obs/report.py",
                 "gol_tpu_torch/obs/canary.py",
                 "gol_tpu_torch/control/__init__.py",
                 "gol_tpu_torch/control/spec.py",
                 "gol_tpu_torch/control/manifest.py",
                 "gol_tpu_torch/control/controller.py",
                 "chip_smoke.py"):
        assert want in names
    native = sorted(p.name for p in (REPO / "gol_tpu_torch" / "native")
                    .iterdir() if p.name != "__pycache__")
    assert native == ["Makefile", "board.cpp"]


def _module_runs(node) -> list:
    """The module names that a list literal runs as `-m MODULE`."""
    if not isinstance(node, ast.List):
        return []
    items = node.elts
    return [b.value for a, b in zip(items, items[1:])
            if isinstance(a, ast.Constant) and a.value == "-m"
            and isinstance(b, ast.Constant) and isinstance(b.value, str)]


def test_no_argv_runs_gol_tpu_as_a_module():
    """No argv list in the port (the controller's spawn commands, the
    smoke script's processes) runs `-m gol_tpu` or a module of it: the
    import scan cannot see an argv string."""
    bad, runs = [], 0
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            for mod in _module_runs(node):
                runs += 1
                if _forbidden(mod):
                    bad.append(f"{path.name}:{node.lineno} -m {mod}")
    assert runs >= 3  # the controller's two spawns and the smoke's CLI
    assert not bad, bad
    # The scan itself catches the bad form.
    tree = ast.parse('cmd = [sys.executable, "-m", "gol_tpu", "--relay"]')
    assert [_module_runs(n) for n in ast.walk(tree)
            if isinstance(n, ast.List)] == [["gol_tpu"]]


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

    # Meshes and rings are ported: a mesh needs its devices (the CPU
    # without a device list is one), and builds over a device list.
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_stepper(height=64, width=64, device="cpu", mesh="2x2")
    assert make_stepper(height=64, width=64, devices=["cpu"] * 4,
                        mesh="2x2").name == "packed-mesh2d-2x2"
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


def test_cpu_ring_run_loads_no_jax(golden_root, tmp_path):
    """Rings, a mesh and the lane layout run on the CPU — an engine
    with a packed 2-shard ring injected, the dense and Generations
    rings, a 2x2 mesh, --partition-rule layout=lane-coupled — load no
    JAX and nothing of gol_tpu."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
import gol_tpu_torch
from gol_tpu_torch import FinalTurnComplete, Params
from gol_tpu_torch.engine.distributor import Engine
from gol_tpu_torch.parallel import make_stepper
p = Params(turns=100, threads=2, image_width=64, image_height=64,
           image_dir={str(golden_root / 'images')!r}, out_dir={str(tmp_path)!r},
           tick_seconds=0.05)
ring = make_stepper(threads=2, height=64, width=64, devices=["cpu"] * 2)
assert ring.name == "packed-halo-ring-2", ring.name
e = Engine(p, stepper=ring).start()
assert any(isinstance(x, FinalTurnComplete) for x in e.events)
e.join(60)
w = (np.arange(100 * 64).reshape(100, 64) % 7 == 0).astype(np.uint8) * 255
for kw in ({{}}, {{"rule": "B2/S/C3"}}):
    s = make_stepper(threads=3, height=100, width=64, devices=["cpu"] * 3, **kw)
    s.fetch(s.step_n(s.put(w), 20)[0])
s = make_stepper(height=64, width=64, devices=["cpu"] * 4, mesh="2x2")
s.fetch(s.step_n(s.put(w[:64]), 5)[0])
q = Params(turns=100, image_width=64, image_height=64,
           image_dir=p.image_dir, out_dir=p.out_dir + "/lanes",
           partition_rules="layout=lane-coupled")
assert any(isinstance(x, FinalTurnComplete)
           for x in gol_tpu_torch.run(q, device="cpu"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    want = (golden_root / "check" / "images" / "64x64x100.pgm").read_bytes()
    assert (tmp_path / "64x64x100.pgm").read_bytes() == want
    assert (tmp_path / "lanes" / "64x64x100.pgm").read_bytes() == want


def test_cuda_ring_without_gpu_raises(no_cuda):
    """A ring or mesh asked of CUDA devices refuses without a card, as
    the single-device entries do; there is no move to the CPU."""
    from gol_tpu_torch.parallel import make_stepper

    for kw in ({"threads": 4}, {"threads": 4, "devices": ["cuda:0"] * 4},
               {"mesh": "2x2", "devices": ["cuda:0"] * 4}):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_stepper(height=128, width=64, **kw)


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


def _gol_tpu_messages() -> set:
    """Every string constant of gol_tpu's CLI (adjacent literals are
    joined by the parser): the guards' messages the port keeps."""
    tree = ast.parse((REPO / "gol_tpu" / "cli.py").read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--sessions", "--serve", "0"], "no CUDA GPU",
                 id="--sessions"),
    pytest.param(["--relay", "x:1", "--sessions", "--serve", "0",
                  "--platform", "cpu"], None, id="--relay"),
    pytest.param(["--record", "--serve", "0", "--platform", "cpu"],
                 "--record applies to --serve --sessions", id="--record"),
    pytest.param(["--replay", "x:1", "--serve", "0"], "no CUDA GPU",
                 id="--replay"),
    pytest.param(["--serve", "0", "--platform", "cpu",
                  "--session-budget-flops", "1e9"], None,
                 id="--session-budget-flops"),
    pytest.param(["--serve", "0", "--platform", "cpu",
                  "--session-budget-bytes", "1e6"], None,
                 id="--session-budget-bytes"),
    pytest.param(["--relay", "x:1", "--serve", "0", "--tile", "64"], None,
                 id="--tile with --relay"),
    pytest.param(["--serve", "0", "--ws-port", "0"], None,
                 id="--ws-port without --relay"),
    pytest.param(["--relay", "x:1"], None, id="--relay without --serve"),
    pytest.param(["--relay", "x:1", "--serve", "0", "--resume", "latest"],
                 None, id="--relay with --resume"),
    pytest.param(["--serve", "0", "--remote-write", "x:1"], None,
                 id="--remote-write without --metrics-port"),
    pytest.param(["--collector", "0", "--control", "s.json"], None,
                 id="--collector with --control"),
    pytest.param(["--collector", "0", "--serve", "0"], None,
                 id="--collector with a serving mode"),
    pytest.param(["--collector", "0", "--resume", "x.pgm"], None,
                 id="--collector with a snapshot"),
    pytest.param(["--control", "s.json", "--relay", "x:1"], None,
                 id="--control with --relay"),
    pytest.param(["--control", "s.json", "--resume", "latest"], None,
                 id="--control with --resume"),
])
def test_unported_serving_flags_refused(argv, match, no_cuda):
    """Every gol_tpu serving flag is ported: the relay, the session
    budgets, the alerting, history and control flags reach gol_tpu's
    own guards with gol_tpu's messages (match None: the message is one
    of gol_tpu's CLI's), and `--sessions` / `--replay` without
    --platform cpu reach the card."""
    from gol_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    msg = str(e.value)
    if match is None:
        assert msg.startswith("error: ") and msg in _gol_tpu_messages(), msg
    else:
        assert match in msg


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


def test_relay_on_gpu_without_a_card_exits_nonzero(no_cuda, tmp_path):
    """A relay steps no board, but `--platform gpu` (the default) still
    needs the card: without one it exits nonzero before it dials."""
    r = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "--relay", "127.0.0.1:1",
         "--serve", "127.0.0.1:0", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=ENV)
    assert r.returncode != 0
    assert "no CUDA GPU" in r.stderr
    assert not list(tmp_path.iterdir())


def _until_banner(proc, prefix, timeout=60.0):
    import select
    import time

    deadline = time.monotonic() + timeout
    seen = ""
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.2)
        if ready:
            line = proc.stdout.readline()
            seen += line
            if line.startswith(prefix):
                return line
        if proc.poll() is not None:
            break
    raise AssertionError(f"no {prefix!r} banner:\n{seen}")


@pytest.mark.parametrize("mode", ["--collector", "--control"])
def test_collector_and_control_run_without_a_card(mode, tmp_path):
    """`--collector` and `--control` compute nothing on any device: with
    no --platform and no card they start, serve their sidecar and end
    cleanly on SIGINT."""
    import json
    import signal
    import time

    if mode == "--collector":
        argv, banner = ["--collector", "127.0.0.1:0"], "collector serving on"
    else:
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps({"root": "127.0.0.1:1",
                                    "interval_secs": 0.2}))
        argv, banner = ["--control", str(spec)], "controller reconciling"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", *argv, "--out",
         str(tmp_path / "out"), "--metrics-port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**ENV, "PYTHONUNBUFFERED": "1"})
    try:
        _until_banner(proc, banner)
        _until_banner(proc, "metrics serving on")
        time.sleep(1.0)  # past the banner, into the serving loop
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cpu_relay_and_collector_round_loads_no_jax(tmp_path):
    """A relay round and a history round on the CPU — EngineServer, a
    RelayNode with its WebSocket gateway, a batching observer through
    the relay, the alert evaluator, a RemoteWriter into a
    CollectorServer, a query, the console, a report, the controller's
    spec and manifest — load no JAX and nothing of gol_tpu."""
    code = f"""
import io, sys
sys.path.insert(0, {str(REPO)!r})
from gol_tpu_torch.distributed import Controller, EngineServer
from gol_tpu_torch.params import Params
from gol_tpu_torch.relay import RelayNode
from gol_tpu_torch.obs import console, freshness, report
from gol_tpu_torch.obs.collector import CollectorServer, RemoteWriter
from gol_tpu_torch.obs.http import MetricsServer
from gol_tpu_torch.obs.tsdb import TSDB
from gol_tpu_torch.control import ControllerManifest, FleetSpec
p = Params(turns=10**9, image_width=64, image_height=64,
           image_dir={str(REPO / "fixtures" / "images")!r},
           out_dir={str(tmp_path)!r}, tick_seconds=60.0)
srv = EngineServer(p, port=0, device="cpu").start()
relay = RelayNode(srv.address, port=0, ws_port=0).start()
assert relay.synced.wait(10)
ob = Controller(*relay.address, want_flips=True, batch=True,
                batch_turns=8, observe=True, timeout=10)
assert ob.wait_sync(10)
for i, ev in enumerate(ob.events):
    if i > 30:
        break
ev = freshness.AlertEvaluator(freshness.parse_rules(
    "age: max(gol_tpu_server_worst_turn_age_seconds) > 60"))
ev.eval_once()
db = TSDB({str(tmp_path / 'tsdb')!r})
col = CollectorServer("127.0.0.1", 0, db).start()
side = MetricsServer(port=0, alerts=ev, tsdb=db).start()
rw = RemoteWriter("127.0.0.1:%d" % col.address[1], source="x")
assert rw.push_once()
snap = console.fleet_snapshot([console.Endpoint("127.0.0.1:%d"
                                                % side.address[1])])
console.render(snap, out=io.StringIO())
FleetSpec({{"root": "127.0.0.1:1"}})
ControllerManifest({str(tmp_path / 'controller.json')!r})
assert report.main(["usage", {str(tmp_path)!r}, "--json"]) == 0
rw.close(); side.close(); col.close(); ob.close(); relay.shutdown()
srv.shutdown()
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout


def test_multihost_and_chaos_load_no_jax(tmp_path):
    """The multi-process job (a one-process gloo job, the global device
    list, the config check, the SPMD mirror over a CPU ring) and the
    chaos harness (a recipe's oracle, the runner's server argv) load no
    JAX and nothing of gol_tpu, and both modules are in the scans
    above; the runner spawns `-m gol_tpu_torch`."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"gol_tpu_torch/parallel/multihost.py",
            "gol_tpu_torch/testing/chaos.py"} <= names
    code = f"""
import socket, sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from gol_tpu_torch.parallel import multihost
from gol_tpu_torch.parallel.stepper import make_stepper
from gol_tpu_torch.testing import chaos
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
multihost.initialize(f"127.0.0.1:{{port}}", 1, 0, local_devices=["cpu"] * 2)
assert multihost.process_count() == 1 and multihost.is_coordinator()
assert [d.rank for d in multihost.global_devices()] == [0, 0]
multihost.verify_job_config(64, 64, 2)
ring = make_stepper(threads=2, height=64, width=64, devices=["cpu"] * 2)
s = multihost.spmd_stepper(ring)
w = (np.arange(64 * 64).reshape(64, 64) % 5 == 0).astype(np.uint8) * 255
p, c = s.step_n(s.put(w), 7)
assert s.fetch(p).shape == (64, 64)
multihost.notify_stop()
board = chaos.oracle_board(chaos.Recipe("x", seed=3), 40)
assert board.shape == (64, 64)
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax") or m == "gol_tpu"
             or m.startswith("gol_tpu."))
print("FORBIDDEN", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN []" in r.stdout, r.stdout
    src = (REPO / "gol_tpu_torch" / "testing" / "chaos.py").read_text()
    assert '"-m", "gol_tpu_torch"' in src
