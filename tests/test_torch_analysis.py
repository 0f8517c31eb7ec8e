"""gol_tpu_torch.analysis — the port's static linter against gol_tpu's.

The eight per-module checks keep gol_tpu's names and are re-aimed at
the port's hazards: each has a torch-spelled snippet it must flag and
one it must pass. Where a check does not depend on the framework
(blocking-io-timeout, the allowlist, parse errors) the same snippet
goes through both packages' linters and the findings must agree as
(check, line, scope). The strict gate over the port's own tree is the
tier-1 counterpart of gol_tpu's `test_repo_is_clean_under_allowlist`.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

from gol_tpu.analysis import Allowlist as JAllowlist
from gol_tpu.analysis import lint_paths as jlint
from gol_tpu.analysis.core import AllowlistError as JAllowlistError
from gol_tpu_torch.analysis import Allowlist, Finding, lint_paths
from gol_tpu_torch.analysis.core import AllowlistError, ModuleContext

REPO = pathlib.Path(__file__).resolve().parent.parent


def _stage(tmp_path, code, name="mod.py", subdir=""):
    d = tmp_path / subdir if subdir else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(textwrap.dedent(code))
    return f


def _lint(tmp_path, code, name="mod.py", subdir="", lint=lint_paths):
    return lint([_stage(tmp_path, code, name, subdir)], tmp_path)


def _keys(findings):
    return [(f.check, f.line, f.scope) for f in findings]


# --- one torch-spelled positive and negative snippet per check ---

#: check -> (module subdir, file name, code that must be flagged, the
#: findings' count, code of the same module shape that must pass).
CASES = {
    "host-sync": ("ops", "cuda_x.py", """
        import numpy as np
        import torch

        def step_n_counted(world, n):
            out = world + n
            total = out.sum().item()           # read-back
            alive = int(world.sum())           # host scalar of a tensor
            host = np.asarray(world)           # host copy of a tensor
            return out, total + alive + host.size

        def finish(t):
            torch.cuda.synchronize()           # anywhere: drains the queue
            return t
    """, 4, """
        import numpy as np
        import torch

        def step_n_counted(world, n, out=None):
            rows = int(world.shape[0])         # host metadata: free
            if out is None and world.device.type == "cpu":
                out = torch.empty_like(world)
            table = np.asarray([1, 2, 3])      # a host list, not a tensor
            return world + int(n) + rows, table

        def report(t):
            return t.sum().item()              # not hot: once per run
    """),
    "tracer-branch": ("parallel", "bucket.py", """
        def make(step):
            def step_n(stack, k):
                while stack.any():             # bool() of a tensor
                    stack = step(stack)
                if stack.sum() > 0:
                    stack = step(stack)
                return stack, 0
            return step_n
    """, 2, """
        def make(step):
            def step_n(stack, k, out=None):
                if k > 2 and stack.shape[0] > 1:   # statics, metadata
                    stack = step(stack)
                if out is None or isinstance(stack, tuple):
                    out = stack
                return out, 0
            return step_n
    """),
    "recompile": ("sessions", "bucket.py", """
        import ctypes
        import torch
        from gol_tpu_torch.ops import _build

        def fill_bucket(slots, path):
            libs = []
            for slot in slots:
                # One library per slot: the per-slot rebuild shape.
                libs.append(ctypes.CDLL(path))
                _build.load()
            return libs, torch.compile(lambda x: x)
    """, 3, """
        from gol_tpu_torch.ops import _build

        def fill_bucket(slots):
            lib = _build.load()                # once, outside the loop
            return [lib for _ in slots]
    """),
    "dtype-drift": ("", "bitkernels.py", """
        import numpy as np
        import torch

        def kernel(x):
            y = torch.zeros((4, 4), dtype=torch.float32)
            idx = torch.arange(4, dtype=torch.long)
            return x.double() + y, idx, np.zeros(2, np.uint32)
    """, 4, """
        import numpy as np
        import torch

        def kernel(x):
            y = torch.zeros((4, 4), dtype=torch.int32)
            return (x != 0).to(torch.uint8), y, np.zeros(2, np.bool_)
    """),
    "donation": ("parallel", "ring.py", """
        def make(step):
            def step_n(world, k):
                for _ in range(k):
                    world = step(world)
                return world, 0
            return step_n
    """, 1, """
        def make(step):
            def step_n(world, k):
                for _ in range(k):
                    world.copy_(step(world))   # written into the carry
                return world, 0
            return step_n
    """),
    "obs-in-jit": ("ops", "cuda_y.py", """
        from gol_tpu_torch import obs

        _LAUNCHED = obs.counter("launches_total", "kernel launches")

        def _launch(launches, name, like):
            _LAUNCHED.inc()                    # once per kernel launch
            launches[name] += 1
    """, 1, """
        from gol_tpu_torch import obs

        _LAUNCHED = obs.counter("launches_total", "kernel launches")

        def _launch(launches, name, like):
            launches[name] += 1                # a plain int per launch

        def publish(launches):
            _LAUNCHED.inc(sum(launches.values()))
    """),
    "blocking-io-timeout": ("gol_tpu_torch/distributed", "peer.py", """
        import socket
        from gol_tpu_torch.distributed import wire

        def raw_read(sock):
            return sock.recv(4)

        def undeadlined_dial():
            return socket.create_connection(("engine", 8030))

        def undeadlined_stream(conn):
            return wire.recv_msg(conn.sock)
    """, 3, """
        import socket
        from gol_tpu_torch.distributed import wire

        def dial(host):
            sock = socket.create_connection((host, 8030), timeout=30.0)
            sock.settimeout(5.0)
            return wire.recv_msg(sock)
    """),
    "partition-spec": ("parallel", "rogue.py", """
        from torch.distributed.device_mesh import init_device_mesh
        from gol_tpu_torch.parallel import partition
        from gol_tpu_torch.parallel.partition import Mesh, spec

        def build(devices):
            mesh = Mesh(devices, 2, 2)
            return partition.Sharding(mesh, spec("rows", "cols"))
    """, 4, """
        from gol_tpu_torch.parallel import partition

        def build(devices):
            mesh = partition.mesh2d(devices, 2, 2)
            return partition.named_sharding(mesh, ("rows", "cols"))
    """),
}


@pytest.mark.parametrize("check", sorted(CASES))
def test_check_flags_torch_hazard(tmp_path, check):
    subdir, name, bad, count, _ = CASES[check]
    findings = _lint(tmp_path, bad, name, subdir)
    assert [f.check for f in findings] == [check] * count, \
        [f.render() for f in findings]


@pytest.mark.parametrize("check", sorted(CASES))
def test_check_passes_torch_clean_twin(tmp_path, check):
    subdir, name, _, _, good = CASES[check]
    findings = _lint(tmp_path, good, name, subdir)
    assert findings == [], [f.render() for f in findings]


def test_host_sync_and_tracer_branch_messages_name_the_sync(tmp_path):
    hs = _lint(tmp_path, CASES["host-sync"][2], "cuda_x.py", "ops")
    assert any(".item()" in f.message for f in hs)
    assert any("int() of tensor 'world'" in f.message for f in hs)
    tb = _lint(tmp_path, CASES["tracer-branch"][2], "bucket.py", "parallel")
    assert all("bool() host sync" in f.message
               and "torch.where" in f.message for f in tb)


#: check -> findings its positive snippet still gives when staged in a
#: module outside the check's place (a `tools/` file of the same name).
OUT_OF_PLACE = {"host-sync": 1,            # synchronize: anywhere
                "tracer-branch": 0, "donation": 0, "obs-in-jit": 0,
                "blocking-io-timeout": 0, "partition-spec": 0}


@pytest.mark.parametrize("check", sorted(OUT_OF_PLACE))
def test_check_reads_the_module_place(tmp_path, check):
    """The kernel-plane checks read where the module sits: hot code
    outside `ops/` and `parallel/`, a socket read outside the wire
    plane and a placement outside the parallel layer are no findings;
    a synchronize is one anywhere but bench code."""
    _, name, bad, _, _ = CASES[check]
    findings = _lint(tmp_path, bad, name, "tools")
    assert len(findings) == OUT_OF_PLACE[check], [
        f.render() for f in findings]


def test_bench_code_and_non_kernel_modules_are_exempt(tmp_path):
    assert _lint(tmp_path, CASES["host-sync"][2], "cuda_x.py",
                 "bench") == []
    assert _lint(tmp_path, CASES["dtype-drift"][2], "plotting.py") == []


def test_recompile_clean_on_real_bucket_path():
    """The per-slot pair's negative twin on the shipped code: the
    stepper (the bucket factories included) and the sessions package
    carry zero recompile findings — one library load serves every
    slot."""
    paths = [REPO / "gol_tpu_torch" / "parallel" / "stepper.py",
             REPO / "gol_tpu_torch" / "sessions"]
    findings = [f for f in lint_paths(paths, REPO)
                if f.check == "recompile"]
    assert findings == [], [f.message for f in findings]


def test_hot_table_names_the_stepper_entries_and_wrappers():
    """The discovery table: every multi-turn stepper entry of the
    ring factories and the scans, the ring block and the kernel
    wrappers are hot; the obs wrapper's `step_n` is not."""
    hot = set()
    for rel in ("parallel/stepper.py", "parallel/halo.py",
                "parallel/packed_halo.py", "parallel/mesh2d.py",
                "ops/cuda_bitlife.py", "ops/cuda_life.py"):
        path = REPO / "gol_tpu_torch" / rel
        ctx = ModuleContext(path, rel, path.read_text())
        hot |= {f"{rel}::{i.qualname}" for i in ctx.hot.values()}
    for want in ("parallel/stepper.py::scan_diffs.step_n_with_diffs",
                 "parallel/stepper.py::_packed_state_stepper._step_n",
                 "parallel/stepper.py::make_batch_stepper.step_n",
                 "parallel/halo.py::ring_block",
                 "parallel/halo.py::dense_step_n.step_n",
                 "parallel/packed_halo.py::packed_step_n.step_n",
                 "parallel/mesh2d.py::_mesh_stepper.step_n",
                 "ops/cuda_bitlife.py::_launch",
                 "ops/cuda_bitlife.py::_run_passes",
                 "ops/cuda_bitlife.py::step_n_packed_cuda_raw",
                 "ops/cuda_life.py::_run"):
        assert want in hot, want
    assert "parallel/stepper.py::instrument_stepper.step_n" not in hot


# --- framework-neutral parity with gol_tpu's linter ---

_DEADLINED = """
    import socket
    import struct

    def dial(host):
        sock = socket.create_connection((host, 8030), timeout=30.0)
        sock.settimeout(5.0)
        return wire.recv_msg(sock)

    def reader(conn):
        conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                             struct.pack("ll", 30, 0))
        return wire.recv_msg(conn.sock)

    def accept_loop(listener):
        return listener.accept()

    def blocking(peer):
        peer.settimeout(None)              # blocking mode: no deadline
        return wire.recv_msg(peer)
"""


@pytest.mark.parametrize("code", [CASES["blocking-io-timeout"][2],
                                  _DEADLINED],
                         ids=["undeadlined", "deadlined"])
def test_blocking_io_matches_gol_tpu(tmp_path, code):
    """The wire plane's rule is gol_tpu's: the same module in either
    package's distributed/ gives the same findings."""
    mine = _lint(tmp_path / "t", code, "peer.py", "gol_tpu_torch/distributed")
    theirs = _lint(tmp_path / "j", code, "peer.py", "gol_tpu/distributed",
                   lint=jlint)
    assert mine and _keys(mine) == _keys(theirs)


def test_parse_error_matches_gol_tpu(tmp_path):
    mine = _lint(tmp_path / "t", "def broken(:\n", "bad.py")
    theirs = _lint(tmp_path / "j", "def broken(:\n", "bad.py", lint=jlint)
    assert [f.check for f in mine] == ["parse-error"]
    assert [(*k, f.message) for k, f in zip(_keys(mine), mine)] == \
        [(*k, f.message) for k, f in zip(_keys(theirs), theirs)]


_ALLOW = ("host-sync | mod.py | f | known, measured, fine\n"
          "# a comment\n\n"
          "donation | gone.py | g.step_n | fixed long ago\n")


@pytest.mark.parametrize("text", [_ALLOW, "host-sync | a.py | fn |\n",
                                  "host-sync | a.py\n"],
                         ids=["entries", "no-reason", "short"])
def test_allowlist_parsing_matches_gol_tpu(tmp_path, text):
    f = tmp_path / "allow.txt"
    f.write_text(text)
    try:
        theirs = [vars(e) for e in JAllowlist.load(f).entries]
    except JAllowlistError:
        with pytest.raises(AllowlistError):
            Allowlist.load(f)
        return
    assert [vars(e) for e in Allowlist.load(f).entries] == theirs


def test_allowlist_match_and_stale_match_gol_tpu(tmp_path):
    f = tmp_path / "allow.txt"
    f.write_text(_ALLOW)
    live = [Finding("host-sync", "mod.py", 7, "f", "x")]
    mine, theirs = Allowlist.load(f), JAllowlist.load(f)
    assert mine.allows(live[0]) and theirs.allows(live[0])
    assert [e.path for e in mine.stale(live)] == \
        [e.path for e in theirs.stale(live)] == ["gone.py"]
    assert mine.stale(live, scanned={"mod.py"}) == []


def test_list_checks_matches_gol_tpu(capsys):
    from gol_tpu.analysis.__main__ import main as jmain
    from gol_tpu_torch.analysis.__main__ import main

    assert jmain(["--list-checks"]) == 0
    theirs = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert main(["--list-checks"]) == 0
    mine = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert mine == theirs and len(mine) == 12


# --- the allowlist gate over the port's own tree ---


def test_repo_is_clean_under_allowlist():
    """THE gate: `python -m gol_tpu_torch.analysis --strict` on the
    repo — every finding fixed or allowlisted with a reason, no stale
    entries. A new hazard anywhere in gol_tpu_torch/ fails this test."""
    from gol_tpu_torch.analysis.__main__ import main

    assert main(["--strict"]) == 0


def test_allowlist_entries_carry_reasons_and_no_partition_spec():
    allow = Allowlist.load(REPO / "gol_tpu_torch" / "analysis"
                           / "allowlist.txt")
    assert allow.entries
    assert not [e for e in allow.entries if e.check == "partition-spec"]
    assert all(e.path.startswith("gol_tpu_torch/") for e in allow.entries)


def test_strict_on_path_subset_spares_unscanned_entries():
    from gol_tpu_torch.analysis.__main__ import main

    assert main(["--strict", str(REPO / "gol_tpu_torch" / "cli.py")]) == 0


def test_strict_flags_stale_allowlist_entries(tmp_path):
    from gol_tpu_torch.analysis.__main__ import main

    src = tmp_path / "clean.py"
    src.write_text("x = 1\n")
    al = tmp_path / "allow.txt"
    al.write_text("host-sync | clean.py | f | no longer true\n")
    args = [str(src), "--allowlist", str(al), "--root", str(tmp_path)]
    assert main(args) == 0            # lenient: stale tolerated
    assert main(args + ["--strict"]) == 1  # the gate: shrink-only
    al.write_text("host-sync | clean.py | f\n")
    assert main(args) == 2            # a malformed allowlist


def test_linter_loads_neither_torch_jax_nor_gol_tpu():
    """The linter's promise, gol_tpu's: it runs where the code under
    analysis cannot import. A process that lists the checks and lints
    the whole port has loaded no torch, no jax and nothing of
    gol_tpu."""
    code = textwrap.dedent("""
        import sys
        from gol_tpu_torch.analysis.__main__ import main
        assert main(["--list-checks"]) == 0
        assert main(["--strict"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "gol_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
