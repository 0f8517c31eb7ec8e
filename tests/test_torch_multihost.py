"""The port's multi-process jobs (`gol_tpu_torch.parallel.multihost`,
gloo on the CPU), held against gol_tpu's SINGLE-process results.

- the single-process cases of `tests/test_multihost.py`: the no-op
  initialize, partial arguments refused, the identity, a ring over the
  global devices driving a sharded stepper;
- a two-process job of `--platform cpu` ranks, each owning two CPU
  shards: every ring family (packed Life 256² and its balanced split at
  320², B2/S/C3 planes, the dense ring) and a 2x2 mesh over the two
  processes give the boards, counts, masks, diff stacks, sparse rows,
  the sparse-overflow redo and compact chunks of gol_tpu's
  single-device stepper for the same seed (never gol_tpu's own
  two-process run, whose balanced split fails on the reference);
- the CLI pair's PGM byte-equal to gol_tpu's single-process CLI's, with
  autosave and `--resume latest` across the pair; a config mismatch that
  fails fast in both processes; a worker that exits when its
  coordinator is SIGKILLed;
- the mirror's token discipline: its raises and its opcode stream
  against gol_tpu's, in one process with the broadcast recorded.

Every spawned process has a deadline and is reaped in a `finally`."""

import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
#: One intra-op thread for the children's torch (tiny boards).
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
#: Seconds a process pair may take (two torch imports and a gloo
#: rendezvous are ~5 s on an idle box; a loaded one is slower).
DEADLINE = 240

torch.set_num_threads(1)


def _free_port() -> int:
    """A free port below the kernel's ephemeral range, so that no
    server of a concurrent test binding port 0 can take it between
    this check and the job's rendezvous."""
    while True:
        port = random.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def _pair(argvs, cwd, deadline=DEADLINE):
    """Run one process per argv, all at once; return [(rc, output)].
    Every process is killed and reaped if the deadline passes."""
    procs = [subprocess.Popen(argv, cwd=cwd, env=ENV,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        outs = []
        end = time.monotonic() + deadline
        for p in procs:
            out, _ = p.communicate(timeout=max(1, end - time.monotonic()))
            outs.append((p.returncode, out))
        return outs
    except subprocess.TimeoutExpired:
        pytest.fail(f"process pair {argvs[0][:4]} passed its deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


# --- one process ---------------------------------------------------------

_JOB_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "JAX_COORDINATOR_ADDRESS")


def test_initialize_is_noop_without_coordinator(monkeypatch):
    from gol_tpu.parallel import multihost as jmh
    from gol_tpu_torch.parallel import multihost

    for v in _JOB_VARS:
        monkeypatch.delenv(v, raising=False)
    multihost.initialize()
    jmh.initialize()
    assert multihost.job() is None and multihost.process_count() == 1


@pytest.mark.parametrize("kw", [{"num_processes": 4}, {"process_id": 1}])
def test_initialize_rejects_partial_args(monkeypatch, kw):
    from gol_tpu.parallel import multihost as jmh
    from gol_tpu_torch.parallel import multihost

    for v in _JOB_VARS:
        monkeypatch.delenv(v, raising=False)
    msgs = []
    for mod in (multihost, jmh):
        with pytest.raises(ValueError) as e:
            mod.initialize(**kw)
        msgs.append(str(e.value))
    want = ("num_processes/process_id given without a coordinator "
            "address")
    assert all(m.startswith(want) for m in msgs), msgs


@pytest.mark.parametrize("env,match", [
    ({"MASTER_ADDR": "127.0.0.1"}, "without MASTER_PORT"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"},
     "process count and this process's id"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2",
      "RANK": "2"}, "not in a 2-process job"),
])
def test_torchrun_variables_partial_sets_raise(monkeypatch, env, match):
    from gol_tpu_torch.parallel import multihost

    for v in _JOB_VARS:
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        multihost.initialize(device="cpu")
    assert multihost.job() is None


def test_single_process_identity():
    from gol_tpu.parallel import multihost as jmh
    from gol_tpu_torch.parallel import multihost

    assert multihost.is_coordinator() and jmh.is_coordinator()
    assert multihost.device_count("cpu") == 1
    assert jmh.device_count() == 8  # the forced CPU devices (conftest)
    assert not multihost.is_multiprocess_mesh([torch.device("cpu")] * 4)
    mesh = multihost.global_ring_mesh("cpu")
    assert (mesh.rows, mesh.cols, mesh.owners) == (1, 1, None)
    multihost.notify_stop()  # one process: nothing to release
    multihost.verify_job_config(1, 2, 3)
    # One process: the put places every block, the fetch is a transfer.
    from gol_tpu_torch.parallel import partition

    host = np.arange(64 * 8, dtype=np.int32).reshape(64, 8)
    sharding = partition.Sharding(partition.ring_mesh(["cpu"] * 4),
                                  partition.spec("rows"))
    placed = multihost.spmd_put(sharding, host)
    assert all(p is not None for p in placed.parts)
    np.testing.assert_array_equal(multihost.spmd_fetch(placed),
                                  host.view(np.int32))
    np.testing.assert_array_equal(
        multihost.spmd_fetch(torch.from_numpy(host)), host)


def test_global_ring_mesh_drives_sharded_stepper():
    """gol_tpu's test: its global ring mesh's 8 devices drive a packed
    ring; here the same 8-shard ring over the CPU (one process's global
    devices, repeated) against gol_tpu's."""
    from gol_tpu.models.rules import LIFE as JLIFE
    from gol_tpu.ops import life as jlife
    from gol_tpu.parallel import multihost as jmh
    from gol_tpu.parallel.packed_halo import packed_sharded_stepper as jps
    from gol_tpu_torch.models.rules import LIFE
    from gol_tpu_torch.parallel import multihost
    from gol_tpu_torch.parallel.packed_halo import packed_sharded_stepper

    world = np.asarray(jlife.random_world(256, 64, density=0.3, seed=5))
    j = jps(JLIFE, list(jmh.global_ring_mesh().devices.flat), height=256)
    t = packed_sharded_stepper(
        LIFE, multihost.global_devices("cpu") * 8, 256, 64)
    jp, jc = j.step_n(j.put(world), 11)
    tp, tc = t.step_n(t.put(world), 11)
    np.testing.assert_array_equal(t.fetch(tp), np.asarray(j.fetch(jp)))
    assert int(tc) == int(jc)


# --- the mirror's token discipline, in one process -----------------------


def _recorded(monkeypatch, mod, inner, host_shape):
    """`mod.spmd_stepper(inner)` with its broadcasts recorded instead
    of sent (so the wrapper runs in one process)."""
    sent = []

    def bcast_cmd(op, arg=0, arg2=0):
        sent.append((op, int(arg), int(arg2)))
        return op, int(arg), int(arg2)

    monkeypatch.setattr(mod, "_bcast_cmd", bcast_cmd)
    monkeypatch.setattr(mod, "_bcast", lambda value: np.asarray(value))
    return mod.spmd_stepper(inner), sent


def test_spmd_token_discipline_and_opcodes_match_gol_tpu(monkeypatch):
    import jax

    from gol_tpu.parallel import multihost as jmh
    from gol_tpu.parallel.stepper import make_stepper as jmake
    from gol_tpu_torch.parallel import multihost
    from gol_tpu_torch.parallel.stepper import make_stepper

    rng = np.random.default_rng(3)
    world = ((rng.random((64, 64)) < 0.3) * 255).astype(np.uint8)
    t, t_sent = _recorded(monkeypatch, multihost, make_stepper(
        threads=2, height=64, width=64, devices=["cpu"] * 2), (64, 64))
    j, j_sent = _recorded(monkeypatch, jmh, jmake(
        threads=2, height=64, width=64, devices=jax.devices()[:2]),
        (64, 64))
    assert t.name == "spmd-packed-halo-ring-2" and t.name == j.name
    assert t.capabilities() == j.capabilities()
    for s in (t, j):
        p = s.put(world)
        p, _ = s.step_n(p, 5)
        older = p
        p, mask, _ = s.step_with_diff(p)
        s.fetch(mask)
        p, diffs, _ = s.step_n_with_diffs(p, 3)
        s.fetch_diffs(diffs)
        prev = p
        p, _rows, _ = s.step_n_with_diffs_sparse(prev, 2, 16)
        with pytest.raises(RuntimeError, match="through the plain dense"):
            s.step_n_with_diffs(prev, 2)
        with pytest.raises(RuntimeError, match="unrecognized world"):
            s.step_n_with_diffs(older, 2)
        with pytest.raises(RuntimeError, match="exact input world"):
            s.step_n_with_diffs_redo(p, 2)
        with pytest.raises(RuntimeError, match="another sparse dispatch"):
            s.step_n_with_diffs_sparse(prev, 2, 16)
        with pytest.raises(RuntimeError, match="compact diffs dispatch"):
            s.step_n_with_diffs_compact(prev, 2, 64)
        p, _d, _ = s.step_n_with_diffs_redo(prev, 2)
        with pytest.raises(RuntimeError, match="no sparse dispatch"):
            s.step_n_with_diffs_redo(p, 2)
        p, _h, _v, _ = s.step_n_with_diffs_compact(p, 2, 64)
        p, _d, _ = s.step_n_with_diffs(p, 1)  # continues from its output
        p, _ = s.step_n(p, 3)
        s.alive_count_async(p)
        s.fetch(p)
    assert t_sent == j_sent
    assert (multihost._OP_FETCH_WORLD, multihost._OP_FETCH_MASK,
            multihost._OP_STOP) == (jmh._OP_FETCH_WORLD, jmh._OP_FETCH_MASK,
                                    jmh._OP_STOP)
    assert multihost._OPS == jmh._OPS


# --- two processes over gloo ---------------------------------------------

#: (name, rule, height, width, mesh): every ring family and a 2x2 mesh
#: over 2 processes x 2 CPU shards.
CASES = [
    ("life-256", "B3/S23", 256, 64, None),
    ("life-320-balanced", "B3/S23", 320, 64, None),
    ("gens-256", "B2/S/C3", 256, 64, None),
    ("dense-100", "B3/S23", 100, 48, None),
    ("mesh-2x2", "B3/S23", 128, 64, "2x2"),
]
NAMES = {
    "life-256": "packed-halo-ring-4",
    "life-320-balanced": "packed-halo-ring-uneven-4",
    "gens-256": "gens-packed-halo-ring-4",
    "dense-100": "halo-ring-4",
    "mesh-2x2": "packed-mesh2d-2x2",
}

#: One job runs every case: each case a stepper, a dispatch sequence
#: on the coordinator (the workers replay it), `notify_stop`.
_JOB = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from gol_tpu_torch.parallel import multihost
from gol_tpu_torch.parallel.stepper import make_stepper, compact_value_prefix
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(sys.argv[4])
multihost.initialize(f"127.0.0.1:{port}", 2, rank, local_devices=["cpu"] * 2)
names = {}
for name, rule, h, w, mesh in cases:
    s = make_stepper(threads=4, height=h, width=w, rule=rule, mesh=mesh)
    names[name] = s.name
    if not multihost.is_coordinator():
        multihost.spmd_worker_loop(s, h, w)
        continue
    rng = np.random.default_rng(len(name))
    world = ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)
    r = {}
    p = s.put(world)
    p, c = s.step_n(p, 40)
    r["board40"], r["count40"] = s.fetch(p), int(c)
    p, mask, c = s.step_with_diff(p)
    r["mask"], r["count_diff"] = s.fetch(mask), int(c)
    p, diffs, c = s.step_n_with_diffs(p, 5)
    r["diffs"], r["count_diffs"] = s.fetch_diffs(diffs), int(c)
    if s.step_n_with_diffs_sparse is not None:
        prev = p
        p, rows, c = s.step_n_with_diffs_sparse(prev, 3, 8)
        r["sparse"], r["count_sparse"] = rows.cpu().numpy(), int(c)
        p, diffs, c = s.step_n_with_diffs_redo(prev, 3)
        r["redo"], r["count_redo"] = s.fetch_diffs(diffs), int(c)
        p, hdr, vals, c = s.step_n_with_diffs_compact(p, 4, 4096)
        hdr = hdr.cpu().numpy()
        total = int(hdr.view(np.uint32)[:, 0].sum())
        r["headers"] = hdr
        r["values"] = s.fetch_compact_values(vals, total)[:total]
        r["count_compact"] = int(c)
    p, c = s.step_n(p, 20)
    r["board"], r["count"] = s.fetch(p), int(c)
    r["stats"] = np.asarray([multihost.job().stats["exchanges"],
                             multihost.job().stats["bytes"]])
    np.savez(f"{out}/{name}.npz", **r)
    multihost.notify_stop()
print("JOB_OK", rank, json.dumps(names), flush=True)
"""


def _gol_tpu_reference(rule, h, w, name):
    """The same dispatch sequence on gol_tpu's single-device stepper
    (its dense entry redoes the sparse chunk, as its engine does when a
    stepper offers no redo entry)."""
    import jax

    from gol_tpu.parallel.stepper import make_stepper as jmake

    s = jmake(threads=1, height=h, width=w, rule=rule,
              devices=jax.devices()[:1])
    rng = np.random.default_rng(len(name))
    world = ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)
    r = {}
    host = (lambda a: np.ascontiguousarray(np.asarray(a)))
    p = s.put(world)
    p, c = s.step_n(p, 40)
    r["board40"], r["count40"] = host(s.fetch(p)), int(c)
    p, mask, c = s.step_with_diff(p)
    r["mask"], r["count_diff"] = host(s.fetch(mask)), int(c)
    p, diffs, c = s.step_n_with_diffs(p, 5)
    r["diffs"], r["count_diffs"] = host(diffs), int(c)
    if s.step_n_with_diffs_sparse is not None:
        prev = p
        p, rows, c = s.step_n_with_diffs_sparse(prev, 3, 8)
        r["sparse"], r["count_sparse"] = host(rows), int(c)
        p, diffs, c = s.step_n_with_diffs(prev, 3)
        r["redo"], r["count_redo"] = host(diffs), int(c)
        p, hdr, vals, c = s.step_n_with_diffs_compact(p, 4, 4096)
        hdr = host(hdr)
        total = int(hdr.view(np.uint32)[:, 0].sum())
        r["headers"] = hdr
        r["values"] = host(vals).view(np.uint32)[:total]
        r["count_compact"] = int(c)
    p, c = s.step_n(p, 20)
    r["board"], r["count"] = host(s.fetch(p)), int(c)
    return r


@pytest.fixture(scope="module")
def job_results(tmp_path_factory):
    """Run the two-process job once for every case; {name: npz}, and
    each rank's stepper names."""
    import json

    out = tmp_path_factory.mktemp("mhjob")
    port = _free_port()
    cases = json.dumps(CASES)
    res = _pair([[sys.executable, "-c", _JOB, str(r), str(port), str(out),
                  cases] for r in (0, 1)], cwd=out)
    for rc, text in res:
        assert rc == 0, text[-3000:]
    names = [json.loads(text.split("JOB_OK ", 1)[1].split(" ", 1)[1]
                        .splitlines()[0]) for _, text in res]
    return {name: dict(np.load(out / f"{name}.npz")) for name, *_ in CASES}, \
        names


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_two_process_job_equals_gol_tpu_single_device(job_results, case):
    name, rule, h, w, mesh = case
    got, names = job_results
    assert names[0][name] == f"spmd-{NAMES[name]}"  # the coordinator's
    assert names[1][name] == NAMES[name]  # the worker's ring itself
    want = _gol_tpu_reference(rule, h, w, name)
    got = got[name]
    assert set(want) <= set(got)
    for key, value in want.items():
        g = got[key]
        if np.ndim(value) == 0:
            assert int(g) == int(value), key
        else:
            g = np.ascontiguousarray(g)
            assert g.shape == value.shape, key
            np.testing.assert_array_equal(
                g.view(np.uint8), np.ascontiguousarray(value).view(np.uint8),
                err_msg=key)
    # Every ring boundary of the round-robin ring crosses the processes,
    # so both directions of each exchange went over gloo.
    assert got["stats"][0] > 0 and got["stats"][1] > 0


# --- the CLI pair ----------------------------------------------------------


def _cli(pid, port, out, extra, width=64):
    return [sys.executable, "-m", "gol_tpu_torch", "-w", str(width),
            "-h", "64", "-t", "8", "-noVis", "--platform", "cpu",
            "--chunk", "16", "--images", str(REPO / "fixtures" / "images"),
            "--out", str(out), "--mh-coordinator", f"127.0.0.1:{port}",
            "--mh-procs", "2", "--mh-id", str(pid), *extra]


def _gol_tpu_cli_pgm(tmp_path, monkeypatch) -> bytes:
    """gol_tpu's single-process CLI on the same board, in this process
    (its process-wide planes kept off, as the checkpoint tests do)."""
    from gol_tpu import cli as jcli
    from gol_tpu.obs import accounting, device, flight

    for mod, name in ((flight, "install_sigterm_handler"),
                      (flight, "configure"),
                      (device, "install_compile_watcher"),
                      (device, "enable_cost_probes"),
                      (accounting, "configure")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    out = tmp_path / "jout"
    assert jcli.main(["-w", "64", "-h", "64", "-t", "1", "-noVis",
                      "-turns", "100", "--platform", "cpu",
                      "--images", str(REPO / "fixtures" / "images"),
                      "--out", str(out)]) == 0
    return (out / "64x64x100.pgm").read_bytes()


def test_cli_pair_pgm_autosave_and_resume(tmp_path, monkeypatch):
    """A coordinator and a worker `python -m gol_tpu_torch` on a 2-shard
    ring: autosaves at turns 30 and 60 and the board at 64, then a fresh
    pair resumes from the latest snapshot to turn 100, byte-equal to
    gol_tpu's single-process CLI; and one pair straight to turn 100."""
    out = tmp_path / "out"
    port = _free_port()
    for rc, text in _pair([_cli(r, port, out, ["-turns", "64",
                                               "--autosave-turns", "30"])
                           for r in (0, 1)], cwd=tmp_path):
        assert rc == 0, text[-3000:]
    for turn in (30, 60, 64):
        assert (out / f"64x64x{turn}.pgm").exists()
    port = _free_port()
    for rc, text in _pair([_cli(r, port, out, ["-turns", "100",
                                               "--resume", "latest"])
                           for r in (0, 1)], cwd=tmp_path):
        assert rc == 0, text[-3000:]
    want = _gol_tpu_cli_pgm(tmp_path, monkeypatch)
    assert (out / "64x64x100.pgm").read_bytes() == want
    straight = tmp_path / "straight"
    port = _free_port()
    res = _pair([_cli(r, port, straight, ["-turns", "100"])
                 for r in (0, 1)], cwd=tmp_path)
    assert [rc for rc, _ in res] == [0, 0], res[0][1][-2000:]
    assert "kernel launches" in res[1][1]  # the worker's, as it ends
    assert (straight / "64x64x100.pgm").read_bytes() == want


def test_cli_pair_config_mismatch_fails_fast_everywhere(tmp_path):
    """Processes launched with different board sizes both exit nonzero
    with gol_tpu's diagnostic, the coordinator included."""
    port = _free_port()
    res = _pair([_cli(0, port, tmp_path, ["-turns", "10"], width=64),
                 _cli(1, port, tmp_path, ["-turns", "10"], width=128)],
                cwd=tmp_path, deadline=120)
    assert [rc != 0 for rc, _ in res] == [True, True], res
    for _, text in res:
        assert "multi-host config mismatch" in text


@pytest.mark.parametrize("argv,match", [
    (["--mh-procs", "2"], "num_processes/process_id given without a "
     "coordinator address"),
    (["--mh-id", "1"], "num_processes/process_id given without a "
     "coordinator address"),
    (["--mh-coordinator", "127.0.0.1:1", "--mh-procs", "2", "--mh-id",
      "5"], "not in a 2-process job"),
    (["--mh-coordinator", "nohostport", "--mh-procs", "2", "--mh-id",
      "0"], "is not HOST:PORT"),
])
def test_cli_mh_flags_refused(argv, match, monkeypatch):
    """The flags' refusals, before anything touches a device; the first
    two are gol_tpu's own."""
    from gol_tpu import cli as jcli
    from gol_tpu_torch import cli

    for v in _JOB_VARS:
        monkeypatch.delenv(v, raising=False)
    base = ["-w", "64", "-h", "64", "-noVis", "--platform", "cpu"]
    with pytest.raises(SystemExit, match=match):
        cli.main(base + argv)
    if "given without" in match:
        with pytest.raises(SystemExit, match=match):
            jcli.main(base + argv)


def test_worker_exits_when_coordinator_is_sigkilled(tmp_path):
    """A coordinator SIGKILLed mid-run: its worker's next exchange or
    opcode wait fails on the closed connection, and it exits 1 with the
    error, long before the job's timeout."""
    out = tmp_path / "out"
    port = _free_port()
    log = tmp_path / "coordinator.log"
    argvs = [_cli(r, port, out, ["-turns", str(10 ** 9),
                                 "--metrics-port", "0"])
             for r in (0, 1)]
    with open(log, "w") as f:
        procs = [subprocess.Popen(argvs[0], cwd=tmp_path, env=ENV,
                                  stdout=f, stderr=subprocess.STDOUT)]
    procs.append(subprocess.Popen(argvs[1], cwd=tmp_path, env=ENV,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    try:
        # The coordinator's sidecar starts once both processes joined
        # and checked their configs, and its engine is stepping.
        deadline = time.monotonic() + DEADLINE
        while "metrics serving on" not in log.read_text():
            assert procs[0].poll() is None, log.read_text()[-2000:]
            assert time.monotonic() < deadline, "the job never started"
            time.sleep(0.2)
        time.sleep(1.0)
        assert procs[1].poll() is None, "worker ended before the kill"
        procs[0].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        text, _ = procs[1].communicate(timeout=120)
        assert procs[1].returncode == 1, text[-2000:]
        assert time.monotonic() - t0 < 60
        assert "error:" in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
