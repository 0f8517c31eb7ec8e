"""The port's checkpoints against gol_tpu's: the `checkpoint` helpers on
the same directories, the CLI's `--resume` (a file and `latest`) against
the golden PGMs and its errors, a Generations resume that reproduces the
direct run, `--autosave-turns` snapshots byte-equal to gol_tpu's at the
same turns, the `--tick`/`--autosave-*` flags, and an abandoned
infinite run that must not hang interpreter exit."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import gol_tpu
from gol_tpu import checkpoint as jck
from gol_tpu import cli as jcli
from gol_tpu.engine import distributor as jd
from gol_tpu_torch import checkpoint as tck
from gol_tpu_torch import cli as tcli
from gol_tpu_torch import obs as tobs
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.params import Params

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_checkpoint_helpers_match_gol_tpu(tmp_path):
    d = tmp_path / "out"
    d.mkdir()
    for name in ("64x64x20.pgm", "64x64x0100.pgm", "64x64x100.pgm",
                 "32x32x900.pgm", "64x64x7.pgm.tmp", "notes.txt"):
        (d / name).write_bytes(b"")
    sessions = tmp_path / "sess"
    (sessions / "sessions" / "a").mkdir(parents=True)
    (sessions / "sessions" / "manifest.json").write_text(
        '{"sessions": {"a": {"width": 64, "parked": true}, "b": 3}}')
    (sessions / "sessions" / "a" / ".tombstone").write_text("")
    calls = [
        ("latest_snapshot", (d, 64, 64)),
        ("latest_snapshot", (d, 16, 16)),
        ("latest_snapshot", (tmp_path / "missing", 64, 64)),
        ("latest_any_snapshot", (d,)),
        ("snapshot_turn", ("out/512x512x50.pgm",)),
        ("session_checkpoint_dir", (sessions,)),
        ("session_manifest_path", (sessions,)),
        ("read_session_manifest", (sessions,)),
        ("read_session_manifest", (d,)),
        ("tombstone_path", (sessions, "a")),
        ("is_tombstoned", (sessions, "a")),
        ("is_tombstoned", (sessions, "b")),
        ("manifest_parked", ({"parked": True},)),
        ("manifest_parked", ({"parked": False},)),
    ]
    for name, args in calls:
        assert getattr(tck, name)(*args) == getattr(jck, name)(*args), name
    assert tck.latest_snapshot(d, 64, 64).endswith("64x64x0100.pgm")
    for bad in ("backup.pgm", "64x64.pgm"):
        for mod in (tck, jck):
            with pytest.raises(ValueError, match="not a snapshot filename"):
                mod.snapshot_turn(bad)
    assert tck.TOMBSTONE == jck.TOMBSTONE


def _resume_gauge() -> float:
    return tobs.registry().gauge("gol_tpu_resume_turn").value


def _cli(*argv):
    return tcli.main([*argv, "--platform", "cpu"])


@pytest.mark.parametrize("how", ["file", "latest"])
def test_cli_resume_reproduces_the_golden_pgm(golden_root, tmp_path, how):
    """A 64² run autosaves at turn 50; resuming from that snapshot (by
    path, or as the newest one in --out) writes the golden turn-100 PGM
    and publishes the resumed turn."""
    first = tmp_path / "first"
    assert _cli("-w", "64", "-h", "64", "-turns", "100", "-noVis",
                "--autosave-turns", "50", "--images",
                str(golden_root / "images"), "--out", str(first)) == 0
    snap = first / "64x64x50.pgm"
    out = tmp_path / "resumed"
    out.mkdir()
    if how == "file":
        resume = str(snap)
    else:
        shutil.copy(snap, out / snap.name)
        resume = "latest"
    assert _cli("-w", "64", "-h", "64", "-turns", "100", "-noVis",
                "--images", str(tmp_path / "no-images"), "--out", str(out),
                "--resume", resume) == 0
    assert _resume_gauge() == 50
    want = golden_root / "check" / "images" / "64x64x100.pgm"
    assert (out / "64x64x100.pgm").read_bytes() == want.read_bytes()
    assert (first / "64x64x100.pgm").read_bytes() == want.read_bytes()


@pytest.mark.parametrize("setup,argv,message", [
    (None, ["--resume", "latest"], "no 64x64 snapshot"),
    ("backup.pgm", ["--resume", "{out}/backup.pgm"],
     "not a snapshot filename"),
    ("64x64x300.pgm", ["-turns", "100", "--resume", "latest"],
     "turn 300, beyond -turns 100"),
], ids=["latest-empty-out", "bad-filename", "beyond-turns"])
def test_cli_resume_errors_match_gol_tpu(tmp_path, monkeypatch, setup, argv,
                                        message):
    # gol_tpu's main arms process-wide planes (SIGTERM dump, compile
    # watcher, cost probes, a usage ledger) before it validates --resume;
    # they stay off here, so the rest of this worker's tests see none.
    from gol_tpu.obs import accounting, device, flight

    for mod, name in ((flight, "install_sigterm_handler"),
                      (flight, "configure"),
                      (device, "install_compile_watcher"),
                      (device, "enable_cost_probes"),
                      (accounting, "configure")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    if setup is not None:
        (tmp_path / setup).write_bytes(b"P5\n1 1\n255\n\x00")
    argv = ["-w", "64", "-h", "64", "-noVis", "--out", str(tmp_path),
            *(a.format(out=tmp_path) for a in argv)]
    errors = []
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--platform", "cpu"])
        errors.append(str(exc.value))
    assert message in errors[0]
    assert errors[0] == errors[1]


def _engine_run(eng_mod, p, **kw):
    extra = {"device": "cpu"} if eng_mod is td else {}
    engine = eng_mod.Engine(p, emit_flips=False, **kw, **extra)
    engine.start()
    engine.join(60)
    assert engine.error is None


def test_generations_resume_exact(golden_root, tmp_path):
    """A B2/S/C3 run resumed from its turn-20 snapshot writes the same
    turn-40 gray-level PGM as the direct run, and as gol_tpu's."""
    kw = dict(turns=40, threads=1, image_width=64, image_height=64,
              rule="B2/S/C3", chunk=4, tick_seconds=60.0,
              image_dir=str(golden_root / "images"))
    _engine_run(td, Params(out_dir=str(tmp_path / "direct"), **kw))
    _engine_run(td, Params(out_dir=str(tmp_path / "half"),
                           **{**kw, "turns": 20}))
    snap = read_pgm(tmp_path / "half" / "64x64x20.pgm")
    _engine_run(td, Params(out_dir=str(tmp_path / "res"), **kw),
                initial_world=snap, start_turn=20)
    _engine_run(jd, gol_tpu.Params(out_dir=str(tmp_path / "jax"), **kw))
    direct = (tmp_path / "direct" / "64x64x40.pgm").read_bytes()
    assert (tmp_path / "res" / "64x64x40.pgm").read_bytes() == direct
    assert (tmp_path / "jax" / "64x64x40.pgm").read_bytes() == direct


def test_autosave_pgms_match_gol_tpu(golden_root, tmp_path):
    """`--autosave-turns 16` writes a snapshot every 16 turns, each
    byte-equal to gol_tpu's at the same turn (its engine with the same
    Params)."""
    assert _cli("-w", "64", "-h", "64", "-turns", "50", "-noVis",
                "--autosave-turns", "16", "--images",
                str(golden_root / "images"),
                "--out", str(tmp_path / "torch")) == 0
    _engine_run(jd, gol_tpu.Params(
        turns=50, threads=1, image_width=64, image_height=64, chunk=0,
        autosave_turns=16, tick_seconds=60.0,
        image_dir=str(golden_root / "images"),
        out_dir=str(tmp_path / "jax")))
    names = sorted(p.name for p in (tmp_path / "torch").glob("*.pgm"))
    assert names == ["64x64x16.pgm", "64x64x32.pgm", "64x64x48.pgm",
                     "64x64x50.pgm"]
    for name in names:
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_tick_and_autosave_flags_match_gol_tpu(golden_root, tmp_path,
                                               capsys):
    """The flags parse as gol_tpu's do, reach Params, and `--tick` sets
    the AliveCellsCount cadence the visualiser loop prints."""
    for argv in ([], ["--tick", "0.25", "--autosave-turns", "7",
                      "--autosave-secs", "1.5"]):
        t, j = (m.build_parser().parse_args(argv) for m in (tcli, jcli))
        for flag in ("tick", "autosave_turns", "autosave_secs", "resume",
                     "check_invariants", "profile_dir"):
            assert getattr(t, flag) == getattr(j, flag), flag
    assert _cli("-w", "64", "-h", "64", "-turns", "2000", "--tick", "0.02",
                "--images", str(golden_root / "images"),
                "--out", str(tmp_path)) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.endswith("Cells Alive")]
    assert len(lines) >= 2, lines


def test_abandoned_engine_does_not_hang_exit(golden_root, tmp_path):
    """A started-and-forgotten infinite engine must not pin interpreter
    shutdown (non-daemon thread + the registered exit stop)."""
    code = f"""
import sys; sys.path.insert(0, {str(REPO)!r})
from gol_tpu_torch import Params, run
events = run(Params(turns=10**10, threads=1, image_width=16, image_height=16,
                    chunk=8, image_dir={str(golden_root / 'images')!r},
                    out_dir={str(tmp_path)!r}), device="cpu")
next(iter(events))  # touch the stream, then abandon everything
print("abandoning")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    assert "abandoning" in r.stdout
