"""`python -m gol_tpu_torch` on the CPU: the reference flags write the
golden PGM byte for byte, and the unported visualiser is refused."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
#: One intra-op thread for the child's torch (tiny boards; the suite
#: runs beside timing-sensitive tests).
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "gol_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=ENV)


@pytest.mark.parametrize("size,turns", [(64, 100), (16, 1)])
def test_cli_writes_golden_pgm(golden_root, tmp_path, size, turns):
    r = cli("-w", str(size), "-h", str(size), "-turns", str(turns), "-noVis",
            "--platform", "cpu", "--images", str(golden_root / "images"),
            "--out", str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert f"Width: {size}" in r.stdout
    got = (tmp_path / f"{size}x{size}x{turns}.pgm").read_bytes()
    want = golden_root / "check" / "images" / f"{size}x{size}x{turns}.pgm"
    assert got == want.read_bytes()


def test_cli_without_novis_is_refused(tmp_path):
    r = cli("-w", "16", "-h", "16", "-turns", "1", "--platform", "cpu",
            "--out", str(tmp_path))
    assert r.returncode != 0
    assert "visualiser not yet ported" in r.stderr


def test_cli_missing_image_fails(tmp_path):
    r = cli("-w", "16", "-h", "16", "-turns", "1", "-noVis", "--platform",
            "cpu", "--images", str(tmp_path / "none"), "--out", str(tmp_path))
    assert r.returncode == 1
    assert "engine error" in r.stderr
