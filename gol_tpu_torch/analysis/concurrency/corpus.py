"""Corpus runner — prove the concurrency passes flag the shipped bugs.

`tests/fixtures/concurrency/` re-encodes each race gol_tpu shipped and
fixed (the detach deadlock, the attach-under-conn-lock, the writer-pool
peek-then-pop, the WS gauge double decrement, the heartbeat verb
starvation) as a minimal module that imports nothing of either package
and whose first line declares what the analyzer MUST say about it:

    # lint-expect: lock-order[, lock-blocking, ...]

This runner stages every fixture into a `gol_tpu_torch/`-shaped temp
tree (the checks are path-scoped to the serving plane), lints it with
the concurrency checks only, and fails if any declared check does not
fire on its file — the port's analyzer regression-tested against the
bug classes the serving plane it ports actually shipped. It reads
gol_tpu's fixtures in place; `tests/test_torch_analysis_concurrency.py`
runs the same entry in-process.

    python -m gol_tpu_torch.analysis.concurrency.corpus [fixture_dir]
"""

from __future__ import annotations

import pathlib
import re
import shutil
import sys
import tempfile
from typing import Dict, List, Set, Tuple

_EXPECT_RE = re.compile(r"^#\s*lint-expect:\s*(?P<checks>[\w, -]+)\s*$")
_DEFAULT_DIR = "tests/fixtures/concurrency"
#: Where fixtures are staged — inside the checks' serving-plane scope.
_STAGE = "gol_tpu_torch/distributed"


def expected_checks(source: str) -> Set[str]:
    """The checks a fixture's `# lint-expect:` header declares."""
    for line in source.splitlines()[:5]:
        m = _EXPECT_RE.match(line.strip())
        if m:
            return {c.strip() for c in m.group("checks").split(",")
                    if c.strip()}
    return set()


def run_corpus(fixture_dir: pathlib.Path
               ) -> Tuple[List[str], Dict[str, Set[str]]]:
    """(failures, {fixture name: checks that fired}). A fixture with no
    lint-expect header is itself a failure — an undeclared corpus file
    proves nothing."""
    from gol_tpu_torch.analysis.concurrency import CONCURRENCY_CHECKS
    from gol_tpu_torch.analysis.torchlint import lint_paths

    fixtures = sorted(fixture_dir.glob("*.py"))
    failures: List[str] = []
    fired: Dict[str, Set[str]] = {}
    if not fixtures:
        return [f"no corpus fixtures under {fixture_dir}"], fired
    with tempfile.TemporaryDirectory(prefix="gol-corpus-") as td:
        root = pathlib.Path(td)
        stage = root / _STAGE
        stage.mkdir(parents=True)
        expect: Dict[str, Set[str]] = {}
        for f in fixtures:
            expect[f.name] = expected_checks(f.read_text())
            if not expect[f.name]:
                failures.append(f"{f.name}: missing '# lint-expect:' header")
            shutil.copy(f, stage / f.name)
        findings = lint_paths([root / "gol_tpu_torch"], root,
                              checks=CONCURRENCY_CHECKS)
        for fd in findings:
            fired.setdefault(pathlib.Path(fd.path).name, set()).add(fd.check)
        for name, want in expect.items():
            missing = want - fired.get(name, set())
            if missing:
                failures.append(
                    f"{name}: expected {sorted(missing)} to fire, got "
                    f"{sorted(fired.get(name, set())) or 'nothing'}")
    return failures, fired


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    fixture_dir = pathlib.Path(args[0] if args else _DEFAULT_DIR)
    if not fixture_dir.is_dir():
        print(f"corpus: no such fixture dir {fixture_dir}", file=sys.stderr)
        return 2
    failures, fired = run_corpus(fixture_dir)
    for name in sorted(fired):
        print(f"corpus: {name}: {', '.join(sorted(fired[name]))}")
    if failures:
        for f in failures:
            print(f"corpus FAIL: {f}", file=sys.stderr)
        return 1
    print(f"corpus: {len(fired)} fixture(s), every declared check fired")
    return 0


if __name__ == "__main__":
    sys.exit(main())
