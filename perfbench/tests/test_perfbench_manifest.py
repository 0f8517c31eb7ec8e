"""`BENCHMARK.json` against the benchmark's contract: names, units,
keys, the metrics each cell reports, and the files the harness finds by
name."""

import json
import pathlib
import re

import pytest

from perfbench import harness
from perfbench import run as bench_run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not re.search(
        r"[\n\r\t]", s)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _text(word) and not word.startswith("/")
        assert ".." not in word.split("/")
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert (ROOT / script).is_file()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        optional = {"workloads"} if section in ("end_to_end",
                                                "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | optional
        assert NAME.fullmatch(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert _text(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in (
                "lower", "higher")


def test_metrics():
    names = {m["name"] for m in METRICS}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert len(names) == len(METRICS) and "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    for c in BENCH["workloads"]:
        assert c["chips"] in (1, 4) and c["config"] in configs
        assert NAME.fullmatch(c["traffic"])
        traffic = json.loads((ROOT / "perfbench" / "traffic"
                              / f"{c['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers"
                / f"{traffic['driver']}.py").is_file()
        e2e = {m["name"] for m in bench_run.cell_metrics(BENCH, c["name"],
                                                         False)}
        layer = bench_run.cell_metrics(BENCH, c["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (c["name"], m["name"])
    for name, cfg in configs.items():
        assert name in {c["config"] for c in BENCH["workloads"]}
        assert cfg["file"].startswith("perfbench/configs/")
        assert cfg["source"].startswith("https://")
        body = json.loads((ROOT / cfg["file"]).read_text())
        assert body["reduced"] == cfg["reduced"]
        assert all(NAME.fullmatch(k) for k in cfg["reduced"])
    assert len({c["file"] for c in configs.values()}) == len(configs)
    assert len({c["source"] for c in configs.values()}) == len(configs)


def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


@pytest.mark.parametrize("name", sorted(m["name"] for m in METRICS))
def test_readers_read_nothing_from_an_empty_run(name):
    reader = bench_run.load(ROOT / "perfbench" / "metrics" / f"{name}.py",
                            f"perfbench_metric_{name}")
    assert reader.read(harness.Seen({"width": 512, "height": 512}, {})) is None
