"""Run one benchmark cell of gol_tpu_torch and print its result.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`perfbench/configs/<config>.json`) and a traffic
mix (`perfbench/traffic/<traffic>.json`), which names its driver
(`perfbench/drivers/<driver>.py`). The driver runs the program through
one window of S seconds and checks what it produced against the plain
reference; each metric is read by `perfbench/metrics/<metric>.py`. With
--trace 0 the cell's end-to-end metrics are reported, with --trace 1
its per-layer metrics, read from a `torch.profiler` capture of the
window and the program's counters.

The last line on stdout is one JSON object: correct, attempted, failed,
metrics, device (and breakdown with --trace 1), and last the numbers the
check compared, each beside its limit; those numbers are also the last
lines on stderr. The run exits non-zero, and prints no result, without
enough CUDA cards, when the program cannot be imported, on any error,
or when `jax`, `jaxlib`, `flax` or `gol_tpu` was loaded.
"""

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
#: Top-level modules the port must not load.
BANNED = ("jax", "jaxlib", "flax", "gol_tpu")


def load(path: pathlib.Path, name: str):
    """Import a file of this folder by path (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cell_metrics(bench_json: dict, workload: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    `trace` its per-layer metrics (those listing the cell, and those
    without a list whose end-to-end metric the cell reports)."""
    e2e = [m for m in bench_json["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench_json["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((c for c in bench_json["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    # Kernel caches at fixed paths inside the checkout (the port's own
    # nvcc build already lives under build/gol_tpu_torch/).
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "perfbench" / sub))
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(bench_json, cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_PROC)
    except Exception:  # noqa: BLE001 - any failure: no result, non-zero
        traceback.print_exc()
        return 1
    found = banned_modules()
    if found:
        print(f"perfbench: loaded {found}; the port must not load them",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench_json: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t_proc: float,
             config: "dict | None" = None, traffic: "dict | None" = None,
             control: bool = False) -> tuple:
    """Run one cell through its driver; (result dict, checks). `config`
    and `traffic` replace the cell's files (the CPU tests run tiny
    boards); `control` puts the control in the program's place in the
    check (`control.py`)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import harness

    if config is None:
        config = json.loads(
            (HERE / "configs" / f"{cell['config']}.json").read_text())
    if traffic is None:
        traffic = json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load(HERE / "drivers" / f"{traffic['driver']}.py",
                  f"perfbench_driver_{traffic['driver']}")
    entries = cell_metrics(bench_json, cell["name"], trace)
    readers = {m["name"]: load(HERE / "metrics" / f"{m['name']}.py",
                               f"perfbench_metric_{m['name']}")
               for m in entries}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        bench = harness.Bench(seed % (1 << 63), seconds, trace, config,
                              traffic, device, tmp, t_proc, control)
        seen = driver.run(bench)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(seen)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = seen.failed == 0 and all(c.ok for c in seen.checks)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": seen.memory_peak_bytes}
    if device != "cpu":
        import torch

        dev.update(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=cell["chips"])
    if seen.trace is not None:
        dev.update(busy_s=seen.trace["busy_s"],
                   window_s=seen.trace["window_s"])
    # The card's power limit and SM clock, read beside the window.
    dev.update(seen.notes.get("card", {}))
    print("perfbench notes " + json.dumps(seen.notes, default=str),
          flush=True)
    result = {"correct": correct, "attempted": seen.attempted,
              "failed": seen.failed, "metrics": metrics, "device": dev}
    if seen.trace is not None:
        result["breakdown"] = {"device_ops": seen.trace["device_ops"],
                               "idle_gaps": seen.trace["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in seen.checks}
    return result, seen.checks


if __name__ == "__main__":
    sys.exit(main())
