"""perfbench — the benchmark of gol_tpu_torch, the PyTorch / CUDA port.

Run one cell from the root of a checkout:

    python3 perfbench/run.py --workload life-5120.batch --seed 7 \
        --seconds 30 --trace 0

`BENCHMARK.json` (at the root) names the cells. Everything a cell needs
is found by name under this folder, so a new configuration, traffic mix,
driver or metric is a new file here and a new entry there:

- `configs/<config>.json`: the deployment (board sizes, rule);
- `traffic/<traffic>.json`: which driver runs the cell and its
  parameters (rates, connections, warm-up, samples the check reads);
- `drivers/<driver>.py`: `run(bench)` drives the program through one
  measured window and returns what was seen (`harness.Seen`);
- `metrics/<metric>.py`: `read(seen)` gives one metric's value, or None
  when the run holds nothing for it to read.

The yardstick (`yardstick.py`: operation counts, peaks, rooflines, the
idle share of a trace) and the plain reference (`reference/`) live here
too, so a change to the program cannot move them. Nothing here imports
`jax` or the JAX package `gol_tpu`.
"""
