"""gol_tpu_torch.obs — host-side observability for the port: metrics
(`registry`), spans (`tracing`), the black box (`flight`), usage
accounting (`accounting`), and the dispatch split, memory census and
`torch.profiler` driver (`device`).

Ground rules, as in `gol_tpu.obs`: metrics, spans and flight notes are
host-side and dispatch-granular — never inside a kernel, never per
cell. `GOL_TPU_METRICS=0` turns them off behind a single flag check.
Stdlib-only.
"""

from gol_tpu_torch.obs.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    TopKGauge,
    atomic_write_text,
    counter,
    enabled,
    exponential_buckets,
    gauge,
    histogram,
    registry,
    set_enabled,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "TopKGauge",
    "atomic_write_text",
    "counter",
    "enabled",
    "exponential_buckets",
    "gauge",
    "histogram",
    "registry",
    "set_enabled",
]
