"""gol_tpu_torch.obs — host-side observability for the port: metrics
(`registry`, served live by `http.MetricsServer`), spans (`tracing`),
the black box (`flight`), usage accounting and its ledger
(`accounting`), the freshness plane and its alert evaluator
(`freshness`), the dispatch split, memory census, cost price and
`torch.profiler` driver (`device`); above the process, the scrape join
(`scrape`), the fleet console (`console`), the history plane (`tsdb`,
`collector`), the post-mortem tools (`report`) and the synthetic
observer (`canary`).

Ground rules, as in `gol_tpu.obs`: metrics, spans and flight notes are
host-side and dispatch-granular — never inside a kernel, never per
cell. `GOL_TPU_METRICS=0` turns them off behind a single flag check.
Stdlib-only.
"""

from gol_tpu_torch.obs.registry import (
    REGISTRY,
    CollectedCounter,
    Counter,
    Gauge,
    Histogram,
    Registry,
    TopKGauge,
    atomic_write_text,
    collected_counter,
    counter,
    enabled,
    evict_entity,
    exponential_buckets,
    gauge,
    histogram,
    merge_cumulative_buckets,
    quantile_from_buckets,
    registry,
    remove,
    set_enabled,
    track_entity_series,
)

__all__ = [
    "CollectedCounter",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "REGISTRY",
    "Registry",
    "TopKGauge",
    "atomic_write_text",
    "collected_counter",
    "counter",
    "enabled",
    "evict_entity",
    "exponential_buckets",
    "gauge",
    "histogram",
    "merge_cumulative_buckets",
    "quantile_from_buckets",
    "registry",
    "remove",
    "set_enabled",
    "track_entity_series",
]


def __getattr__(name):
    # MetricsServer lazily, so importing the package never pulls in the
    # http.server machinery a run without --metrics-port does not use.
    if name == "MetricsServer":
        from gol_tpu_torch.obs.http import MetricsServer

        return MetricsServer
    raise AttributeError(name)
