"""Observability: the metrics registry and its Prometheus-text exporter
(:mod:`rabia_tpu_torch.obs.registry`), the anomaly journal
(:mod:`rabia_tpu_torch.obs.journal`) and the flight recorder
(:mod:`rabia_tpu_torch.obs.flight`), ports of the reference's modules of
those names. The reference's admin HTTP shim, telemetry, critical-path
and fleet planes are not ported yet."""

from rabia_tpu_torch.obs.journal import AnomalyJournal
from rabia_tpu_torch.obs.registry import (
    LATENCY_BUCKETS,
    RUNTIME_STAGES,
    SLO_BUCKETS,
    SLO_STAGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus_text,
    slo_bucket_index,
)

__all__ = [
    "AnomalyJournal",
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "RUNTIME_STAGES",
    "SLO_BUCKETS",
    "SLO_STAGES",
    "parse_prometheus_text",
    "slo_bucket_index",
]
