"""Observability: the metrics registry and its Prometheus-text exporter
(:mod:`rabia_tpu_torch.obs.registry`, the port of the reference's
``rabia_tpu/obs/registry.py``). The reference's journal, admin HTTP shim,
flight recorder, telemetry and fleet planes are not ported yet."""

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
