"""Observability: the metrics registry and its Prometheus-text exporter
(:mod:`rabia_tpu_torch.obs.registry`), the anomaly journal
(:mod:`rabia_tpu_torch.obs.journal`), the flight recorder and its
cross-replica trace collection (:mod:`rabia_tpu_torch.obs.flight`), the
admin HTTP shim (:mod:`rabia_tpu_torch.obs.http`), the per-replica
telemetry ring (:mod:`rabia_tpu_torch.obs.telemetry`), the critical-path
decomposition of slow Submits (:mod:`rabia_tpu_torch.obs.critpath`) and
the fleet plane (:mod:`rabia_tpu_torch.obs.fleet_obs`: the
ring-discovered :class:`FleetAggregator`, :func:`collect_fleet_trace`
and the :class:`BurnRateWatchdog`), ports of the reference's modules of
those names."""

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
from rabia_tpu_torch.obs.http import AdminHTTPServer
from rabia_tpu_torch.obs.flight import (
    FR_DTYPE,
    FR_KIND_NAMES,
    TF_DTYPE,
    FlightRecorder,
    batch_id_for,
    build_trace_slice,
    collect_trace,
    fr_hash,
    merge_slices,
    render_timeline,
)
from rabia_tpu_torch.obs.telemetry import (
    TelemetrySampler,
    collect_timeline,
    merge_timelines,
    render_timeline_table,
)
from rabia_tpu_torch.obs.fleet_obs import (
    BurnRateWatchdog,
    FleetAggregator,
    SLOPolicy,
    collect_fleet_trace,
    derive_fleet_sample,
    derive_gateway_figures,
    discover_fleet,
)

__all__ = [
    "BurnRateWatchdog",
    "FleetAggregator",
    "SLOPolicy",
    "collect_fleet_trace",
    "derive_fleet_sample",
    "derive_gateway_figures",
    "discover_fleet",
    "AdminHTTPServer",
    "AnomalyJournal",
    "FR_DTYPE",
    "FR_KIND_NAMES",
    "FlightRecorder",
    "TF_DTYPE",
    "TelemetrySampler",
    "batch_id_for",
    "build_trace_slice",
    "collect_timeline",
    "collect_trace",
    "fr_hash",
    "merge_slices",
    "merge_timelines",
    "render_timeline",
    "render_timeline_table",
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
