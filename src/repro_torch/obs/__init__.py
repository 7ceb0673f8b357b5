"""Observability subsystem: step-level tracing + typed metrics registry.

Shared by the serving engine and the service simulator (see
``docs/observability.md``):

  * ``TraceRecorder`` / ``NOOP`` — typed step/lane/transfer/request events,
    zero-overhead when disabled (``repro_torch.obs.trace``);
  * ``export_chrome`` — Chrome/Perfetto ``trace.json`` exporter
    (``repro_torch.obs.perfetto``), validated by ``tools/check_trace.py``;
  * ``MetricsRegistry`` — counter/gauge/histogram with explicit units;
    ``serving.metrics.summarize`` is a thin view over it
    (``repro_torch.obs.registry``);
  * ``json_safe`` / ``dump_json`` — NaN-safe JSON for every metrics/trace
    export;
  * ``ByteLedger`` / ``RooflineTracker`` — per-step cause x lane byte
    attribution with a checked conservation invariant, and per-step
    compute/HBM/host-link roofline classification
    (``repro_torch.obs.attribution``).
"""
from repro_torch.obs.attribution import (
    AGG_RULES,
    ATTN_READ,
    CAUSE_LANE,
    CAUSES,
    COMPARED_CAUSES,
    KV_FILL,
    PREFETCH_STAGE,
    PREFIX_SAVED,
    RETRY_REFETCH,
    SWAP_IN,
    SWAP_OUT,
    ByteLedger,
    RooflineTracker,
)
from repro_torch.obs.perfetto import dump_json, export_chrome, json_safe, to_chrome
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricCollision,
    MetricsRegistry,
)
from repro_torch.obs.trace import NOOP, NoopTracer, TraceEvent, TraceRecorder

__all__ = [
    "AGG_RULES",
    "ATTN_READ",
    "ByteLedger",
    "CAUSE_LANE",
    "CAUSES",
    "COMPARED_CAUSES",
    "Counter",
    "KV_FILL",
    "PREFETCH_STAGE",
    "PREFIX_SAVED",
    "RETRY_REFETCH",
    "RooflineTracker",
    "SWAP_IN",
    "SWAP_OUT",
    "Gauge",
    "Histogram",
    "MetricCollision",
    "MetricsRegistry",
    "NOOP",
    "NoopTracer",
    "TraceEvent",
    "TraceRecorder",
    "dump_json",
    "export_chrome",
    "json_safe",
    "to_chrome",
]
