"""Service-level metrics: TTFT / TBT percentiles, scheduling delay, QPS.

``summarize`` is a thin view over the typed metrics registry
(``repro_torch.obs.registry``): every component that owns counters —
``SchedStats``, ``PrefetchQueueStats``, ``KVMemoryManager`` via the
simulator's ``mem_stats``, and the request-latency histograms registered
here — declares them with a kind and an explicit unit, and the flat dict
callers have always consumed is just ``registry.as_dict()``.  Every
pre-existing key name (and value) survives unchanged; what changed is that
two components claiming the same name now raise ``MetricCollision``
instead of one silently overwriting the other (the old blind
``m.update(mem_stats)``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs.registry import MetricCollision, MetricsRegistry
from repro_torch.serving.request import Request


def percentile(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


def register_request_metrics(reg: MetricsRegistry,
                             requests: Iterable[Request],
                             horizon: float) -> None:
    """Request-level latency/throughput metrics (the summary's base keys)."""
    reqs = [r for r in requests]
    done = [r for r in reqs if r.finish_time is not None]
    ttft = [r.first_token_time - r.arrival_time for r in done
            if r.first_token_time is not None]
    sched = [r.schedule_time - r.arrival_time for r in done
             if r.schedule_time is not None]
    tbt: List[float] = []
    for r in done:
        tbt.extend(r.tbt_latencies())
    out_tokens = sum(len(r.output) for r in reqs)
    reg.counter("completed", "requests", "requests that finished").inc(
        len(done))
    reg.counter("submitted", "requests", "requests submitted").inc(len(reqs))
    reg.gauge("qps_completed", "req/s", "completed requests per second").set(
        len(done) / horizon if horizon > 0 else float("nan"))
    reg.gauge("tokens_per_s", "tok/s", "output tokens per second").set(
        out_tokens / horizon if horizon > 0 else float("nan"))
    reg.histogram("ttft", "s", "time to first token",
                  percentiles=(50, 99)).observe_all(ttft)
    reg.histogram("tbt", "s", "decode inter-token gap",
                  percentiles=(50, 99)).observe_all(tbt)
    reg.histogram("sched_delay", "s", "arrival -> first scheduled chunk",
                  percentiles=(99,)).observe_all(sched)
    reg.counter("preempted_requests", "requests",
                "requests preempted at least once").inc(
                    float(sum(1 for r in reqs if r.preemptions > 0)))


def summarize(requests: Iterable[Request], horizon: float,
              sched_stats=None, chunk_size: Optional[int] = None,
              mem_stats: Optional[Dict[str, float]] = None,
              prefetch_stats=None,
              registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Aggregate request-level latency metrics; when the scheduler's
    ``SchedStats`` (and its chunk size) are passed, also surface scheduler
    health: preemption counts, recompute debt, swap traffic, and packing
    efficiency. ``mem_stats`` merges memory-subsystem counters (tier
    hit-rate, swapped bytes, HBM bytes moved/saved) from the service sim —
    a ``mem_stats`` key that collides with an already-registered metric
    raises ``MetricCollision`` (it used to silently overwrite).
    ``prefetch_stats`` (a ``PrefetchQueueStats``) surfaces the async-
    prefetch ledger: overlapped/late/sync byte split, stall accounting, and
    overlap efficiency — byte counters are schedule-determined, so the
    engine and the simulator report identical values for identical
    workloads; only ``prefetch_stall_ms`` is simulator time.  Passing a
    pre-populated ``registry`` (e.g. the simulator's, with memory gauges
    already declared) folds those metrics into the same summary."""
    reg = registry if registry is not None else MetricsRegistry()
    register_request_metrics(reg, requests, horizon)
    if sched_stats is not None:
        sched_stats.register_metrics(reg, chunk_size)
    if prefetch_stats is not None:
        prefetch_stats.register_metrics(reg)
    if mem_stats:
        for k, v in mem_stats.items():
            if k in reg:
                raise MetricCollision(
                    f"mem_stats key {k!r} collides with an already-"
                    "registered metric — namespace it instead of "
                    "overwriting")
            reg.gauge(k, "", "memory-subsystem counter (mem_stats)").set(
                float(v))
    return reg.as_dict()
