"""Typed metrics registry: counters, gauges, and histograms with units.

``metrics.summarize``'s flat dict grew one ad-hoc key at a time, until a blind ``m.update(mem_stats)`` could silently overwrite a
scheduler-derived key with a memory-subsystem one.  This module replaces the
key soup with *declared* metrics: every value carried into a summary is
registered with a kind (counter / gauge / histogram), an explicit unit, and
a help line, and registering the same name twice with a different kind or
unit raises ``MetricCollision`` instead of clobbering.

The registry is a snapshot container, not a live telemetry pipe: the stats
objects the scheduler/engine/sim already accumulate (``SchedStats``,
``PrefetchQueueStats``, ``KVMemoryManager``) each expose a
``register_metrics(registry)`` hook that declares their counters at
summary time, and ``serving.metrics.summarize`` becomes a thin view that
assembles one registry and flattens it — every pre-existing key name (and
value) survives unchanged.

Flattening rules (``as_dict``):
  * counter / gauge  -> ``{name: value}`` (values keep their Python type —
    an int stays an int, matching the historical dict);
  * histogram        -> one ``{name}_p{P}`` key per declared percentile
    (e.g. ``ttft`` with percentiles (50, 99) -> ``ttft_p50`` / ``ttft_p99``),
    NaN when no samples were observed.

JSON export goes through ``repro_torch.obs.json_safe`` so NaN/Inf — legal floats,
illegal JSON — serialize as ``null`` instead of the non-standard ``NaN``
token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class MetricCollision(ValueError):
    """Two incompatible registrations claimed the same metric name."""


@dataclasses.dataclass
class Counter:
    """Monotonically accumulated count (events, tokens, bytes)."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = 0

    kind = "counter"

    def inc(self, v=1) -> "Counter":
        if v < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (v={v})")
        self.value += v
        return self


@dataclasses.dataclass
class Gauge:
    """Point-in-time value (rates, ratios, occupancies)."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = float("nan")

    kind = "gauge"

    def set(self, v) -> "Gauge":
        self.value = v
        return self


@dataclasses.dataclass
class Histogram:
    """Sample distribution flattened to ``{name}_p{P}`` percentile keys."""

    name: str
    unit: str = ""
    help: str = ""
    percentiles: Tuple[int, ...] = (50, 99)
    samples: List[float] = dataclasses.field(default_factory=list)

    kind = "histogram"

    def observe(self, v: float) -> "Histogram":
        self.samples.append(float(v))
        return self

    def observe_all(self, vs: Iterable[float]) -> "Histogram":
        self.samples.extend(float(v) for v in vs)
        return self

    def percentile(self, p: float) -> float:
        if not self.samples:
            return float("nan")
        return float(np.percentile(np.asarray(self.samples), p))

    @property
    def count(self) -> int:
        return len(self.samples)


class MetricsRegistry:
    """Name -> typed metric, insertion-ordered, collision-checked."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------------- register
    def _get_or_create(self, cls, name: str, unit: str, help: str, **kw):
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls:
                raise MetricCollision(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}, cannot re-register as {cls.kind}")
            if unit and existing.unit and unit != existing.unit:
                raise MetricCollision(
                    f"metric {name!r} already registered with unit "
                    f"{existing.unit!r}, got {unit!r}")
            return existing
        m = cls(name=name, unit=unit, help=help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get_or_create(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "", help: str = "",
                  percentiles: Tuple[int, ...] = (50, 99)) -> Histogram:
        h = self._get_or_create(Histogram, name, unit, help,
                                percentiles=tuple(percentiles))
        if h.percentiles != tuple(percentiles):
            raise MetricCollision(
                f"histogram {name!r} already registered with percentiles "
                f"{h.percentiles}, got {tuple(percentiles)}")
        return h

    # --------------------------------------------------------------- access
    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def metrics(self) -> List[object]:
        return list(self._metrics.values())

    def flat_names(self) -> List[str]:
        """Every key ``as_dict`` would emit (histograms expanded)."""
        out: List[str] = []
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out.extend(f"{m.name}_p{p}" for p in m.percentiles)
            else:
                out.append(m.name)
        return out

    def as_dict(self) -> Dict[str, float]:
        """Flatten to the historical ``metrics.summarize`` dict shape."""
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                for p in m.percentiles:
                    out[f"{m.name}_p{p}"] = m.percentile(p)
            else:
                out[m.name] = m.value
        return out

    def spec_rows(self) -> List[Tuple[str, str, str, str]]:
        """(flat key, kind, unit, help) rows — the docs/observability.md
        registry -> summarize mapping is generated from this."""
        rows: List[Tuple[str, str, str, str]] = []
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                for p in m.percentiles:
                    rows.append((f"{m.name}_p{p}", m.kind, m.unit, m.help))
            else:
                rows.append((m.name, m.kind, m.unit, m.help))
        return rows
