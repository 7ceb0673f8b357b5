"""Byte-attribution ledger: which bytes moved, why, on which lane, per step.

The paper's headline claims are bandwidth claims (1.5-2.4x HBM traffic
reduction, 8.06x decode speedup), but aggregate counters alone cannot say
*which* bytes moved *why* on *which* step. The ``ByteLedger`` closes that
gap: every byte-moving site — the engine's ``_apply_swaps`` /
``_issue_prefetch`` and the sim's ``service`` pricing loop — debits a typed
**cause** on a fixed **lane**, keyed by the step that moved it:

  cause            lane        debited by                      meaning
  ---------------  ----------  ------------------------------  ------------------------------------------
  ``attn_read``    hbm         Scheduler (shared)              KV bytes the ragged paged attention reads
  ``kv_fill``      hbm         sim service loop                step HBM traffic net of BEOL-retained bytes
  ``swap_out``     host_link   engine ``_apply_swaps`` / sim   KV pages spilled to host DRAM
  ``swap_in``      host_link   engine ``_apply_swaps`` / sim   KV pages restored from host DRAM
  ``prefetch_stage`` beol      engine ``_issue_prefetch`` /    bytes staged ahead (engine: host->device
                               sim earned fills                copies; sim: HBM->BEOL fills earned)
  ``retry_refetch`` host_link  Scheduler (shared)              bytes a failed transfer re-sends
  ``prefix_saved`` hbm         Scheduler (shared)              HBM fill bytes prefix adoption avoided

``attn_read`` is a *demand* cause (bytes attention consumed, whichever tier
served them) and ``prefix_saved`` a *savings* cause; the remaining five are
**movers** whose per-lane sums must reproduce the pre-existing aggregate
counters exactly — the conservation invariant:

    swap_out + swap_in                    == ``swapped_bytes``
    kv_fill + swap_out + swap_in          == ``hbm_bytes_moved``      (sim)
    prefetch_stage                        == ``prefetch_fill_bytes``  (sim)
    swap_out / swap_in                    == ``KVMemoryManager`` swap byte totals
    attn_read                             == ``attn_tokens_touched * kv_bytes_per_token``
    prefix_saved                          == ``prefix_fill_bytes_saved``

``tools/check_trace.py`` enforces these on every recorded trace, and —
because the causes in ``COMPARED_CAUSES`` are schedule-determined — the
attribution instants carry canonical ``sched`` keys, so ``--compare``
asserts the engine and the sim attributed identical bytes on every step.

``RooflineTracker`` classifies each sim step as compute- / HBM- /
host-link-bound from the ``Hardware`` model's three service times, emits
Perfetto ``"C"`` counter tracks (lane utilizations + the bound index), and
registers p50/p99 lane-utilization histograms in the metrics registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.obs.trace import LANE_ATTRIBUTION

# causes
ATTN_READ = "attn_read"
KV_FILL = "kv_fill"
SWAP_OUT = "swap_out"
SWAP_IN = "swap_in"
PREFETCH_STAGE = "prefetch_stage"
RETRY_REFETCH = "retry_refetch"
PREFIX_SAVED = "prefix_saved"
CAUSES = (ATTN_READ, KV_FILL, SWAP_OUT, SWAP_IN, PREFETCH_STAGE,
          RETRY_REFETCH, PREFIX_SAVED)

# lanes
LANE_HBM = "hbm"
LANE_HOST = "host_link"
LANE_BEOL = "beol"
CAUSE_LANE: Dict[str, str] = {
    ATTN_READ: LANE_HBM,
    KV_FILL: LANE_HBM,
    SWAP_OUT: LANE_HOST,
    SWAP_IN: LANE_HOST,
    PREFETCH_STAGE: LANE_BEOL,
    RETRY_REFETCH: LANE_HOST,
    PREFIX_SAVED: LANE_HBM,
}
# causes that are bytes actually moved (vs demand served / savings earned)
MOVER_CAUSES = (KV_FILL, SWAP_OUT, SWAP_IN, PREFETCH_STAGE, RETRY_REFETCH)
# schedule-determined causes: both backends MUST debit identical bytes per
# step (they derive from the shared Scheduler / memory-manager records), so
# they ride the attribution instant's canonical sched key and fall under
# ``check_trace.py --compare``
COMPARED_CAUSES = (ATTN_READ, SWAP_OUT, SWAP_IN, RETRY_REFETCH, PREFIX_SAVED)

# name of the run-total instant on LANE_ATTRIBUTION (the lane itself lives
# in repro_torch.obs.trace.PIPELINE_LANES for a stable Perfetto tid)
TOTALS_EVENT = "attr totals"

# aggregate-counter name -> the causes whose total must reproduce it; the
# single source of truth shared by conservation_errors and check_trace.py
AGG_RULES: Dict[str, Tuple[str, ...]] = {
    "swapped_bytes": (SWAP_OUT, SWAP_IN),
    "hbm_bytes_moved": (KV_FILL, SWAP_OUT, SWAP_IN),
    "prefetch_fill_bytes": (PREFETCH_STAGE,),
    "swap_out_bytes": (SWAP_OUT,),
    "swap_in_bytes": (SWAP_IN,),
    "attn_read_bytes": (ATTN_READ,),
    "prefix_saved_bytes": (PREFIX_SAVED,),
    "retry_refetch_bytes": (RETRY_REFETCH,),
}


def bytes_close(a: float, b: float) -> bool:
    """Byte-count equality with float slack: exact to one byte, plus a
    relative term for the sim's float accumulation over long runs."""
    return abs(a - b) <= max(1.0, 1e-6 * max(abs(a), abs(b)))


class ByteLedger:
    """Per-step cause x lane byte attribution, debited at every byte-moving
    site. One ledger lives on the Scheduler, so engine and sim debits for
    schedule-determined causes share the same object and code path; each
    backend adds its own pricing-side causes on top."""

    def __init__(self):
        # step -> cause -> bytes (insertion-ordered by first debit)
        self._steps: Dict[int, Dict[str, float]] = {}
        self._totals: Dict[str, float] = {c: 0.0 for c in CAUSES}

    # ---------------------------------------------------------------- debits
    def debit(self, step: int, cause: str, nbytes: float) -> None:
        if cause not in CAUSE_LANE:
            raise ValueError(f"unknown attribution cause {cause!r}; "
                             f"want one of {CAUSES}")
        if nbytes < 0:
            raise ValueError(f"negative debit {nbytes} for {cause!r}")
        if nbytes == 0:
            return
        rec = self._steps.setdefault(int(step), {})
        rec[cause] = rec.get(cause, 0.0) + float(nbytes)
        self._totals[cause] += float(nbytes)

    # ----------------------------------------------------------------- views
    def steps(self) -> List[int]:
        return sorted(self._steps)

    def step_causes(self, step: int) -> Dict[str, float]:
        return dict(self._steps.get(int(step), {}))

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def lane_totals(self, movers_only: bool = False) -> Dict[str, float]:
        """Bytes per lane; ``movers_only`` drops demand/savings causes so
        the result is traffic that physically moved."""
        out = {LANE_HBM: 0.0, LANE_HOST: 0.0, LANE_BEOL: 0.0}
        for c, v in self._totals.items():
            if movers_only and c not in MOVER_CAUSES:
                continue
            out[CAUSE_LANE[c]] += v
        return out

    def hbm_moved_bytes(self) -> float:
        """Bytes that crossed HBM, the sim's ``hbm_bytes_moved`` identity:
        net-of-retained fills plus host swap traffic (which streams through
        HBM on its way to/from the link)."""
        t = self._totals
        return t[KV_FILL] + t[SWAP_OUT] + t[SWAP_IN]

    def per_step(self) -> List[Dict[str, float]]:
        """One record per step that moved bytes: ``{"step": s, cause: v}``."""
        return [{"step": s, **{c: v for c, v in self._steps[s].items()}}
                for s in self.steps()]

    def as_dict(self) -> Dict[str, object]:
        """JSON-exportable view (``--attribution-json``): per-step records,
        cause totals, and lane totals (moved vs all-cause)."""
        return {
            "causes": {c: CAUSE_LANE[c] for c in CAUSES},
            "per_step": self.per_step(),
            "totals": self.totals(),
            "lane_totals": self.lane_totals(),
            "lane_moved": self.lane_totals(movers_only=True),
        }

    # ---------------------------------------------------------- conservation
    def conservation_errors(self, aggregates: Mapping[str, float]) -> List[str]:
        """Check every aggregate counter provided against the cause totals
        that must reproduce it (AGG_RULES); unknown keys are errors so a
        typo cannot silently skip a check. Returns human-readable
        violations, empty when conservation holds."""
        errs: List[str] = []
        for key, expected in aggregates.items():
            causes = AGG_RULES.get(key)
            if causes is None:
                errs.append(f"unknown aggregate {key!r} (no AGG_RULES entry)")
                continue
            got = sum(self._totals[c] for c in causes)
            if not bytes_close(got, float(expected)):
                errs.append(
                    f"conservation violated: {'+'.join(causes)} = {got:.1f} "
                    f"but aggregate {key} = {float(expected):.1f}")
        # internal identity: per-step sums reproduce the running totals
        for c in CAUSES:
            per = sum(rec.get(c, 0.0) for rec in self._steps.values())
            if not bytes_close(per, self._totals[c]):
                errs.append(f"ledger internal mismatch for {c!r}: per-step "
                            f"sum {per:.1f} != total {self._totals[c]:.1f}")
        return errs

    def compare(self, other: "ByteLedger") -> List[str]:
        """Engine==sim check on the schedule-determined causes, per step."""
        errs: List[str] = []
        for s in sorted(set(self._steps) | set(other._steps)):
            a, b = self._steps.get(s, {}), other._steps.get(s, {})
            for c in COMPARED_CAUSES:
                va, vb = a.get(c, 0.0), b.get(c, 0.0)
                if not bytes_close(va, vb):
                    errs.append(f"step {s} cause {c!r}: {va:.1f} != {vb:.1f}")
        return errs

    # ------------------------------------------------------------ trace/emit
    def record_step(self, tracer, step: int,
                    ts: Optional[float] = None) -> None:
        """Emit the step's attribution instant. The sched key carries the
        COMPARED_CAUSES bytes (int-rounded), so ``check_trace.py --compare``
        asserts engine and sim attributed identical bytes every step; the
        full cause split rides the args for ``check_trace``'s conservation
        pass and Perfetto inspection."""
        if tracer is None or not tracer.enabled:
            return
        rec = self._steps.get(int(step), {})
        key = ("attr", int(step)) + tuple(
            int(round(rec.get(c, 0.0))) for c in COMPARED_CAUSES)
        tracer.instant(LANE_ATTRIBUTION, f"attr {step}", ts=ts, step=step,
                       sched=key, **{c: rec.get(c, 0.0) for c in CAUSES})

    def record_totals(self, tracer,
                      aggregates: Optional[Mapping[str, float]] = None,
                      ts: Optional[float] = None) -> None:
        """Emit the run-total attribution instant: cause totals as
        ``total_<cause>`` plus each independently accumulated aggregate as
        ``agg_<name>`` — ``check_trace.py`` re-derives the per-step sums and
        enforces conservation against both."""
        if tracer is None or not tracer.enabled:
            return
        args = {f"total_{c}": v for c, v in self._totals.items()}
        for k, v in (aggregates or {}).items():
            if k not in AGG_RULES:
                raise ValueError(f"unknown aggregate {k!r} (no AGG_RULES "
                                 "entry) — the checker could not verify it")
            args[f"agg_{k}"] = float(v)
        tracer.instant(LANE_ATTRIBUTION, TOTALS_EVENT, ts=ts, **args)

    # -------------------------------------------------------------- registry
    def register_metrics(self, reg) -> None:
        """Declare cause/lane totals in a typed metrics registry; names are
        ``attr_``-prefixed so they never collide with the historical
        summarize keys the aggregates live under."""
        for c in CAUSES:
            reg.counter(f"attr_{c}_bytes", "bytes",
                        f"bytes attributed to cause {c!r} on the "
                        f"{CAUSE_LANE[c]} lane").inc(self._totals[c])
        for lane, v in self.lane_totals(movers_only=True).items():
            reg.counter(f"attr_moved_{lane}_bytes", "bytes",
                        f"mover-cause bytes attributed to the {lane} "
                        "lane").inc(v)


# ---------------------------------------------------------------------------
# Per-step roofline classification
# ---------------------------------------------------------------------------

ROOFLINE_BOUNDS = ("compute", "hbm", "host_link")


@dataclasses.dataclass
class RooflineStep:
    step: int
    bound: str
    compute_t: float
    hbm_t: float
    host_t: float
    wall_t: float

    def utilization(self, which: str) -> float:
        """Lane occupancy as a fraction of the step's wall time, clamped to
        1.0 (issued-ahead transfers can land more bytes than one wall)."""
        t = {"compute": self.compute_t, "hbm": self.hbm_t,
             "host_link": self.host_t}[which]
        if self.wall_t <= 0:
            return 0.0
        return min(1.0, t / self.wall_t)


class RooflineTracker:
    """Classifies each step as compute- / HBM- / host-link-bound from the
    Hardware model's three service times and emits the result as Perfetto
    ``"C"`` counter tracks + registry gauges/histograms."""

    def __init__(self):
        self.steps: List[RooflineStep] = []
        self.bound_counts: Dict[str, int] = {b: 0 for b in ROOFLINE_BOUNDS}

    def observe(self, step: int, compute_t: float, hbm_t: float,
                host_t: float, wall_t: float, tracer=None,
                ts: Optional[float] = None) -> RooflineStep:
        bound = max(zip(ROOFLINE_BOUNDS, (compute_t, hbm_t, host_t)),
                    key=lambda kv: kv[1])[0]
        rec = RooflineStep(step, bound, compute_t, hbm_t, host_t, wall_t)
        self.steps.append(rec)
        self.bound_counts[bound] += 1
        if tracer is not None and tracer.enabled:
            tracer.counter("roofline_compute_util",
                           rec.utilization("compute"), ts=ts)
            tracer.counter("roofline_hbm_util", rec.utilization("hbm"), ts=ts)
            tracer.counter("roofline_host_util",
                           rec.utilization("host_link"), ts=ts)
            # numeric bound index (counters are numeric-only):
            # 0=compute 1=hbm 2=host_link
            tracer.counter("roofline_bound",
                           float(ROOFLINE_BOUNDS.index(bound)), ts=ts)
        return rec

    def bound_fraction(self, which: str) -> float:
        n = len(self.steps)
        return self.bound_counts[which] / n if n else float("nan")

    def register_metrics(self, reg) -> None:
        for b in ROOFLINE_BOUNDS:
            reg.counter(f"roofline_{b}_bound_steps", "steps",
                        f"steps whose dominant service time was {b}").inc(
                            float(self.bound_counts[b]))
        for which, name in (("compute", "lane_util_compute"),
                            ("hbm", "lane_util_hbm"),
                            ("host_link", "lane_util_host")):
            h = reg.histogram(name, "ratio",
                              f"per-step {which} occupancy fraction of the "
                              "step wall time", percentiles=(50, 99))
            h.observe_all(s.utilization(which) for s in self.steps)
