"""Step-level trace recorder for the packing-prefetch pipeline.

The paper's whole argument is *overlap* — decode compute hiding KV movement
— and overlap is a statement about *time*, not about end-of-run aggregates.
This module records what happened **when**, on which lane, as typed events
both backends (the real engine and the analytical simulator) emit through
the same Scheduler:

  * **step spans** — one per packed step, split into phases: compute,
    sync-transfer stall, prefetch (late-landing) stall;
  * **lane spans** — per-resource busy intervals: MXU compute, the HBM->BEOL
    fill engine, the host DMA link, swap staging;
  * **transfer events** — the ``PrefetchQueue`` ledger's lifecycle
    (issued -> in-flight -> landed -> consumed / cancelled), one instant per
    transition, carrying the byte split the consume receipt reports;
  * **request lifecycle** — arrival -> admit -> prefill -> first token ->
    decode -> preempt / swap-out / swap-in -> finish, recorded as instants
    and *derived* into per-request state spans (queued / prefill / decode /
    swapped) by a tiny state machine, so a p99 TTFT outlier's life is one
    visible bar in Perfetto.

Schedule-determined vs timing events
------------------------------------
Events that depend only on the schedule (step composition, admissions,
preemptions, ledger issue/consume traffic) carry a canonical ``sched`` key.
Because one Scheduler drives both backends, the engine and the simulator
emit **identical sched-key sequences** for identical workloads — the
ledger-equality guarantee, now checkable structurally by
``tools/check_trace.py --compare``.  Timestamps, durations, and land times
are backend-specific (wall clock vs simulated seconds) and are never part
of a sched key.

Zero overhead when disabled
---------------------------
The default tracer is the module-level ``NOOP`` singleton: every method is
a ``pass`` and ``enabled`` is False, so instrumented code guards any
argument construction behind ``if tracer.enabled:`` and a disabled run
does no per-event work at all.

Clocks: the engine uses a monotonic wall clock (``time.perf_counter``
relative to recorder creation); the simulator drives a *manual* clock via
``set_time`` so every event stamps simulated seconds.  ``now()`` hides the
difference from the Scheduler.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

# lanes (exported so the checker/docs agree on names)
LANE_STEP = "step"
LANE_SCHED = "scheduler"
LANE_COMPUTE = "compute"
LANE_STALL_SYNC = "stall:sync"
LANE_STALL_PREFETCH = "stall:prefetch"
LANE_HOST_LINK = "host_link"
LANE_HBM_FILL = "hbm_fill"
LANE_PREFETCH_STAGE = "prefetch_stage"
LANE_QUEUE = "prefetch_queue"
LANE_ATTRIBUTION = "attribution"
PIPELINE_LANES = (
    LANE_STEP, LANE_SCHED, LANE_COMPUTE, LANE_STALL_SYNC,
    LANE_STALL_PREFETCH, LANE_HOST_LINK, LANE_HBM_FILL,
    LANE_PREFETCH_STAGE, LANE_QUEUE, LANE_ATTRIBUTION,
)

# request lifecycle transitions -> the state span they open (None = closed).
# "first_token" and "prefill_done" both enter decode: the former fires only
# when the token is the request's first ever (TTFT edge), the latter on
# re-prefills after a recompute preemption.  "fallback" is the robustness
# layer's swap->recompute downgrade (back to queued, re-prefills later);
# "cancel" is terminal like finish (deadline kill / shutdown).
REQ_TRANSITIONS: Dict[str, Optional[str]] = {
    "arrival": "queued",
    "admit": "prefill",
    "first_token": "decode",
    "prefill_done": "decode",
    "preempt": "queued",
    "swap_out": "swapped",
    "swap_in": "decode",
    "fallback": "queued",
    "finish": None,
    "cancel": None,
}


@dataclasses.dataclass
class TraceEvent:
    """One recorded event. ``ph`` follows the Chrome trace-event phases this
    exports to: "X" complete span, "i" instant, "C" counter."""

    name: str
    lane: str  # a PIPELINE_LANES entry, or "request" with rid >= 0
    ph: str
    ts: float  # seconds (wall for the engine, simulated for the sim)
    dur: float = 0.0
    step: Optional[int] = None
    rid: Optional[int] = None
    args: Dict[str, object] = dataclasses.field(default_factory=dict)
    # canonical schedule-determined key (tuple) — identical between engine
    # and sim for identical workloads; None for timing-only events
    sched: Optional[tuple] = None


class NoopTracer:
    """Recording disabled: every hook is a no-op, ``enabled`` gates any
    argument construction at call sites."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def set_time(self, t: float) -> None:
        pass

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def counter(self, *a, **kw) -> None:
        pass

    def sched_step(self, *a, **kw) -> None:
        pass

    def request_event(self, *a, **kw) -> None:
        pass

    def transfer_event(self, *a, **kw) -> None:
        pass


NOOP = NoopTracer()


class TraceRecorder:
    """Collects typed events; export with ``repro_torch.obs.perfetto``."""

    enabled = True

    def __init__(self, backend: str, manual_clock: bool = False):
        self.backend = backend  # "engine" | "sim" (free-form label)
        self.manual_clock = manual_clock
        self.events: List[TraceEvent] = []
        self._t = 0.0
        self._t0 = time.perf_counter()
        # rid -> (open state name, open ts) for lifecycle span derivation
        self._open_state: Dict[int, Tuple[str, float]] = {}

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        if self.manual_clock:
            return self._t
        return time.perf_counter() - self._t0

    def set_time(self, t: float) -> None:
        """Advance the manual (simulated) clock; monotonicity enforced so
        derived spans can never run backwards."""
        if t > self._t:
            self._t = t

    # ------------------------------------------------------------- raw hooks
    def span(self, lane: str, name: str, ts: float, dur: float,
             step: Optional[int] = None, rid: Optional[int] = None,
             **args) -> None:
        self.events.append(TraceEvent(name, lane, "X", ts, max(0.0, dur),
                                      step=step, rid=rid, args=args))

    def instant(self, lane: str, name: str, ts: Optional[float] = None,
                step: Optional[int] = None, rid: Optional[int] = None,
                sched: Optional[tuple] = None, **args) -> None:
        self.events.append(TraceEvent(
            name, lane, "i", self.now() if ts is None else ts,
            step=step, rid=rid, args=args, sched=sched))

    def counter(self, name: str, value: float,
                ts: Optional[float] = None) -> None:
        self.events.append(TraceEvent(
            name, name, "C", self.now() if ts is None else ts,
            args={"value": value}))

    # ------------------------------------------------- scheduler-facing hooks
    def sched_step(self, step: int, decode: tuple, prefill: tuple,
                   preempted: tuple, swap_out: tuple, swap_in: tuple,
                   issued: tuple, consumed: tuple,
                   retried: tuple = ()) -> None:
        """The canonical schedule-determined record of one StepPlan.  The
        tuple is the *identity* of the step: two backends that executed the
        same schedule emit byte-for-byte equal keys in the same order.
        ``retried`` (fault-injection re-attempts) extends the key only when
        non-empty, so fault-free traces are byte-identical to builds that
        predate the robustness layer."""
        key = ("step", step, decode, prefill, preempted, swap_out, swap_in,
               issued, consumed)
        if retried:
            key = key + (retried,)
        self.instant(LANE_SCHED, f"plan {step}", step=step, sched=key,
                     decodes=len(decode), prefill_tokens=sum(s[2] for s in prefill),
                     preempted=len(preempted), issued=len(issued),
                     consumed=len(consumed))

    def request_event(self, rid: int, what: str, ts: Optional[float] = None,
                      step: Optional[int] = None, sched_key: bool = True,
                      **args) -> None:
        """A request lifecycle transition: records the instant and advances
        the per-request state machine, closing the open state span.
        ``sched_key=False`` keeps an event out of the compared sequence
        (arrivals: the engine submits up front, the sim on the arrival
        clock, so their *positions* in the stream legitimately differ)."""
        t = self.now() if ts is None else ts
        key = (what, rid) + tuple(sorted(args.items())) if sched_key else None
        self.instant("request", what, ts=t, step=step, rid=rid,
                     sched=key, **args)
        nxt = REQ_TRANSITIONS.get(what)
        if what not in REQ_TRANSITIONS:
            return  # annotation (e.g. "adopt"): no state change
        cur = self._open_state.pop(rid, None)
        if cur is not None:
            state, t0 = cur
            self.span("request", state, t0, max(0.0, t - t0), rid=rid)
        if nxt is not None:
            self._open_state[rid] = (nxt, t)

    def transfer_event(self, tid: int, rid: int, kind: str, state: str,
                       nbytes: float, ts: Optional[float] = None,
                       **args) -> None:
        """One ledger lifecycle transition (issued/landed/consumed/...).
        Timing-only: the *schedule-determined* issue/consume traffic is
        already inside the step's sched key; land times are backend time."""
        self.instant(LANE_QUEUE, f"{kind}:{state}", ts=ts, rid=rid,
                     tid=tid, kind=kind, state=state,
                     nbytes=float(nbytes), **args)

    # -------------------------------------------------------------- finalize
    def close(self) -> None:
        """Close any still-open request spans at the latest timestamp (a
        trace of a partial run keeps its unfinished requests visible)."""
        if not self._open_state:
            return
        end = max((e.ts + e.dur for e in self.events), default=0.0)
        for rid, (state, t0) in sorted(self._open_state.items()):
            self.span("request", state, t0, max(0.0, end - t0), rid=rid)
        self._open_state.clear()

    def sched_sequence(self) -> List[tuple]:
        """The schedule-determined event keys, in emission order."""
        return [e.sched for e in self.events if e.sched is not None]
