"""Deterministic, seedable fault schedules for the transfer/memory layers.

A ``FaultPlan`` is a declarative chaos schedule.  It never mutates anything
itself — the ``PrefetchQueue`` / scheduler / sim *ask* the plan (through a
``FaultInjector``) what happens to each transfer attempt, and the plan
answers deterministically from ``(seed, tid, attempt)``.  That makes every
chaos run exactly reproducible: the same plan against the same workload
deals the same verdicts in the engine and in the sim, regardless of
wall-clock timing, retry interleaving, or backend.

Verdicts are dealt **per attempt** (not per transfer): a transfer that
fails attempt 0 draws a fresh verdict for attempt 1, so retry success is
part of the schedule, not an accident of ordering.

Beyond per-attempt verdicts the plan can model two environmental faults:

  * ``bw_collapse`` — step windows during which the host link delivers
    only a fraction of its bandwidth (sim pricing; transfers take longer,
    stalls grow);
  * ``phantom_blocks`` — step windows during which the allocator reports
    N fewer free blocks than it really has (spurious ``OutOfBlocks``
    pressure: admissions stall, nothing already admitted is harmed).

``RetryPolicy`` lives here too: bounded retries with exponential backoff,
shared by the ledger state machine in ``memory/prefetch_queue.py``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Optional, Sequence, Tuple

# Verdicts dealt to a single transfer attempt.
VERDICT_OK = "ok"
VERDICT_FAIL = "fail"
VERDICT_DELAY = "delay"

# Default fault surface: swap restores.  (Kept as a plain string to avoid a
# circular import with memory.prefetch_queue, which lazy-imports NO_FAULTS.)
_SWAP_IN = "swap_in"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Outcome of one transfer attempt: fail it, or delay it N steps."""

    verdict: str
    delay_steps: int = 0

    def __post_init__(self) -> None:
        if self.verdict not in (VERDICT_OK, VERDICT_FAIL, VERDICT_DELAY):
            raise ValueError(f"unknown fault verdict {self.verdict!r}")
        if self.verdict == VERDICT_DELAY and self.delay_steps < 1:
            raise ValueError("delay verdict needs delay_steps >= 1")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry budget with exponential backoff, in scheduler steps.

    A failed attempt ``k`` (0-based) waits ``backoff_steps * 2**k`` steps
    (capped at ``max_backoff_steps``) before re-entering ISSUED.  After
    ``max_retries`` failed attempts the transfer is aborted — terminal
    CANCELLED with reason ``"retries_exhausted"`` — and the consumer falls
    back (swap restore → recompute).
    """

    max_retries: int = 3
    backoff_steps: int = 1
    max_backoff_steps: int = 64

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_steps < 1:
            raise ValueError("backoff_steps must be >= 1")

    def backoff(self, attempt: int) -> int:
        return min(self.max_backoff_steps, self.backoff_steps * (1 << min(attempt, 16)))


@dataclasses.dataclass
class FaultPlan:
    """Seedable fault schedule.  ``rate``s are per-attempt probabilities.

    ``scripted`` pins exact verdicts for chosen ``(tid, attempt)`` pairs and
    wins over the seeded draw — handy for regression tests that need one
    specific transfer to fail.  ``until_step`` confines random faults to
    attempts started before that step (environmental windows below are
    unaffected), which is how recovery/degraded-exit scenarios are built.

    ``bw_collapse`` / ``phantom_blocks`` are ``(start_step, end_step, value)``
    windows: value = bandwidth factor in (0, 1] resp. phantom block count.
    """

    seed: int = 0
    fail_rate: float = 0.0
    delay_rate: float = 0.0
    max_delay_steps: int = 3
    kinds: Tuple[str, ...] = (_SWAP_IN,)
    until_step: Optional[int] = None
    scripted: Dict[Tuple[int, int], FaultSpec] = dataclasses.field(default_factory=dict)
    bw_collapse: Sequence[Tuple[int, int, float]] = ()
    phantom_blocks: Sequence[Tuple[int, int, int]] = ()

    def __post_init__(self) -> None:
        if not 0.0 <= self.fail_rate <= 1.0 or not 0.0 <= self.delay_rate <= 1.0:
            raise ValueError("fault rates must be in [0, 1]")
        if self.fail_rate + self.delay_rate > 1.0:
            raise ValueError("fail_rate + delay_rate must be <= 1")
        if self.max_delay_steps < 1:
            raise ValueError("max_delay_steps must be >= 1")
        for lo, hi, f in self.bw_collapse:
            if not (0.0 < f <= 1.0) or hi < lo:
                raise ValueError(f"bad bw_collapse window ({lo}, {hi}, {f})")
        for lo, hi, n in self.phantom_blocks:
            if n < 0 or hi < lo:
                raise ValueError(f"bad phantom_blocks window ({lo}, {hi}, {n})")

    @property
    def active(self) -> bool:
        return bool(
            self.fail_rate > 0
            or self.delay_rate > 0
            or self.scripted
            or self.bw_collapse
            or self.phantom_blocks
        )

    def verdict(self, tid: int, attempt: int, step: int) -> FaultSpec:
        """Deterministic verdict for one attempt of one transfer.

        Depends only on (seed, tid, attempt) — never on wall time or
        backend — so engine and sim deal identical fates to the same
        ledger entry.
        """
        spec = self.scripted.get((tid, attempt))
        if spec is not None:
            return spec
        if self.until_step is not None and step >= self.until_step:
            return FaultSpec(VERDICT_OK)
        rng = random.Random(self.seed * 1000003 + tid * 9973 + attempt)
        u = rng.random()
        if u < self.fail_rate:
            return FaultSpec(VERDICT_FAIL)
        if u < self.fail_rate + self.delay_rate:
            return FaultSpec(VERDICT_DELAY, delay_steps=rng.randint(1, self.max_delay_steps))
        return FaultSpec(VERDICT_OK)

    def host_bw_factor(self, step: int) -> float:
        factor = 1.0
        for lo, hi, f in self.bw_collapse:
            if lo <= step <= hi:
                factor = min(factor, f)
        return factor

    def phantom_free_blocks(self, step: int) -> int:
        phantom = 0
        for lo, hi, n in self.phantom_blocks:
            if lo <= step <= hi:
                phantom = max(phantom, n)
        return phantom

    # -- JSON round-trip (the --fault-plan CLI format) ----------------------

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "fail_rate": self.fail_rate,
            "delay_rate": self.delay_rate,
            "max_delay_steps": self.max_delay_steps,
            "kinds": list(self.kinds),
            "until_step": self.until_step,
            "scripted": [
                {"tid": tid, "attempt": att, "verdict": s.verdict, "delay_steps": s.delay_steps}
                for (tid, att), s in sorted(self.scripted.items())
            ],
            "bw_collapse": [list(w) for w in self.bw_collapse],
            "phantom_blocks": [list(w) for w in self.phantom_blocks],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "FaultPlan":
        scripted = {
            (int(s["tid"]), int(s.get("attempt", 0))): FaultSpec(
                s["verdict"], int(s.get("delay_steps", 0))
            )
            for s in obj.get("scripted", ())
        }
        return cls(
            seed=int(obj.get("seed", 0)),
            fail_rate=float(obj.get("fail_rate", 0.0)),
            delay_rate=float(obj.get("delay_rate", 0.0)),
            max_delay_steps=int(obj.get("max_delay_steps", 3)),
            kinds=tuple(obj.get("kinds", (_SWAP_IN,))),
            until_step=obj.get("until_step"),
            scripted=scripted,
            bw_collapse=tuple((int(a), int(b), float(f)) for a, b, f in obj.get("bw_collapse", ())),
            phantom_blocks=tuple(
                (int(a), int(b), int(n)) for a, b, n in obj.get("phantom_blocks", ())
            ),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


class FaultInjector:
    """Runtime face of a ``FaultPlan``: deals verdicts and counts them.

    ``FaultInjector(None)`` (== ``NO_FAULTS``) is inert: ``enabled`` is
    False and every consult short-circuits, so the fault-free paths stay
    bit-identical to a build without this package.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan
        self.injected_failures = 0
        self.injected_delays = 0

    @property
    def enabled(self) -> bool:
        return self.plan is not None and self.plan.active

    def attempt(self, tid: int, rid: int, kind: str, attempt: int, step: int) -> Optional[FaultSpec]:
        """Verdict for one attempt; None means the attempt proceeds cleanly."""
        if not self.enabled or kind not in self.plan.kinds:
            return None
        spec = self.plan.verdict(tid, attempt, step)
        if spec.verdict == VERDICT_OK:
            return None
        if spec.verdict == VERDICT_FAIL:
            self.injected_failures += 1
        else:
            self.injected_delays += 1
        return spec

    def host_bw_factor(self, step: int) -> float:
        return self.plan.host_bw_factor(step) if self.enabled else 1.0

    def phantom_free_blocks(self, step: int) -> int:
        return self.plan.phantom_free_blocks(step) if self.enabled else 0

    def register_metrics(self, reg) -> None:
        reg.counter("injected_failures", "events", "fault attempts dealt a fail verdict").inc(
            float(self.injected_failures)
        )
        reg.counter("injected_delays", "events", "fault attempts dealt a delay verdict").inc(
            float(self.injected_delays)
        )


NO_FAULTS = FaultInjector(None)
