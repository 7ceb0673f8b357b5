"""Degraded-mode controller: rolling transfer-failure-rate state machine.

The scheduler feeds this one observation per step — how many transfer
attempts started and how many failed since the last step — and the
controller keeps a rolling window of those deltas.  When the windowed
failure rate crosses ``threshold`` (with at least ``min_events`` attempts
in the window, so one unlucky transfer can't trip it), the engine enters
**degraded mode**: async prefetch is disabled (no new speculative
transfers to fail) and new admissions are deferred while already-admitted
work drains.  Exit uses hysteresis — the rate must fall to
``threshold * exit_factor`` (or the window must drain to zero attempts)
before normal service resumes, so the mode doesn't flap at the boundary.

Degradation *defers*, it never drops: a shed admission stays queued and is
admitted as soon as the mode clears (the scheduler keeps its idle escape
hatch, so a degraded engine with nothing else to run still makes
progress).  Tokens are therefore unaffected — only latency is.
"""
from __future__ import annotations

import collections
from typing import Optional


class DegradedModeController:
    def __init__(
        self,
        threshold: float,
        window: int = 16,
        min_events: int = 4,
        exit_factor: float = 0.5,
    ):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("degraded threshold must be in (0, 1]")
        if window < 1 or min_events < 1:
            raise ValueError("window and min_events must be >= 1")
        if not 0.0 <= exit_factor < 1.0:
            raise ValueError("exit_factor must be in [0, 1)")
        self.threshold = threshold
        self.min_events = min_events
        self.exit_factor = exit_factor
        self._hist: collections.deque = collections.deque(maxlen=window)
        self.degraded = False
        self.entries = 0
        self.entered_at: Optional[int] = None

    def rate(self) -> float:
        attempts = sum(a for _, a in self._hist)
        if attempts <= 0:
            return 0.0
        return sum(f for f, _ in self._hist) / attempts

    def observe(self, step: int, failures: int, attempts: int) -> bool:
        """Record one step's (failures, attempts) delta.

        Returns True when the mode flipped on this observation.
        """
        self._hist.append((failures, attempts))
        total = sum(a for _, a in self._hist)
        rate = self.rate()
        if not self.degraded:
            if total >= self.min_events and rate >= self.threshold:
                self.degraded = True
                self.entries += 1
                self.entered_at = step
                return True
        elif total == 0 or rate <= self.threshold * self.exit_factor:
            self.degraded = False
            self.entered_at = None
            return True
        return False
