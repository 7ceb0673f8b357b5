"""Fault injection + graceful degradation for the transfer/memory layers.

The packing-prefetch overlap story assumes the host link and the HBM fill
engine always deliver on schedule.  This package is where that assumption
is allowed to break *on purpose* — deterministically, seedably, and
identically reproducibly — and where the recovery machinery lives:

  * ``faults``   — ``FaultPlan`` (a declarative, seedable chaos schedule:
    failed / delayed transfer attempts, transient host-link bandwidth
    collapse, spurious pool pressure) and ``FaultInjector`` (the runtime
    that deals verdicts per transfer attempt), plus ``RetryPolicy``
    (bounded exponential backoff);
  * ``degraded`` — ``DegradedModeController``: the rolling-window
    failure-rate state machine behind the engine-level degraded mode
    (async prefetch off, new admissions deferred, automatic recovery).

The headline invariant (tests/test_robustness.py): for ANY fault schedule,
every non-cancelled request produces exactly the fault-free greedy tokens,
and the allocator / transfer ledger end in a clean state.
"""
from repro_torch.robustness.degraded import DegradedModeController
from repro_torch.robustness.faults import (
    NO_FAULTS,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    RetryPolicy,
    VERDICT_DELAY,
    VERDICT_FAIL,
    VERDICT_OK,
)

__all__ = [
    "DegradedModeController",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "NO_FAULTS",
    "RetryPolicy",
    "VERDICT_DELAY",
    "VERDICT_FAIL",
    "VERDICT_OK",
]
