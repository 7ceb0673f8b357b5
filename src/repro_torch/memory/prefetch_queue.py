"""Asynchronous prefetch ledger: the in-flight/landed state machine on KV
transfers ("Asynchronous KV Cache Prefetching", PAPERS.md).

The packing-prefetch co-design only pays off if next-step KV movement
genuinely overlaps this step's compute.  This module is the discipline that
makes that overlap *safe*: every transfer the scheduler plans one step ahead
— a swapped-out request's host->HBM restore, a prefix-cache re-adoption's
BEOL warm-up, a BEOL fill — is tracked through an explicit lifecycle::

    free -> issued -> in-flight -> landed -> (consumed == readable)
                        |
                        +-> cancelled (intent never materialized)
                        |
                        +-> failed -> retried -> issued   (fault injection:
                              |        bounded retries w/ exponential backoff)
                              +-> cancelled("retries_exhausted")

Invariants the rest of the stack relies on:

  * a transfer that has not LANDED is never readable — a consuming step
    that needs its pages must *stall* for the remaining bytes (surfaced as
    explicit ``prefetch_stall`` time in the simulator, a synchronous copy in
    the engine), never read stale data;
  * issuing is idempotent per ``(rid, kind)``: one outstanding transfer at a
    time, so a mispredicted intent is consumed late (still overlapped) or
    cancelled, never duplicated;
  * consumption is schedule-determined: the same Scheduler drives the real
    engine and the analytical simulator, so ledger byte counters
    (``bytes_overlapped``, ``bytes_sync``) agree between them for identical
    workloads — only *time* (``stall_s``) is simulator-specific.

The queue itself has no clock.  The simulator advances in-flight transfers
with ``progress(budget_bytes)`` (residual host-link bandwidth earned during
each step's wall time); the engine calls ``land()`` when its staged copy has
actually been dispatched to the device.

Fault injection (``repro_torch.robustness``) threads through the same ledger: a
``FaultInjector`` deals a per-attempt verdict (ok / fail / delay) when an
attempt starts, and the queue executes it — a failed attempt resets the
transfer's bytes, backs off ``RetryPolicy.backoff(attempt)`` steps, and
re-enters ISSUED via ``retry_tick``; a transfer that exhausts its retry
budget is aborted (terminal CANCELLED with reason ``"retries_exhausted"``,
surfaced to the scheduler through ``take_aborted`` so the consumer can fall
back, e.g. swap restore -> recompute).  With the injector disabled every
fault path is dead code and the ledger behaves exactly as before.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# transfer kinds
SWAP_IN = "swap_in"  # host DRAM -> HBM restore of a swapped request
ADOPT = "adopt"  # prefix-cache re-adoption: BEOL warm-up of matched pages
FILL = "fill"  # HBM -> BEOL prefetch fill (aggregate, rid = -1)
KINDS = (SWAP_IN, ADOPT, FILL)

# lifecycle states
ISSUED = "issued"  # intent recorded, no bytes moved yet
IN_FLIGHT = "in_flight"  # some bytes moved, not all
LANDED = "landed"  # every byte on the destination tier: readable
CONSUMED = "consumed"  # a step read the pages (terminal)
CANCELLED = "cancelled"  # intent never materialized (terminal)
FAILED = "failed"  # attempt failed (injected); waiting out retry backoff


@dataclasses.dataclass
class PrefetchTransfer:
    """One planned movement of KV bytes, issued ahead of its consumer."""

    tid: int
    rid: int  # request the pages belong to (-1 for aggregate fills)
    kind: str  # SWAP_IN | ADOPT | FILL
    nbytes: float
    issue_step: int  # scheduler step that emitted the intent
    state: str = ISSUED
    remaining: float = 0.0  # bytes not yet landed
    consume_step: Optional[int] = None
    # fault-injection bookkeeping (inert unless an injector is attached)
    attempt: int = 0  # 0-based attempt index; bumps on each retry
    attempt_step: int = 0  # step the current attempt started on
    ready_step: int = 0  # earliest step this attempt may move/land (delay/backoff)
    fault: Optional[object] = None  # FaultSpec dealt to the current attempt
    deferred: bool = False  # engine saw a delay verdict; re-attempt via retry_tick
    cancel_reason: Optional[str] = None

    def __post_init__(self):
        self.remaining = float(self.nbytes)
        self.attempt_step = self.issue_step
        self.ready_step = self.issue_step

    @property
    def landed(self) -> bool:
        return self.state == LANDED

    @property
    def live(self) -> bool:
        return self.state in (ISSUED, IN_FLIGHT, LANDED, FAILED)


@dataclasses.dataclass
class ConsumeReceipt:
    """What the consuming step found when it asked for its pages."""

    rid: int
    kind: str
    nbytes: float  # total bytes the consumer needed
    remaining: float  # bytes NOT landed at consume time (the stall debt)
    issued_ahead: bool  # an intent existed from an earlier step

    @property
    def overlapped(self) -> float:
        """Bytes that crossed the link before the consumer needed them."""
        return self.nbytes - self.remaining if self.issued_ahead else 0.0


@dataclasses.dataclass
class PrefetchQueueStats:
    """Ledger counters; schedule-determined except ``stall_s`` (sim time).

    ``bytes_overlapped`` + ``bytes_late`` + ``bytes_sync`` partition every
    byte a consuming step ever needed: moved ahead of time, issued ahead but
    still in flight at consume, or never issued ahead at all.
    """

    issued: int = 0
    consumed: int = 0
    cancelled: int = 0
    sync_fetches: int = 0  # consumes with no issued-ahead transfer
    stall_events: int = 0  # consumes that found unlanded bytes
    bytes_issued: float = 0.0
    bytes_overlapped: float = 0.0  # landed before the consuming step
    bytes_late: float = 0.0  # issued ahead but unlanded at consume
    bytes_sync: float = 0.0  # never issued ahead: fully synchronous
    bytes_cancelled: float = 0.0  # intents that never found a consumer
    stall_s: float = 0.0  # simulator-accumulated stall time
    # fault-injection / recovery counters (zero without an injector)
    transfer_failures: int = 0  # attempts dealt a fail verdict
    transfer_retries: int = 0  # failed attempts that re-entered ISSUED
    transfers_aborted: int = 0  # transfers cancelled after exhausting retries
    bytes_refetched: float = 0.0  # bytes re-sent because an attempt failed

    def overlap_efficiency(self) -> float:
        """Fraction of needed transfer bytes hidden under earlier compute.
        NaN when no transfers were ever consumed — an idle step contributes
        nothing, so idle-heavy runs are not inflated toward 1.0."""
        total = self.bytes_overlapped + self.bytes_late + self.bytes_sync
        if total <= 0:
            return float("nan")
        return self.bytes_overlapped / total

    def register_metrics(self, reg) -> None:
        """Declare the ledger's counters in a typed metrics registry under
        the historical ``metrics.summarize`` key names."""
        reg.counter("bytes_overlapped", "bytes",
                    "transfer bytes landed before their consuming step").inc(
                        float(self.bytes_overlapped))
        reg.counter("prefetch_late_bytes", "bytes",
                    "issued-ahead bytes still unlanded at consume").inc(
                        float(self.bytes_late))
        reg.counter("prefetch_sync_bytes", "bytes",
                    "consumed bytes never issued ahead (synchronous)").inc(
                        float(self.bytes_sync))
        reg.counter("prefetch_cancelled_bytes", "bytes",
                    "issued intents that never found a consumer").inc(
                        float(self.bytes_cancelled))
        reg.counter("prefetch_issued", "events",
                    "transfer intents issued ahead").inc(float(self.issued))
        reg.counter("prefetch_stall_events", "events",
                    "consumes that found unlanded bytes").inc(
                        float(self.stall_events))
        reg.counter("prefetch_stall_ms", "ms",
                    "simulator-accumulated prefetch stall time").inc(
                        self.stall_s * 1e3)
        reg.gauge("overlap_efficiency", "ratio",
                  "fraction of needed transfer bytes hidden under earlier "
                  "compute").set(self.overlap_efficiency())
        reg.counter("retry_count", "events",
                    "failed transfer attempts retried after backoff").inc(
                        float(self.transfer_retries))
        reg.counter("transfer_failures", "events",
                    "transfer attempts that failed (fault injection)").inc(
                        float(self.transfer_failures))
        reg.counter("transfers_aborted", "events",
                    "transfers cancelled after exhausting their retry "
                    "budget").inc(float(self.transfers_aborted))
        reg.counter("bytes_refetched", "bytes",
                    "bytes re-sent across the host link due to failed "
                    "attempts").inc(float(self.bytes_refetched))


class PrefetchQueue:
    """Transfer ledger shared by the Scheduler, the engine, and the sim.

    ``tracer`` (a ``repro_torch.obs.trace`` recorder; None = disabled) receives
    one instant per lifecycle transition — issued / landed / consumed /
    cancelled — which is exactly the per-lane transfer timeline the
    Perfetto export shows and ``tools/check_trace.py`` checks the
    consumed-only-after-landed invariant against."""

    def __init__(self, tracer=None, injector=None, retry=None):
        self._next_tid = 0
        self.transfers: List[PrefetchTransfer] = []  # issue order
        self._live: Dict[Tuple[int, str], PrefetchTransfer] = {}
        self._aborted: Dict[Tuple[int, str], str] = {}  # retries exhausted
        self.stats = PrefetchQueueStats()
        if tracer is None:
            from repro_torch.obs.trace import NOOP
            tracer = NOOP
        self.trace = tracer
        if injector is None:
            from repro_torch.robustness.faults import NO_FAULTS
            injector = NO_FAULTS
        if retry is None:
            from repro_torch.robustness.faults import RetryPolicy
            retry = RetryPolicy()
        self.injector = injector
        self.retry = retry

    # ------------------------------------------------------------------ issue
    def pending(self, rid: int, kind: str) -> Optional[PrefetchTransfer]:
        """The outstanding (non-terminal) transfer for (rid, kind), if any."""
        return self._live.get((rid, kind))

    def issue(self, rid: int, kind: str, nbytes: float,
              step: int) -> Optional[PrefetchTransfer]:
        """Record an intent: ``nbytes`` must land before a later step may
        read rid's pages.  Idempotent per (rid, kind) — an intent already in
        flight is returned unchanged; zero-byte intents are not tracked."""
        if kind not in KINDS:
            raise ValueError(f"unknown transfer kind {kind!r}; want {KINDS}")
        if nbytes <= 0:
            return None
        existing = self._live.get((rid, kind))
        if existing is not None:
            return existing
        t = PrefetchTransfer(self._next_tid, rid, kind, float(nbytes), step)
        self._next_tid += 1
        self.transfers.append(t)
        self._live[(rid, kind)] = t
        self.stats.issued += 1
        self.stats.bytes_issued += t.nbytes
        if self.injector.enabled:
            self._deal(t, step)
        if self.trace.enabled:
            self.trace.transfer_event(t.tid, rid, kind, ISSUED, t.nbytes,
                                      issue_step=step)
        return t

    def _deal(self, t: PrefetchTransfer, step: int) -> None:
        """Draw the fault verdict for the attempt that starts now.  A delay
        verdict pushes ``ready_step`` out; a fail verdict is held on the
        transfer and *executed at the next step boundary* by ``retry_tick``
        — schedule-determined, so engine and sim register the same failure
        at the same step."""
        from repro_torch.robustness.faults import VERDICT_DELAY
        t.fault = self.injector.attempt(t.tid, t.rid, t.kind, t.attempt, step)
        t.attempt_step = step
        t.ready_step = step
        if t.fault is not None and t.fault.verdict == VERDICT_DELAY:
            t.ready_step = step + max(1, t.fault.delay_steps)

    @staticmethod
    def _doomed(t: PrefetchTransfer) -> bool:
        return t.fault is not None and getattr(t.fault, "verdict", None) == "fail"

    # --------------------------------------------------------------- movement
    def progress(self, budget_bytes: float, step: Optional[int] = None) -> float:
        """Advance in-flight transfers oldest-first with ``budget_bytes`` of
        link capacity (the simulator's residual bandwidth earned during one
        step's wall time).  Returns the bytes actually moved.  Transfers
        whose remaining bytes reach zero become LANDED (readable) — unless
        the current attempt was dealt a fail verdict, in which case the
        bytes are wasted and the transfer enters retry backoff.  ``step``
        (the scheduler step the budget was earned in) gates delayed
        attempts; None skips all fault gating."""
        moved = 0.0
        budget = float(budget_bytes)
        for t in self.transfers:
            if budget <= 0:
                break
            if t.state not in (ISSUED, IN_FLIGHT):
                continue
            if step is not None and step < t.ready_step:
                continue  # delay verdict / backoff: attempt not started yet
            if step is not None and self._doomed(t):
                continue  # doomed attempt: retry_tick executes the failure
            take = min(budget, t.remaining)
            t.remaining -= take
            budget -= take
            moved += take
            t.state = LANDED if t.remaining <= 0 else IN_FLIGHT
            if self.trace.enabled:
                self.trace.transfer_event(t.tid, t.rid, t.kind, t.state,
                                          t.nbytes, moved_bytes=take)
        return moved

    def land(self, t: PrefetchTransfer) -> None:
        """Force-land a transfer: the engine calls this once its staged
        host->device copy has been dispatched (the device buffer carries the
        bytes, ordered before any compute that reads them)."""
        already = t.state == LANDED
        t.remaining = 0.0
        t.state = LANDED
        if self.trace.enabled and not already:
            self.trace.transfer_event(t.tid, t.rid, t.kind, LANDED, t.nbytes)

    def attempt_land(self, t: PrefetchTransfer, step: int) -> bool:
        """The engine's fault-aware ``land``: consult the verdict dealt to
        the current attempt before dispatching the staged copy.  Returns
        True iff the transfer is LANDED after the call.  A delay verdict
        defers the attempt (``retry_tick`` re-surfaces it once
        ``ready_step`` arrives); a fail verdict leaves the transfer
        un-landed — ``retry_tick`` executes the failure at the next step
        boundary, identically in both backends."""
        if not self.injector.enabled:
            self.land(t)
            return True
        if t.state not in (ISSUED, IN_FLIGHT):
            return t.state == LANDED
        if step < t.ready_step:
            t.deferred = True
            return False
        if self._doomed(t):
            return False
        self.land(t)
        return True

    def _fail(self, t: PrefetchTransfer, step: int) -> None:
        """Execute a fail verdict on the current attempt: bytes already
        moved are wasted (``bytes_refetched``); the transfer either backs
        off for a retry or — once the budget is spent — aborts into a
        terminal CANCELLED the consumer discovers via ``take_aborted``."""
        self.stats.transfer_failures += 1
        self.stats.bytes_refetched += float(t.nbytes)
        t.remaining = float(t.nbytes)
        t.deferred = False
        if self.trace.enabled:
            self.trace.transfer_event(t.tid, t.rid, t.kind, FAILED, t.nbytes,
                                      attempt=t.attempt)
        if t.attempt >= self.retry.max_retries:
            self._live.pop((t.rid, t.kind), None)
            t.state = CANCELLED
            t.cancel_reason = "retries_exhausted"
            self._aborted[(t.rid, t.kind)] = t.cancel_reason
            self.stats.transfers_aborted += 1
            self.stats.cancelled += 1
            self.stats.bytes_cancelled += t.nbytes
            if self.trace.enabled:
                self.trace.transfer_event(t.tid, t.rid, t.kind, CANCELLED,
                                          t.nbytes, reason=t.cancel_reason)
        else:
            t.state = FAILED
            t.ready_step = step + self.retry.backoff(t.attempt)

    def retry_tick(self, step: int) -> List[PrefetchTransfer]:
        """Pump the fault/retry state machine at the top of a scheduler
        step.  Three schedule-determined transitions, in order:

        1. attempts dealt a fail verdict that have had their step on the
           link *fail now* (backoff or terminal abort via ``_fail``);
        2. FAILED transfers whose backoff expired re-enter ISSUED with a
           fresh verdict for the next attempt;
        3. engine-deferred delayed attempts whose ``ready_step`` arrived
           are re-surfaced.

        Returns the transfers the engine must re-attempt this step
        (``StepPlan.retried``).  Because this runs inside the shared
        ``Scheduler.next_step``, failures/retries/aborts register at the
        same step index in the engine and the sim."""
        out: List[PrefetchTransfer] = []
        for t in list(self._live.values()):
            if t.state in (ISSUED, IN_FLIGHT) and self._doomed(t) \
                    and step > t.attempt_step:
                self._fail(t, step)
        for t in list(self._live.values()):
            if t.state == FAILED and t.ready_step <= step:
                t.attempt += 1
                t.state = ISSUED
                t.remaining = float(t.nbytes)
                self._deal(t, step)
                self.stats.transfer_retries += 1
                if self.trace.enabled:
                    self.trace.transfer_event(t.tid, t.rid, t.kind, "retried",
                                              t.nbytes, attempt=t.attempt)
                out.append(t)
            elif t.state == ISSUED and t.deferred and t.ready_step <= step:
                t.deferred = False
                out.append(t)
        return out

    def blocked(self, rid: int, kind: str = SWAP_IN) -> bool:
        """Is the outstanding transfer for (rid, kind) mid-recovery?  True
        while it sits out a retry backoff (FAILED) and while a retried
        attempt is back on the link but not landed — the consumer parks
        instead of consuming, so the retry overlaps other work and the
        issued→failed→retried→landed lifecycle completes; consuming early
        would charge a full sync fetch for bytes the retry delivers."""
        t = self._live.get((rid, kind))
        if t is None:
            return False
        if t.state == FAILED:
            return True
        return t.attempt > 0 and t.state in (ISSUED, IN_FLIGHT)

    def actionable_bytes(self, step: int) -> float:
        """Bytes the link could move at ``step``: in-flight remainders whose
        attempt has started and is not fail-doomed.  The sim's pump steps
        stall exactly this long (at degraded bandwidth) to land retries."""
        total = 0.0
        for t in self._live.values():
            if t.state not in (ISSUED, IN_FLIGHT):
                continue
            if step < t.ready_step or self._doomed(t):
                continue
            total += t.remaining
        return total

    def has_aborted(self, rid: int, kind: str = SWAP_IN) -> bool:
        return (rid, kind) in self._aborted

    def take_aborted(self, rid: int, kind: str = SWAP_IN) -> Optional[str]:
        """Pop and return the abort reason for (rid, kind), if its transfer
        exhausted the retry budget.  One-shot: the consumer that takes it
        owns the fallback."""
        return self._aborted.pop((rid, kind), None)

    # ---------------------------------------------------------------- reading
    def readable(self, rid: int, kind: str = SWAP_IN) -> bool:
        """May a step read rid's pages for this transfer kind?  True iff no
        outstanding transfer exists or it has fully LANDED.  An ISSUED or
        IN_FLIGHT transfer is never readable — the consumer must stall."""
        t = self._live.get((rid, kind))
        return t is None or t.state == LANDED

    def consume(self, rid: int, kind: str, step: int,
                demand_bytes: float = 0.0) -> ConsumeReceipt:
        """The consuming step claims rid's pages.  Retires the outstanding
        transfer (if any) and returns a receipt splitting the demand into
        overlapped (landed ahead of time) vs remaining (stall debt) bytes.
        With no issued-ahead transfer the whole ``demand_bytes`` is a
        synchronous fetch."""
        t = self._live.pop((rid, kind), None)
        if t is None or t.issue_step >= step:
            # never issued ahead (or issued within the consuming step):
            # nothing overlapped — the full demand moves synchronously
            nbytes = float(demand_bytes)
            if t is not None:
                t.state = CONSUMED
                t.consume_step = step
                if nbytes <= 0:
                    nbytes = t.nbytes
            rec = ConsumeReceipt(rid, kind, nbytes, nbytes, issued_ahead=False)
            if nbytes > 0:
                self.stats.sync_fetches += 1
                self.stats.bytes_sync += nbytes
                self.stats.stall_events += 1
            self.stats.consumed += 1
            if self.trace.enabled:
                self.trace.transfer_event(
                    t.tid if t is not None else -1, rid, kind, CONSUMED,
                    nbytes, consume_step=step, late_bytes=nbytes, sync=True)
            return rec
        t.state = CONSUMED
        t.consume_step = step
        # the consumer's actual demand wins over the predicted intent size
        # (e.g. an adopt intent probed 4 blocks but 2 were evicted meanwhile)
        needed = float(demand_bytes) if demand_bytes > 0 else t.nbytes
        landed = t.nbytes - t.remaining
        late = max(0.0, needed - min(needed, landed))
        rec = ConsumeReceipt(rid, kind, needed, late, issued_ahead=True)
        self.stats.consumed += 1
        self.stats.bytes_overlapped += rec.overlapped
        self.stats.bytes_late += late
        if late > 0:
            self.stats.stall_events += 1
        if self.trace.enabled:
            self.trace.transfer_event(t.tid, rid, kind, CONSUMED, needed,
                                      consume_step=step, late_bytes=late,
                                      sync=False)
        return rec

    def cancel(self, rid: int, kind: str, reason: Optional[str] = None) -> float:
        """Retire an intent whose consumer will never come (e.g. the request
        finished while parked, or was cancelled).  Returns the cancelled
        bytes.  ``reason`` is recorded on the transfer and in the trace."""
        t = self._live.pop((rid, kind), None)
        if t is None:
            return 0.0
        t.state = CANCELLED
        t.cancel_reason = reason
        self.stats.cancelled += 1
        self.stats.bytes_cancelled += t.nbytes
        if self.trace.enabled:
            args = {"reason": reason} if reason else {}
            self.trace.transfer_event(t.tid, rid, kind, CANCELLED, t.nbytes,
                                      **args)
        return t.nbytes

    def cancel_outstanding(self, reason: str = "shutdown") -> int:
        """Cancel every live intent (engine shutdown / interrupt): leaves
        the ledger fully terminal so a flushed trace passes the lifecycle
        checker.  Returns the number of intents cancelled."""
        keys = list(self._live)
        for rid, kind in keys:
            self.cancel(rid, kind, reason=reason)
        return len(keys)

    # ------------------------------------------------------------- accounting
    def note_fill(self, earned_bytes: float, shortfall_bytes: float) -> None:
        """Fold a step's BEOL fill earn into the overlap ledger.  Fills are
        issued and consumed at step granularity by the simulator's transfer
        engine (earned out of residual bandwidth); a shortfall is a coverage
        downgrade — the attention op falls back to HBM reads — never a
        stall, so it is recorded as cancelled bytes, not late bytes."""
        if earned_bytes > 0:
            self.stats.bytes_overlapped += float(earned_bytes)
        if shortfall_bytes > 0:
            self.stats.bytes_cancelled += float(shortfall_bytes)

    def in_flight_bytes(self) -> float:
        return sum(t.remaining for t in self._live.values()
                   if t.state in (ISSUED, IN_FLIGHT))

    def outstanding(self) -> int:
        """Number of non-terminal ledger entries (the dangling-entry check
        in the chaos property harness: must be 0 after a drained run)."""
        return len(self._live)

    def fully_terminal(self) -> bool:
        """True iff every transfer ever issued reached CONSUMED or
        CANCELLED — the clean-ledger half of the headline invariant."""
        return all(t.state in (CONSUMED, CANCELLED) for t in self.transfers)
