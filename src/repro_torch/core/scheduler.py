"""Packing-prefetch scheduler — the paper's §III, backend-agnostic.

One scheduler drives both the *real* JAX serving engine (repro_torch.serving.engine)
and the *analytical* service-level simulator (repro_torch.sim.service): the engine
executes StepPlans on a model, the simulator prices the same StepPlans with
the hardware cost model. This guarantees the simulated results (paper Figs
7/8) describe exactly the scheduling policy the runnable system implements.

Policy (Sarathi-Serve style, as adopted by the paper, generalized to
continuous batching over multiple prefills):
  * decode-first: every active decode request is scheduled each step;
  * chunked-prefill packing: the remaining token budget (chunk_size minus
    decode tokens) is filled with chunks from up to
    ``max_concurrent_prefills`` requests — a short prompt no longer waits
    behind a long one monopolizing the prefill lane;
  * admission policies: ``fcfs`` (arrival order), ``sjf`` (shortest remaining
    prefill first), ``priority`` (Request.priority desc, fcfs tie-break);
  * KV-pressure preemption: KV occupancy lives in a paged block allocator
    (repro_torch.memory) — when this step's decode growth would exceed the
    capacity budget, the victim (lowest-priority/youngest, or
    least-recently-admitted under ``eviction="lru"``) is shed:
      - ``preemption="recompute"``: KV is dropped and the request
        re-queues to re-prefill prompt + generated output;
      - ``preemption="swap"``: the victim's block table spills to host DRAM
        and re-attaches block-exactly when pressure drops — no recompute
        debt, at the cost of host-link DMA the simulator prices.
    Greedy outputs are token-identical either way;
  * prefetch: each StepPlan carries a PrefetchPlan for the *next* attention
    op's KV (one-layer lookahead) planned over the BEOL tier's block
    residency — retained blocks are BEOL hits, the delta is a fill the
    transfer engine must earn from residual bandwidth;
  * async prefetch (``async_prefetch=True``): the scheduler additionally
    plans one step ahead through the in-flight/landed transfer ledger
    (repro_torch.memory.prefetch_queue) — while step N computes, it issues
    intents for step N+1's swap-in restores and prefix-cache re-adoptions
    so the engine/sim can move those bytes early; the consuming step
    verifies landed-state and stalls for any late remainder (never reads
    pages whose transfer has not landed).

Invariants the engine and simulator both rely on:
  * block tables grow in ``next_step`` covering exactly this step's writes —
    between steps ``mem.tokens_of(rid)`` equals the KV tokens actually
    written (no phantom +1 reservation);
  * an empty plan implies no state changed (safe to idle);
  * every ledger transfer consumed by a step was either landed (overlapped)
    or explicitly accounted as late/synchronous — a restore is never
    silently free;
  * greedy outputs are token-identical across preemption modes, prefix-cache
    on/off, and async prefetch on/off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefetch import PrefetchPlan, PrefetchPlanner
from repro_torch.memory.block_allocator import prefix_fill_bytes_saved
from repro_torch.memory.manager import KVMemoryManager
from repro_torch.memory.prefetch_queue import (
    ADOPT,
    SWAP_IN,
    ConsumeReceipt,
    PrefetchQueue,
    PrefetchTransfer,
)
from repro_torch.obs.attribution import (
    ATTN_READ,
    PREFIX_SAVED,
    RETRY_REFETCH,
    ByteLedger,
)
from repro_torch.obs.trace import LANE_SCHED, NOOP
from repro_torch.robustness.degraded import DegradedModeController
from repro_torch.robustness.faults import FaultInjector, FaultPlan, RetryPolicy
from repro_torch.serving.request import Request, State
from repro_torch.core.opcost import kv_tokens_touched

POLICIES = ("fcfs", "sjf", "priority")
PREEMPTION_MODES = ("recompute", "swap")
EVICTION_MODES = ("priority", "lru")
BEOL_POLICIES = ("longest", "priority")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    chunk_size: int = 512  # token budget per packed step
    max_decode_batch: int = 32  # concurrent decode slots
    prefetch_buffer_bytes: int = 512 * 1024 * 1024  # the M3D buffer (paper: 512MB)
    max_concurrent_prefills: int = 1  # prefill requests packable into one step
    policy: str = "fcfs"  # admission order: fcfs | sjf | priority
    # total KV tokens the backing store holds across all active requests
    # (None = unbounded). Exceeding it triggers decode preemption.
    kv_capacity_tokens: Optional[int] = None
    # how a preempted decode's KV is handled: recompute (drop + re-prefill)
    # or swap (spill block table to host, restore on re-admission)
    preemption: str = "recompute"
    # preemption victim order: "priority" (lowest priority, youngest) or
    # "lru" (least-recently-(re)admitted, LRU HBM eviction)
    eviction: str = "priority"
    # paged KV block size in tokens (1 = token-granular)
    kv_block_size: int = 1
    # BEOL placement policy: "longest" (longest-context-first pinning) or
    # "priority" (priority-partitioned quotas)
    beol_policy: str = "longest"
    # physical page pool size in blocks (None = unbounded allocator, soft
    # capacity only). When set, the allocator is *bounded*: growth past the
    # pool raises OutOfBlocks, so admission stalls and preemption fall back
    # on this hard bound. The packed engine backs this with real device
    # memory — total pool pages may be far below max_decode_batch * max_len
    # (genuine over-subscription).
    num_kv_blocks: Optional[int] = None
    # radix prefix cache: completed prompt prefixes are indexed block-by-
    # block and later requests adopt the matched run copy-on-write — no
    # prefill compute, no HBM fill for the shared tokens. Needs materialized
    # token ids (placeholder [0]*L prompts would alias every request).
    enable_prefix_cache: bool = False
    # cap on cached blocks (None = bounded only by pool pressure/eviction)
    prefix_cache_blocks: Optional[int] = None
    # admission low-watermark in free pool pages: NEW requests are admitted
    # only while at least this many pages are free (or reclaimable from the
    # prefix cache), so admission backs off before the hard OutOfBlocks
    # signal and shed/re-admit thrash shrinks. 0 disables; in-flight work
    # and an idle system are never gated (progress guarantee).
    admission_watermark: int = 0
    # asynchronous prefetch: plan transfers ONE STEP AHEAD through the
    # in-flight/landed ledger — next-step swap-in restores and prefix-cache
    # re-adoptions are issued while the current step computes, so their DMA
    # overlaps compute (engine: staged host->device copies; sim: residual-
    # bandwidth transfers with explicit prefetch_stall for late landings).
    # False restores the fully synchronous pricing/copy path; greedy
    # outputs are token-identical either way.
    async_prefetch: bool = True
    # --- robustness knobs (repro_torch.robustness; all inert at their defaults) ---
    # deterministic fault schedule perturbing the transfer/memory layers
    # (None = no chaos: every fault path below is dead code and behavior is
    # bit-identical to a faultless build)
    fault_plan: Optional[FaultPlan] = None
    # bounded retry budget + exponential backoff for failed transfers; a
    # swap-in that exhausts it falls back to recompute (token-identical)
    max_transfer_retries: int = 3
    retry_backoff_steps: int = 1
    # per-request wall deadline relative to arrival (engine: steps, sim:
    # seconds — whatever clock drives ``next_step(now)``); requests past it
    # are cancelled cleanly (allocator/prefix/ledger refs all released).
    # Request.deadline (absolute) composes with this: the earlier one wins.
    request_timeout: Optional[float] = None
    # degraded mode: when the rolling transfer-failure rate over
    # ``degraded_window`` steps crosses ``degraded_threshold``, async
    # prefetch is disabled and new admissions are deferred until the rate
    # clears (hysteresis at threshold/2). None disables the controller.
    degraded_threshold: Optional[float] = None
    degraded_window: int = 16
    degraded_min_events: int = 4

    def __post_init__(self):
        if self.max_transfer_retries < 0:
            raise ValueError("max_transfer_retries must be >= 0")
        if self.retry_backoff_steps < 1:
            raise ValueError("retry_backoff_steps must be >= 1")
        if self.request_timeout is not None and self.request_timeout <= 0:
            raise ValueError("request_timeout must be > 0 when set")
        if self.degraded_threshold is not None \
                and not 0.0 < self.degraded_threshold <= 1.0:
            raise ValueError("degraded_threshold must be in (0, 1] when set")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; want one of {POLICIES}")
        if self.preemption not in PREEMPTION_MODES:
            raise ValueError(
                f"unknown preemption {self.preemption!r}; want one of {PREEMPTION_MODES}")
        if self.eviction not in EVICTION_MODES:
            raise ValueError(
                f"unknown eviction {self.eviction!r}; want one of {EVICTION_MODES}")
        if self.beol_policy not in BEOL_POLICIES:
            raise ValueError(
                f"unknown beol_policy {self.beol_policy!r}; want one of {BEOL_POLICIES}")
        if self.max_concurrent_prefills < 1:
            raise ValueError("max_concurrent_prefills must be >= 1")
        if self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if self.num_kv_blocks is not None and self.num_kv_blocks < 1:
            raise ValueError("num_kv_blocks must be >= 1 when set")
        if self.admission_watermark < 0:
            raise ValueError("admission_watermark must be >= 0")
        if self.prefix_cache_blocks is not None and self.prefix_cache_blocks < 1:
            raise ValueError("prefix_cache_blocks must be >= 1 when set")


@dataclasses.dataclass(frozen=True)
class PrefillSegment:
    """One request's chunk within a packed step."""

    rid: int
    slot: int
    start: int  # chunk token range [start, start+length) of the effective prompt
    length: int
    finishes: bool  # last chunk -> emits first token


@dataclasses.dataclass
class StepPlan:
    """One packed execution cycle: all decodes + up to N prefill chunks."""

    decode_slots: List[int]
    decode_rids: List[int]
    prefill_segments: List[PrefillSegment] = dataclasses.field(default_factory=list)
    preempted_rids: List[int] = dataclasses.field(default_factory=list)
    # swap-mode traffic this step: (rid, slot at spill time) / (rid, new slot)
    swapped_out: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    swapped_in: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    prefetch: Optional[PrefetchPlan] = None
    prefetch_committed: bool = False  # BEOL placement landed (sim or engine)
    # async-prefetch ledger traffic this step: transfers ISSUED now for the
    # NEXT step's consumers (the engine stages their copies while this
    # step's compute runs), and receipts for transfers CONSUMED by this
    # step's restores/adoptions (receipt.remaining = stall debt in bytes)
    issued: List[PrefetchTransfer] = dataclasses.field(default_factory=list)
    consumed: List[ConsumeReceipt] = dataclasses.field(default_factory=list)
    # fault recovery: transfers whose retry/delay window opened this step —
    # the engine re-attempts their staged copies (empty without an injector)
    retried: List[PrefetchTransfer] = dataclasses.field(default_factory=list)
    # this plan's step index (pre-increment); -1 until next_step stamps it
    step: int = -1
    # True for a robustness "pump" cycle: zero scheduled tokens, emitted
    # only so retry/backoff clocks advance while every restore is parked
    pump: bool = False
    # unified mixed-batch segment layout (decode rows first — one 1-token
    # segment each — then one segment per prefill chunk): cumulative packed
    # row offsets and cumulative KV extents. Segment s spans packed rows
    # [cu_q_lens[s], cu_q_lens[s+1]) and its last row attends
    # cu_kv_lens[s+1] - cu_kv_lens[s] keys. The engine feeds these straight
    # to the mixed kernel; the sim prices attention bytes from the same
    # arrays, so the two stay byte-identical by construction.
    cu_q_lens: Tuple[int, ...] = (0,)
    cu_kv_lens: Tuple[int, ...] = (0,)
    # mid-block prefix-cache adoptions: device page copies the engine
    # applies before any other device write this step —
    # (rid, src_block, dst_block, n_valid_tokens) per partial tail
    prefix_copies: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def kv_lens(self) -> Tuple[int, ...]:
        """Per-segment KV extents (diff of cu_kv_lens)."""
        return tuple(b - a for a, b in zip(self.cu_kv_lens,
                                           self.cu_kv_lens[1:]))

    @property
    def total_prefill_tokens(self) -> int:
        return sum(s.length for s in self.prefill_segments)

    @property
    def total_tokens(self) -> int:
        return len(self.decode_slots) + self.total_prefill_tokens

    @property
    def finishing_rids(self) -> List[int]:
        return [s.rid for s in self.prefill_segments if s.finishes]

    @property
    def is_empty(self) -> bool:
        return self.total_tokens == 0


@dataclasses.dataclass
class SchedStats:
    """Aggregate counters surfaced into service metrics."""

    steps: int = 0
    scheduled_tokens: int = 0  # decode + prefill tokens actually packed
    prefill_tokens: int = 0
    decode_tokens: int = 0
    preemptions: int = 0
    preempted_tokens: int = 0  # KV tokens dropped (recompute debt)
    out_of_block_stalls: int = 0  # admissions/chunks deferred by a full pool
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_out_tokens: int = 0  # KV tokens spilled to host (no recompute debt)
    # ragged-attention accounting: KV key tokens the block-granular paged
    # path actually reads vs what a padded dense-gather batch would read
    attn_tokens_touched: int = 0
    attn_tokens_padded: int = 0
    # radix prefix cache: admissions whose prompt matched a cached prefix
    # (vs missed), prefill tokens skipped outright, and the HBM fill bytes
    # those skips never streamed (shared formula: prefix_fill_bytes_saved)
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0
    prefix_inserted_blocks: int = 0
    prefix_fill_bytes_saved: int = 0
    # admissions deferred by the free-page low-watermark (soft back-off
    # before the hard out_of_block_stalls signal)
    watermark_stalls: int = 0
    # prefetch-plan coverage, averaged over steps that actually had
    # plannable bytes: a step with zero demand (attention-free arch, empty
    # decode set) is counted as VACUOUS and excluded from the average —
    # reporting it as 1.0 would inflate coverage/overlap on idle steps
    prefetch_steps: int = 0
    prefetch_vacuous_steps: int = 0
    prefetch_coverage_sum: float = 0.0
    # robustness / graceful degradation (all zero without faults/deadlines)
    fallback_recomputes: int = 0  # swap restores that fell back to recompute
    deadline_cancellations: int = 0  # requests killed past their deadline
    cancelled_requests: int = 0  # all cancellations (deadline + shutdown)
    degraded_mode_steps: int = 0  # steps spent in degraded mode
    degraded_sheds: int = 0  # steps that deferred admissions while degraded
    injected_oob_stalls: int = 0  # admission stalls caused by phantom pressure
    pump_steps: int = 0  # zero-token cycles emitted to tick retry clocks

    def packing_efficiency(self, chunk_size: int) -> float:
        """Scheduled tokens / chunk budget — 1.0 means every step was full."""
        if self.steps == 0:
            return float("nan")
        return self.scheduled_tokens / (self.steps * chunk_size)

    def attn_padding_savings(self) -> float:
        """Fraction of padded attention reads the ragged path avoids."""
        if self.attn_tokens_padded == 0:
            return float("nan")
        return 1.0 - self.attn_tokens_touched / self.attn_tokens_padded

    def prefix_hit_rate(self) -> float:
        """Fraction of admissions that adopted a cached prompt prefix."""
        total = self.prefix_hits + self.prefix_misses
        if total == 0:
            return float("nan")
        return self.prefix_hits / total

    def prefetch_coverage(self) -> float:
        """Mean prefetch coverage over non-vacuous steps (NaN when every
        step had zero plannable bytes — idle steps never report 1.0)."""
        if self.prefetch_steps == 0:
            return float("nan")
        return self.prefetch_coverage_sum / self.prefetch_steps

    def register_metrics(self, reg, chunk_size: Optional[int] = None) -> None:
        """Declare the scheduler's counters in a typed metrics registry —
        the names ARE the historical ``metrics.summarize`` keys."""
        reg.counter("preemptions", "events",
                    "decode/prefill victims shed by KV pressure").inc(
                        float(self.preemptions))
        reg.counter("preempted_tokens", "tokens",
                    "KV tokens dropped to recompute debt").inc(
                        float(self.preempted_tokens))
        reg.counter("prefill_tokens", "tokens",
                    "prompt tokens actually prefilled").inc(
                        float(self.prefill_tokens))
        reg.counter("steps", "steps", "packed steps executed").inc(
            float(self.steps))
        reg.counter("swap_outs", "events", "block tables spilled to host").inc(
            float(self.swap_outs))
        reg.counter("swap_ins", "events", "block tables restored from host").inc(
            float(self.swap_ins))
        reg.counter("swapped_out_tokens", "tokens",
                    "KV tokens spilled to host (no recompute debt)").inc(
                        float(self.swapped_out_tokens))
        reg.counter("attn_tokens_touched", "tokens",
                    "KV key tokens the block-granular paged path reads").inc(
                        float(self.attn_tokens_touched))
        reg.counter("attn_tokens_padded", "tokens",
                    "KV key tokens a padded dense gather would read").inc(
                        float(self.attn_tokens_padded))
        reg.gauge("attn_padding_savings", "ratio",
                  "fraction of padded attention reads the ragged path "
                  "avoids").set(self.attn_padding_savings())
        reg.counter("out_of_block_stalls", "events",
                    "admissions/chunks deferred by a full pool").inc(
                        float(self.out_of_block_stalls))
        reg.counter("watermark_stalls", "events",
                    "admissions deferred by the free-page low-watermark").inc(
                        float(self.watermark_stalls))
        reg.counter("prefix_hits", "events",
                    "admissions that adopted a cached prefix").inc(
                        float(self.prefix_hits))
        reg.counter("prefix_misses", "events",
                    "admissions with no cached prefix match").inc(
                        float(self.prefix_misses))
        reg.gauge("prefix_hit_rate", "ratio",
                  "fraction of admissions adopting a cached prefix").set(
                      self.prefix_hit_rate())
        reg.counter("prefix_tokens_skipped", "tokens",
                    "prefill tokens skipped via prefix adoption").inc(
                        float(self.prefix_hit_tokens))
        reg.counter("prefix_inserted_blocks", "blocks",
                    "finished-prompt blocks indexed in the radix cache").inc(
                        float(self.prefix_inserted_blocks))
        reg.counter("prefix_fill_bytes_saved", "bytes",
                    "HBM fill bytes prefix adoption never streamed").inc(
                        float(self.prefix_fill_bytes_saved))
        reg.gauge("prefetch_coverage", "ratio",
                  "mean prefetch coverage over non-vacuous steps").set(
                      self.prefetch_coverage())
        reg.counter("prefetch_vacuous_steps", "steps",
                    "steps with zero plannable prefetch bytes").inc(
                        float(self.prefetch_vacuous_steps))
        reg.counter("fallback_recomputes", "events",
                    "swap restores that exhausted retries and fell back to "
                    "recompute").inc(float(self.fallback_recomputes))
        reg.counter("deadline_cancellations", "events",
                    "requests cancelled past their deadline").inc(
                        float(self.deadline_cancellations))
        reg.counter("cancelled_requests", "requests",
                    "requests cancelled (deadline, shutdown, ...)").inc(
                        float(self.cancelled_requests))
        reg.counter("degraded_mode_steps", "steps",
                    "steps spent in degraded mode (prefetch off, admissions "
                    "deferred)").inc(float(self.degraded_mode_steps))
        reg.counter("degraded_sheds", "events",
                    "steps that deferred new admissions while degraded").inc(
                        float(self.degraded_sheds))
        reg.counter("injected_oob_stalls", "events",
                    "admission stalls caused by injected phantom pool "
                    "pressure").inc(float(self.injected_oob_stalls))
        reg.counter("pump_steps", "steps",
                    "zero-token cycles emitted to advance retry/backoff "
                    "clocks").inc(float(self.pump_steps))
        if chunk_size is not None:
            reg.gauge("packing_efficiency", "ratio",
                      "scheduled tokens / chunk budget (1.0 = every step "
                      "full)").set(self.packing_efficiency(chunk_size))


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, model_cfg: ModelConfig,
                 tracer=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        # step-level tracing: the NOOP singleton when disabled — every hook
        # below is guarded by ``trace.enabled`` so a disabled run does no
        # per-event work (repro_torch.obs.trace)
        self.trace = tracer if tracer is not None else NOOP
        # the memory subsystem is the single source of truth for KV occupancy
        self.mem = KVMemoryManager(
            model_cfg,
            block_size=cfg.kv_block_size,
            capacity_tokens=cfg.kv_capacity_tokens,
            beol_bytes=cfg.prefetch_buffer_bytes,
            beol_policy=cfg.beol_policy,
            num_blocks=cfg.num_kv_blocks,
            enable_prefix_cache=cfg.enable_prefix_cache,
            prefix_cache_blocks=cfg.prefix_cache_blocks,
        )
        self.planner = PrefetchPlanner(model_cfg, cfg.prefetch_buffer_bytes,
                                       mem=self.mem)
        # fault injection + graceful degradation (repro_torch.robustness): the
        # injector deals deterministic per-attempt verdicts into the ledger,
        # the retry policy bounds recovery, and the controller flips the
        # degraded-mode switch off the rolling failure rate.  All inert at
        # the default config — the fault-free paths stay bit-identical.
        self.injector = FaultInjector(cfg.fault_plan)
        self.degraded: Optional[DegradedModeController] = None
        if cfg.degraded_threshold is not None:
            self.degraded = DegradedModeController(
                cfg.degraded_threshold, window=cfg.degraded_window,
                min_events=cfg.degraded_min_events)
        self._fail_seen = 0
        self._attempt_seen = 0
        self._deadlines = cfg.request_timeout is not None
        # rids whose backing state (engine swap_store/_staged rows) must be
        # purged: cancelled requests and swap->recompute fallbacks. The
        # engine drains this via drain_released() right after next_step.
        self._released: List[Tuple[int, str]] = []
        # in-flight/landed transfer ledger: next-step swap-in restores and
        # prefix re-adoptions are issued here one step ahead; the engine
        # lands them as its staged copies dispatch, the sim advances them
        # with each step's residual host-link bandwidth
        self.prefetch_queue = PrefetchQueue(
            tracer=self.trace, injector=self.injector,
            retry=RetryPolicy(max_retries=cfg.max_transfer_retries,
                              backoff_steps=cfg.retry_backoff_steps))
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}  # slot -> request (prefill or decode)
        self.free_slots: List[int] = list(range(cfg.max_decode_batch))
        self.prefilling: List[Request] = []  # admission order
        self.swapped: List[Request] = []  # swap-out order (oldest first)
        self.requests: Dict[int, Request] = {}
        self.stats = SchedStats()
        # per-step cause x lane byte attribution. Schedule-determined causes
        # (attn_read / prefix_saved / retry_refetch) are debited HERE, once,
        # by the shared scheduler; each backend adds its own pricing-side
        # causes (swap traffic, fills, staged prefetch) on its own ledger
        # wiring — equality of the shared causes is then a genuine
        # engine==sim cross-check, not a tautology.
        self.ledger = ByteLedger()

    # ------------------------------------------------------------------ API
    def add_request(self, req: Request) -> None:
        # fail fast on a request the hard pool can never hold: its table
        # peaks at prompt + max_new_tokens - 1 written tokens (the final
        # sampled token is never written), and nothing the preemption loop
        # sheds can make a lone over-sized context fit — without this guard
        # it would either crash the decode growth with OutOfBlocks or stall
        # its prefill forever (take clamps to 0 with has_work still true)
        hard = self.mem.allocator.num_blocks
        if hard is not None:
            need = self.mem.allocator.blocks_for(
                req.prompt_len + req.max_new_tokens - 1)
            if need > hard:
                raise ValueError(
                    f"request {req.rid} peaks at {need} KV blocks "
                    f"(prompt={req.prompt_len} + max_new={req.max_new_tokens})"
                    f" but the physical pool holds num_kv_blocks={hard}")
        self.requests[req.rid] = req
        req.state = State.QUEUED
        self.waiting.append(req)
        if req.deadline is not None:
            self._deadlines = True
        if self.trace.enabled:
            # sched_key=False: the engine submits up front, the sim admits
            # arrivals on its clock — stream *positions* legitimately differ
            self.trace.request_event(
                req.rid, "arrival", ts=max(req.arrival_time, 0.0),
                sched_key=False, prompt_len=req.prompt_len,
                max_new_tokens=req.max_new_tokens, priority=req.priority)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active or self.swapped)

    @property
    def kv_in_use(self) -> int:
        """Device-resident KV tokens (block tables; host-swapped KV excluded)."""
        return self.mem.device_tokens

    def packing_efficiency(self) -> float:
        return self.stats.packing_efficiency(self.cfg.chunk_size)

    # -------------------------------------------------------------- policies
    def _policy_key(self):
        """Admission-order sort key for the configured policy."""
        if self.cfg.policy == "sjf":
            return lambda r: (r.total_prefill_len - r.prefill_pos, r.arrival_time, r.rid)
        if self.cfg.policy == "priority":
            return lambda r: (-r.priority, r.arrival_time, r.rid)
        return lambda r: (r.arrival_time, r.rid)  # fcfs

    def _pop_waiting(self) -> Request:
        """Remove and return the next request per the admission policy."""
        best = min(self.waiting, key=self._policy_key())
        self.waiting.remove(best)
        return best

    def _preempt_victim(self, decodes: List[Request]) -> Request:
        """priority: lowest priority first, then youngest (latest arrival).
        lru: least-recently-(re)admitted (LRU HBM eviction)."""
        if self.cfg.eviction == "lru":
            rid = self.mem.tiers.lru_victim((r.rid, r.arrival_time) for r in decodes)
            return self.requests[rid]
        return min(decodes, key=lambda r: (r.priority, -r.arrival_time, -r.rid))

    def _watermark_ok(self) -> bool:
        """Admission low-watermark: admit new requests only while at least
        ``admission_watermark`` pool pages are free or reclaimable. Never
        gates an otherwise-idle system (something must always run)."""
        wm = self.cfg.admission_watermark
        if wm <= 0:
            return True
        free = self.mem.effective_free_blocks()
        if free is None or free >= wm:
            return True
        return not self.active and not self.swapped

    def _admit_prefix(self, req: Request, plan: StepPlan) -> None:
        """Match a freshly admitted request's effective prompt against the
        radix prefix cache; a hit adopts the cached block run as the table
        prefix and fast-forwards ``prefill_pos`` past the shared tokens (the
        final token always stays uncached so the finishing chunk computes
        the first output logits).  An adopt intent issued for this rid on an
        earlier step is consumed here (its BEOL warm-up either overlapped or
        arrives late); a predicted hit that did not materialize is
        cancelled."""
        if self.mem.prefix is None:
            return
        tokens = req.prefill_slice(0, req.total_prefill_len)
        matched = self.mem.match_prefix(
            req.rid, tokens, max_tokens=req.total_prefill_len - 1,
            step=self.stats.steps)
        req.cached_prefix_len = matched
        q = self.prefetch_queue
        if matched:
            if q.pending(req.rid, ADOPT) is not None:
                plan.consumed.append(q.consume(
                    req.rid, ADOPT, self.stats.steps,
                    demand_bytes=matched * self.planner.kv_btl))
            req.prefill_pos = matched
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += matched
            saved = prefix_fill_bytes_saved(
                matched, self.mem.kv_bytes_per_token)
            self.stats.prefix_fill_bytes_saved += saved
            self.ledger.debit(self.stats.steps, PREFIX_SAVED, saved)
            if self.trace.enabled:
                self.trace.request_event(req.rid, "adopt",
                                         step=self.stats.steps,
                                         matched_tokens=matched)
        else:
            q.cancel(req.rid, ADOPT)
            self.stats.prefix_misses += 1

    def _release_slot(self, req: Request, plan: StepPlan) -> int:
        """Preemption bookkeeping common to every victim kind: count it and
        free the slot. Returns the released slot id."""
        self.stats.preemptions += 1
        req.preemptions += 1
        plan.preempted_rids.append(req.rid)
        slot = req.slot
        del self.active[slot]
        self.free_slots.append(slot)
        self.free_slots.sort()
        req.slot = None
        return slot

    def _requeue_recompute(self, req: Request) -> None:
        """Recompute-style tail: drop KV (counting the debt) and send the
        request back to the waiting queue to re-prefill from scratch."""
        if req.rid in self.mem.allocator.tables:
            self.stats.preempted_tokens += self.mem.tokens_of(req.rid)
            self.mem.free(req.rid)
        req.prefill_pos = 0
        req.state = State.QUEUED
        self.waiting.append(req)

    def _preempt(self, req: Request, plan: StepPlan) -> None:
        slot = self._release_slot(req, plan)
        if self.cfg.preemption == "swap":
            # swap-style preemption: the block table spills to host DRAM and
            # all request state (prefill_pos, output) survives intact.
            tokens = self.mem.swap_out(req.rid)
            self.stats.swap_outs += 1
            self.stats.swapped_out_tokens += tokens
            req.swaps += 1
            req.state = State.SWAPPED
            plan.swapped_out.append((req.rid, slot))
            self.swapped.append(req)
            if self.trace.enabled:
                self.trace.request_event(req.rid, "swap_out",
                                         step=self.stats.steps, tokens=tokens)
            return
        # recompute-style preemption: the generated output becomes part of
        # the effective prompt and is re-prefilled later.
        req.restart_output_len = len(req.output)
        self._requeue_recompute(req)
        if self.trace.enabled:
            self.trace.request_event(req.rid, "preempt",
                                     step=self.stats.steps, mode="recompute")

    def _preempt_prefill(self, req: Request, plan: StepPlan) -> None:
        """Shed an in-flight *prefill* to free pool blocks (hard-bound
        pressure only). Always recompute-style — a prefill has no output
        yet, so re-queueing just restarts its chunked prefill; swap restore
        semantics (which resume decoding) don't apply."""
        self._release_slot(req, plan)
        self.prefilling.remove(req)
        self._requeue_recompute(req)
        if self.trace.enabled:
            self.trace.request_event(req.rid, "preempt",
                                     step=self.stats.steps, mode="shed")

    def _restore_swapped(self, plan: StepPlan, now: float) -> None:
        """Re-admit swapped-out decodes (oldest first) when a slot is free
        and the capacity budget allows. If nothing is decoding, the oldest
        swapped request is force-restored so the system always progresses —
        same soft-capacity escape hatch as the never-preempt-last-decode
        rule.

        Fault recovery rides the head of the queue: a restore whose swap-in
        transfer exhausted its retries falls back to recompute (the host
        copy is dropped and the request re-prefills prompt + output —
        token-identical under greedy); a restore mid-retry stays parked so
        the retried transfer lands first (restores are strictly
        oldest-first, so nothing overtakes it)."""
        while self.swapped and self.free_slots:
            req = self.swapped[0]
            if self.injector.enabled:
                reason = self.prefetch_queue.take_aborted(req.rid, SWAP_IN)
                if reason is not None:
                    self._fallback_recompute(req, reason)
                    continue
                if self.prefetch_queue.blocked(req.rid, SWAP_IN):
                    break  # retry in flight/backoff: park until it lands
            decode_rids = [r.rid for r in self.active.values()
                           if r.state == State.DECODE]
            # pages the restore mints: spilled blocks + this step's decode
            # growth (kept/shared blocks are still device-resident and
            # already projected via the swap record)
            need = self.mem.swap_in_extra_blocks(req.rid)
            fits = self.mem.fits_after_growth(decode_rids, extra_blocks=need)
            # a forced restore may over-run the soft budget but never the
            # physical pool — attach() would raise OutOfBlocks
            forced = not decode_rids and self.mem.hard_fits_after_growth(
                decode_rids, extra_blocks=need)
            if not (fits or forced):
                break
            self.swapped.pop(0)
            # claim the restore's host->HBM bytes from the ledger BEFORE the
            # attach mints pages: a transfer issued on an earlier step (and
            # landed) makes the restore free; anything else is late/sync
            # debt the consuming backend must pay before reading the pages
            plan.consumed.append(self.prefetch_queue.consume(
                req.rid, SWAP_IN, self.stats.steps,
                demand_bytes=self.mem.swap_host_bytes(req.rid)))
            self.mem.swap_in(req.rid)
            self.mem.tiers.touch(req.rid, self.stats.steps)
            self.stats.swap_ins += 1
            req.slot = self.free_slots.pop(0)
            req.state = State.DECODE
            self.active[req.slot] = req
            plan.swapped_in.append((req.rid, req.slot))
            if self.trace.enabled:
                self.trace.request_event(req.rid, "swap_in",
                                         step=self.stats.steps, slot=req.slot)

    # ----------------------------------------------------- robustness hooks
    def _fallback_recompute(self, req: Request, reason: str) -> None:
        """Swap restore gave up (retries exhausted): drop the host copy and
        recompute instead.  The generated output joins the effective prompt
        and the request re-prefills from scratch — greedy tokens are
        identical to the fault-free run, only latency is lost."""
        self.swapped.remove(req)
        # a speculative SWAP_IN intent may have been re-issued between the
        # abort and this discovery — tear it down with the host copy
        self.prefetch_queue.cancel(req.rid, SWAP_IN, reason="swap_fallback")
        self.stats.preempted_tokens += req.context_len  # recompute debt
        self.mem.drop_swapped(req.rid)
        self._released.append((req.rid, "swap_fallback"))
        self.stats.fallback_recomputes += 1
        req.restart_output_len = len(req.output)
        self._requeue_recompute(req)
        if self.trace.enabled:
            # sched_key=False: which step discovers the abort is fault-
            # schedule detail, not part of the canonical schedule record
            self.trace.request_event(req.rid, "fallback",
                                     step=self.stats.steps, sched_key=False,
                                     reason=reason)

    def cancel_request(self, rid: int, reason: str, now: float = 0.0) -> bool:
        """Cancel a request in ANY non-terminal state, releasing everything
        it holds: scheduler queues/slots, allocator refs (incl. prefix-cache
        COW shares), host swap records, and outstanding ledger intents.  The
        engine purges its swap_store/_staged rows via ``drain_released``.
        ``finish_time`` stays None so the request never counts as completed.
        Returns True iff the request existed and was cancelled."""
        req = self.requests.get(rid)
        if req is None or req.state in (State.DONE, State.CANCELLED):
            return False
        q = self.prefetch_queue
        q.cancel(rid, SWAP_IN, reason=reason)
        q.cancel(rid, ADOPT, reason=reason)
        q.take_aborted(rid, SWAP_IN)  # an un-taken abort dies with the rid
        if req.state == State.QUEUED:
            self.waiting.remove(req)
        elif req.state == State.SWAPPED:
            self.swapped.remove(req)
            self.mem.drop_swapped(rid)
        else:  # PREFILL or DECODE: owns a slot and (usually) a block table
            if req in self.prefilling:
                self.prefilling.remove(req)
            if req.slot is not None:
                del self.active[req.slot]
                self.free_slots.append(req.slot)
                self.free_slots.sort()
                req.slot = None
            if rid in self.mem.allocator.tables:
                self.mem.free(rid)
        self._released.append((rid, reason))
        req.state = State.CANCELLED
        req.cancel_reason = reason
        self.stats.cancelled_requests += 1
        if self.trace.enabled:
            self.trace.request_event(rid, "cancel", step=self.stats.steps,
                                     sched_key=False, reason=reason)
        return True

    def cancel_all(self, reason: str = "shutdown", now: float = 0.0) -> int:
        """Cancel every non-terminal request (graceful shutdown). Returns
        the number cancelled."""
        return sum(1 for rid in list(self.requests)
                   if self.cancel_request(rid, reason, now))

    def drain_released(self) -> List[Tuple[int, str]]:
        """Hand the engine the rids whose backing state (swap_store rows,
        staged device copies) must be purged, clearing the log."""
        out, self._released = self._released, []
        return out

    def _expire_deadlines(self, now: float) -> None:
        """Cancel requests past their deadline.  ``Request.deadline`` is an
        absolute time on the driving clock; ``cfg.request_timeout`` is
        relative to arrival; the earlier of the two wins."""
        timeout = self.cfg.request_timeout
        for req in list(self.requests.values()):
            if req.state in (State.DONE, State.CANCELLED):
                continue
            deadline = req.deadline
            if timeout is not None:
                rel = req.arrival_time + timeout
                deadline = rel if deadline is None else min(deadline, rel)
            if deadline is not None and now > deadline:
                if self.cancel_request(req.rid, "deadline", now):
                    self.stats.deadline_cancellations += 1

    def _degraded_now(self) -> bool:
        return self.degraded is not None and self.degraded.degraded

    def _robustness_tick(self, plan: StepPlan, now: float) -> None:
        """Top-of-step robustness pass: expire deadlines, pump the ledger's
        fault/retry state machine, and feed the degraded-mode controller
        one (failures, attempts) observation."""
        step = self.stats.steps
        if self._deadlines:
            self._expire_deadlines(now)
        if self.injector.enabled:
            # attribute exactly the wasted bytes the fail pass charges
            # (bytes_refetched), not the re-attempt list: ``retried`` also
            # resurfaces deferred attempts that re-send nothing
            before = self.prefetch_queue.stats.bytes_refetched
            plan.retried = self.prefetch_queue.retry_tick(step)
            wasted = self.prefetch_queue.stats.bytes_refetched - before
            if wasted > 0:
                self.ledger.debit(step, RETRY_REFETCH, wasted)
        if self.degraded is not None:
            qs = self.prefetch_queue.stats
            attempts = qs.issued + qs.transfer_retries
            flipped = self.degraded.observe(
                step, qs.transfer_failures - self._fail_seen,
                attempts - self._attempt_seen)
            self._fail_seen = qs.transfer_failures
            self._attempt_seen = attempts
            if flipped and self.trace.enabled:
                what = "degraded_enter" if self.degraded.degraded else "degraded_exit"
                self.trace.instant(LANE_SCHED, what, step=step,
                                   rate=self.degraded.rate())
            if self.degraded.degraded:
                self.stats.degraded_mode_steps += 1

    def _needs_pump(self, plan: StepPlan) -> bool:
        """An empty plan normally means "safe to idle" — except mid-recovery:
        with a retried transfer to re-attempt or every restore parked on a
        backoff, the backends must emit a zero-token cycle so the retry
        clocks keep ticking (bounded: every failed transfer either retries
        or aborts into a recompute fallback within the retry budget)."""
        if plan.retried:
            return True
        if not (self.injector.enabled and self.swapped):
            return False
        q = self.prefetch_queue
        return any(q.blocked(r.rid, SWAP_IN) or q.has_aborted(r.rid, SWAP_IN)
                   for r in self.swapped)

    # ----------------------------------------------------------------- steps
    def next_step(self, now: float = 0.0) -> Optional[StepPlan]:
        """Build the next packed step, mutating request bookkeeping."""
        plan = StepPlan(decode_slots=[], decode_rids=[])
        plan.step = self.stats.steps
        if self.injector.enabled or self.degraded is not None or self._deadlines:
            self._robustness_tick(plan, now)

        # KV-pressure preemption: each decode grows its context by one this
        # step; shed victims until the projected block occupancy fits. Never
        # preempt the last remaining decode (no livelock) — it may over-run
        # the *soft* budget, but the *hard* pool bound cannot be crossed:
        # there, in-flight prefills are shed instead so the decode's growth
        # never raises OutOfBlocks.
        if self.mem.capacity_blocks is not None:
            while True:
                decodes = [r for r in self.active.values() if r.state == State.DECODE]
                if self.mem.fits_after_growth([r.rid for r in decodes]):
                    break
                if len(decodes) > 1:
                    self._preempt(self._preempt_victim(decodes), plan)
                    continue
                rids = [r.rid for r in decodes]
                if self.prefilling and not self.mem.hard_fits_after_growth(rids):
                    self._preempt_prefill(self.prefilling[-1], plan)  # youngest
                    continue
                # soft capacity: the last decode runs over budget
                self.mem.over_capacity_steps += 1
                break

        # swap-in restores happen after shedding: pressure just measured, so
        # a restore never immediately re-preempts within the same step
        if self.swapped:
            self._restore_swapped(plan, now)

        # KV growth is planned *here*, before the compute runs: each decode's
        # table extends by the one token this step writes, so the engine's
        # block-table mirror already names the physical pages the step's
        # scatter targets. Between steps every table covers exactly the
        # tokens actually written (no phantom +1 reservation).
        for slot, req in sorted(self.active.items()):
            if req.state == State.DECODE:
                plan.decode_slots.append(slot)
                plan.decode_rids.append(req.rid)
                self.mem.on_decode(req.rid)

        budget = max(0, self.cfg.chunk_size - len(plan.decode_slots))

        # multi-prefill packing: fill the budget with one chunk per in-flight
        # prefill (admission order), admitting new requests whenever budget,
        # a free slot, a prefill lane, AND pool headroom remain — a bounded
        # pool turns OutOfBlocks into an admission signal (chunks shrink to
        # the growable token count; admission stalls when no block is free).
        stalled: set = set()  # rids whose chunk was pool-blocked this step
        admission_stalled = False
        watermark_stalled = False
        degraded_stalled = False
        while True:
            scheduled: set = set()  # rids already visited this pass
            while budget > 0:
                pre = next((r for r in self.prefilling if r.rid not in scheduled),
                           None)
                if pre is None:
                    if not (self.waiting and self.free_slots
                            and len(self.prefilling) < self.cfg.max_concurrent_prefills):
                        break
                    if self._degraded_now() and (self.active or self.swapped):
                        # degraded mode sheds NEW admissions (deferral, not
                        # rejection: the request stays queued) while already-
                        # admitted work drains; an otherwise-idle system
                        # still admits — same escape hatch as the watermark
                        if not degraded_stalled:
                            self.stats.degraded_sheds += 1
                            degraded_stalled = True
                        break
                    # injected phantom pool pressure applies only at NEW
                    # admissions (never to in-flight growth, which must not
                    # deadlock) and never gates an otherwise-idle system
                    phantom = 0
                    if self.injector.enabled and (self.active or self.swapped):
                        phantom = self.injector.phantom_free_blocks(
                            self.stats.steps)
                    if not self.mem.has_block_headroom(phantom=phantom):
                        # counted once per step, even across shed-replan passes
                        if not admission_stalled:
                            if phantom and self.mem.has_block_headroom():
                                self.stats.injected_oob_stalls += 1
                            else:
                                self.stats.out_of_block_stalls += 1
                            admission_stalled = True
                        break
                    if not self._watermark_ok():
                        # soft back-off: pages exist but sit below the low-
                        # watermark — defer NEW admissions so running work
                        # finishes instead of thrashing through shed/re-admit
                        if not watermark_stalled:
                            self.stats.watermark_stalls += 1
                            watermark_stalled = True
                        break
                    pre = self._pop_waiting()
                    pre.slot = self.free_slots.pop(0)
                    pre.state = State.PREFILL
                    self.active[pre.slot] = pre
                    self.prefilling.append(pre)
                    self.mem.tiers.touch(pre.rid, self.stats.steps)
                    self._admit_prefix(pre, plan)
                    if self.trace.enabled:
                        self.trace.request_event(
                            pre.rid, "admit", step=self.stats.steps,
                            slot=pre.slot,
                            cached_prefix=pre.cached_prefix_len)
                scheduled.add(pre.rid)
                take = min(budget, pre.total_prefill_len - pre.prefill_pos)
                headroom = self.mem.grow_headroom(pre.rid)
                if headroom is not None and take > headroom:
                    take = headroom
                    if take <= 0:
                        if pre.rid not in stalled:
                            self.stats.out_of_block_stalls += 1
                            stalled.add(pre.rid)
                        continue  # pool-blocked; another prefill may have slack
                self.mem.on_prefill(pre.rid, take)  # reserve this chunk's pages
                plan.prefill_segments.append(PrefillSegment(
                    rid=pre.rid, slot=pre.slot, start=pre.prefill_pos, length=take,
                    finishes=pre.prefill_pos + take >= pre.total_prefill_len,
                ))
                if pre.schedule_time is None:
                    pre.schedule_time = now
                budget -= take
            if not plan.is_empty or len(self.prefilling) <= 1:
                break
            # every in-flight prefill is pool-blocked and nothing decodes:
            # shed the youngest and replan — a lone prefill always fits (the
            # engine sizes the pool to hold at least one max_len context),
            # so this converges instead of deadlocking on OutOfBlocks
            self._preempt_prefill(self.prefilling[-1], plan)

        # preemption/restores only fire with >= 1 surviving decode in the
        # plan, and the stall-shed retry above always converges to a
        # schedulable prefill — so an empty plan implies no state changed...
        # except mid-fault-recovery, where a zero-token pump cycle keeps the
        # retry/backoff clocks ticking (see _needs_pump)
        if plan.is_empty:
            if not self._needs_pump(plan):
                return None
            plan.pump = True
            self.stats.pump_steps += 1

        # stamp the plan's mixed-batch segment layout: decode rows first (one
        # 1-token segment each, attending its full context), then one segment
        # per prefill chunk (its last row attends start+length keys). This is
        # THE layout — the engine builds the kernel's cu-lens arrays from it
        # and the attention pricing below reads the same numbers.
        cu_q, cu_kv = [0], [0]
        for r in plan.decode_rids:
            cu_q.append(cu_q[-1] + 1)
            cu_kv.append(cu_kv[-1] + self.requests[r].context_len)
        for seg in plan.prefill_segments:
            cu_q.append(cu_q[-1] + seg.length)
            cu_kv.append(cu_kv[-1] + seg.start + seg.length)
        plan.cu_q_lens = tuple(cu_q)
        plan.cu_kv_lens = tuple(cu_kv)
        plan.prefix_copies.extend(self.mem.drain_prefix_copies())

        if not plan.pump:
            # prefetch lookahead: the decode set whose attention follows this
            # packed compute phase (current decodes + every finishing prefill)
            ctx = {r: self.requests[r].context_len for r in plan.decode_rids}
            finishing = []
            for seg in plan.prefill_segments:
                if seg.finishes:
                    ctx[seg.rid] = self.requests[seg.rid].total_prefill_len
                    finishing.append(seg.rid)
            prios = {r: self.requests[r].priority for r in ctx}
            plan.prefetch = self.planner.plan(ctx, finishing=finishing,
                                              priorities=prios)
            # coverage accounting (vacuous-step bugfix): a plan with zero
            # plannable bytes contributes nothing to the average instead of a
            # fake 1.0 — idle/attention-free steps cannot inflate coverage
            if plan.prefetch.total_tokens == 0:
                self.stats.prefetch_vacuous_steps += 1
            else:
                self.stats.prefetch_steps += 1
                self.stats.prefetch_coverage_sum += plan.prefetch.coverage

            # mixed-batch attention accounting: the unified kernel reads each
            # SEGMENT's blocks once — a decode row its context, a prefill
            # chunk its prefix+chunk — never once per chunk token. Priced
            # straight off the plan's segment layout, so engine and sim agree
            # by construction.
            bs = self.mem.block_size
            kv_lens = plan.kv_lens
            touched = kv_tokens_touched(kv_lens, bs)
            max_row = max(kv_lens, default=1)
            rows = len(plan.decode_slots) + plan.total_prefill_tokens
            self.stats.attn_tokens_touched += touched
            self.ledger.debit(self.stats.steps, ATTN_READ,
                              touched * self.mem.kv_bytes_per_token)
            # baseline at the same block granularity as `touched`: what a
            # rectangular gather over the paged pool would read — every row
            # padded to the step's longest context — so savings are never
            # negative and sim/engine comparable
            self.stats.attn_tokens_padded += rows * (bs * -(-max_row // bs))

        # one-step-ahead transfer intents: issued against the ledger while
        # THIS step's compute runs, consumed by the next step's restores /
        # adoptions (still pre-increment: issue_step == this plan's index).
        # Degraded mode turns the lookahead off — no speculative transfers
        # to fail while the failure rate is hot; restores go synchronous.
        if self.cfg.async_prefetch and not self._degraded_now():
            self._plan_ahead(plan)

        # canonical schedule-determined step record: the same Scheduler
        # drives both backends, so for identical workloads the engine and
        # the simulator emit identical key sequences — checked structurally
        # by tools/check_trace.py --compare (timestamps are never in keys)
        if self.trace.enabled:
            self.trace.sched_step(
                step=self.stats.steps,
                decode=tuple(plan.decode_rids),
                prefill=tuple((s.rid, s.start, s.length, int(s.finishes))
                              for s in plan.prefill_segments),
                preempted=tuple(plan.preempted_rids),
                swap_out=tuple(plan.swapped_out),
                swap_in=tuple(plan.swapped_in),
                issued=tuple((t.rid, t.kind, int(round(t.nbytes)))
                             for t in plan.issued),
                consumed=tuple((r.rid, r.kind, int(round(r.nbytes)))
                               for r in plan.consumed),
                retried=tuple((t.rid, t.kind, t.attempt)
                              for t in plan.retried),
            )

        self.stats.steps += 1
        self.stats.scheduled_tokens += plan.total_tokens
        self.stats.decode_tokens += len(plan.decode_slots)
        self.stats.prefill_tokens += plan.total_prefill_tokens
        return plan

    def _plan_ahead(self, plan: StepPlan) -> None:
        """Emit next-step transfer intents from the plan just built (the
        paper's prefetch half, made temporal): predict which parked requests
        restore next step and which waiting prompts will hit the prefix
        cache, and issue their transfers so the DMA overlaps this step's
        compute.  Mispredictions are safe — an unconsumed intent is consumed
        late (still partially overlapped) or cancelled, and an unpredicted
        consumer simply pays the synchronous path."""
        q = self.prefetch_queue
        step = self.stats.steps  # this plan's index (pre-increment)
        # (a) swap-in restores: the oldest parked requests that could take a
        # slot next step — currently free slots plus decodes finishing now.
        # Under capacity thrash no slot is ever free at plan time (the next
        # preemption frees it mid-step, right before the restore), so the
        # oldest parked request is ALWAYS a candidate: restores are strictly
        # oldest-first, so its transfer is consumed eventually and a too-
        # early issue just lands ahead of a later consumer (never wasted)
        if self.swapped:
            freeing = sum(
                1 for rid in plan.decode_rids
                if (self.requests[rid].finished
                    or len(self.requests[rid].output) + 1
                    >= self.requests[rid].max_new_tokens))
            slots = max(1, len(self.free_slots) + freeing)
            for req in self.swapped[:slots]:
                # a pending aborted record means the restore gate will fall
                # back to recompute — a fresh intent would only dangle
                if q.has_aborted(req.rid, SWAP_IN):
                    continue
                t = q.issue(req.rid, SWAP_IN,
                            self.mem.swap_host_bytes(req.rid), step)
                if t is not None and t.issue_step == step:
                    plan.issued.append(t)
        # (b) prefix-cache re-adoptions: probe (read-only) the next
        # admission candidates' prompts; a predicted hit's matched pages get
        # their BEOL warm-up issued ahead of the admitting step. The matched
        # blocks are device-resident pages already — no bytes cross a link —
        # so the intent lands at issue in BOTH backends: it prices the
        # prediction (overlapped vs cancelled), not a data movement
        if self.mem.prefix is not None and self.waiting:
            lanes = self.cfg.max_concurrent_prefills - len(self.prefilling)
            if lanes > 0:
                head = sorted(self.waiting, key=self._policy_key())[:lanes]
                for req in head:
                    tokens = req.prefill_slice(0, req.total_prefill_len)
                    matched = self.mem.probe_prefix(
                        tokens, max_tokens=req.total_prefill_len - 1)
                    t = q.issue(req.rid, ADOPT,
                                matched * self.planner.kv_btl, step)
                    if t is not None and t.issue_step == step:
                        plan.issued.append(t)
                        q.land(t)

    def commit_prefetch(self, plan: StepPlan,
                        earned_fill_bytes: Optional[float] = None) -> None:
        """Land this step's BEOL placement. The simulator calls this with the
        fill bytes the transfer engine actually earned; the engine (and
        ``complete_step``, as a fallback) commits the full placement."""
        pf = plan.prefetch
        if pf is None or pf.placement is None or plan.prefetch_committed:
            return
        earned_blocks = None
        if earned_fill_bytes is not None:
            earned_blocks = int(earned_fill_bytes // max(self.mem.tiers.block_bytes, 1))
        self.mem.commit_beol(pf.placement, earned_blocks, step=self.stats.steps)
        plan.prefetch_committed = True

    def complete_step(self, plan: StepPlan, now: float = 0.0) -> List[int]:
        """Advance request states after a step executed. Returns finished
        rids. Block tables were already grown in ``next_step`` (the pages had
        to exist before the compute wrote into them), so here only request
        state advances — ``mem.tokens_of`` stays equal to the KV tokens
        actually written at every step boundary."""
        self.commit_prefetch(plan)
        finished: List[int] = []
        for seg in plan.prefill_segments:
            req = self.requests[seg.rid]
            req.prefill_pos += seg.length
            if seg.finishes:
                # last chunk computed the next output token
                req.state = State.DECODE
                self.prefilling.remove(req)
                if req.first_token_time is None:
                    req.first_token_time = now
                    if self.trace.enabled:
                        self.trace.request_event(req.rid, "first_token",
                                                 step=self.stats.steps - 1)
                elif self.trace.enabled:
                    # re-prefill after a recompute preemption: not a TTFT
                    # edge, but the lifecycle span still re-enters decode
                    self.trace.request_event(req.rid, "prefill_done",
                                             step=self.stats.steps - 1)
                req.token_times.append(now)
                # the prompt's KV is fully written: index its full blocks in
                # the radix cache so later shared-prefix admissions fork them
                # copy-on-write (original prompt only — recompute-restart
                # output tokens are backend-dependent and never cached)
                if self.mem.prefix is not None:
                    self.stats.prefix_inserted_blocks += self.mem.insert_prefix(
                        req.rid, req.prompt, step=self.stats.steps,
                        priority=req.priority)

        for rid in plan.decode_rids:
            req = self.requests[rid]
            req.token_times.append(now)

        # completion by output length or an explicit finish flag (the engine
        # sets Request.finished on EOS rather than mutating max_new_tokens,
        # so requested-vs-generated length metrics stay truthful)
        for rid in list(plan.decode_rids) + plan.finishing_rids:
            req = self.requests[rid]
            if req.finished or len(req.output) >= req.max_new_tokens:
                req.state = State.DONE
                req.finish_time = now
                finished.append(rid)
                self.mem.free(rid)
                if self.trace.enabled:
                    self.trace.request_event(rid, "finish",
                                             step=self.stats.steps - 1,
                                             output_tokens=len(req.output))
                if req.slot is not None:
                    del self.active[req.slot]
                    self.free_slots.append(req.slot)
                    self.free_slots.sort()
                    req.slot = None  # keep rid -> req for metrics
        return finished
