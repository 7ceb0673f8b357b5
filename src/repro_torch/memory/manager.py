"""KV-cache memory manager: the scheduler's single source of truth.

Composes the paged block allocator (device occupancy), the radix prefix
cache (copy-on-write prompt sharing), the tier manager (BEOL residency),
and host-side swap bookkeeping into one object both the Scheduler and the
service simulator consult. Capacity questions once answered with a raw
token counter now go through block tables:

  * occupancy   — ``device_tokens`` / ``device_blocks`` from live tables,
    with shared pages (forked / prefix-cached) counted ONCE;
  * pressure    — ``fits_after_growth`` projects this step's decode growth
    block-granularly against the capacity budget;
  * sharing     — ``match_prefix`` adopts a cached prompt prefix as a new
    request's table (no prefill compute, no HBM fill for those tokens);
    ``insert_prefix`` indexes a finished prefill's full blocks; under
    ``OutOfBlocks`` pressure unreferenced cache leaves are reclaimed before
    growth fails (LRU + priority eviction);
  * preemption  — ``free`` (recompute: KV dropped) vs ``swap_out`` /
    ``swap_in``: the table detaches to host DRAM and re-attaches
    block-exactly — *shared* blocks stay device-resident via the detach
    record's kept references, only private pages cross the host link;
  * prefetch    — ``place_beol`` ranks the decode set's blocks into the
    BEOL tier for the tier-aware PrefetchPlanner.

Two capacity regimes compose:
  * the *soft* budget (``capacity_tokens``) drives the preemption loop but
    may legally be over-subscribed — the last remaining decode is never
    preempted (the no-livelock rule), and the overflow is
    visible in ``over_capacity_steps``;
  * the *hard* bound (``num_blocks``) is the physical page pool the engine
    actually allocated device memory for — ``grow`` past it raises
    ``OutOfBlocks``, so the scheduler must gate admission and shed load
    (``hard_fits_after_growth`` / ``grow_headroom``) before planning writes.
    Cache-only blocks never harden that bound: they are reclaimable, so
    headroom counts them as free-in-waiting and growth evicts on demand.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.memory.block_allocator import (
    BlockAllocator,
    DetachRecord,
    OutOfBlocks,
    swap_bytes_block_rounded,
)
from repro_torch.memory.prefix_cache import PrefixCache
from repro_torch.memory.tiers import Placement, TierManager


@dataclasses.dataclass
class SwapRecord:
    """A swapped-out request's KV: private pages parked in host DRAM, shared
    pages pinned on device by the detach record's kept references."""

    record: DetachRecord
    tokens: int  # full written context at swap-out time

    @property
    def table(self):
        return self.record.table

    @property
    def kept(self) -> List[bool]:
        return self.record.kept


def hbm_kv_pool_blocks(hbm_bytes: int, model_cfg: ModelConfig,
                       block_size: int, param_bytes: int = 2) -> Optional[int]:
    """KV page-pool size the arch's real HBM budget affords: capacity minus
    resident weights, divided by one block's full-stack KV bytes. None for
    attention-free models (no paged KV to budget)."""
    kv_per_token = model_cfg.kv_bytes_per_token_layer * model_cfg.n_attn_layers
    if kv_per_token <= 0:
        return None
    weights = model_cfg.param_count() * param_bytes
    budget = max(0, int(hbm_bytes) - weights)
    return budget // (max(block_size, 1) * kv_per_token)


class KVMemoryManager:
    def __init__(
        self,
        model_cfg: ModelConfig,
        block_size: int = 1,
        capacity_tokens: Optional[int] = None,
        beol_bytes: int = 0,
        beol_policy: str = "longest",
        num_blocks: Optional[int] = None,
        enable_prefix_cache: bool = False,
        prefix_cache_blocks: Optional[int] = None,
    ):
        self.cfg = model_cfg
        self.block_size = block_size
        self.capacity_tokens = capacity_tokens
        # num_blocks None -> unbounded allocator, the soft budget alone is
        # enforced by the scheduler's preemption loop via fits_after_growth();
        # num_blocks set -> the physical page pool the engine allocated, a
        # hard bound grow() cannot cross
        self.allocator = BlockAllocator(block_size, num_blocks=num_blocks)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator, max_blocks=prefix_cache_blocks)
            if enable_prefix_cache else None
        )
        self.kv_btl = model_cfg.kv_bytes_per_token_layer
        self.kv_bytes_per_token = self.kv_btl * model_cfg.n_attn_layers
        block_bytes_layer = max(block_size * self.kv_btl, 1)
        self.tiers = TierManager(beol_bytes, block_bytes_layer, policy=beol_policy)
        self.swapped: Dict[int, SwapRecord] = {}
        self.last_restored: Dict[int, SwapRecord] = {}
        # authoritative host-link swap traffic, accumulated at the moment
        # pages actually detach/attach — the attribution ledger's swap
        # causes must reproduce these exactly (conservation invariant)
        self.swap_out_bytes_total = 0
        self.swap_in_bytes_total = 0
        self.over_capacity_steps = 0
        # mid-block COW adoptions recorded by match_prefix, drained into
        # StepPlan.prefix_copies: (rid, src_block, dst_block, n_tokens)
        self.pending_prefix_copies: List[Tuple[int, int, int, int]] = []

    # ------------------------------------------------------------- occupancy
    @property
    def capacity_blocks(self) -> Optional[int]:
        """Tightest capacity bound in blocks: min(soft budget, hard pool)."""
        soft = (None if self.capacity_tokens is None
                else self.capacity_tokens // self.block_size)
        hard = self.allocator.num_blocks
        if soft is None:
            return hard
        if hard is None:
            return soft
        return min(soft, hard)

    @property
    def device_tokens(self) -> int:
        """Written tokens resident in live tables, shared pages counted once."""
        return self.allocator.physical_used_tokens()

    @property
    def device_blocks(self) -> int:
        return self.allocator.used_blocks

    @property
    def host_tokens(self) -> int:
        """Tokens whose KV actually lives in host DRAM (spilled pages only;
        a swapped table's shared pages stay device-resident)."""
        return sum(r.record.spilled_tokens(self.block_size)
                   for r in self.swapped.values())

    @property
    def prefix_cached_blocks(self) -> int:
        return self.prefix.cached_blocks if self.prefix is not None else 0

    def register_metrics(self, reg) -> None:
        """Declare the memory subsystem's health gauges in a typed metrics
        registry (historical ``metrics.summarize`` key names)."""
        reg.gauge("kv_fragmentation", "ratio",
                  "reserved-but-unused fraction of live physical blocks").set(
                      self.fragmentation())
        reg.counter("over_capacity_steps", "steps",
                    "steps the last surviving decode over-ran the soft "
                    "budget").inc(float(self.over_capacity_steps))
        reg.gauge("prefix_cached_blocks", "blocks",
                  "blocks currently held by the radix prefix cache").set(
                      float(self.prefix_cached_blocks))
        reg.counter("swap_out_bytes", "bytes",
                    "host-link bytes spilled by KV swap-outs").inc(
                        float(self.swap_out_bytes_total))
        reg.counter("swap_in_bytes", "bytes",
                    "host-link bytes restored by KV swap-ins").inc(
                        float(self.swap_in_bytes_total))

    def tokens_of(self, rid: int) -> int:
        t = self.allocator.tables.get(rid)
        return t.num_tokens if t is not None else 0

    def blocks_of(self, rid: int) -> int:
        t = self.allocator.tables.get(rid)
        return t.num_blocks if t is not None else 0

    def fragmentation(self) -> float:
        """Reserved-but-unused fraction of live physical blocks — tables,
        cached prefixes (always full), and swap-pinned shared pages — each
        counted once however many owners share them."""
        fill = self.allocator.block_fill()
        if self.prefix is not None:
            for bid in self.prefix.block_ids():
                fill[bid] = self.block_size
        for rec in self.swapped.values():
            t = rec.record.table
            for i, (bid, kept) in enumerate(zip(t.blocks, rec.record.kept)):
                if kept:
                    tok = t.block_tokens(i, self.block_size)
                    if tok > fill.get(bid, 0):
                        fill[bid] = tok
        cap = len(fill) * self.block_size
        if cap == 0:
            return 0.0
        return 1.0 - sum(fill.values()) / cap

    def shared_overlap_tokens(self, rids: Iterable[int]) -> int:
        """Tokens double-counted when summing the given tables' contexts:
        physical blocks referenced by k>1 of the tables contribute
        (k-1)*block_size. The prefetch planner subtracts this so BEOL demand
        counts shared pages once."""
        counts: Dict[int, int] = {}
        for rid in rids:
            t = self.allocator.tables.get(rid)
            if t is None:
                continue
            for b in t.blocks:
                counts[b] = counts.get(b, 0) + 1
        return sum(c - 1 for c in counts.values() if c > 1) * self.block_size

    # -------------------------------------------------------------- pressure
    def projected_blocks(self, growing_rids: Iterable[int]) -> int:
        """Physical device blocks after each growing rid appends one token:
        unique blocks across live tables (shared pages once) plus swap-pinned
        shared pages no live table names, plus the new tail blocks growth
        mints. Cache-only blocks are excluded — they are reclaimed on demand
        before growth can fail."""
        grow: Set[int] = set(growing_rids)
        unique: Set[int] = set()
        extra = 0
        for rid, t in self.allocator.tables.items():
            unique.update(t.blocks)
            tokens = t.num_tokens + (1 if rid in grow else 0)
            extra += max(0, self.allocator.blocks_for(tokens) - t.num_blocks)
        for rec in self.swapped.values():
            unique.update(rec.record.kept_blocks)
        return len(unique) + extra

    def fits_after_growth(self, growing_rids: Iterable[int],
                          extra_tokens: int = 0, extra_blocks: int = 0) -> bool:
        """Would this step's decode growth (+ an optional swap-in needing
        ``extra_tokens``/``extra_blocks``) stay within the capacity budget
        (soft and hard)?"""
        cap = self.capacity_blocks
        if cap is None:
            return True
        extra = self.allocator.blocks_for(extra_tokens) + extra_blocks
        return self.projected_blocks(growing_rids) + extra <= cap

    def hard_fits_after_growth(self, growing_rids: Iterable[int],
                               extra_tokens: int = 0,
                               extra_blocks: int = 0) -> bool:
        """Like ``fits_after_growth`` but against the *physical* pool only:
        when this is False, ``grow`` would raise OutOfBlocks — the soft
        budget's over-subscription escape hatch does not apply."""
        cap = self.allocator.num_blocks
        if cap is None:
            return True
        extra = self.allocator.blocks_for(extra_tokens) + extra_blocks
        return self.projected_blocks(growing_rids) + extra <= cap

    def effective_free_blocks(self) -> Optional[int]:
        """Free pool pages plus cache pages reclaimable on demand."""
        free = self.allocator.free_blocks
        if free is None:
            return None
        if self.prefix is not None:
            free += self.prefix.reclaimable_blocks()
        return free

    def grow_headroom(self, rid: int) -> Optional[int]:
        """Tokens rid can grow before the physical pool runs out: free blocks
        (including evictable cache blocks) plus the slack in rid's tail
        block. None means unbounded."""
        free = self.effective_free_blocks()
        if free is None:
            return None
        t = self.allocator.tables.get(rid)
        slack = t.slack_tokens(self.block_size) if t is not None else 0
        return free * self.block_size + slack

    def has_block_headroom(self, phantom: int = 0) -> bool:
        """``phantom`` free blocks are discounted before the check — the
        fault injector's spurious-OutOfBlocks pressure (admission-gate only;
        in-flight growth never sees it, so nothing admitted can deadlock)."""
        free = self.effective_free_blocks()
        return free is None or free - phantom > 0

    # ---------------------------------------------------------- prefix cache
    def _reclaim_for(self, need_blocks: int) -> bool:
        """Evict unreferenced cache leaves until ``need_blocks`` pool pages
        are free; True when the shortfall was covered."""
        if self.prefix is None:
            return False
        free = self.allocator.free_blocks or 0
        short = need_blocks - free
        if short <= 0:
            return True
        return self.prefix.evict(short) >= short

    def _grow(self, rid: int, n_tokens: int) -> None:
        """``allocator.grow`` with eviction-under-pressure: a full pool first
        reclaims unreferenced cache leaves, then retries; only a genuinely
        exhausted pool raises."""
        try:
            self.allocator.grow(rid, n_tokens)
            return
        except OutOfBlocks:
            t = self.allocator.tables.get(rid)
            have = t.num_blocks if t is not None else 0
            tok = t.num_tokens if t is not None else 0
            need = self.allocator.blocks_for(tok + n_tokens) - have
            if not self._reclaim_for(need):
                raise
        self.allocator.grow(rid, n_tokens)

    def match_prefix(self, rid: int, tokens: Sequence[int],
                     max_tokens: Optional[int] = None, step: int = 0) -> int:
        """Adopt the longest cached prefix of ``tokens`` as rid's table;
        returns matched tokens (0 on miss / cache disabled). Full blocks are
        adopted in place (copy-on-write references); a **mid-block partial
        tail** — a cached block whose first ``p < block_size`` tokens match —
        is adopted by minting a fresh private block and recording a device
        page-copy intent ``(rid, src_block, dst_block, n_tokens)`` in
        ``pending_prefix_copies`` (the scheduler drains it into
        ``StepPlan.prefix_copies``; the engine copies the page before any
        other device write of the step). ``prefill_pos`` can therefore
        resume at the exact matched token offset, not just block
        boundaries. At least one token is always left uncached
        (``max_tokens``, default ``len(tokens) - 1``) so the final prefill
        chunk still computes the first output logits."""
        if self.prefix is None or rid in self.allocator.tables:
            return 0
        limit = max(0, len(tokens) - 1 if max_tokens is None else max_tokens)
        blocks, partial = self.prefix.match_tokens(tokens, step=step,
                                                   max_tokens=limit)
        if not blocks and partial is None:
            return 0
        matched = len(blocks) * self.block_size
        self.allocator.adopt(rid, blocks, matched)
        if partial is not None:
            src, p = partial
            try:
                self._grow(rid, p)
            except OutOfBlocks:
                # pool too tight to mint the COW tail: keep what full blocks
                # gave us (a partial-only match degrades back to a miss)
                if not blocks:
                    self.allocator.free(rid)
                    return 0
                return matched
            dst = self.allocator.tables[rid].blocks[-1]
            self.pending_prefix_copies.append((rid, src, dst, p))
            matched += p
        return matched

    def drain_prefix_copies(self) -> List[Tuple[int, int, int, int]]:
        """Hand off the mid-block COW copy intents recorded since the last
        drain: (rid, src_block, dst_block, n_tokens) per partial adoption."""
        out, self.pending_prefix_copies = self.pending_prefix_copies, []
        return out

    def probe_prefix(self, tokens: Sequence[int],
                     max_tokens: Optional[int] = None) -> int:
        """Read-only ``match_prefix``: tokens a future admission WOULD adopt
        right now (full blocks plus a mid-block partial tail).  No LRU
        touch, no adoption — the one-step-ahead prefetch planner prices
        re-adoption intents with this, so it must count exactly what
        ``match_prefix`` will match."""
        if self.prefix is None:
            return 0
        limit = max(0, len(tokens) - 1 if max_tokens is None else max_tokens)
        return self.prefix.probe_tokens(tokens, max_tokens=limit)

    def insert_prefix(self, rid: int, tokens: Sequence[int], step: int = 0,
                      priority: int = 0) -> int:
        """Index rid's completed full prompt blocks (KV already written);
        returns newly cached blocks."""
        if self.prefix is None:
            return 0
        t = self.allocator.tables.get(rid)
        if t is None:
            return 0
        covered = min(len(tokens), t.num_tokens)
        n_full = covered // self.block_size
        if n_full == 0:
            return 0
        return self.prefix.insert(tokens[:n_full * self.block_size],
                                  t.blocks[:n_full], step=step,
                                  priority=priority)

    # ------------------------------------------------------------- lifecycle
    def on_prefill(self, rid: int, n_tokens: int) -> None:
        self._grow(rid, n_tokens)

    def on_decode(self, rid: int) -> None:
        self._grow(rid, 1)

    def free(self, rid: int) -> int:
        """Drop a request's KV entirely (finish or recompute preemption).
        Blocks a cached prefix (or another fork) still references stay
        live — only the last owner returns them to the pool."""
        self.tiers.drop(rid)
        return self.allocator.free(rid)

    # ------------------------------------------------------------------ swap
    def swap_out(self, rid: int) -> int:
        """Spill rid's private KV pages to host DRAM; returns tokens whose
        pages actually cross the host link (shared pages stay on device,
        pinned by the detach record)."""
        self.tiers.drop(rid)
        record = self.allocator.detach(rid)
        rec = SwapRecord(record=record, tokens=record.table.num_tokens)
        self.swapped[rid] = rec
        self.swap_out_bytes_total += self.swap_host_bytes(rid)
        return record.spilled_tokens(self.block_size)

    def swap_in_extra_blocks(self, rid: int) -> int:
        """Pool pages a restore must mint: the spilled blocks (kept ones are
        still resident) plus one for the restored request's next decode."""
        rec = self.swapped[rid]
        return len(rec.record.spilled_indices) + 1

    def swap_in(self, rid: int) -> int:
        """Restore rid's KV; returns tokens moved over the host link. Kept
        (shared) blocks re-enter the table with their original ids — no
        bytes move; spilled blocks land in freshly minted pages the engine
        scatters the host copies into. Transactional: on OutOfBlocks the
        host record stays parked (kept references included)."""
        rec = self.swapped[rid]
        try:
            self.allocator.attach(rec.record)
        except OutOfBlocks:
            if not self._reclaim_for(len(rec.record.spilled_indices)):
                raise
            self.allocator.attach(rec.record)
        self.swap_in_bytes_total += self.swap_host_bytes(rid)
        del self.swapped[rid]
        self.last_restored[rid] = rec
        return rec.record.spilled_tokens(self.block_size)

    def drop_swapped(self, rid: int) -> int:
        """Abort a parked request: discard its host record and release the
        kept blocks' device references."""
        rec = self.swapped.pop(rid)
        return self.allocator.release_record(rec.record)

    def swapped_tokens_of(self, rid: int) -> int:
        return self.swapped[rid].tokens

    def swap_host_bytes(self, rid: int) -> int:
        """Host-link bytes rid's swap-out moves: whole pages, spilled
        (private) blocks only."""
        rec = self.swapped[rid]
        return int(len(rec.record.spilled_indices) * self.block_size
                   * self.kv_bytes_per_token)

    def restored_host_bytes(self, rid: int) -> int:
        """Host-link bytes rid's most recent swap-in moved (same spilled
        pages the swap-out parked)."""
        rec = self.last_restored.get(rid)
        if rec is None:
            return 0
        return int(len(rec.record.spilled_indices) * self.block_size
                   * self.kv_bytes_per_token)

    def swap_bytes(self, tokens: int) -> int:
        """Full-stack KV bytes (all attention layers) a swap of ``tokens``
        moves over the host link — whole pages, matching the engine's
        per-page gather/scatter copies. Record-unaware upper bound; prefer
        ``swap_host_bytes`` / ``restored_host_bytes`` when a record exists."""
        return swap_bytes_block_rounded(tokens, self.block_size,
                                        self.kv_bytes_per_token)

    # -------------------------------------------------------------- prefetch
    def place_beol(self, ctx_tokens: Dict[int, int], finishing: Iterable[int],
                   priorities: Optional[Dict[int, int]] = None) -> Placement:
        return self.tiers.place(ctx_tokens, self.block_size,
                                finishing=finishing, priorities=priorities)

    def commit_beol(self, placement: Placement,
                    earned_fill_blocks: Optional[int] = None,
                    step: int = 0) -> None:
        self.tiers.commit(placement, earned_fill_blocks, step=step)
