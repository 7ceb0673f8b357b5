"""KV-cache prefetch planning (paper §III, conditions (1) and (2)).

The planner owns the spatial half of the paper's co-design: given the
prefetch-buffer capacity (the M3D BEOL memory — 512 MB on the TPUv6e-like
config) and the decode set's per-request context lengths, it decides which
KV data the next attention op will find resident on-chip.

The paper prefetches ONE LAYER ahead (layer-by-layer schedule), so capacity
is compared against a single layer's KV for the packed decode batch:
    bytes_per_layer = sum_i ctx_len_i * kv_bytes_per_token_layer
Residency is allocated decode-request-first, longest-context-first (longest
contexts are the most HBM-bound — they benefit most per byte).

Two modes:
  * legacy (no memory manager): token-granular longest-first fill — the
    original byte heuristic, kept for direct construction in tests;
  * tier-aware (``mem`` passed): residency is block-granular and delegated
    to the tier manager's placement policy. Blocks already resident in the
    BEOL tier from earlier steps are *retained* (no HBM crossing); only the
    delta is a fill the transfer engine must earn out of residual
    bandwidth (temporal condition (2)).

Finishing prefills are priced explicitly: their KV is still being written
during this packed phase, so their resident bytes are NOT streamable fills —
they appear in ``finishing_bytes`` and only become fillable next step. For
attention-free architectures the next attention op needs zero bytes, so the
plan reports ``total_tokens == 0`` and full (vacuous) coverage rather than
pretending the SSM state is unprefetched KV.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.memory.manager import KVMemoryManager
from repro_torch.memory.tiers import Placement


@dataclasses.dataclass(frozen=True)
class PrefetchPlan:
    """Residency decision for one packed step (one layer lookahead)."""

    buffer_bytes: int
    kv_bytes_per_token_layer: int
    # per decode request: tokens of its KV (one layer) resident on-chip
    resident_tokens: Dict[int, int]
    total_tokens: int
    # tokens of ``resident_tokens`` that belong to finishing prefills — their
    # KV is written during this step, so it cannot be streamed as a fill
    finishing_tokens: int = 0
    # bytes already resident in the BEOL tier from earlier steps (hits)
    retained_bytes: int = 0
    # tier placement backing this plan (tier-aware mode only)
    placement: Optional[Placement] = None

    @property
    def resident_total(self) -> int:
        return sum(self.resident_tokens.values())

    @property
    def coverage(self) -> float:
        """Fraction of the next attention op's KV bytes already on-chip.
        1.0 when nothing is needed (empty decode set / attention-free).
        Clamped: per-request residency may sum shared prefix pages more than
        once while the demand denominator counts each physical page once."""
        if self.total_tokens == 0:
            return 1.0
        return min(1.0, self.resident_total / self.total_tokens)

    @property
    def effective_coverage(self) -> Optional[float]:
        """``coverage`` with the vacuous case made explicit: ``None`` when
        the step had zero plannable bytes (attention-free arch or an empty
        decode set).  Averages (``metrics.summarize``'s ``prefetch_coverage``
        / overlap efficiency) must exclude these steps — a vacuous 1.0 would
        inflate them on idle steps."""
        if self.total_tokens == 0:
            return None
        return self.coverage

    @property
    def prefetch_bytes(self) -> int:
        """Bytes the schedule wants resident for the next attention op."""
        return self.resident_total * self.kv_bytes_per_token_layer

    @property
    def finishing_bytes(self) -> int:
        """Resident bytes being written this step (not streamable as fills)."""
        return self.finishing_tokens * self.kv_bytes_per_token_layer

    @property
    def fill_bytes(self) -> int:
        """Bytes that must actually cross HBM->BEOL during the compute-bound
        phase: wanted minus already-resident minus still-being-written."""
        return max(0, self.prefetch_bytes - self.retained_bytes - self.finishing_bytes)


class PrefetchPlanner:
    def __init__(self, model_cfg: ModelConfig, buffer_bytes: int,
                 mem: Optional[KVMemoryManager] = None, block_size: int = 1):
        self.cfg = model_cfg
        self.buffer_bytes = int(buffer_bytes)
        self.kv_btl = model_cfg.kv_bytes_per_token_layer
        self.mem = mem
        # demand granularity: the ragged paged kernel reads whole KV blocks,
        # so prefetch demand is each context rounded up to blocks — the
        # bytes the next attention op actually touches (block_size=1 ==
        # exact token pricing)
        self.block_size = mem.block_size if mem is not None else max(block_size, 1)

    def _touched(self, tokens: int) -> int:
        bs = self.block_size
        return bs * -(-tokens // bs)

    def plan(self, ctx_lens: Dict[int, int], finishing: Iterable[int] = (),
             priorities: Optional[Dict[int, int]] = None) -> PrefetchPlan:
        """ctx_lens: {request id: KV tokens}. Decode-request-first fill.

        ``finishing`` names requests whose prefill completes this step: their
        KV is still being written during the packed phase, so established
        decodes get buffer residency first; within each class the fill is
        longest-context-first (longest contexts are the most HBM-bound).
        """
        fin = set(finishing)
        if self.kv_btl == 0:  # attention-free arch: nothing to prefetch
            return PrefetchPlan(self.buffer_bytes, 0, {r: 0 for r in ctx_lens},
                                total_tokens=0)
        touched = {r: self._touched(t) for r, t in ctx_lens.items()}
        total = self._dedup_total(ctx_lens, touched)
        if self.mem is not None and self.mem.tiers.capacity_bytes > 0:
            return self._plan_tiered(ctx_lens, touched, fin, priorities, total)
        budget = self.buffer_bytes // self.kv_btl  # tokens that fit (one layer)
        resident: Dict[int, int] = {}
        for rid in sorted(ctx_lens, key=lambda r: (r in fin, -ctx_lens[r])):
            take = min(touched[rid], budget)
            resident[rid] = take
            budget -= take
        return PrefetchPlan(
            self.buffer_bytes, self.kv_btl, resident, total,
            finishing_tokens=sum(resident[r] for r in fin if r in resident),
        )

    def _dedup_total(self, ctx_lens: Dict[int, int],
                     touched: Dict[int, int]) -> int:
        """Demand denominator with shared pages counted ONCE: requests whose
        tables fork a common prefix (radix cache hits) need that prefix
        resident a single time — one BEOL copy serves every sharer."""
        total = sum(touched.values())
        if self.mem is None:
            return total
        overlap = self.mem.shared_overlap_tokens(ctx_lens)
        return max(0, total - overlap)

    def _plan_tiered(self, ctx_lens: Dict[int, int], touched: Dict[int, int],
                     fin: set, priorities: Optional[Dict[int, int]],
                     total: int) -> PrefetchPlan:
        """Block-granular residency over the BEOL tier's placement policy."""
        mem = self.mem
        placement = mem.place_beol(ctx_lens, finishing=fin, priorities=priorities)
        bs = mem.block_size
        resident = {
            r: min(touched[r], placement.desired_blocks.get(r, 0) * bs)
            for r in ctx_lens
        }
        retained_tok = {
            r: min(resident[r], placement.retained_blocks.get(r, 0) * bs)
            for r in ctx_lens
        }
        return PrefetchPlan(
            self.buffer_bytes, self.kv_btl, resident, total,
            finishing_tokens=sum(resident[r] for r in fin if r in resident),
            retained_bytes=sum(retained_tok[r] for r in ctx_lens if r not in fin)
            * self.kv_btl,
            placement=placement,
        )
