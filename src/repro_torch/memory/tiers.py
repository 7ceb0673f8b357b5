"""Explicit memory-tier model: BEOL prefetch buffer / HBM / host DRAM.

The paper's ultra-large on-chip memory is the BEOL (M3D gain-cell) buffer —
a *cache* of HBM-resident KV blocks that decode attention can read at
on-chip bandwidth. This module tracks per-request block residency in that
cache across steps, which is what turns prefetch from a per-step byte
heuristic into a real memory system:

  * blocks already resident from a previous step are BEOL *hits* — their KV
    never re-crosses HBM (the source of the paper's HBM-traffic reduction);
  * blocks newly wanted are *fills* — DMA work the transfer engine must
    earn out of residual HBM bandwidth during the compute-bound phase;
  * blocks no longer wanted are evicted (free: BEOL holds clean copies).

Placement policies (pluggable via ``policy``):
  * ``"longest"`` — longest-context-first pinning: decode requests ranked by
    context length, finishing prefills last (their KV is still being
    written this step). The longest contexts are the most HBM-bound, so
    they benefit most per resident byte.
  * ``"priority"`` — priority-partitioned quotas: the BEOL block budget is
    split across priority classes proportional to their populations
    (weighted by class rank so higher classes never starve), longest-first
    within a class.

Eviction from the BEOL is free (it caches clean HBM copies): blocks simply
drop when a request leaves the desired set. ``lru_victim`` exposes
least-recently-(re)admitted ordering over ``last_access`` for the
scheduler's ``eviction="lru"`` swap/preemption victim selection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

BEOL, HBM, HOST = "beol", "hbm", "host"
POLICIES = ("longest", "priority")


@dataclasses.dataclass
class Placement:
    """Desired BEOL residency for one step, split into hits and fills."""

    desired_blocks: Dict[int, int]  # rid -> prefix blocks wanted resident
    retained_blocks: Dict[int, int]  # rid -> blocks already resident (hits)
    fill_blocks: Dict[int, int]  # rid -> blocks to DMA HBM -> BEOL
    evicted_blocks: int  # blocks dropped from residency this step
    # finishing prefills: desired but NOT fillable this step (their KV is
    # being written during the packed phase) — they earn residency next step
    finishing: Set[int] = dataclasses.field(default_factory=set)

    def total(self, field: str) -> int:
        return sum(getattr(self, field).values())


@dataclasses.dataclass
class TierStats:
    hit_blocks: int = 0  # served from BEOL without an HBM crossing
    fill_blocks: int = 0  # DMA'd into BEOL (earned)
    evicted_blocks: int = 0


class TierManager:
    """Per-block BEOL residency tracking with pluggable placement."""

    def __init__(self, beol_capacity_bytes: int, block_bytes: int,
                 policy: str = "longest"):
        if policy not in POLICIES:
            raise ValueError(f"unknown tier policy {policy!r}; want one of {POLICIES}")
        self.capacity_bytes = int(beol_capacity_bytes)
        self.block_bytes = max(int(block_bytes), 1)
        self.policy = policy
        self.resident: Dict[int, int] = {}  # rid -> prefix blocks in BEOL
        self.last_access: Dict[int, int] = {}  # rid -> step of last (re)admission
        self.stats = TierStats()

    # ------------------------------------------------------------ properties
    @property
    def budget_blocks(self) -> int:
        return self.capacity_bytes // self.block_bytes

    @property
    def resident_blocks(self) -> int:
        return sum(self.resident.values())

    @property
    def resident_bytes(self) -> int:
        return self.resident_blocks * self.block_bytes

    # -------------------------------------------------------------- policies
    def _rank(self, ctx_blocks: Dict[int, int], finishing: Set[int],
              priorities: Dict[int, int]) -> List[int]:
        """Placement order (established decodes first, longest context first)."""
        return sorted(ctx_blocks, key=lambda r: (r in finishing, -ctx_blocks[r], r))

    def _desired_longest(self, ctx_blocks, finishing, priorities) -> Dict[int, int]:
        budget = self.budget_blocks
        desired: Dict[int, int] = {}
        for rid in self._rank(ctx_blocks, finishing, priorities):
            take = min(ctx_blocks[rid], budget)
            desired[rid] = take
            budget -= take
        return desired

    def _desired_priority(self, ctx_blocks, finishing, priorities) -> Dict[int, int]:
        """Partition the BEOL budget into per-priority-class quotas.

        Quota weight = class population x (1 + class rank), so higher
        priorities get a super-proportional share; unconsumed quota spills
        to the next class down (then a final longest-first pass hands out
        any remainder)."""
        budget = self.budget_blocks
        classes: Dict[int, List[int]] = {}
        for rid in ctx_blocks:
            classes.setdefault(priorities.get(rid, 0), []).append(rid)
        ranked = sorted(classes, reverse=True)  # high priority first
        weights = {p: len(classes[p]) * (1 + rank_from_low(p, ranked)) for p in ranked}
        wsum = sum(weights.values()) or 1
        desired: Dict[int, int] = {r: 0 for r in ctx_blocks}
        spill = 0
        for p in ranked:
            quota = budget * weights[p] // wsum + spill
            for rid in self._rank({r: ctx_blocks[r] for r in classes[p]},
                                  finishing, priorities):
                take = min(ctx_blocks[rid], quota)
                desired[rid] = take
                quota -= take
            spill = quota
        # final pass: hand leftover to any still-unsatisfied request
        left = self.budget_blocks - sum(desired.values())
        for rid in self._rank(ctx_blocks, finishing, priorities):
            if left <= 0:
                break
            extra = min(ctx_blocks[rid] - desired[rid], left)
            desired[rid] += extra
            left -= extra
        return desired

    # ----------------------------------------------------------------- steps
    def place(self, ctx_tokens: Dict[int, int], block_size: int,
              finishing: Iterable[int] = (),
              priorities: Optional[Dict[int, int]] = None) -> Placement:
        """Decide desired BEOL residency for the decode set; no state change
        until ``commit`` (the sim prices the fills first)."""
        fin = set(finishing)
        prios = priorities or {}
        ctx_blocks = {r: -(-t // block_size) for r, t in ctx_tokens.items() if t > 0}
        for r in ctx_tokens:
            ctx_blocks.setdefault(r, 0)
        if self.policy == "priority":
            desired = self._desired_priority(ctx_blocks, fin, prios)
        else:
            desired = self._desired_longest(ctx_blocks, fin, prios)
        retained = {r: min(desired[r], self.resident.get(r, 0)) for r in desired}
        # finishing-prefill KV cannot stream this step: fill demand is zero
        # (it becomes a regular fill next step, once the KV exists in HBM)
        fills = {r: 0 if r in fin else desired[r] - retained[r] for r in desired}
        evicted = sum(n for r, n in self.resident.items() if r not in desired)
        evicted += sum(self.resident.get(r, 0) - retained[r]
                       for r in desired if self.resident.get(r, 0) > retained[r])
        return Placement(desired, retained, fills, evicted, finishing=fin)

    def commit(self, placement: Placement, earned_fill_blocks: Optional[int] = None,
               step: int = 0) -> None:
        """Apply a placement: hits stay, fills land up to the earned budget
        (placement order — longest contexts fill first), the rest evicts.
        Finishing prefills never land here: their fill demand was zero (and
        unpriced), so residency for them is earned on a later step."""
        order = sorted((r for r in placement.fill_blocks
                        if r not in placement.finishing),
                       key=lambda r: (-placement.desired_blocks[r], r))
        budget = (sum(placement.fill_blocks.values())
                  if earned_fill_blocks is None else earned_fill_blocks)
        new_resident: Dict[int, int] = {}
        filled = 0
        for rid, kept in placement.retained_blocks.items():
            if kept or placement.desired_blocks.get(rid):
                new_resident[rid] = kept
        for rid in order:
            take = min(placement.fill_blocks[rid], budget)
            new_resident[rid] = new_resident.get(rid, 0) + take
            budget -= take
            filled += take
        self.resident = {r: n for r, n in new_resident.items() if n > 0}
        for rid in self.resident:
            self.last_access.setdefault(rid, step)
        self.stats.hit_blocks += placement.total("retained_blocks")
        self.stats.fill_blocks += filled
        self.stats.evicted_blocks += placement.evicted_blocks

    def drop(self, rid: int) -> int:
        """Evict a request's blocks (finish / preemption / swap-out)."""
        n = self.resident.pop(rid, 0)
        self.last_access.pop(rid, None)
        self.stats.evicted_blocks += n
        return n

    # --------------------------------------------------------------- helpers
    def touch(self, rid: int, step: int) -> None:
        """Record (re)admission time. Entries live until ``drop`` (finish,
        recompute preemption, or swap-out) so ``lru_victim`` sees every
        active request's admission, not just the BEOL-resident ones."""
        self.last_access[rid] = step

    def lru_victim(self, candidates: Iterable[Tuple[int, float]]) -> int:
        """Least-recently-(re)admitted rid among (rid, arrival) candidates;
        never-admitted requests order by arrival."""
        cands = list(candidates)
        return min(cands, key=lambda c: (self.last_access.get(c[0], -1),
                                         c[1], c[0]))[0]


def rank_from_low(p: int, ranked_desc: List[int]) -> int:
    """Rank of priority p counted from the lowest class (lowest -> 0)."""
    return len(ranked_desc) - 1 - ranked_desc.index(p)
