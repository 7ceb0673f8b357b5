"""Paged KV-cache block allocator (vLLM-style, block-granular bookkeeping).

KV storage is carved into fixed-size blocks of ``block_size`` tokens. Each
request owns a BlockTable — an ordered list of block ids covering its context
prefix — and blocks are ref-counted so tables can share prefixes (fork /
radix prefix cache). The allocator is the scheduler's source of truth for KV
occupancy: capacity checks, preemption pressure, and swap accounting are all
expressed in blocks rather than the raw token counter the seed scheduler used.

Two capacity modes:
  * bounded (``num_blocks`` set): ``grow`` raises OutOfBlocks when the free
    list is exhausted — used by property tests and hard-capacity backends;
  * unbounded (``num_blocks=None``): fresh block ids are minted on demand —
    used by the Scheduler, which enforces *soft* capacity itself (it must be
    able to over-subscribe by design: the last remaining decode is never
    preempted, so a lone long context may legally exceed the budget).

Sharing records (copy-on-write x swap composition): ``detach`` used to
refuse tables holding shared blocks (the old ``SharedBlocks`` guard),
because ``attach`` minted fresh private pages and a round trip would have
silently duplicated shared prefixes. Detach now returns a ``DetachRecord``
carrying a per-block ``kept`` mask: shared blocks (refcount > 1) KEEP this
table's reference and stay device-resident — only private blocks spill to
host. ``attach`` reuses the kept ids verbatim (the record's reference
transfers back to the table) and mints fresh ids only for the spilled tail,
so a forked / prefix-cached table swaps out and back without ever
duplicating shared pages and the engine only moves the private pages over
the host link.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union


def swap_bytes_block_rounded(tokens: int, block_size: int,
                             kv_bytes_per_token: float) -> int:
    """Host-link bytes one swap direction moves for a ``tokens``-token table:
    whole pages, because the physically paged engine gathers/scatters entire
    (page, heads, head_dim) pages rather than token rows. Memory-domain
    logic (how the allocator's pages round a token count); the manager and
    the service simulator both price swaps through it."""
    bs = max(block_size, 1)
    return int(bs * -(-int(tokens) // bs) * kv_bytes_per_token)


def prefix_fill_bytes_saved(tokens_skipped: int, kv_bytes_per_token: float) -> int:
    """HBM fill bytes a prefix-cache hit avoids for ``tokens_skipped`` prompt
    tokens: the full-stack KV write traffic those tokens' prefill would have
    streamed into HBM. Single source of truth for the savings number — the
    scheduler's stats, the service simulator, and the benchmarks all price
    the skip through this, so sim and engine agree by construction."""
    return int(max(0, tokens_skipped) * kv_bytes_per_token)


class OutOfBlocks(RuntimeError):
    """Bounded allocator exhausted."""


class DoubleFree(RuntimeError):
    """A block's refcount would go negative, or a table was freed twice."""


@dataclasses.dataclass
class BlockTable:
    """One request's ordered block list covering its context prefix."""

    rid: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    num_tokens: int = 0  # tokens actually written/reserved (<= capacity)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def capacity_tokens(self, block_size: int) -> int:
        return len(self.blocks) * block_size

    def slack_tokens(self, block_size: int) -> int:
        """Reserved-but-unused tokens in the tail block (internal fragmentation)."""
        return self.capacity_tokens(block_size) - self.num_tokens

    def block_tokens(self, i: int, block_size: int) -> int:
        """Written tokens block ``i`` of this table holds."""
        return max(0, min(block_size, self.num_tokens - i * block_size))


@dataclasses.dataclass
class DetachRecord:
    """A detached (swapped-out) table plus its sharing record.

    ``kept[i]`` is True when block ``table.blocks[i]`` was shared at detach
    time: it stayed device-resident and this record still holds its
    reference (the other owners — forks, radix-cache nodes — may free
    theirs meanwhile; the record's reference keeps the content alive).
    Blocks with ``kept[i]`` False were private: they returned to the free
    list and their contents must round-trip through host DRAM."""

    table: BlockTable
    kept: List[bool]

    @property
    def spilled_indices(self) -> List[int]:
        return [i for i, k in enumerate(self.kept) if not k]

    @property
    def kept_blocks(self) -> List[int]:
        return [b for b, k in zip(self.table.blocks, self.kept) if k]

    def spilled_tokens(self, block_size: int) -> int:
        """Written tokens living in the spilled (host-bound) blocks."""
        return sum(self.table.block_tokens(i, block_size)
                   for i in self.spilled_indices)


class BlockAllocator:
    def __init__(self, block_size: int, num_blocks: Optional[int] = None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.tables: Dict[int, BlockTable] = {}
        self.ref_count: Dict[int, int] = {}
        self._free: List[int] = list(range(num_blocks)) if num_blocks else []
        self._next_id = num_blocks or 0
        # counters
        self.allocated_blocks_total = 0
        self.freed_blocks_total = 0
        self.peak_used_blocks = 0

    # ---------------------------------------------------------------- sizing
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens (ceil)."""
        return -(-max(n_tokens, 0) // self.block_size)

    @property
    def used_blocks(self) -> int:
        """Physical blocks in use — each block counted ONCE however many
        tables / cache nodes / swap records share it."""
        return len(self.ref_count)

    @property
    def used_tokens(self) -> int:
        """Table-summed token count (shared prefixes counted per table).
        Use ``physical_used_tokens`` for occupancy that counts shared
        pages once."""
        return sum(t.num_tokens for t in self.tables.values())

    def block_fill(self) -> Dict[int, int]:
        """Per-physical-block written tokens, from the live tables' view:
        a block shared by several tables is as full as its fullest owner
        says (prefix sharing is full-block-aligned, so owners agree)."""
        fill: Dict[int, int] = {}
        for t in self.tables.values():
            for i, bid in enumerate(t.blocks):
                tok = t.block_tokens(i, self.block_size)
                if tok > fill.get(bid, 0):
                    fill[bid] = tok
        return fill

    def physical_used_tokens(self) -> int:
        """Written tokens across live tables with shared blocks counted once."""
        return sum(self.block_fill().values())

    @property
    def free_blocks(self) -> Optional[int]:
        """Free blocks remaining; None when unbounded."""
        if self.num_blocks is None:
            return None
        return self.num_blocks - self.used_blocks

    def fragmentation(self) -> float:
        """Internal fragmentation: reserved-but-unused fraction of the live
        tables' physical blocks (shared pages counted once)."""
        fill = self.block_fill()
        cap = len(fill) * self.block_size
        if cap == 0:
            return 0.0
        return 1.0 - sum(fill.values()) / cap

    # ------------------------------------------------------------ allocation
    def _mint(self) -> int:
        if self._free:
            return self._free.pop()
        if self.num_blocks is not None:
            raise OutOfBlocks(f"all {self.num_blocks} blocks in use")
        bid = self._next_id
        self._next_id += 1
        return bid

    def table(self, rid: int) -> BlockTable:
        if rid not in self.tables:
            self.tables[rid] = BlockTable(rid)
        return self.tables[rid]

    def can_grow(self, rid: int, n_tokens: int) -> bool:
        if self.num_blocks is None:
            return True
        t = self.tables.get(rid) or BlockTable(rid)
        need = self.blocks_for(t.num_tokens + n_tokens) - t.num_blocks
        return need <= self.num_blocks - self.used_blocks

    def grow(self, rid: int, n_tokens: int) -> List[int]:
        """Extend rid's table to cover n_tokens more; returns new block ids.
        Transactional: on OutOfBlocks the table is left exactly as it was."""
        t = self.table(rid)
        t.num_tokens += n_tokens
        new: List[int] = []
        try:
            while t.num_blocks * self.block_size < t.num_tokens:
                bid = self._mint()
                t.blocks.append(bid)
                self.ref_count[bid] = 1
                new.append(bid)
        except OutOfBlocks:
            t.num_tokens -= n_tokens
            for bid in reversed(new):
                t.blocks.pop()
                del self.ref_count[bid]
                self._free.append(bid)
            if not t.blocks and t.num_tokens == 0:
                del self.tables[rid]
            raise
        self.allocated_blocks_total += len(new)
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)
        return new

    def fork(self, src_rid: int, dst_rid: int) -> BlockTable:
        """Share src's blocks with a new table (copy-on-write prefix sharing)."""
        if dst_rid in self.tables:
            raise ValueError(f"rid {dst_rid} already has a table")
        src = self.tables[src_rid]
        dst = BlockTable(dst_rid, blocks=list(src.blocks), num_tokens=src.num_tokens)
        for bid in dst.blocks:
            self.ref_count[bid] += 1
        self.tables[dst_rid] = dst
        return dst

    # -------------------------------------------------- external references
    # The radix prefix cache holds its own reference on each cached block so
    # cached prefixes survive their inserting request; a request admitted
    # with a cache hit *adopts* the matched block run as its table prefix.
    def incref(self, bid: int) -> None:
        """Add an external (non-table) reference to a live block."""
        rc = self.ref_count.get(bid)
        if rc is None:
            raise DoubleFree(f"block {bid} is not live; cannot reference it")
        self.ref_count[bid] = rc + 1

    def decref(self, bid: int) -> bool:
        """Drop an external reference; returns True when the block was the
        last reference and returned to the free list."""
        rc = self.ref_count.get(bid)
        if rc is None:
            raise DoubleFree(f"block {bid} already free")
        if rc == 1:
            del self.ref_count[bid]
            self._free.append(bid)
            self.freed_blocks_total += 1
            return True
        self.ref_count[bid] = rc - 1
        return False

    def adopt(self, rid: int, blocks: List[int], num_tokens: int) -> BlockTable:
        """Create rid's table from EXISTING block ids (a matched prefix-cache
        run): each block gains a reference; ``num_tokens`` must cover the
        blocks exactly (prefix sharing is full-block-aligned, so the adopted
        run carries no writable slack — the first suffix token mints a fresh
        private block and shared pages are never scribbled)."""
        if rid in self.tables:
            raise ValueError(f"rid {rid} already has a table")
        if num_tokens != len(blocks) * self.block_size:
            raise ValueError(
                f"adopted prefix must be full-block-aligned: {num_tokens} "
                f"tokens vs {len(blocks)} blocks of {self.block_size}")
        for bid in blocks:
            self.incref(bid)
        t = BlockTable(rid, blocks=list(blocks), num_tokens=num_tokens)
        self.tables[rid] = t
        return t

    # ------------------------------------------------------------- lifecycle
    def free(self, rid: int) -> int:
        """Release rid's table; returns blocks actually returned to the free
        list (shared blocks stay live until their last owner frees)."""
        return self._release(rid)[1]

    def detach(self, rid: int) -> DetachRecord:
        """Remove rid's table for swap-out. Private blocks (refcount 1)
        return to the free list — their contents round-trip through host
        DRAM. Shared blocks keep this table's reference and stay device
        resident (see ``DetachRecord``), so copy-on-write sharing and swap
        compose without duplicating pages."""
        t = self.tables.pop(rid, None)
        if t is None:
            raise DoubleFree(f"rid {rid} has no table (already freed?)")
        kept: List[bool] = []
        released = 0
        for bid in t.blocks:
            rc = self.ref_count.get(bid)
            if rc is None:
                raise DoubleFree(f"block {bid} already free")
            if rc > 1:
                kept.append(True)  # reference moves from table to record
            else:
                del self.ref_count[bid]
                self._free.append(bid)
                released += 1
                kept.append(False)
        self.freed_blocks_total += released
        return DetachRecord(table=t, kept=kept)

    def _release(self, rid: int):
        t = self.tables.pop(rid, None)
        if t is None:
            raise DoubleFree(f"rid {rid} has no table (already freed?)")
        released = 0
        for bid in t.blocks:
            rc = self.ref_count.get(bid)
            if rc is None:
                raise DoubleFree(f"block {bid} already free")
            if rc == 1:
                del self.ref_count[bid]
                self._free.append(bid)
                released += 1
            else:
                self.ref_count[bid] = rc - 1
        self.freed_blocks_total += released
        return t, released

    def attach(self, record: Union[DetachRecord, BlockTable]) -> BlockTable:
        """Re-admit a detached table (swap-in). Kept (shared) blocks reuse
        their ids verbatim — the record's reference transfers back to the
        table, no bytes move. Spilled blocks get freshly minted ids at the
        same positions; the engine scatters the host copies into exactly
        those. Block count round-trips exactly. Transactional: on
        OutOfBlocks nothing changes and the record stays parked (kept
        references included)."""
        if isinstance(record, BlockTable):  # legacy: a fully private table
            record = DetachRecord(table=record,
                                  kept=[False] * record.num_blocks)
        table = record.table
        if table.rid in self.tables:
            raise ValueError(f"rid {table.rid} already has a table")
        new_blocks: List[int] = []
        minted: List[int] = []
        try:
            for bid, kept in zip(table.blocks, record.kept):
                if kept:
                    new_blocks.append(bid)
                else:
                    nb = self._mint()
                    self.ref_count[nb] = 1
                    minted.append(nb)
                    new_blocks.append(nb)
        except OutOfBlocks:
            for nb in reversed(minted):
                del self.ref_count[nb]
                self._free.append(nb)
            raise
        fresh = BlockTable(table.rid, blocks=new_blocks,
                           num_tokens=table.num_tokens)
        self.tables[table.rid] = fresh
        self.allocated_blocks_total += len(minted)
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)
        return fresh

    def release_record(self, record: DetachRecord) -> int:
        """Discard a parked record without re-attaching (the swapped request
        was aborted/freed): drop the kept blocks' references."""
        released = 0
        for bid in record.kept_blocks:
            if self.decref(bid):
                released += 1
        record.kept = [False] * record.table.num_blocks
        return released
