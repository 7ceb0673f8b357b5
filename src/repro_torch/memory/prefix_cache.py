"""Radix prefix cache: token-id trie over full KV blocks in the page pool.

Shared prompt prefixes (system prompts, multi-turn context) re-submit the
same leading tokens again and again; without sharing, every request
re-prefills and re-stores its own KV copy of them. This module indexes
**full-block-aligned** prompt prefixes in a radix tree: each node covers one
allocator block (``block_size`` consecutive token ids, keyed under its
parent) and names the physical page already holding that block's KV.

The cache holds its OWN reference on every cached block (allocator
``incref``), so cached KV survives the inserting request. A later request
whose prompt walks the same path *adopts* the matched block run as its
table prefix (``BlockAllocator.adopt``) — zero prefill compute and zero HBM
fill traffic for the matched tokens. Matching resumes **mid-block**: after
the fully shared run, ``match_tokens`` also matches a token-level prefix of
the next cached block; the adopter gets a *fresh private* tail page plus a
recorded copy intent (``(rid, src, dst, n_tokens)``, drained via
``drain_prefix_copies``) that the engine executes as a device-side
page-prefix copy before any step writes. Shared pages are never written
after insertion — full blocks are shared by reference, and the partial tail
is copy-on-write into the private page.

Eviction: under ``OutOfBlocks`` pressure the memory manager reclaims
*unreferenced leaves* — nodes whose block has refcount 1 (only the cache's
own reference) and no children — lowest request priority first, then least
recently accessed (LRU). Interior nodes become evictable once their
children go; a block shared with a live table or a parked swap record is
never reclaimed (its refcount exceeds 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.memory.block_allocator import BlockAllocator


@dataclasses.dataclass
class PrefixCacheStats:
    inserted_blocks: int = 0
    evicted_blocks: int = 0
    matched_blocks: int = 0
    lookups: int = 0


class _Node:
    __slots__ = ("key", "block", "children", "parent", "priority", "last_access")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"], priority: int, last_access: int):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.priority = priority
        self.last_access = last_access


class PrefixCache:
    """Radix index over the allocator's pages; see module docstring."""

    def __init__(self, allocator: BlockAllocator,
                 max_blocks: Optional[int] = None):
        self.alloc = allocator
        self.max_blocks = max_blocks
        self.root = _Node(None, -1, None, 0, 0)
        self._nodes: List[_Node] = []  # every live non-root node
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------ inspection
    @property
    def cached_blocks(self) -> int:
        return len(self._nodes)

    def reclaimable_blocks(self) -> int:
        """Cached blocks held ONLY by the cache (refcount 1): evictable on
        demand, so admission headroom may count them as free-in-waiting."""
        return sum(1 for n in self._nodes
                   if self.alloc.ref_count.get(n.block, 0) == 1)

    def block_ids(self) -> List[int]:
        return [n.block for n in self._nodes]

    # ----------------------------------------------------------------- match
    def match(self, tokens: Sequence[int], step: int = 0,
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest cached full-block prefix of ``tokens`` (at most
        ``max_blocks`` deep): the physical block ids along the matching trie
        path. Only nodes the caller can actually adopt are LRU-touched —
        walking past the adoptable depth would mark never-used leaves hot
        and skew eviction."""
        bs = self.alloc.block_size
        self.stats.lookups += 1
        node = self.root
        blocks: List[int] = []
        depth = len(tokens) // bs
        if max_blocks is not None:
            depth = min(depth, max_blocks)
        for i in range(depth):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.last_access = step
            blocks.append(child.block)
            node = child
        self.stats.matched_blocks += len(blocks)
        return blocks

    def match_tokens(self, tokens: Sequence[int], step: int = 0,
                     max_tokens: Optional[int] = None,
                     ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix measured in TOKENS, not blocks: the
        full-block walk of :meth:`match` plus a **mid-block partial tail** —
        the longest common token-prefix between the remaining (< block)
        tokens and any child key at the stop node. Returns ``(blocks,
        partial)`` where ``partial`` is ``(block_id, n_tokens)`` or None.

        The partial block is NOT adoptable in place (its tail tokens differ
        or are unwritten for this prompt): the caller copies the page and
        owns the copy privately, so shared pages are still never scribbled.
        """
        bs = self.alloc.block_size
        self.stats.lookups += 1
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        node = self.root
        blocks: List[int] = []
        for i in range(limit // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.last_access = step
            blocks.append(child.block)
            node = child
        self.stats.matched_blocks += len(blocks)
        rem = tuple(tokens[len(blocks) * bs:limit])
        partial = None
        if rem:
            best, best_child = 0, None
            for key, child in node.children.items():
                p = 0
                for a, b in zip(key, rem):
                    if a != b:
                        break
                    p += 1
                if p > best:
                    best, best_child = p, child
            if best_child is not None:
                best_child.last_access = step
                partial = (best_child.block, best)
        return blocks, partial

    def probe_tokens(self, tokens: Sequence[int],
                     max_tokens: Optional[int] = None) -> int:
        """Read-only :meth:`match_tokens`: cached tokens (full blocks + a
        mid-block partial tail) a future admission would adopt, without
        touching LRU timestamps or stats."""
        bs = self.alloc.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        node = self.root
        matched = 0
        for i in range(limit // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            matched += bs
            node = child
        rem = tuple(tokens[matched:limit])
        if rem:
            best = 0
            for key in node.children:
                p = 0
                for a, b in zip(key, rem):
                    if a != b:
                        break
                    p += 1
                best = max(best, p)
            matched += best
        return matched

    def probe(self, tokens: Sequence[int],
              max_blocks: Optional[int] = None) -> int:
        """Read-only ``match``: how many full blocks of ``tokens`` the trie
        currently covers, WITHOUT touching LRU timestamps or stats.  The
        prefetch planner uses this to issue adopt intents one step ahead of
        the admitting step — a probe must not mark nodes hot, or predicted
        (possibly never-admitted) prompts would skew eviction."""
        bs = self.alloc.block_size
        node = self.root
        depth = len(tokens) // bs
        if max_blocks is not None:
            depth = min(depth, max_blocks)
        matched = 0
        for i in range(depth):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            matched += 1
            node = child
        return matched

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               step: int = 0, priority: int = 0) -> int:
        """Index a completed prefix: ``blocks[i]`` must already hold the KV
        of ``tokens[i*bs:(i+1)*bs]`` (the inserting request's table prefix).
        Existing nodes are kept (the request retains its private duplicate;
        future requests share the cached copy); new full blocks are adopted
        with a cache-owned reference. Returns newly cached blocks."""
        bs = self.alloc.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        node = self.root
        new = 0
        for i in range(n_full):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                if (self.max_blocks is not None
                        and self.cached_blocks >= self.max_blocks
                        and self.evict(1) == 0):
                    break  # cache full of referenced blocks; stop indexing
                self.alloc.incref(blocks[i])
                child = _Node(key, blocks[i], node, priority, step)
                node.children[key] = child
                self._nodes.append(child)
                new += 1
            child.last_access = step
            child.priority = max(child.priority, priority)
            node = child
        self.stats.inserted_blocks += new
        return new

    # ----------------------------------------------------------------- evict
    def _evictable(self) -> List[_Node]:
        rc = self.alloc.ref_count
        return [n for n in self._nodes
                if not n.children and rc.get(n.block, 0) == 1]

    def evict(self, need_blocks: int) -> int:
        """Reclaim up to ``need_blocks`` unreferenced leaves (lowest priority
        first, then LRU), cascading to parents as they become leaves.
        Returns blocks actually returned to the allocator's free list."""
        freed = 0
        while freed < need_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.priority, n.last_access,
                                                n.block))
            self._drop(victim)
            freed += 1
        self.stats.evicted_blocks += freed
        return freed

    def _drop(self, node: _Node) -> None:
        node.parent.children.pop(node.key, None)
        self._nodes.remove(node)
        self.alloc.decref(node.block)

    def clear(self) -> int:
        """Drop every cache reference (leaves first); returns blocks freed."""
        freed = 0
        for node in sorted(self._nodes, key=lambda n: -self._depth(n)):
            node.parent.children.pop(node.key, None)
            if self.alloc.decref(node.block):
                freed += 1
        self._nodes.clear()
        self.stats.evicted_blocks += freed
        return freed

    @staticmethod
    def _depth(node: _Node) -> int:
        d = 0
        while node.parent is not None:
            node = node.parent
            d += 1
        return d
