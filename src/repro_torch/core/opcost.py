"""The one cost helper the scheduler prices attention reads with.

A copy of ``kv_tokens_touched`` from the JAX package's ``sim/opcost.py``;
the rest of that module (the analytical simulator) is not part of the port.
"""
from __future__ import annotations

from typing import Sequence


def kv_tokens_touched(ctx_lens: Sequence[int], block_size: int = 1) -> int:
    """KV tokens the ragged paged decode attention actually reads: each
    context rounds up to whole KV blocks (the kernel skips blocks past a
    row's length, so cost scales with real tokens — never with the padded
    cache extent). ``block_size=1`` is exact per-token pricing."""
    bs = max(block_size, 1)
    return sum(bs * -(-int(c) // bs) for c in ctx_lens)
