"""Tiered KV-cache memory subsystem: paged block allocator, radix prefix
cache (copy-on-write prompt sharing), BEOL/HBM/host tier model, the
transfer engine that prices placement deltas as DMA, and the async
prefetch ledger (issued/in-flight/landed state machine) that makes
one-step-ahead KV movement safe to overlap with compute."""
from repro_torch.memory.block_allocator import (
    BlockAllocator,
    BlockTable,
    DetachRecord,
    DoubleFree,
    OutOfBlocks,
    prefix_fill_bytes_saved,
)
from repro_torch.memory.manager import KVMemoryManager, SwapRecord, hbm_kv_pool_blocks
from repro_torch.memory.prefetch_queue import (
    ConsumeReceipt,
    PrefetchQueue,
    PrefetchQueueStats,
    PrefetchTransfer,
)
from repro_torch.memory.prefix_cache import PrefixCache, PrefixCacheStats
from repro_torch.memory.tiers import BEOL, HBM, HOST, Placement, TierManager
from repro_torch.memory.transfers import DMAPlan, DMAReport, Transfer, TransferEngine

__all__ = [
    "BEOL",
    "HBM",
    "HOST",
    "BlockAllocator",
    "BlockTable",
    "ConsumeReceipt",
    "DMAPlan",
    "DMAReport",
    "DetachRecord",
    "DoubleFree",
    "KVMemoryManager",
    "OutOfBlocks",
    "Placement",
    "PrefetchQueue",
    "PrefetchQueueStats",
    "PrefetchTransfer",
    "PrefixCache",
    "PrefixCacheStats",
    "SwapRecord",
    "TierManager",
    "Transfer",
    "TransferEngine",
    "hbm_kv_pool_blocks",
    "prefix_fill_bytes_saved",
]
