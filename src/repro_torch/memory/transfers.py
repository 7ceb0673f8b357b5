"""Transfer engine: tier placement deltas -> per-step DMA plans, priced
against residual bandwidth during the compute-bound packed phase.

This implements the paper's temporal condition (2) at service level: the
BEOL buffer only helps if residual HBM bandwidth during the packed
compute-bound phase actually suffices to fill it. The stage cost model
reports each step's latency and own HBM traffic; everything left over is
slack the DMA plan competes for:

    slack_time   = max(0, stage_time - stage_hbm_bytes / hbm_stream_bw)
    earned_fill  = min(fill_bytes, slack_time * hbm_stream_bw)

Prefetch fills beyond ``earned_fill`` simply do not land — coverage is
*earned*, not assumed. Host transfers (swap-out spills / swap-in restores)
ride the host DMA link (``Hardware.host_bw``): they overlap compute up to
the slack left after fills, and any remainder stalls the step:

    swap_time  = swap_bytes / min(host_bw, hbm_stream_bw)
    stall      = max(0, swap_time - (slack_time - earned_fill_time))
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.memory.tiers import BEOL, HBM, HOST

FILL, SWAP_OUT, SWAP_IN = "prefetch_fill", "swap_out", "swap_in"


@dataclasses.dataclass(frozen=True)
class Transfer:
    src: str
    dst: str
    nbytes: float
    kind: str  # FILL | SWAP_OUT | SWAP_IN


@dataclasses.dataclass
class DMAPlan:
    transfers: List[Transfer] = dataclasses.field(default_factory=list)

    def add(self, src: str, dst: str, nbytes: float, kind: str):
        if nbytes > 0:
            self.transfers.append(Transfer(src, dst, float(nbytes), kind))

    def bytes_of(self, kind: str) -> float:
        return sum(t.nbytes for t in self.transfers if t.kind == kind)

    @property
    def fill_bytes(self) -> float:
        return self.bytes_of(FILL)

    @property
    def swap_bytes(self) -> float:
        return self.bytes_of(SWAP_OUT) + self.bytes_of(SWAP_IN)


@dataclasses.dataclass(frozen=True)
class DMAReport:
    """What actually moved: earned fill + swap stall accounting."""

    earned_fill_bytes: float  # HBM->BEOL bytes that fit in the slack
    fill_shortfall_bytes: float  # planned fills that did NOT land
    swap_bytes: float  # host-link traffic (out + in)
    hidden_time: float  # DMA time overlapped with compute
    stall_time: float  # added to the step latency


class TransferEngine:
    """Prices DMA plans against a Hardware's bandwidth budget."""

    def __init__(self, hw):
        self.hw = hw
        self.hbm_stream_bw = hw.hbm_bw * hw.bw_efficiency
        self.host_bw = min(getattr(hw, "host_bw", 64e9), self.hbm_stream_bw)

    def build(self, fill_bytes: float, swap_out_bytes: float = 0.0,
              swap_in_bytes: float = 0.0) -> DMAPlan:
        plan = DMAPlan()
        plan.add(HBM, BEOL, fill_bytes, FILL)
        plan.add(HBM, HOST, swap_out_bytes, SWAP_OUT)
        plan.add(HOST, HBM, swap_in_bytes, SWAP_IN)
        return plan

    def price(self, dma: DMAPlan, stage_time: float,
              stage_hbm_bytes: float, host_bw_scale: float = 1.0) -> DMAReport:
        """``host_bw_scale`` < 1 models a transient host-link bandwidth
        collapse (robustness fault windows): swap traffic takes
        proportionally longer while HBM streaming is unaffected."""
        slack_time = max(0.0, stage_time - stage_hbm_bytes / self.hbm_stream_bw)
        fill = dma.fill_bytes
        earned = min(fill, slack_time * self.hbm_stream_bw)
        fill_time = earned / self.hbm_stream_bw if earned else 0.0
        swap = dma.swap_bytes
        host_bw = self.host_bw * max(1e-9, host_bw_scale)
        swap_time = swap / host_bw if swap else 0.0
        swap_hidden = min(swap_time, max(0.0, slack_time - fill_time))
        return DMAReport(
            earned_fill_bytes=earned,
            fill_shortfall_bytes=fill - earned,
            swap_bytes=swap,
            hidden_time=fill_time + swap_hidden,
            stall_time=swap_time - swap_hidden,
        )
