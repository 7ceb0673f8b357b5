"""Continuous-batching serving engine driven by the packing-prefetch scheduler.

The PyTorch counterpart of the JAX package's ``serving/engine.py``: decode
tokens and prefill chunks share every linear and FFN matmul in one
``packed_step``. Two KV layouts, as in JAX (``attn_kernel``):

  * ``"paged"``: a physically paged pool of ``num_kv_blocks + 1`` pages per
    layer (the extra page is the scratch page dead table entries and padding
    rows point at); ``block_mirror`` carries the allocator's real page ids,
    re-synced every step, so pages are relocatable and the pool may be
    over-subscribed. Attention is one mixed-batch call (B1) per layer.
  * ``"dense"``: the fallback, a ``(n_slots + 1, max_len)`` slot cache per
    layer (``Model.init_cache``); attention is one one-query-per-row call
    (B2) per layer. ``"auto"`` picks it when ``max_len`` is not a multiple of
    the page size.

Each step the engine builds ALL of the step's metadata on the host — tokens,
slots, positions, block tables, the segment layout, the kernel's q-tile list
and the rows to sample — and copies it to the device in one transfer that
every layer reuses. The step packs exactly its real rows: the JAX engine pads
them to ``max_decode_batch + chunk_size`` so its jitted step keeps one shape,
which an eager step does not need, and padding rows would cost a decode-only
step the matmuls of a full chunk. Segments and table columns keep the JAX
engine's pow2 padding; zero-width segments and unused columns cost nothing.

Archs that cannot pack (Mamba2 here; JAX also Mamba1 hybrids and
enc-dec) run JAX's two-call path instead (``_run_two_call``): one
``Model.decode_step`` over the step's decode slots, then one
``Model.prefill`` per packed prefill segment, each over its slot's state in
``model.init_cache(n_slots + 1, max_len)``. They have no page pool and no
block mirror.

Swap preemption parks a victim's KV in host memory (``swap_store``): in paged
mode only the record's spilled (private) pages, which a swap-in scatters into
the fresh pages ``attach()`` mints at the same table positions; in dense mode
the slot's cache rows; on the two-call path the slot's ``{conv, ssm}``
states. A swap moves exactly those pages or rows, with no padding, packed
into one flat buffer: one device gather, then one copy to pinned host memory
on the compute stream, ordered by an event. The pinned buffers are reused
(``HostPool``). The prefix cache's mid-block resumes copy a cached page into
a fresh private one (``_apply_prefix_copies``), every source gathered before
any destination is written. A step's swap-outs are gathered before its
prefix copies, since a copy's destination may be a page a victim just gave
up; JAX runs the copies first (ROADMAP.md §C).

Asynchronous prefetch (``SchedulerConfig.async_prefetch``): the scheduler
issues next-step transfer intents (swap-in restores, prefix re-adoptions)
through the in-flight/landed ledger while this step runs. The engine
realizes a restore by *staging*: its host copy goes to the device on the
engine's own copy stream, enqueued after this step's kernels and before the
host waits on the step's tokens, so the copy rides under the compute. The
consuming step's ``_apply_swaps`` makes the compute stream wait on the staged
copy's event and scatters from it device to device; an unpredicted restore
copies from the host on the compute stream. ``_verify_landed`` refuses a
step that would read pages whose transfer has not landed. Staged and direct
restores scatter the same bytes, so greedy outputs are token-identical with
async prefetch on or off. On the CPU the same code runs without streams,
events or pinning, chosen by the engine's ``device``.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the archs ``Model`` does not build (Mamba1, enc-dec).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packed_step import DenseView, PagedView, packed_step, supports_packed
from repro_torch.core.scheduler import Scheduler, SchedulerConfig, StepPlan
from repro_torch.kernels.paged_attention import q_tiles, row_tiles
from repro_torch.memory.prefetch_queue import ADOPT, SWAP_IN
from repro_torch.models.model import Model
from repro_torch.obs.attribution import PREFETCH_STAGE as ATTR_PREFETCH_STAGE
from repro_torch.obs.attribution import SWAP_IN as ATTR_SWAP_IN
from repro_torch.obs.attribution import SWAP_OUT as ATTR_SWAP_OUT
from repro_torch.obs.trace import (
    LANE_COMPUTE,
    LANE_HOST_LINK,
    LANE_PREFETCH_STAGE,
    LANE_SCHED,
    LANE_STEP,
    NOOP,
)
from repro_torch.serving.request import Request

ATTN_KERNELS = ("auto", "paged", "dense")
_ALIGN = 16  # byte alignment of each leaf inside a swap buffer
_HOST_ROUND = 2 << 20  # pinned buffers are sized in 2 MiB steps, so they fit again


def _pow2_at_least(n: int, start: int = 8) -> int:
    m = start
    while m < n:
        m *= 2
    return m


class HostPool:
    """Host buffers for swapped KV, kept and reused: pinning memory costs far
    more than a copy into it (on an H100's host, pinning ran at about 2.8
    GB/s against 54 GB/s for the copy), so a buffer goes back to the free
    list when its restore is done and the next swap-out takes the smallest
    free one that fits. Each engine has its own pool. A buffer comes back
    with the events of the copies that last read it; the stream that writes
    it next waits on them (on the CPU there are none)."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._free: List[Tuple[torch.Tensor, list]] = []
        self.pinned = 0  # buffers allocated
        self.pinned_bytes = 0
        self.reused = 0

    def take(self, nbytes: int) -> torch.Tensor:
        fits = [i for i, (buf, _) in enumerate(self._free) if buf.numel() >= nbytes]
        if fits:
            i = min(fits, key=lambda j: self._free[j][0].numel())
            buf, events = self._free.pop(i)
            for ev in events:
                torch.cuda.current_stream().wait_event(ev)
            self.reused += 1
            return buf
        size = -(-nbytes // _HOST_ROUND) * _HOST_ROUND
        self.pinned += 1
        self.pinned_bytes += size
        return torch.empty(size, dtype=torch.uint8, pin_memory=self.pin)

    def give(self, buf: torch.Tensor, events: list) -> None:
        self._free.append((buf, list(events)))


class Engine:
    def __init__(
        self,
        model: Model,
        params,
        sched_cfg: SchedulerConfig,
        max_len: int,
        cache_dtype: Optional[torch.dtype] = None,  # None: the model's dtype
        eos_id: Optional[int] = None,
        attn_kernel: str = "auto",
        tracer=None,  # a repro_torch.obs TraceRecorder (wall clock)
        device="cuda",
    ):
        if attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"unknown attn_kernel {attn_kernel!r}; want one of {ATTN_KERNELS}")
        self.device = torch.device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.cuda = self.device.type == "cuda"
        # SSM archs cannot share a step's matmuls across rows of different
        # requests' recurrent states: they run the two-call path
        self.two_call = not supports_packed(model.cfg)
        self.page_size = sched_cfg.kv_block_size
        if attn_kernel == "auto":
            attn_kernel = ("paged" if not self.two_call and max_len % self.page_size == 0
                           else "dense")
        if attn_kernel == "paged" and (self.two_call or max_len % self.page_size):
            raise ValueError(
                "attn_kernel='paged' needs packed mode and max_len divisible by "
                f"kv_block_size (max_len={max_len}, block={self.page_size})")
        if sched_cfg.enable_prefix_cache and attn_kernel != "paged":
            # dense slot caches and two-call states have no shared pages a
            # forked block table could point at
            raise ValueError(
                "enable_prefix_cache requires the physically paged engine path "
                "(attn_kernel='paged'); dense/two-call KV has no copy-on-write pages to share")
        self.attn_kernel = attn_kernel
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_len = max_len
        self.eos_id = eos_id
        self.n_slots = sched_cfg.max_decode_batch
        self.steps_run = 0
        self.prefetch_log: List[float] = []
        # swap preemption's host tier: rid -> {"idx": spilled table positions
        # (paged; None otherwise), "kv": the flat host buffer (None when
        # every page stayed resident), "buf": the pooled buffer it views,
        # "events": the copies that touched it}
        self.swap_store: Dict[int, dict] = {}
        # async prefetch: rid -> {"kv": the staged device copy of a
        # predicted restore, "event": its copy's end}, made by
        # _issue_prefetch on the copy stream, consumed by _apply_swaps
        self._staged: Dict[int, dict] = {}
        self.host_pool = HostPool(pin=self.cuda)
        self._copy_stream = None  # made at the first staged copy
        # bytes each direction actually moved (the ledger's counts are the
        # scheduler's; these are the copies')
        self.swap_bytes_moved = {"d2h": 0, "h2d": 0}
        # None, or a list the engine appends a record to for every swap
        # copy and every step's kernel window, with CUDA events (card only)
        self.copy_log: Optional[list] = None

        if attn_kernel == "paged":
            self._group = self.cfg.n_heads // self.cfg.n_kv_heads
            # physically paged KV: num_kv_blocks relocatable pages (default:
            # the dense layout's capacity) + 1 scratch page. Backing the
            # allocator with the same bound makes OutOfBlocks a real
            # admission signal.
            pps = self.pages_per_slot = max_len // self.page_size
            pool_pages = sched_cfg.num_kv_blocks
            if pool_pages is None:
                pool_pages = self.n_slots * pps
                sched_cfg = dataclasses.replace(sched_cfg, num_kv_blocks=pool_pages)
            if pool_pages < pps:
                raise ValueError(
                    f"num_kv_blocks={pool_pages} cannot hold one max_len "
                    f"context ({pps} pages of {self.page_size} tokens)")
            self.num_pool_pages = pool_pages
            self._scratch_page = pool_pages  # the extra page past the pool
            self.cache = model.init_page_pool(pool_pages, self.page_size, cache_dtype)
            # host mirror of the allocator's block tables: one row per slot
            # holding real physical page ids, plus the scratch slot's row
            # that padding segments own; dead entries -> scratch
            self.block_mirror = np.full((self.n_slots + 1, pps), self._scratch_page, np.int32)
        else:
            # dense slot storage (KV caches, or two-call SSM states), + 1
            # scratch row as in JAX (the port computes only real rows, so
            # nothing writes it)
            self.cache = model.init_cache(self.n_slots + 1, max_len, cache_dtype)

        self.sched_cfg = sched_cfg
        self.trace = tracer if tracer is not None else NOOP
        self.scheduler = Scheduler(sched_cfg, model.cfg, tracer=self.trace)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self.scheduler.add_request(req)

    def run(self, max_steps: int = 10_000) -> None:
        while self.scheduler.has_work and self.steps_run < max_steps:
            if self.step(now=float(self.steps_run)) is None:
                break

    def shutdown(self, reason: str = "shutdown") -> int:
        """Cancel every non-terminal request, purge their host-tier and
        staged state, and cancel outstanding ledger intents, so a flushed
        trace is fully terminal. Returns the number cancelled."""
        n = self.scheduler.cancel_all(reason, now=float(self.steps_run))
        self._purge_released()
        self.scheduler.prefetch_queue.cancel_outstanding(reason)
        return n

    def _purge_released(self) -> None:
        """Drop the host copies and staged device copies of requests the
        scheduler released (cancellations, swap->recompute fallbacks). A
        staged copy still in flight keeps its memory: it was allocated on the
        copy stream, which reuses it only after the copy."""
        for rid, _reason in self.scheduler.drain_released():
            self._release_host(self.swap_store.pop(rid, None))
            self._staged.pop(rid, None)

    def register_metrics(self, reg) -> None:
        """Engine-side gauges for the typed metrics registry: step count,
        host-tier occupancy and (paged) pool capacity / peak pressure."""
        reg.counter("engine_steps", "steps", "engine steps executed").inc(self.steps_run)
        reg.gauge("engine_swap_store_entries", "requests",
                  "host-tier KV copies currently held").set(float(len(self.swap_store)))
        if self.attn_kernel == "paged":
            reg.gauge("kv_pool_pages", "pages",
                      "physical pages in the paged KV pool").set(float(self.num_pool_pages))
            reg.gauge("kv_pool_peak_used", "pages",
                      "peak pages simultaneously allocated").set(
                          float(self.scheduler.mem.allocator.peak_used_blocks))
        if self.scheduler.injector.enabled:
            self.scheduler.injector.register_metrics(reg)
        self.scheduler.ledger.register_metrics(reg)

    def attribution_aggregates(self) -> Dict[str, float]:
        """The engine's byte counters, keyed by the ``obs.attribution``
        AGG_RULES names the conservation checker maps onto ledger causes."""
        sched = self.scheduler
        mem = sched.mem
        return {
            "attn_read_bytes": float(sched.stats.attn_tokens_touched * mem.kv_bytes_per_token),
            "prefix_saved_bytes": float(sched.stats.prefix_fill_bytes_saved),
            "swap_out_bytes": float(mem.swap_out_bytes_total),
            "swap_in_bytes": float(mem.swap_in_bytes_total),
            "swapped_bytes": float(mem.swap_out_bytes_total + mem.swap_in_bytes_total),
            "retry_refetch_bytes": float(sched.prefetch_queue.stats.bytes_refetched),
        }

    # ----------------------------------------------------------------- steps
    def step(self, now: float = 0.0) -> Optional[StepPlan]:
        """One step, in the JAX engine's order (plan, page moves, the landed
        check, compute, staging of the next step's restores,
        ``complete_step``, the step's attribution instant) but for the page
        moves: JAX copies prefix pages before the swaps, the port gathers
        the swap-outs first (``_apply_swaps``). The staging is enqueued after
        the compute's kernels and before the host waits on the step's
        tokens."""
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        plan = self.scheduler.next_step(now)
        self._purge_released()  # even a None plan may have cancelled requests
        if plan is None:
            return None
        if plan.prefetch is not None:
            self.prefetch_log.append(plan.prefetch.coverage)
        t1 = tr.now() if tr.enabled else 0.0
        self._refuse_round_trips(plan)
        self._apply_swaps(plan)  # swap-outs, prefix copies, swap-ins
        self._verify_landed(plan)
        t2 = tr.now() if tr.enabled else 0.0
        window = self._mark(plan.step, "kernels")
        pending = self._run_two_call(plan) if self.two_call else self._run_packed(plan)
        self._mark_end(window)
        t3 = tr.now() if tr.enabled else 0.0
        self._issue_prefetch(plan)
        self._take_tokens(pending)
        t4 = tr.now() if tr.enabled else 0.0
        self.scheduler.complete_step(plan, now)
        self.scheduler.ledger.record_step(tr, plan.step)
        if tr.enabled:
            t5 = tr.now()
            step = self.steps_run
            tr.span(LANE_STEP, f"step {step}", t0, t5 - t0, step=step,
                    tokens=plan.total_tokens, decodes=len(plan.decode_rids),
                    prefill_tokens=plan.total_prefill_tokens)
            tr.span(LANE_SCHED, "next_step", t0, t1 - t0, step=step)
            if plan.swapped_out or plan.swapped_in:
                tr.span(LANE_HOST_LINK, "apply_swaps", t1, t2 - t1, step=step,
                        swap_out=len(plan.swapped_out), swap_in=len(plan.swapped_in))
            tr.span(LANE_COMPUTE, "compute", t2, t4 - t2, step=step, tokens=plan.total_tokens)
            tr.span(LANE_PREFETCH_STAGE, "stage+complete", t3, t5 - t3, step=step,
                    issued=len(plan.issued))
        self.steps_run += 1
        return plan

    def _sample_rows(self, logits_rows: torch.Tensor) -> np.ndarray:
        """(rows, vocab) logits on the device -> (rows,) token ids on the
        host. The engine's single sampling hook: greedy (first maximum on a
        tie, as ``np.argmax``); override for other decoders."""
        return torch.argmax(logits_rows, dim=-1).cpu().numpy()

    def _take_tokens(self, pending) -> None:
        """Sample each (requests, logits rows) pair the compute left and
        append the tokens: the host's only wait on the step's compute."""
        for reqs, logits in pending:
            for req, tok in zip(reqs, self._sample_rows(logits)):
                self._append(req, int(tok))

    def _append(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            req.finished = True  # complete_step checks the flag explicitly

    # ------------------------------------------------------- copy timing
    def _mark(self, step: int, kind: str, **info) -> Optional[dict]:
        """With ``copy_log`` on (card only), a record whose start event is
        recorded now on the current stream; ``_mark_end`` records its end."""
        if self.copy_log is None or not self.cuda:
            return None
        rec = dict(step=step, kind=kind, start=torch.cuda.Event(enable_timing=True),
                   end=torch.cuda.Event(enable_timing=True), **info)
        rec["start"].record()
        self.copy_log.append(rec)
        return rec

    @staticmethod
    def _mark_end(rec: Optional[dict]) -> None:
        if rec is not None:
            rec["end"].record()

    # ----------------------------------------------------------------- swaps
    def block_spans(self, rid: int) -> List[Tuple[int, int, int]]:
        """A request's block table on its logical token axis: [(block_id,
        start_token, n_tokens)], which pool page holds which span."""
        mem = self.scheduler.mem
        table = mem.allocator.tables.get(rid)
        if table is None:
            return []
        bs = mem.block_size
        return [(bid, i * bs, min(bs, table.num_tokens - i * bs))
                for i, bid in enumerate(table.blocks)]

    def _refuse_round_trips(self, plan: StepPlan) -> None:
        """A plan that swaps a request out and back in within one step has
        no host copy to restore from when the swaps run (the memory
        manager's record is gone): refuse it before any device write."""
        both = sorted({r for r, _ in plan.swapped_out} & {r for r, _ in plan.swapped_in})
        if both:
            raise RuntimeError(
                f"step {plan.step}: request {both[0]} is swapped out and back in within one "
                f"plan (swapped_out={plan.swapped_out}, swapped_in={plan.swapped_in}); its "
                "pages were never gathered. A reference-side scheduler fault: ROADMAP.md §C")

    def _apply_prefix_copies(self, plan: StepPlan) -> None:
        """The plan's mid-block prefix resumes: each ``(rid, src_block,
        dst_block, n_tokens)`` copies a cached page whose first ``n_tokens``
        match the admitted prompt into the fresh private page the admission
        minted. Whole pages move (positions past ``n_tokens`` stay masked
        until the request's prefill writes them); the shared source is never
        written. Each layer's sources are gathered before any destination of
        that layer is written; ``_apply_swaps`` runs it after the swap-outs,
        whose pages a destination may reuse."""
        if self.attn_kernel != "paged" or not plan.prefix_copies:
            return
        ids = torch.tensor([[s for _, s, _, _ in plan.prefix_copies],
                            [d for _, _, d, _ in plan.prefix_copies]],
                           dtype=torch.long).to(self.device)
        src, dst = ids[0], ids[1]
        for layer in self.cache:
            for v in layer.values():
                v.index_copy_(0, dst, v.index_select(0, src))

    def _units(self, slot: int, table_ids: Optional[List[int]]):
        """What one swap moves, leaf by leaf: (leaf tensor, index
        of its units, number of units, unit shape). Paged: the pages
        ``table_ids`` of every layer's K and V pool. Dense and two-call: the
        slot's row of every cache leaf (K/V, or conv/ssm states)."""
        out = []
        if table_ids is not None:
            index = torch.tensor(table_ids, dtype=torch.long).to(self.device)
            n = len(table_ids)
        else:
            index, n = slot, 1
        for layer in self.cache:
            for v in layer.values():
                out.append((v, index, n, tuple(v.shape[1:])))
        return out

    @staticmethod
    def _layout(units) -> Tuple[List[Tuple[int, int]], int]:
        """Byte offsets and sizes of each leaf inside one flat swap buffer."""
        spans, off = [], 0
        for v, _, n, shape in units:
            size = n * int(np.prod(shape)) * v.element_size()
            spans.append((off, size))
            off += -(-size // _ALIGN) * _ALIGN
        return spans, off

    @staticmethod
    def _views(flat: torch.Tensor, units, spans):
        return [flat[o:o + s].view(v.dtype).view((n,) + shape)
                for (v, _, n, shape), (o, s) in zip(units, spans)]

    def _swap_out(self, plan: StepPlan, rid: int, slot: int) -> None:
        """Gather ``rid``'s spilled pages (paged) or slot rows into one flat
        device buffer, then copy it to a pooled host buffer: on the card a
        pinned one, the copy non-blocking on the compute stream, its end an
        event that a later copy from the host waits on."""
        idx = None
        table_ids = None
        if self.attn_kernel == "paged":
            rec = self.scheduler.mem.swapped[rid].record
            idx = rec.spilled_indices
            if not idx:  # every page shared: nothing crosses the link
                self.swap_store[rid] = {"idx": idx, "kv": None, "buf": None, "events": []}
                return
            table_ids = [rec.table.blocks[i] for i in idx]
        units = self._units(slot, table_ids)
        spans, total = self._layout(units)
        stage = torch.empty(total, dtype=torch.uint8, device=self.device)
        for (v, index, _, _), view in zip(units, self._views(stage, units, spans)):
            if table_ids is not None:
                torch.index_select(v, 0, index, out=view)
            else:
                view.copy_(v[index:index + 1])
        buf = self.host_pool.take(total)
        host = buf[:total]
        timing = self._mark(plan.step, "d2h", rid=rid, nbytes=total)
        host.copy_(stage, non_blocking=self.cuda)
        self._mark_end(timing)
        events = []
        if self.cuda:
            events.append(torch.cuda.Event())
            events[0].record()
        self.swap_bytes_moved["d2h"] += total
        self.swap_store[rid] = {"idx": idx, "kv": host, "buf": buf, "events": events}

    def _swap_in(self, plan: StepPlan, rid: int, slot: int) -> None:
        """Scatter ``rid``'s host copy into the fresh pages ``attach()``
        minted at the spilled table positions (paged), or into its new slot's
        rows. From the staged device copy when async prefetch landed one
        (the compute stream waits on its event), else from the host on the
        compute stream."""
        entry = self.swap_store.pop(rid)
        staged = self._staged.pop(rid, None)
        if entry["kv"] is None:
            return  # every page stayed resident; the table reuses them
        table_ids = None
        if self.attn_kernel == "paged":
            blocks = self.scheduler.mem.allocator.tables[rid].blocks
            table_ids = [blocks[i] for i in entry["idx"]]
        units = self._units(slot, table_ids)
        spans, total = self._layout(units)
        host = entry["kv"]
        if staged is not None:
            dev = staged["kv"]
            if self.cuda:
                torch.cuda.current_stream().wait_event(staged["event"])
                dev.record_stream(torch.cuda.current_stream())
        else:
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            timing = self._mark(plan.step, "h2d_direct", rid=rid, nbytes=total)
            dev.copy_(host, non_blocking=self.cuda)
            self._mark_end(timing)
            self.swap_bytes_moved["h2d"] += total
            if self.cuda:
                entry["events"].append(torch.cuda.Event())
                entry["events"][-1].record()
        for (v, index, _, _), view in zip(units, self._views(dev, units, spans)):
            if table_ids is not None:
                v.index_copy_(0, index, view)
            else:
                v[index:index + 1].copy_(view)
        self._release_host(entry)

    def _release_host(self, entry: Optional[dict]) -> None:
        if entry is not None and entry["buf"] is not None:
            self.host_pool.give(entry["buf"], entry["events"])

    def _apply_swaps(self, plan: StepPlan) -> None:
        """The plan's page moves, before the compute: swap-outs, then the
        prefix copies, then swap-ins. The swap-outs are gathered before any
        pool page is written: planning frees a victim's pages before
        admission mints a prefix copy's destination, so that destination can
        be a page the victim held (JAX copies first, and its swap-out then
        saves the copied page: ROADMAP.md §C). Prefix copies come before the
        swap-ins, whose pages are fresh too. The host-link bytes are debited
        first, from the memory manager's own records, as JAX does. ``step``
        has refused a plan that swaps one request both ways."""
        mem = self.scheduler.mem
        led = self.scheduler.ledger
        for rid, _slot in plan.swapped_out:
            led.debit(plan.step, ATTR_SWAP_OUT, mem.swap_host_bytes(rid))
        for rid, _slot in plan.swapped_in:
            led.debit(plan.step, ATTR_SWAP_IN, mem.restored_host_bytes(rid))
        for rid, slot in plan.swapped_out:
            self._swap_out(plan, rid, slot)
        self._apply_prefix_copies(plan)
        for rid, slot in plan.swapped_in:
            self._swap_in(plan, rid, slot)

    # ------------------------------------------------------------- prefetch
    def _issue_prefetch(self, plan: StepPlan) -> None:
        """Realize the ledger transfers this plan issued (or retried) for
        the next step. SWAP_IN: the restore's host copy is put on the device
        on the engine's copy stream, after the swap-out's copy (its event)
        and into memory of that stream's own pool, so a staged copy that a
        failed attempt drops cannot be reused while it is in flight. ADOPT:
        the matched pages are already resident; the intent lands at once.

        Under fault injection ``attempt_land`` arbitrates: an attempt that
        does not land drops its staged copy, and the retry clock re-surfaces
        the transfer in a later plan's ``retried`` list, where this loop
        stages it again from the intact host copy."""
        q = self.scheduler.prefetch_queue
        for t in list(plan.issued) + list(plan.retried):
            if t.kind == SWAP_IN:
                entry = self.swap_store.get(t.rid)
                if entry is None:
                    continue  # the intent outlived the host copy
                if not q.attempt_land(t, plan.step):
                    self._staged.pop(t.rid, None)
                    continue
                if t.rid in self._staged:
                    continue  # a re-land over an intact staged copy moves nothing
                if entry["kv"] is None:
                    continue  # every page shared: nothing to move
                self._staged[t.rid] = self._stage(plan, t.rid, entry)
                self.scheduler.ledger.debit(plan.step, ATTR_PREFETCH_STAGE, t.nbytes)
            elif t.kind == ADOPT:
                q.attempt_land(t, plan.step)

    def _stage(self, plan: StepPlan, rid: int, entry: dict) -> dict:
        host = entry["kv"]
        self.swap_bytes_moved["h2d"] += host.numel()
        if not self.cuda:
            return {"kv": host.clone(), "event": None}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        s = self._copy_stream
        for ev in entry["events"][:1]:  # the swap-out's copy to the host
            s.wait_event(ev)
        with torch.cuda.stream(s):
            dev = torch.empty(host.numel(), dtype=torch.uint8, device=self.device)
            timing = self._mark(plan.step, "h2d_staged", rid=rid, nbytes=host.numel())
            dev.copy_(host, non_blocking=True)
            self._mark_end(timing)
            done = torch.cuda.Event()
            done.record(s)
        entry["events"].append(done)
        return {"kv": dev, "event": done}

    def _verify_landed(self, plan: StepPlan) -> None:
        """No request this step touches may have an issued or in-flight (not
        landed) transfer: a broken overlap schedule becomes a loud error
        instead of stale KV."""
        q = self.scheduler.prefetch_queue
        rids = set(plan.decode_rids)
        rids.update(s.rid for s in plan.prefill_segments)
        for rid in sorted(rids):
            for kind in (SWAP_IN, ADOPT):
                if not q.readable(rid, kind):
                    raise RuntimeError(
                        f"async prefetch invariant violated: request {rid} is scheduled "
                        f"this step but its {kind} transfer has not landed")

    # ---------------------------------------------------------------- packed
    def _sync_block_mirror(self, plan: StepPlan) -> int:
        """Re-sync the block-table mirror from the allocator's tables for
        this step's active slots: free slots fall back to the scratch page,
        live slots copy their table's actual physical page ids. Returns the
        longest context (tokens) any row touches this step."""
        m = self.block_mirror
        pps = self.pages_per_slot
        m[:] = self._scratch_page
        sch = self.scheduler
        need_tokens: Dict[int, int] = {}
        for slot, rid in zip(plan.decode_slots, plan.decode_rids):
            need_tokens[slot] = sch.requests[rid].next_decode_pos + 1
        for seg in plan.prefill_segments:
            need_tokens[seg.slot] = max(need_tokens.get(seg.slot, 0), seg.start + seg.length)
        tables = sch.mem.allocator.tables
        for slot, req in sch.active.items():
            table = tables.get(req.rid)
            if table is None:
                continue
            n = min(pps, table.num_blocks)
            if n:
                m[slot, :n] = table.blocks[:n]
        return max(need_tokens.values(), default=1)

    def _nb_bucket(self, max_tokens: int) -> int:
        """Block-table columns for this step: ceil(longest context / page),
        rounded up to a power of two, capped at the per-slot page count."""
        need = -(-max(max_tokens, 1) // self.page_size)
        return min(_pow2_at_least(need), self.pages_per_slot)

    def _run_packed(self, plan: StepPlan):
        """Launch the step's packed compute; returns the (requests, logits
        rows) to sample."""
        sch = self.scheduler
        N = plan.total_tokens
        if N == 0:
            return []  # a zero-token (robustness pump) step computes nothing
        tokens = np.zeros((N,), np.int32)
        slots = np.zeros((N,), np.int32)
        positions = np.zeros((N,), np.int32)

        nd = len(plan.decode_slots)
        for i, (slot, rid) in enumerate(zip(plan.decode_slots, plan.decode_rids)):
            req = sch.requests[rid]
            tokens[i] = req.output[-1]
            positions[i] = req.next_decode_pos
            slots[i] = slot
        row = nd
        last_rows = {}  # rid -> row of its segment's last token (finishing only)
        for seg in plan.prefill_segments:
            req = sch.requests[seg.rid]
            tokens[row:row + seg.length] = req.prefill_slice(seg.start, seg.length)
            positions[row:row + seg.length] = np.arange(seg.start, seg.start + seg.length)
            slots[row:row + seg.length] = seg.slot
            if seg.finishes:
                last_rows[seg.rid] = row + seg.length - 1
            row += seg.length

        rows = list(range(nd)) + list(last_rows.values())
        rids = list(plan.decode_rids) + list(last_rows.keys())
        logits = self._packed_logits(plan, tokens, slots, positions, row, rows)
        # sampled later: one device->host transfer of just the token ids
        return [([sch.requests[rid] for rid in rids], logits)] if rows else []

    def _packed_logits(self, plan, tokens, slots, positions, n_rows: int, rows):
        if self.attn_kernel == "paged":
            return self._packed_paged(plan, tokens, slots, positions, n_rows, rows)
        # dense: ONE host->device copy of the rows' tokens, slots and
        # positions, the rows to sample and B2's row tiles (a chunk's rows
        # share its slot's keys); DenseView derives the rest
        cfg = self.model.cfg
        tiles = row_tiles(slots[:, None], positions + 1, cfg.n_heads // cfg.n_kv_heads)
        parts = [tokens, slots, positions, np.asarray(rows, np.int32), tiles.ravel()]
        meta = torch.from_numpy(np.concatenate(parts)).to(self.device)
        d_tokens, d_slots, d_pos, d_rows, d_tiles = torch.split(meta, [p.size for p in parts])
        logits, self.cache = packed_step(
            self.model, self.params, self.cache, d_tokens, d_slots, d_pos,
            DenseView(d_slots, d_pos, tiles=d_tiles.view(-1, 2)))
        return logits[d_rows.long()]

    def _packed_paged(self, plan: StepPlan, tokens, slots, positions, n_rows: int,
                      rows) -> torch.Tensor:
        """The paged step's metadata and compute; returns the logits of
        ``rows``."""
        nd = len(plan.decode_slots)
        max_ctx = self._sync_block_mirror(plan)
        nb = self._nb_bucket(max_ctx)
        # segment layout for the mixed-batch attention call, straight from
        # the plan (decodes, then prefill segments — the row order above);
        # padding segments are zero-width and own the scratch slot
        s_real = nd + len(plan.prefill_segments)
        sb = _pow2_at_least(s_real)
        cu_q = np.full((sb + 1,), plan.cu_q_lens[-1], np.int32)
        cu_q[:s_real + 1] = plan.cu_q_lens
        kv_lens = np.zeros((sb,), np.int32)
        kv_lens[:s_real] = plan.kv_lens
        seg_slots = np.full((sb,), self.n_slots, np.int32)
        seg_slots[:nd] = plan.decode_slots
        for i, seg in enumerate(plan.prefill_segments):
            seg_slots[nd + i] = seg.slot
        if int(cu_q[s_real]) != n_rows:
            raise RuntimeError(f"plan row layout mismatch: cu_q_lens end {cu_q[s_real]} "
                               f"!= packed rows {n_rows}")
        if nd and not np.array_equal(kv_lens[:nd], positions[:nd] + 1):
            raise RuntimeError("decode kv_lens drifted from engine positions")
        tiles = q_tiles(cu_q, self._group)

        # ONE host->device copy of the step's metadata; every layer reuses it
        parts = [tokens, slots, positions, self.block_mirror[:, :nb].ravel(), cu_q,
                 kv_lens, seg_slots, tiles.ravel(), np.asarray(rows, np.int32)]
        meta = torch.from_numpy(np.concatenate(parts)).to(self.device)
        views = torch.split(meta, [p.size for p in parts])
        d_tokens, d_slots, d_pos, d_bt, d_cu, d_kv, d_seg, d_tiles, d_rows = views
        paged = PagedView(d_bt.view(self.n_slots + 1, nb), self.page_size, cu_q_lens=d_cu,
                          kv_lens=d_kv, seg_slots=d_seg, tiles=d_tiles.view(-1, 2))
        logits, self.cache = packed_step(self.model, self.params, self.cache, d_tokens,
                                         d_slots, d_pos, paged)
        return logits[d_rows.long()]

    # -------------------------------------------------------------- two-call
    def _run_two_call(self, plan: StepPlan):
        """JAX's two-call step: one decode call over the decode slots, then
        one prefill call per segment. JAX decodes every slot row and keeps
        the old state of rows that are not decoding (``_mask_tree``); rows
        are independent, so the port decodes only the decoding slots'
        states, gathered, and writes them back. A prefill runs on views of
        its slot's state, which it updates in place. Returns the (requests,
        logits rows) to sample."""
        sch = self.scheduler
        dev = self.device
        pending = []
        if plan.decode_slots:
            reqs = [sch.requests[rid] for rid in plan.decode_rids]
            meta = torch.from_numpy(np.asarray(
                [list(plan.decode_slots), [r.output[-1] for r in reqs],
                 [r.next_decode_pos for r in reqs]], np.int64)).to(dev)
            slots, tokens, index = meta[0], meta[1, :, None].to(torch.int32), meta[2]
            sub = [{k: v.index_select(0, slots) for k, v in layer.items()}
                   for layer in self.cache]
            logits, sub = self.model.decode_step(self.params, tokens, sub, index)
            for layer, part in zip(self.cache, sub):
                for k, v in layer.items():
                    v.index_copy_(0, slots, part[k])
            pending.append((reqs, logits))

        for seg in plan.prefill_segments:
            req = sch.requests[seg.rid]
            sub = [{k: v[seg.slot:seg.slot + 1] for k, v in layer.items()}
                   for layer in self.cache]
            if seg.start == 0:
                # slot reuse / re-prefill after preemption: the states are
                # additive, so the slot starts from zeros
                for layer in sub:
                    for v in layer.values():
                        v.zero_()
            chunk = np.asarray(req.prefill_slice(seg.start, seg.length), np.int32)[None]
            logits, _ = self.model.prefill(self.params,
                                           {"tokens": torch.from_numpy(chunk).to(dev)}, sub,
                                           seg.start)
            if seg.finishes:
                pending.append(([req], logits[:1]))
        return pending
