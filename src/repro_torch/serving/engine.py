"""Continuous-batching serving engine driven by the packing-prefetch scheduler.

The PyTorch counterpart of the JAX package's ``serving/engine.py`` for its
packed path: decode tokens and prefill chunks share every linear and FFN
matmul in one ``packed_step``, with recompute preemption. Two KV layouts, as
in JAX (``attn_kernel``):

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

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: swap preemption and the prefix cache (with their staged async
prefetch), and the archs ``Model`` does not build (Mamba1, enc-dec).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.packed_step import DenseView, PagedView, packed_step, supports_packed
from repro_torch.core.scheduler import Scheduler, SchedulerConfig, StepPlan
from repro_torch.kernels.paged_attention import q_tiles, row_tiles
from repro_torch.models.model import Model
from repro_torch.obs.trace import LANE_COMPUTE, LANE_PREFETCH_STAGE, LANE_SCHED, LANE_STEP, NOOP
from repro_torch.serving.request import Request

ATTN_KERNELS = ("auto", "paged", "dense")


def _pow2_at_least(n: int, start: int = 8) -> int:
    m = start
    while m < n:
        m *= 2
    return m


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
        # SSM archs cannot share a step's matmuls across rows of different
        # requests' recurrent states: they run the two-call path
        self.two_call = not supports_packed(model.cfg)
        if sched_cfg.preemption == "swap":
            raise NotImplementedError(
                "swap preemption is not ported yet (ROADMAP.md A5: the engine's swap, "
                "prefix-cache and async-prefetch staging)")
        if sched_cfg.enable_prefix_cache:
            raise NotImplementedError(
                "the prefix cache is not ported yet (ROADMAP.md A5: the engine's swap, "
                "prefix-cache and async-prefetch staging)")
        self.page_size = sched_cfg.kv_block_size
        if attn_kernel == "auto":
            attn_kernel = ("paged" if not self.two_call and max_len % self.page_size == 0
                           else "dense")
        if attn_kernel == "paged" and (self.two_call or max_len % self.page_size):
            raise ValueError(
                "attn_kernel='paged' needs packed mode and max_len divisible by "
                f"kv_block_size (max_len={max_len}, block={self.page_size})")
        self.attn_kernel = attn_kernel
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_len = max_len
        self.eos_id = eos_id
        self.n_slots = sched_cfg.max_decode_batch
        self.steps_run = 0
        self.prefetch_log: List[float] = []

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
        """Cancel every non-terminal request and outstanding ledger intent,
        so a flushed trace is fully terminal. Returns the number cancelled."""
        n = self.scheduler.cancel_all(reason, now=float(self.steps_run))
        self.scheduler.drain_released()
        self.scheduler.prefetch_queue.cancel_outstanding(reason)
        return n

    def register_metrics(self, reg) -> None:
        """Engine-side gauges for the typed metrics registry: step count and
        pool capacity / peak pressure."""
        reg.counter("engine_steps", "steps", "engine steps executed").inc(self.steps_run)
        reg.gauge("engine_swap_store_entries", "requests",
                  "host-tier KV copies currently held").set(0.0)
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
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        plan = self.scheduler.next_step(now)
        # no swap store or staged copies to purge (swap and the prefix cache
        # are refused at construction, so no plan carries their traffic or
        # transfer intents); the log is drained so it does not grow
        self.scheduler.drain_released()
        if plan is None:
            return None
        if plan.prefetch is not None:
            self.prefetch_log.append(plan.prefetch.coverage)
        t1 = tr.now() if tr.enabled else 0.0
        if self.two_call:
            self._run_two_call(plan)
        else:
            self._run_packed(plan)
        t2 = tr.now() if tr.enabled else 0.0
        self.scheduler.complete_step(plan, now)
        self.scheduler.ledger.record_step(tr, plan.step)
        if tr.enabled:
            t3 = tr.now()
            step = self.steps_run
            tr.span(LANE_STEP, f"step {step}", t0, t3 - t0, step=step,
                    tokens=plan.total_tokens, decodes=len(plan.decode_rids),
                    prefill_tokens=plan.total_prefill_tokens)
            tr.span(LANE_SCHED, "next_step", t0, t1 - t0, step=step)
            tr.span(LANE_COMPUTE, "compute", t1, t2 - t1, step=step,
                    tokens=plan.total_tokens)
            tr.span(LANE_PREFETCH_STAGE, "stage+complete", t2, t3 - t2,
                    step=step, issued=len(plan.issued))
        self.steps_run += 1
        return plan

    def _sample_rows(self, logits_rows: torch.Tensor) -> np.ndarray:
        """(rows, vocab) logits on the device -> (rows,) token ids on the
        host. The engine's single sampling hook: greedy (first maximum on a
        tie, as ``np.argmax``); override for other decoders."""
        return torch.argmax(logits_rows, dim=-1).cpu().numpy()

    def _append(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            req.finished = True  # complete_step checks the flag explicitly

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

    def _run_packed(self, plan: StepPlan) -> None:
        sch = self.scheduler
        N = plan.total_tokens
        if N == 0:
            return  # a zero-token (robustness pump) step computes nothing
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
        if self.attn_kernel == "paged":
            logits = self._packed_paged(plan, tokens, slots, positions, row, rows)
        else:
            # dense: ONE host->device copy of the rows' tokens, slots and
            # positions, the rows to sample and B2's row tiles (a chunk's
            # rows share its slot's keys); DenseView derives the rest
            cfg = self.model.cfg
            tiles = row_tiles(slots[:, None], positions + 1, cfg.n_heads // cfg.n_kv_heads)
            parts = [tokens, slots, positions, np.asarray(rows, np.int32), tiles.ravel()]
            meta = torch.from_numpy(np.concatenate(parts)).to(self.device)
            d_tokens, d_slots, d_pos, d_rows, d_tiles = torch.split(meta,
                                                                    [p.size for p in parts])
            logits, self.cache = packed_step(
                self.model, self.params, self.cache, d_tokens, d_slots, d_pos,
                DenseView(d_slots, d_pos, tiles=d_tiles.view(-1, 2)))
            logits = logits[d_rows.long()]
        # one device->host transfer of just the sampled token ids
        if rows:
            for rid, tok in zip(rids, self._sample_rows(logits)):
                self._append(sch.requests[rid], int(tok))

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
    def _run_two_call(self, plan: StepPlan) -> None:
        """JAX's two-call step: one decode call over the decode slots, then
        one prefill call per segment. JAX decodes every slot row and keeps
        the old state of rows that are not decoding (``_mask_tree``); rows
        are independent, so the port decodes only the decoding slots'
        states, gathered, and writes them back. A prefill runs on views of
        its slot's state, which it updates in place."""
        sch = self.scheduler
        dev = self.device
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
            for req, tok in zip(reqs, self._sample_rows(logits)):
                self._append(req, int(tok))

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
                self._append(req, int(self._sample_rows(logits[:1])[0]))
