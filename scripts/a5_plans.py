#!/usr/bin/env python3
"""The plans ``chip_smoke.py``'s A5 runs get, from the scheduler alone on the CPU.

    PYTHONPATH=src python scripts/a5_plans.py

Drives the port's ``Scheduler`` (no model: every decode row and finishing
prefill emits a dummy token, and without an EOS the plans do not depend on
the tokens) over Llama3.1-8B's configuration with ``chip_smoke.py``'s own
``SERVE`` settings, prompts (``serve_prompts``), ``SWAP_SCHED`` and
``PREFIX_REQUESTS``, and its pool rule (``launch.serve.sized_kv_pool``'s
dense-equivalent pool, which the card's runs take), for ``serve_swap`` /
``serve_swap_sync``, ``serve_prefix`` / ``serve_prefix_off``, and the prefix
cache with swap preemption together, which ``chip_smoke.py`` does not run at
full width. Prints one JSON line a workload: steps, swaps and their GiB,
prefix hits, skipped tokens and mid-block copies, prefill tokens, the steps
with swap traffic, the steps that swap a request out and back in within one
plan (the reference scheduler's fault, ``ROADMAP.md`` §C), and the prefix
copies whose destination is a page a swap-out of the same step gave up.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import PREFIX_REQUESTS, SERVE, SWAP_SCHED, serve_prompts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from repro_torch.launch.serve import sized_kv_pool  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.workload import shared_prefix_requests  # noqa: E402


def serve_requests(vocab):
    return [Request(rid=i, prompt=p, max_new_tokens=SERVE["max_new"])
            for i, p in enumerate(serve_prompts(vocab))]


def sched_config(cfg, settings):
    pool, _ = sized_kv_pool(cfg, torch.device("cpu"), torch.bfloat16, SERVE["max_batch"],
                            SERVE["max_len"], SERVE["page"])
    return SchedulerConfig(chunk_size=SERVE["chunk"], max_decode_batch=SERVE["max_batch"],
                           max_concurrent_prefills=SERVE["max_prefills"],
                           kv_block_size=SERVE["page"], num_kv_blocks=pool, **settings)


def drive(name, settings, requests, cfg):
    sched = Scheduler(sched_config(cfg, settings), cfg)
    for r in requests:
        sched.add_request(r)
    step, copies, swap_steps, round_trips, reused = 0, 0, [], [], []
    while sched.has_work:
        plan = sched.next_step(float(step))
        if plan is None:
            break
        both = sorted({r for r, _ in plan.swapped_out} & {r for r, _ in plan.swapped_in})
        if both:
            round_trips.append(dict(step=step, rids=both))
        gave_up = set()
        for rid, _ in plan.swapped_out:
            if rid in sched.mem.swapped:
                rec = sched.mem.swapped[rid].record
                gave_up.update(rec.table.blocks[i] for i in rec.spilled_indices)
        reused.extend(dict(step=step, rid=c[0], page=c[2]) for c in plan.prefix_copies
                      if c[2] in gave_up)
        copies += len(plan.prefix_copies)
        if plan.swapped_out or plan.swapped_in:
            swap_steps.append(dict(step=step, out=[r for r, _ in plan.swapped_out],
                                   back=[r for r, _ in plan.swapped_in]))
        for rid in list(plan.decode_rids) + plan.finishing_rids:
            sched.requests[rid].output.append(1)
        sched.complete_step(plan, float(step))
        step += 1
    st, mem = sched.stats, sched.mem
    print(json.dumps(dict(
        workload=name, steps=step, swap_outs=st.swap_outs, swap_ins=st.swap_ins,
        swap_out_gib=mem.swap_out_bytes_total / 2**30, swap_in_gib=mem.swap_in_bytes_total / 2**30,
        prefix_hits=st.prefix_hits, prefix_hit_tokens=st.prefix_hit_tokens,
        prefix_copies=copies, prefill_tokens=st.prefill_tokens, swap_steps=swap_steps,
        same_step_round_trips=round_trips, copies_into_swapped_out_pages=reused)))


def main():
    cfg = get_config("llama3.1-8b")
    swap = SWAP_SCHED
    drive("serve_swap", dict(swap, async_prefetch=True), serve_requests(cfg.vocab_size), cfg)
    drive("serve_swap_sync", dict(swap, async_prefetch=False), serve_requests(cfg.vocab_size),
          cfg)

    def shared():
        return shared_prefix_requests(vocab_size=cfg.vocab_size, **PREFIX_REQUESTS)

    drive("serve_prefix", dict(enable_prefix_cache=True), shared(), cfg)
    drive("serve_prefix_off", {}, shared(), cfg)
    drive("prefix_with_swap", dict(swap, enable_prefix_cache=True), shared(), cfg)


if __name__ == "__main__":
    main()
