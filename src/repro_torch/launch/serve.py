"""Serving launcher: packing-prefetch engine over a workload, in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
        --requests 8 --chunk 512 --max-batch 8 --kv-block 16 --max-len 8192

Weights are random, drawn on the device from seed 0. The physical KV page
pool is sized from the device memory left free once the weights are resident
(``torch.cuda.mem_get_info``, less ``ACTIVATION_RESERVE`` for activations),
divided by one page's full-stack KV bytes in the pool dtype, and capped at the
dense-equivalent layout (``max_batch * max_len`` tokens). On the CPU the cap
is the size. ``--num-kv-blocks`` overrides both. ``--attn-kernel dense``
serves from a dense ``(max_batch + 1, max_len)`` slot cache instead and
sizes no pool. An attention-free arch (``--arch mamba2-2.7b``) runs the
two-call path over a fixed ``(max_batch + 1)``-row state and sizes no pool
either; the launcher prints the state's bytes. ``--layers N`` keeps an
arch's published widths and runs its first N layers, for a model whose
weights outgrow the card (llama3.1-70b: 141 GB in bf16). The flags mirror
the JAX launcher's: ``--preemption swap`` parks preempted KV in pinned host
memory, ``--prefix-cache`` shares cached prompt pages copy-on-write (the
paged path only; ``--shared-prefix N`` makes prompts that share N tokens),
and ``--no-async-prefetch`` turns off the staging of predicted restores on
the engine's copy stream (tokens are the same either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.reduced import dropless
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models import build_model
from repro_torch.obs.perfetto import dump_json, export_chrome
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import summarize
from repro_torch.serving.request import Request, State
from repro_torch.serving.workload import shared_prefix_requests

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# device memory kept free for a step's activations when sizing the pool: a
# 512-row chunk's fp32 logits over a 128K vocabulary take 0.26 GB, its FFN
# intermediates 0.04 GB; the rest is headroom for the caching allocator
ACTIVATION_RESERVE = 4 * 2**30


def depth_cut(cfg, layers: int):
    """``cfg`` at its own widths with only its first ``layers`` layers (a
    whole number of scan periods past the prefix)."""
    if not cfg.n_prefix_layers < layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: {layers} layers is not in {cfg.n_prefix_layers + 1}.."
                         f"{cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=layers, layer_specs=cfg.layer_specs[:layers])


def sized_kv_pool(cfg, device: torch.device, dtype: torch.dtype, max_batch: int,
                  max_len: int, kv_block: int):
    """(pool_blocks, basis): free device memory after the weights, less
    ``ACTIVATION_RESERVE``, over one block's KV bytes; capped at the
    dense-equivalent layout. ``basis`` says which bound was taken."""
    if not cfg.n_attn_layers:
        raise ValueError(f"{cfg.name} has no attention layers: it keeps a fixed state per "
                         "slot, not a KV pool")
    dense_equiv = max_batch * max_len // kv_block
    floor = max(1, max_len // kv_block)  # the engine needs one max_len context
    if device.type != "cuda":
        return dense_equiv, "dense"
    free, _total = torch.cuda.mem_get_info(device)
    elem = torch.empty((), dtype=dtype).element_size()
    block_bytes = kv_block * 2 * cfg.n_kv_heads * cfg.head_dim * elem * cfg.n_attn_layers
    budget = max(0, free - ACTIVATION_RESERVE) // block_bytes
    if budget < floor:
        return floor, "floor"
    if budget < dense_equiv:
        return budget, "free_memory"
    return dense_equiv, "dense"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="run only the first N layers, at the published widths")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="weights, activations and KV pool")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefetch-mb", type=float, default=0.25)
    ap.add_argument("--policy", choices=["fcfs", "sjf", "priority"], default="fcfs")
    ap.add_argument("--max-prefills", type=int, default=1,
                    help="prefill requests packable into one step")
    ap.add_argument("--kv-capacity", type=int, default=None,
                    help="total KV token budget; exceeding it preempts decodes")
    ap.add_argument("--preemption", choices=["recompute", "swap"], default="recompute",
                    help="drop-and-re-prefill vs spill-to-host preemption")
    ap.add_argument("--kv-block", type=int, default=1,
                    help="paged KV block size in tokens")
    ap.add_argument("--num-kv-blocks", type=int, default=None,
                    help="explicit physical KV page pool size in blocks (overrides the "
                         "free-memory sizing). Smaller pools over-subscribe: admission "
                         "stalls on OutOfBlocks instead of over-allocating")
    ap.add_argument("--attn-kernel", choices=["auto", "paged", "dense"], default="auto",
                    help="packed attention path: ragged block-table (paged) vs dense "
                         "slot cache")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: shared prompt prefixes fork cached pages "
                         "copy-on-write instead of re-prefilling")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="generate prompts sharing a system prefix of this many tokens "
                         "(0 = independent random prompts)")
    ap.add_argument("--admission-watermark", type=int, default=0,
                    help="free-page low-watermark gating NEW admissions (blocks)")
    ap.add_argument("--no-async-prefetch", action="store_true",
                    help="disable one-step-ahead KV transfer staging: swap restores copy "
                         "from the host on the compute stream instead of riding under the "
                         "previous step (outputs are token-identical either way)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json of the run")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the full metrics summary as NaN-safe JSON")
    ap.add_argument("--attribution-json", default=None, metavar="PATH",
                    help="dump the per-step byte-attribution ledger as NaN-safe JSON")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="JSON FaultPlan to inject deterministic transfer chaos")
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="per-attempt transfer failure probability")
    ap.add_argument("--delay-rate", type=float, default=0.0,
                    help="per-attempt transfer delay probability")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault schedule")
    ap.add_argument("--max-transfer-retries", type=int, default=3,
                    help="failed-transfer retry budget")
    ap.add_argument("--request-timeout", type=float, default=None,
                    help="per-request deadline in engine steps after arrival")
    ap.add_argument("--degraded-threshold", type=float, default=None,
                    help="rolling transfer-failure rate that trips degraded mode")
    args = ap.parse_args()

    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.layers is not None:
        cfg = depth_cut(cfg, args.layers)
    cfg = dropless(cfg)  # serving uses dropless MoE dispatch
    model = build_model(cfg, dtype=dtype, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    pool, pool_basis = args.num_kv_blocks, "flag"
    if pool is None and not cfg.n_attn_layers:
        pool_basis = "two-call state"  # no KV: a fixed state per slot
    elif pool is None and args.attn_kernel == "dense":
        pool_basis = "dense slot cache"
    elif pool is None:
        pool, pool_basis = sized_kv_pool(cfg, device, dtype, args.max_batch, args.max_len,
                                         args.kv_block)
    fault_plan = None
    if args.fault_plan:
        from repro_torch.robustness import FaultPlan
        fault_plan = FaultPlan.load(args.fault_plan)
    elif args.fail_rate > 0 or args.delay_rate > 0:
        from repro_torch.robustness import FaultPlan
        fault_plan = FaultPlan(seed=args.fault_seed, fail_rate=args.fail_rate,
                               delay_rate=args.delay_rate)
    tracer = TraceRecorder("engine") if args.trace_out else None
    eng = Engine(model, params, SchedulerConfig(
        chunk_size=args.chunk, max_decode_batch=args.max_batch,
        prefetch_buffer_bytes=int(args.prefetch_mb * 2**20),
        max_concurrent_prefills=args.max_prefills, policy=args.policy,
        kv_capacity_tokens=args.kv_capacity, preemption=args.preemption,
        kv_block_size=args.kv_block, num_kv_blocks=pool,
        enable_prefix_cache=args.prefix_cache,
        admission_watermark=args.admission_watermark,
        async_prefetch=not args.no_async_prefetch,
        fault_plan=fault_plan,
        max_transfer_retries=args.max_transfer_retries,
        request_timeout=args.request_timeout,
        degraded_threshold=args.degraded_threshold),
        max_len=args.max_len, attn_kernel=args.attn_kernel, tracer=tracer, device=device)
    rng = np.random.default_rng(0)
    if args.shared_prefix > 0:
        for req in shared_prefix_requests(
                args.requests, shared_len=args.shared_prefix,
                unique_len=max(8, args.max_len // 8),
                max_new_tokens=args.max_new, vocab_size=cfg.vocab_size):
            eng.submit(req)
    else:
        for rid in range(args.requests):
            L = int(rng.integers(8, args.max_len // 2))
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, L).tolist(),
                               max_new_tokens=args.max_new))

    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    interrupted = False
    try:
        eng.run(max_steps=5000)
        if eng.scheduler.has_work:
            n = eng.shutdown("truncated")
            print(f"[launch.serve] step budget exhausted: cancelled {n} "
                  "unfinished request(s)", file=sys.stderr)
    except KeyboardInterrupt:
        interrupted = True
        n = eng.shutdown("interrupt")
        print(f"[launch.serve] interrupted: cancelled {n} in-flight "
              "request(s), flushing artifacts", file=sys.stderr)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    reg = MetricsRegistry()
    eng.register_metrics(reg)
    m = summarize(eng.scheduler.requests.values(), horizon=float(max(eng.steps_run, 1)),
                  sched_stats=eng.scheduler.stats, chunk_size=args.chunk,
                  prefetch_stats=eng.scheduler.prefetch_queue.stats,
                  registry=reg)
    if args.trace_out:
        eng.scheduler.ledger.record_totals(tracer, eng.attribution_aggregates())
        export_chrome(tracer, args.trace_out)
        print(f"[launch.serve] trace written to {args.trace_out}")
    if args.metrics_json:
        dump_json(args.metrics_json, m)
        print(f"[launch.serve] metrics written to {args.metrics_json}")
    if args.attribution_json:
        dump_json(args.attribution_json, eng.scheduler.ledger.as_dict())
        print(f"[launch.serve] attribution ledger written to {args.attribution_json}")
    alloc = eng.scheduler.mem.allocator
    if eng.two_call:  # a fixed state per slot: its bytes, not pool pages
        nbytes = sum(t.numel() * t.element_size() for layer in eng.cache for t in layer.values())
        memory = f"state={nbytes}B({pool_basis}:{device.type})"
    else:
        memory = (f"pool={alloc.peak_used_blocks}/{alloc.num_blocks}pages"
                  f"({pool_basis}:{device.type})")
    swap_rep = (f"swap_d2h={eng.swap_bytes_moved['d2h']}B "
                f"swap_h2d={eng.swap_bytes_moved['h2d']}B "
                f"host_buffers={eng.host_pool.pinned}+{eng.host_pool.reused}reused "
                if args.preemption == "swap" else "")
    prefix_rep = (f"prefix_hit_rate={m['prefix_hit_rate']:.2f} "
                  f"prefill_skipped={int(m['prefix_tokens_skipped'])}tok "
                  f"fill_saved={m['prefix_fill_bytes_saved']:.0f}B "
                  if args.prefix_cache else "")
    print(f"[launch.serve] mode={'two-call' if eng.two_call else 'packed'} "
          f"attn={eng.attn_kernel} "
          f"policy={args.policy} steps={eng.steps_run} "
          f"completed={m['completed']}/{m['submitted']} "
          f"pack_eff={m['packing_efficiency']:.2f} "
          f"preemptions={int(m['preemptions'])} "
          f"swaps={int(m['swap_outs'])} "
          f"{memory} "
          f"{swap_rep}"
          f"{prefix_rep}"
          f"oob_stalls={int(m['out_of_block_stalls'])} "
          f"wm_stalls={int(m['watermark_stalls'])} "
          f"attn_savings={m['attn_padding_savings']:.2f} "
          f"prefetch_cov={m['prefetch_coverage']:.2f} "
          f"overlapped={m['bytes_overlapped']:.0f}B "
          f"overlap_eff={m['overlap_efficiency']:.2f} "
          f"async={'off' if args.no_async_prefetch else 'on'}")
    unfinished = sorted(r.rid for r in eng.scheduler.requests.values()
                        if r.state is not State.DONE)
    if unfinished or interrupted:
        print(f"[launch.serve] exiting nonzero: {len(unfinished)} "
              f"unfinished request(s) {unfinished[:16]}"
              f"{'...' if len(unfinished) > 16 else ''}"
              f"{' (interrupted)' if interrupted else ''}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
