#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # every phase, the result line last

Runs from a checkout of the repository, on a machine with a CUDA card and the
CUDA toolkit; it needs no network. Phases, each printing JSON lines:

  device          card, power limit, torch/CUDA versions; TF32 off for fp32 checks
  build           nvcc builds every kernel of the port from src/repro_torch, one
                  process per source, all at once; ptxas's registers and spills
                  of every instantiation (none of B1's, B3's bf16 cluster's
                  or B5's, and none at head_dim 256, may spill)
  kernel_parity   each kernel against its plain PyTorch version on the card, with
                  NaN in every dead key, at the main paths' shapes (Llama3.1-8B
                  heads: KV 8, G 4, d 128), at gemma2-2b's (KV 4, G 2, d 256,
                  window 4096, softcap 50; dropping either from the plain
                  version must fail), at kernels_micro's shapes and at the
                  reduced test shapes, with times beside the card's bound and one
                  PyTorch library call: B1 mixed_paged_attention (also rows of
                  up to 131072 keys, split over keys, where a combine that did
                  not rescale its partials by their maxima must fail; the plan
                  each case ran, read back from its scratch, against
                  ref.mixed_split_plan), B2
                  paged_attention (pages of 1, 16 and max_len; the dense
                  engine's decode-only and prefill-bearing steps, the latter's
                  chunk rows in row tiles), B3
                  decode_attention (bf16: the cluster plan each case ran
                  against ref.cluster_plan, one launch a call in the trace,
                  a combine without a share's rescale or with a share left
                  out rejected, rows shorter than a block a CTA, a 131072-key
                  row, G up to 16 at d 16 to 256, and one call captured in a
                  CUDA graph and replayed on new inputs, bit-equal to
                  eager), B4 flash_attention; B5
                  ssd_chunk_scan at
                  Mamba2-2.7B's widths (100, 512 and 4096 tokens, the
                  overflow case), two groups and reduced widths, y and the
                  final state held apart; dropping h0 or the carry, a carry
                  without the chunk's decay and a stale carried state (chunk
                  c - 2's) rejected; the schedule the kernel's library makes
                  against its Python copy. The new GQA groups (group_parity):
                  B1-B4 at KV 2, d 128 with G 6 (qwen2-1.5b) and G 16
                  (chatglm3-6b; B3 at G 6 only), bf16 and fp32, at their main
                  paths' shapes. B5's scratch (b5_scratch_checks): one call
                  captured in a CUDA graph and replayed twice on new inputs,
                  bit-equal to eager, its epoch word moved on by one a
                  replay; a call on a second stream on a scratch of its own;
                  the epoch word's wrap (flags and states zeroed, epoch 1);
                  a capture on an unsized stream refused
  reduced_serve   the paged engine at reduced width in fp32 on the card (kernel)
                  and on the CPU (plain version): the same greedy tokens
  engine_bf16     the engine in bf16 at Llama3.1-8B's attention heads, reduced
                  depth and width: every attention call of the run against
                  the plain version on the same bf16 tensors, and the plan
                  each call ran (read back from its scratch) against
                  ref.mixed_split_plan, a decode-only and a mixed step among
                  them and a decode row of more than one split
  reduced_serial  reduced width, fp32, on the card: serial per-request prefill +
                  decode (B4, B3), the paged engine (B1) and the dense engine (B2)
                  give the same greedy tokens, and the CPU's serial run too
  reduced_two_call reduced mamba2-2.7b in fp32: the two-call engine on the card
                  (B5) and on the CPU and the serial path on the card give the
                  same greedy tokens
  reduced_archs   gemma2-2b, qwen2-1.5b, chatglm3-6b, qwen3-32b and llama3.1-70b
                  at reduced widths with their published GQA groups (G 2, 6,
                  16, 8, 8), fp32, biases and norm scales drawn from a seed:
                  the paged engine on the card gives the CPU's greedy tokens,
                  and for gemma2 so do the dense engine and the serial path
  reduced_a5      swap preemption (paged, dense and two-call), async staging on
                  and off, the prefix cache with mid-block copies (one case
                  copying into a page a swap-out of the same step gave up),
                  and a fault plan with retries, on reduced Llama3.1-8B and
                  Mamba2-2.7B in fp32 with tests/test_torch_a5.py's
                  workloads: the engine on the card gives the CPU's greedy
                  tokens and schedule, and every page (or slot row) a swap-in
                  restored is bit-equal to the victim's page as its step found
                  it, some under another physical page id
  serve           the port's Engine (paged, B1) on Llama3.1-8B at full width, all
                  32 layers, bf16, seeded random weights: 8 requests, 32 new
                  tokens each; then a profiled window (serve_profile)
  serve_dense     the same workload through attn_kernel="dense" (B2), after a
                  checked pass (serve_dense_check): every layer's B2 call of one
                  prefill-bearing and one decode-only step against the plain
                  version on the same bf16 tensors
  serial          the same 8 requests served one at a time (B4 prefill, B3
                  decode): the paper's serial baseline, and serve's speed-up
                  over it
  serve_swap_sync, serve_swap
                  SERVE's workload under a KV budget of 8192 tokens with swap
                  preemption (4 swap-outs, 0.70 GiB each way), without and then
                  with async staging on the engine's copy stream (each
                  engine pinning its own host buffers): the swap steps and
                  their ms, with and without the digests' device ms, D2H and
                  H2D GB/s from CUDA events, each staged
                  copy's share inside its step's kernel window, the bytes moved
                  against the memory manager's, every restored page's digest
                  against its swap-out's; the two runs' plans step by step and,
                  where they match, their tokens
  serve_prefix, serve_prefix_off
                  8 prompts sharing 2008 tokens (not a whole number of pages)
                  with the prefix cache (6 hits, 6 mid-block copies) and without
  micro           kernels_micro's two comparisons at its full shapes: dense (B3)
                  vs ragged paged (B2) decode, unified mixed (B1) vs per-token (B2)
  serve_mamba     SERVE's workload through the two-call engine on Mamba2-2.7B at
                  full width, all 64 layers, bf16 (B5 in every layer of every
                  prefill segment), after a checked pass (serve_mamba_check:
                  every layer's B5 call of one segment that carries a state
                  against the plain version); then a profiled window
  serve_gemma2, serve_dense_gemma2, serial_gemma2
                  gemma2-2b at full width and depth (26 layers, window 4096
                  on its even layers, softcaps 50 and 30), bf16, through the
                  paged engine, the dense engine (after its checked pass,
                  serve_dense_gemma2_check) and serially, on GEMMA2_SERVE:
                  SERVE with every prompt 4500-7900 tokens, past the window
  serve_qwen2, serve_chatglm3, serve_qwen3, serve_llama70b
                  SERVE's workload through the paged engine at the published
                  widths of qwen2-1.5b (G 6, biases, tied), chatglm3-6b (G
                  16, half-dim RoPE, biases) and qwen3-32b (G 8, q/k norms),
                  all at full depth, and llama3.1-70b at 32 of its 80 layers

then the kernels line (each kernel's launches on its main path and on every
path that ran it, ``launches_by_path``), the card's name and power limit as
nvidia-smi gives them, and, last, {"ok": true, "device": {...}}. Any failure
raises: the script exits nonzero and prints no result. Without a CUDA card
it exits 1.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 CUDA cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # abs and rel; bf16 against fp32 plain
# bf16 is held tighter too, to the scale of what it compares: |err| <= 2^-7
# |plain| + 2e-2 rms(plain row). The output is rounded to bf16 (at most 2^-8
# |x|) and P enters the tensor cores in bf16, which moves a row by about 1e-3
# of its rms; a skipped key block or an ignored softcap moves it by a tenth.
BF16_ROW = (2.0**-7, 2e-2)
# a fault (softcap or window dropped, a broken combine) must break the check
# this many times over
FAULT_MARGIN = 3.0
SERVE = dict(requests=8, prompt_lo=512, prompt_hi=4096, max_new=32, chunk=512,
             max_batch=8, max_prefills=2, page=16, max_len=8192)
# gemma2-2b's paths: SERVE with every prompt past its 4096-token local window
GEMMA2_SERVE = dict(SERVE, prompt_lo=4500, prompt_hi=7900)
# the full-width runs of the archs beside Llama3.1-8B: (phase, arch, layers
# run: None for all), each through the paged engine on SERVE's workload
ARCH_SERVES = [("serve_qwen2", "qwen2-1.5b", None), ("serve_chatglm3", "chatglm3-6b", None),
               ("serve_qwen3", "qwen3-32b", None),
               # 141 GB in bf16: its published widths at 32 of its 80 layers
               ("serve_llama70b", "llama3.1-70b", 32)]
# every kernel of the port: its source and the TPU kernel it replaces
KERNELS = {
    "mixed_paged_attention": ("src/repro_torch/kernels/csrc/mixed_paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:268"),
    "paged_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                        "src/repro/kernels/paged_attention.py:119"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:92"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
    "ssd_chunk_scan": ("src/repro_torch/kernels/csrc/ssd_chunk_scan.cu",
                       "src/repro/kernels/ssd.py:81"),
}
NO_LIBRARY = "none: no one PyTorch call computes the SSD chunk scan (a causal, decayed scan)"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(log):
    """Each kernel instantiation's registers, spills and stack frame from
    nvcc's ``-Xptxas=-v`` output, with its head dim where the mangled name
    carries one (template arguments 16..256)."""
    import re

    funcs, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = dict(function=m.group(1))
            dims = [int(x) for x in re.findall(r"Li(\d+)E", m.group(1))
                    if int(x) in (16, 32, 64, 128, 256)]
            current["head_dim"] = dims[0] if dims else None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            funcs.append(current)
            current = None
    return funcs


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel_parity
# ---------------------------------------------------------------------------


def make_case(torch, seed, segs, *, kv, g, d, page, dtype, window=None, softcap=None,
              pad_rows=7, q_scale=1.0):
    """A packed step's attention inputs on the card: ``segs`` (q_len, kv_len)
    segments plus zero-width padding segments up to a power of two (as the
    engine pads), ``pad_rows`` padding rows, pages shuffled over the pool, and
    every dead slot — unused pages, the scratch page, the unwritten tail of
    each last live page — filled with NaN. Metadata from a numpy seed, values
    drawn on the card from the same seed, queries scaled by ``q_scale`` (so
    that scores reach a softcap of 50). The q-tile list is built once, as
    the engine builds it once per step."""
    import numpy as np

    from repro_torch.kernels.paged_attention import q_tiles

    rng = np.random.default_rng(seed)
    n_seg = len(segs)
    sb = 1
    while sb < n_seg:
        sb *= 2
    sb = max(sb, 8)
    live = [-(-kvl // page) for _, kvl in segs]
    nb = max(live)
    P = sum(live) + 8
    scratch = P  # the extra page past the pool, as the engine lays it out
    ids = rng.permutation(P).astype(np.int32)
    tables = np.full((sb, nb), scratch, np.int32)
    off = 0
    for s, n in enumerate(live):
        tables[s, :n] = ids[off:off + n]
        off += n
    cu = np.zeros(sb + 1, np.int32)
    cu[1:n_seg + 1] = np.cumsum([q for q, _ in segs])
    cu[n_seg + 1:] = cu[n_seg]
    kv_lens = np.zeros(sb, np.int32)
    kv_lens[:n_seg] = [k for _, k in segs]
    n_real = int(cu[-1])

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    shape = (P + 1, page, kv, d)
    k_pages = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    v_pages = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    q = q_scale * torch.randn((n_real + pad_rows, kv, g, d), generator=gen, device=dev)
    dead = torch.ones(P + 1, dtype=torch.bool)
    dead[torch.from_numpy(ids[:off]).long()] = False
    k_pages[dead.to(dev)] = float("nan")
    v_pages[dead.to(dev)] = float("nan")
    for s, ((_, kvl), n) in enumerate(zip(segs, live)):
        tail = kvl - (n - 1) * page
        k_pages[int(tables[s, n - 1]), tail:] = float("nan")
        v_pages[int(tables[s, n - 1]), tail:] = float("nan")
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(q=q.to(dtype), k=k_pages.to(dtype), v=v_pages.to(dtype), cu=t(cu),
                kv_lens=t(kv_lens), tables=t(tables), tiles=t(q_tiles(cu, g)), window=window,
                softcap=softcap, n_real=n_real, segs=segs, page=page)


def work(case):
    """Bytes the function must move and operations it must do for this
    case's data: every key a segment's rows can see read once (no page
    rounding, window honoured), queries read once, outputs written once;
    4 * H * d operations per (row, visible key)."""
    q = case["q"]
    _, kv, g, d = q.shape
    elem = q.element_size()
    keys, pairs = 0, 0
    for q_len, kv_len in case["segs"]:
        w = case["window"]
        first = kv_len - q_len
        lo = 0 if w is None else max(0, first - w + 1)
        keys += kv_len - lo
        for pos in range(first, kv_len):
            pairs += pos + 1 if w is None else min(pos + 1, w)
    nbytes = keys * kv * d * 2 * elem + 2 * case["n_real"] * kv * g * d * elem
    flops = 4 * pairs * kv * g * d
    return nbytes, flops


def bound_of(nbytes, flops, dtype):
    """The least time the card could take: bytes over its memory rate or
    operations over its peak rate for ``dtype``, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` runs, each from a cold L2
    (a 128 MB buffer is rewritten between runs, outside the timed span)."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn``: the summed duration of the kernels it
    launches, from torch.profiler (CUDA activity), each run after a 128 MB
    L2 flush whose kernel (``bitwise_not``) is left out. Unlike ``time_ms``
    it excludes the host's time to enqueue the call, which for a kernel of
    tens of microseconds is most of a lone call's span. A trace with no
    device time is taken once more (CUPTI has returned an empty window on
    the card); if the second is empty too, falls back to ``time_ms`` and
    says so. Returns (ms, how, {kernel name: ms per call}, {kernel name:
    launches the trace recorded, against ``reps`` calls})."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(32 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        # each kernel's mean time per launch, times its launches per call:
        # a trace that lost some records (CUPTI's buffers can drop them)
        # still gives each kernel's time, where dividing its total by
        # ``reps`` would undercount it
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "bitwise_not" not in e.key.lower() and e.self_device_time_total > 0]
        parts = {e.key[:60]: e.self_device_time_total / 1e3 / e.count
                 * max(1, round(e.count / reps)) for e in events}
        if parts:
            return sum(parts.values()), "profiler", parts, {e.key[:60]: e.count for e in events}
    return time_ms(torch, fn, reps, warmup), "events", {}, {}


def host_us(torch, fn, reps):
    """Mean host time to issue one call of ``fn``: ``reps`` calls back to
    back with no synchronisation between them (a serving step issues its
    layers' calls so), the wrapper's Python and its launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def timings(torch, kernel, plain, library, reps):
    """Device times of the kernel, its plain version and the library call
    (None where no one PyTorch call computes the function), the kernel's
    event-timed span (host enqueue included) and its host time a call."""
    k_ms, how, parts, records = device_ms(torch, kernel, reps)
    p_ms = device_ms(torch, plain, 2, warmup=1)[0]
    l_ms = device_ms(torch, library, reps)[0] if library is not None else None
    return dict(kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, timing=how,
                kernel_parts=parts, kernel_records=records, timed_calls=reps,
                kernel_event_ms=time_ms(torch, kernel, reps),
                kernel_host_us=host_us(torch, kernel, reps))


def library_call(torch, case):
    """``scaled_dot_product_attention`` over the same segments as one padded
    batch (segment x heads x max q_len x max visible keys) with a boolean
    mask; K/V pre-gathered into contiguous tensors and expanded to the query
    heads. Returns the call and a map of its output to packed rows, for a
    sanity check."""
    import torch.nn.functional as F

    q, k_pages, v_pages = case["q"], case["k"], case["v"]
    _, KV, G, d = q.shape
    H = KV * G
    page, w = case["page"], case["window"]
    segs = [(ql, kl) for ql, kl in case["segs"]]
    B, Lq, Lk = len(segs), max(ql for ql, _ in segs), max(kl for _, kl in segs)
    qb = torch.zeros((B, H, Lq, d), dtype=q.dtype, device="cuda")
    kb = torch.zeros((B, KV, Lk, d), dtype=q.dtype, device="cuda")
    vb = torch.zeros_like(kb)
    mask = torch.zeros((B, 1, Lq, Lk), dtype=torch.bool, device="cuda")
    cu = case["cu"].tolist()
    for s, (ql, kl) in enumerate(segs):
        qb[s, :, :ql] = q[cu[s]:cu[s] + ql].reshape(ql, H, d).transpose(0, 1)
        n = -(-kl // page)
        pages = case["tables"][s, :n].long()
        kb[s, :, :kl] = k_pages[pages].reshape(n * page, KV, d)[:kl].transpose(0, 1)
        vb[s, :, :kl] = v_pages[pages].reshape(n * page, KV, d)[:kl].transpose(0, 1)
        qp = torch.arange(kl - ql, kl, device="cuda")[:, None]
        kp = torch.arange(Lk, device="cuda")[None, :]
        ok = kp <= qp
        if w is not None:
            ok &= kp > qp - w
        mask[s, 0, :ql] = ok
    mask[:, :, :, 0] |= ~mask.any(-1)  # padded query rows: one harmless key
    kb, vb = kb.repeat_interleave(G, 1), vb.repeat_interleave(G, 1)  # GQA: head h = kv*G + g

    def call():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    def rows(o):
        parts = [o[s, :, :ql].transpose(0, 1).reshape(ql, KV, G, d)
                 for s, (ql, _) in enumerate(segs)]
        return torch.cat(parts)

    return call, rows


def segment_library_calls(torch, case):
    """``scaled_dot_product_attention`` once per segment, each over its own
    keys only (K/V pre-gathered and expanded to the query heads; a boolean
    mask where a chunk's rows see different keys), for cases whose padded
    batch would hold every segment at the longest row's length. Returns one
    call that runs them all in turn (its device time is their sum) and a map
    of its outputs to packed rows."""
    import torch.nn.functional as F

    q, k_pages, v_pages = case["q"], case["k"], case["v"]
    _, KV, G, d = q.shape
    H = KV * G
    page, w = case["page"], case["window"]
    cu = case["cu"].tolist()
    segs = []
    for s, (ql, kl) in enumerate(case["segs"]):
        n = -(-kl // page)
        pages = case["tables"][s, :n].long()
        kb = k_pages[pages].reshape(n * page, KV, d)[:kl].transpose(0, 1)[None]
        vb = v_pages[pages].reshape(n * page, KV, d)[:kl].transpose(0, 1)[None]
        qb = q[cu[s]:cu[s] + ql].reshape(ql, H, d).transpose(0, 1)[None].contiguous()
        qp = torch.arange(kl - ql, kl, device="cuda")[:, None]
        kp = torch.arange(kl, device="cuda")[None, :]
        ok = kp <= qp
        if w is not None:
            ok &= kp > qp - w
        mask = None if bool(ok.all()) else ok[None, None]
        segs.append((qb, kb.repeat_interleave(G, 1).contiguous(),
                     vb.repeat_interleave(G, 1).contiguous(), mask, ql))

    def call():
        return [F.scaled_dot_product_attention(qb, kb, vb, attn_mask=m)
                for qb, kb, vb, m, _ in segs]

    def rows(outs):
        return torch.cat([o[0].transpose(0, 1).reshape(ql, KV, G, d)
                          for o, (*_, ql) in zip(outs, segs)])

    return call, rows


def tol_used(got, plain, dtype):
    """The largest error over its allowance (at most 1 passes): fp32 |err| <=
    1e-4 (1 + |plain|); bf16 the tighter of 2e-2 (1 + |plain|) and 2^-7 |plain|
    + 2e-2 rms of the plain row. NaN anywhere gives NaN, which fails."""
    import torch

    err = (got - plain).abs()
    allow = TOL[dtype] * (1 + plain.abs())
    if dtype == "bfloat16":
        rtol, scale = BF16_ROW
        rms = plain.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
        allow = torch.minimum(allow, rtol * plain.abs() + scale * rms)
    return float((err / allow).max())


def parity_record(torch, name, kernel, dtype, got, plain, faults, shape):
    """The parity record of one case: ``got`` (the kernel's live rows) and
    ``plain`` (the plain version's, fp32) have rows on their first axis;
    ``faults`` are plain outputs with the softcap or the window dropped,
    which the check must reject ``FAULT_MARGIN`` times over."""
    real = got.float()
    finite = bool(torch.isfinite(real).all())
    used = tol_used(real, plain, dtype)
    fault_used = {k: tol_used(f, plain, dtype) for k, f in faults.items()}
    return dict(phase="kernel_parity", case=name, kernel=kernel, dtype=dtype, shape=shape,
                max_abs_err=float((real - plain).abs().max()),
                plain_rms=float(plain.pow(2).mean().sqrt()), tol_used=used,
                fault_tol_used=fault_used, finite=finite,
                ok=finite and used <= 1 and all(u >= FAULT_MARGIN for u in fault_used.values()))


def finish(rec):
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"kernel_parity {rec['case']}: {rec}")
    return rec


@contextlib.contextmanager
def recorded_scratch():
    """Keeps every scratch B1's wrapper makes inside the block, in call
    order, so that the plan each launch ran can be read back from it."""
    import repro_torch.kernels.paged_attention as pa

    made, real = [], pa.key_split_workspace

    def recording(q, n_tiles, n_split, sms):
        made.append((real(q, n_tiles, n_split, sms), n_split, sms))
        return made[-1][0]

    pa.key_split_workspace = recording
    try:
        yield made
    finally:
        pa.key_split_workspace = real


def plan_check(torch, made, q, k_pages, cu_q_lens, kv_lens, block_tables, tiles, window):
    """The plan one B1 launch ran, read back from its scratch (``made``, one
    entry of ``recorded_scratch``): each leading tile's kind and live spans,
    the heavy CTAs' span and the partial slots used, against
    ``ref.mixed_split_plan`` on the same inputs."""
    from repro_torch.kernels.paged_attention import key_splits, q_tile_rows
    from repro_torch.kernels.ref import mixed_split_plan

    sc, n_split, sms = made
    _, KV, G, d = q.shape
    n_tiles = tiles.shape[0]
    ints = sc.tensor[:sc.o_part].view(torch.int32).cpu()
    cap = n_tiles * n_split
    counts = ints[sc.counts:sc.counts + 3].tolist()
    items = ints[:4 * cap].view(2, cap, 2)
    card = {}
    for kind in (0, 1):
        for t, split in items[kind, :counts[kind]].tolist():
            card.setdefault(t, (kind, []))[1].append(split)
    card = {t: (kind, sorted(splits)) for t, (kind, splits) in card.items()}
    bf16 = q.dtype == torch.bfloat16
    span = key_splits(block_tables.shape[1] * k_pages.shape[1])[1]
    cu, lens = cu_q_lens.tolist(), kv_lens.tolist()
    ctas, heavy_span = mixed_split_plan(
        tiles.cpu().tolist(), cu, lens, tile_rows=q_tile_rows(G), group=G, span_keys=span,
        pair=bf16, light_max=16 if bf16 else 0, n_kv=KV, sms=sms, window=window or None)
    plain = {c["tile"]: (c["kind"], list(range(len(c["spans"])))) for c in ctas}
    slots = sum(len(c["spans"]) * c["m_eff"] for c in ctas if len(c["spans"]) > 1)
    q_lens = [hi - lo for lo, hi in zip(cu, cu[1:])]
    seg_of = {c["tile"]: c["seg"] for c in ctas}
    return dict(matches=card == plain and int(ints[sc.counts + 5]) == heavy_span
                and counts[2] == slots,
                ctas=len(card), items=counts[0] + counts[1], slots=counts[2],
                slot_cap=(sc.ml_part - sc.o_part) // (KV * d), heavy_span=heavy_span,
                max_decode_splits=max((len(card[t][1]) for t in card
                                       if q_lens[seg_of.get(t, 0)] == 1), default=0),
                decode_only=max(q_lens) == 1,
                mixed=max(q_lens) > 1 and 1 in q_lens)


def run_case(torch, name, case, split_fault=False, library="padded"):
    """One B1 case: parity against the plain version (fp32, same inputs),
    the faults the check must reject (softcap or window dropped; with
    ``split_fault``, the partials combined without rescaling by their
    maxima, as the kernel splits them), then times beside the bound and
    SDPA over the same segments: as one padded batch (``library="padded"``)
    or one call a segment, summed (``"segments"``)."""
    from repro_torch.kernels.paged_attention import cta_rows, key_splits, mixed_paged_attention
    from repro_torch.kernels.ref import mixed_attention_ref, mixed_split_ref

    dtype = str(case["q"].dtype).replace("torch.", "")
    args = (case["q"], case["k"], case["v"], case["cu"], case["kv_lens"], case["tables"])
    w, cap = case["window"], case["softcap"]
    kw = dict(window=w, softcap=cap)
    with recorded_scratch() as made:
        got = mixed_paged_attention(*args, **kw, tiles=case["tiles"])
    torch.cuda.synchronize()
    plan = plan_check(torch, made[0], case["q"], case["k"], case["cu"], case["kv_lens"],
                      case["tables"], case["tiles"], w)
    # the plain version in fp32 from the same inputs
    plain_args = (*(a.float() for a in args[:3]), *args[3:])
    plain = mixed_attention_ref(*plain_args, **kw)
    n = case["n_real"]
    # the check must see a kernel that ignored the softcap or the window
    faults = {}
    if cap is not None:
        faults["no_softcap"] = mixed_attention_ref(*plain_args, window=w)[:n]
    if w is not None:
        faults["no_window"] = mixed_attention_ref(*plain_args, softcap=cap)[:n]
    n_split, span = key_splits(case["tables"].shape[1] * case["page"])
    if split_fault:
        faults["no_rescale"] = mixed_split_ref(
            *plain_args, cta_rows=cta_rows(case["q"].dtype, case["q"].shape[2]),
            span_keys=span, rescale=False, **kw)[:n]
    rec = parity_record(torch, name, "mixed_paged_attention", dtype, got[:n], plain[:n], faults,
                        dict(rows=n, segments=len(case["segs"]), kv=case["q"].shape[1],
                             g=case["q"].shape[2], d=case["q"].shape[3], page=case["page"],
                             window=w, softcap=cap, n_split=n_split, span_keys=span))
    rec.update(plan=plan, ok=rec["ok"] and plan["matches"] and plan["slots"] <= plan["slot_cap"])
    del faults  # fp32 copies of every row: free before the timed calls
    nbytes, flops = work(case)
    b, by = bound_of(nbytes, flops, dtype)
    if library == "padded":
        call, rows = library_call(torch, case)
        lib_name = ("torch.nn.functional.scaled_dot_product_attention (padded batch, "
                    "boolean mask, KV pre-gathered)")
    else:
        call, rows = segment_library_calls(torch, case)
        lib_name = ("torch.nn.functional.scaled_dot_product_attention, one call a segment "
                    "summed (KV pre-gathered; boolean mask for chunks)")
    lib_err = float((rows(call()).float() - plain[:n]).abs().max())
    rec.update(
        **timings(torch, lambda: mixed_paged_attention(*args, **kw, tiles=case["tiles"]),
                  lambda: mixed_attention_ref(*args, **kw), call, reps=10),
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops, library=lib_name,
        library_max_abs_err=lib_err)
    return finish(rec)


def kernel_parity(torch):
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    llama = dict(kv=8, g=4, d=128, page=16)
    decode16 = [(1, int(c)) for c in np.linspace(1024, 32768, 16)]
    mixed = [(1, int(c)) for c in np.linspace(1024, 4096, 8)] + [(512, 4096 + 512)]
    small = [(1, 37), (1, 300), (64, 64 + 700), (17, 17), (1, 1)]
    gemma = dict(kv=4, g=2, d=256, page=16)
    local = dict(window=4096, softcap=50.0, q_scale=64.0)
    gemma_mixed = [(1, int(c)) for c in np.linspace(1000, 8192, 6)] + [(300, 7000), (200, 3000)]
    cases = [
        ("decode16_bf16", 1, decode16, dict(llama, dtype=bf16)),
        ("mixed_bf16", 2, mixed, dict(llama, dtype=bf16)),
        ("decode16_fp32", 3, decode16, dict(llama, dtype=f32)),
        ("mixed_fp32", 4, mixed, dict(llama, dtype=f32)),
        ("page1_fp32", 5, small, dict(llama, page=1, dtype=f32)),
        ("page1_bf16", 6, small, dict(llama, page=1, dtype=bf16)),
        # caps of 3-5 bend unit-normal scores (a cap of 50 would not)
        ("window_softcap_bf16", 7, mixed,
         dict(llama, dtype=bf16, window=1024, softcap=3.0)),
        ("window_softcap_fp32", 8, small,
         dict(llama, dtype=f32, window=100, softcap=5.0)),
        ("reduced_d16_fp32", 9, small, dict(kv=2, g=2, d=16, page=4, dtype=f32)),
        ("reduced_d16_bf16", 10, small, dict(kv=2, g=2, d=16, page=4, dtype=bf16,
                                              window=16, softcap=3.0)),
        ("d32_g8_fp32", 11, small, dict(kv=1, g=8, d=32, page=8, dtype=f32)),
        ("d64_g1_bf16", 12, small, dict(kv=4, g=1, d=64, page=8, dtype=bf16)),
        # G 64: a q-tile is one row, a bf16 CTA two, and a decode row is no
        # light item (64 vectors): B1's wgmma path at its widest group
        ("d128_g64_bf16", 21, small, dict(kv=1, g=64, d=128, page=8, dtype=bf16,
                                          window=100, softcap=5.0)),
        # gemma2-2b's attention (KV 4, G 2, d 256, window 4096 on its local
        # layers, softcap 50): decode rows and two chunks at lengths up to
        # 8192, so the window bites; queries scaled by 64 so that scores
        # reach several times the cap
        ("gemma2_mixed_bf16", 13, gemma_mixed, dict(gemma, dtype=bf16, **local)),
        ("gemma2_mixed_fp32", 14, gemma_mixed, dict(gemma, dtype=f32, **local)),
        ("gemma2_global_bf16", 15, gemma_mixed, dict(gemma, dtype=bf16, softcap=50.0,
                                                      q_scale=64.0)),
    ]
    # the split over keys: each case also rejects a combine that sums the
    # partials without rescaling them by their maxima
    long_rows = [(1, 8192), (1, 32768), (1, 65536), (1, 131072), (512, 4096 + 512)]
    windowed = [(1, int(c)) for c in np.linspace(8192, 32768, 8)] + [(256, 16384)]
    short = [(1, 1), (1, 17), (1, 64), (1, 65), (1, 200), (1, 300), (40, 300), (1, 32768)]
    split_cases = [
        # Llama3.1's context: 4 decode rows up to 131072 keys (537 MB of
        # K/V); SDPA a segment, since a padded batch would hold every
        # segment at 131072 keys
        ("decode_long_bf16", 16, long_rows, dict(llama, dtype=bf16), "segments"),
        # each row's 1024 window keys in 2 spans of 512; keys left of it never read
        ("split_window_bf16", 17, windowed, dict(llama, dtype=bf16, window=1024, softcap=3.0),
         "padded"),
        # the short rows' CTAs hold one span; the 32K row's 64
        ("split_short_rows_bf16", 18, short, dict(llama, dtype=bf16), "padded"),
        ("split_short_rows_fp32", 19, short, dict(llama, dtype=f32), "padded"),
        ("page1_long_fp32", 20, [(1, 3000), (1, 700), (33, 600), (1, 1)],
         dict(llama, page=1, dtype=f32), "padded"),
    ]
    recs = {}
    for name, seed, segs, kw in cases:
        case = make_case(torch, seed, segs, **kw)
        recs[name] = run_case(torch, name, case)
        del case
        torch.cuda.empty_cache()
    for name, seed, segs, kw, library in split_cases:
        case = make_case(torch, seed, segs, **kw)
        recs[name] = run_case(torch, name, case, split_fault=True, library=library)
        del case
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# kernel_parity: B2 paged_attention, B3 decode_attention (one query per row)
# ---------------------------------------------------------------------------


def _live_range(length, window):
    """Keys [lo, length) a row at position length - 1 reads."""
    return (0 if window is None else max(0, length - window)), length


def row_case(torch, seed, lengths, *, kv, g, d, dtype, cap, page=None, window=None,
             softcap=None, q_scale=1.0, nan_left_of_window=True):
    """One query per row. ``page=None``: B3's dense caches (N, cap, KV, d).
    Else B2's pool of ``cap // page`` pages per row, shuffled, plus a scratch
    page that every dead table entry names (``page == cap`` is the dense
    engine's layout: each row's cache one page). Every dead key — past a
    row's length, in unused pages, and left of its window unless
    ``nan_left_of_window`` is False (the earlier tokens a serving cache
    holds there, which a kernel that ignored the window would read) —
    holds NaN. Values
    drawn on the card from the seed (queries scaled by ``q_scale``); tables
    from a numpy seed, and B2's row tiles from them (``row_tiles``)."""
    import numpy as np

    from repro_torch.kernels.paged_attention import row_tiles

    rng = np.random.default_rng(seed)
    N = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = np.zeros((N, cap), bool)  # the keys each row reads
    held = np.zeros((N, cap), bool)  # the keys that hold values
    for n, L in enumerate(lengths):
        lo, hi = _live_range(L, window)
        live[n, lo:hi] = True
        held[n, lo if nan_left_of_window else 0:hi] = True
    q = q_scale * torch.randn((N, kv, g, d), generator=gen, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tiles = None
    if page is None:
        k = torch.randn((N, cap, kv, d), generator=gen, device="cuda")
        v = torch.randn((N, cap, kv, d), generator=gen, device="cuda")
        dead = torch.from_numpy(~held).cuda()
        k[dead], v[dead] = float("nan"), float("nan")
        tables = None
    else:
        nb = cap // page
        P = N * nb + 1  # the last page is the scratch page
        tables = rng.permutation(N * nb).astype(np.int32).reshape(N, nb)
        used = held.reshape(N, nb, page).any(-1)
        tables[~used] = P - 1
        pool_live = np.zeros((P, page), bool)
        pool_live[tables[used]] = held.reshape(N, nb, page)[used]
        k = torch.randn((P, page, kv, d), generator=gen, device="cuda")
        v = torch.randn((P, page, kv, d), generator=gen, device="cuda")
        dead = torch.from_numpy(~pool_live).cuda()
        k[dead], v[dead] = float("nan"), float("nan")
        tiles = torch.from_numpy(row_tiles(tables, np.asarray(lengths), g)).cuda()
        tables = torch.from_numpy(tables).cuda()
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), lens=lens, tables=tables,
                tiles=tiles, lengths=list(lengths), live=live, window=window, softcap=softcap,
                page=page, cap=cap)


def dense_step_case(torch, seed, segs, *, kv, g, d, dtype, cap, window=None, softcap=None,
                    q_scale=1.0):
    """A dense-engine step's B2 inputs: segment s, (q_len, kv_len), owns
    slot s of a (len(segs) + 1, cap, KV, d) slot cache (the last slot is the
    scratch slot) and gives q_len rows, row j at position kv_len - q_len + j,
    each reading its slot as one page of ``cap`` tokens (table [[s]]), in
    the row tiles the engine builds (``row_tiles``: a chunk's rows share
    tiles). Every key past a slot's kv_len, and the whole scratch slot,
    holds NaN; keys left of a row's window are the slot's own (live for its
    later rows). Carries the rows (for B2 and its plain version) and the
    segments (for the bound and the library call)."""
    import numpy as np

    from repro_torch.kernels.paged_attention import row_tiles

    n_seg = len(segs)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((n_seg + 1, cap, kv, d), generator=gen, device="cuda")
    v = torch.randn((n_seg + 1, cap, kv, d), generator=gen, device="cuda")
    for s, (_, kvl) in enumerate(segs):
        k[s, kvl:], v[s, kvl:] = float("nan"), float("nan")
    k[n_seg], v[n_seg] = float("nan"), float("nan")
    slots = np.array([s for s, (ql, _) in enumerate(segs) for _ in range(ql)], np.int32)
    lengths = [kvl - ql + j + 1 for ql, kvl in segs for j in range(ql)]
    q = q_scale * torch.randn((len(lengths), kv, g, d), generator=gen, device="cuda")
    cu = np.zeros(n_seg + 1, np.int32)
    cu[1:] = np.cumsum([ql for ql, _ in segs])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    lens = np.asarray(lengths, np.int32)
    live = np.arange(cap)[None, :] < lens[:, None]
    if window is not None:
        live &= np.arange(cap)[None, :] >= lens[:, None] - window
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), lens=t(lens),
                tables=t(slots[:, None]), tiles=t(row_tiles(slots[:, None], lens, g)),
                lengths=lengths, live=live, window=window, softcap=softcap, page=cap, cap=cap,
                segs=segs, cu=t(cu), seg_tables=t(np.arange(n_seg, dtype=np.int32)[:, None]),
                n_real=len(lengths))


def paged_ref_rows(q, k_pages, v_pages, lengths, tables, rows=32, **kw):
    """``paged_attention_ref`` over ``rows`` rows at a time: it gathers each
    row's pages, and over a prefill chunk's ~1000 rows with pages of
    ``max_len`` tokens one call would gather tens of GiB."""
    import torch

    from repro_torch.kernels.ref import paged_attention_ref

    return torch.cat([paged_attention_ref(q[i:i + rows], k_pages, v_pages, lengths[i:i + rows],
                                          tables[i:i + rows], **kw)
                      for i in range(0, q.shape[0], rows)])


def row_work(case):
    """Bytes (live keys read once, q read and out written once) and
    operations (4 G d per query head group and live key) of a row case."""
    _, kv, g, d = case["q"].shape
    elem = case["q"].element_size()
    keys = int(case["live"].sum())
    nbytes = keys * kv * d * 2 * elem + 2 * case["q"].numel() * elem
    return nbytes, 4 * keys * kv * g * d


def row_library(torch, case):
    """``scaled_dot_product_attention`` over the same rows as one padded
    batch (row x heads x 1 query x longest live span) with a boolean mask,
    each row's live keys pre-gathered (outside the timed call), zeroed where
    padded, and expanded to the query heads."""
    import torch.nn.functional as F

    q, k, v = case["q"], case["k"], case["v"]
    N, KV, G, d = q.shape
    spans = [_live_range(L, case["window"]) for L in case["lengths"]]
    Lmax = max(hi - lo for lo, hi in spans)
    idx = torch.zeros((N, Lmax), dtype=torch.long)
    ok = torch.zeros((N, Lmax), dtype=torch.bool)
    for n, (lo, hi) in enumerate(spans):
        j = torch.arange(lo, hi)
        if case["page"] is None:
            idx[n, :hi - lo] = n * case["cap"] + j
        else:
            idx[n, :hi - lo] = case["tables"][n].cpu().long()[j // case["page"]] \
                * case["page"] + j % case["page"]
        ok[n, :hi - lo] = True
    idx, ok = idx.cuda(), ok.cuda()
    flat_k, flat_v = k.reshape(-1, KV, d), v.reshape(-1, KV, d)
    kb = torch.where(ok[..., None, None], flat_k[idx], 0).transpose(1, 2)  # (N, KV, L, d)
    vb = torch.where(ok[..., None, None], flat_v[idx], 0).transpose(1, 2)
    kb, vb = kb.repeat_interleave(G, 1).contiguous(), vb.repeat_interleave(G, 1).contiguous()
    qb = q.reshape(N, KV * G, 1, d)
    mask = ok[:, None, None, :]

    def call():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    return call, lambda o: o.reshape(N, KV, G, d)


def b3_plan(torch, q, cap):
    """The launch shape B3's bf16 wrapper picks for ``q`` over a cache of
    ``cap`` keys, held to its Python copy, with the clusters of that shape
    the card holds at once."""
    import ctypes

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import cluster_launchers, cluster_plan

    N, KV, G, d = q.shape
    C, stages = cluster_plan(N * KV, cap, d)
    active = ctypes.c_int(0)
    err = cluster_launchers()[1](d, G, C, stages, ctypes.byref(active))
    return dict(cluster=C, stages=stages, ctas=C * N * KV, clusters=N * KV,
                max_active_clusters=active.value if err == 0 else None,
                matches_ref=(C, stages) == ref.cluster_plan(N * KV, cap, d))


def run_row_case(torch, name, case):
    from repro_torch.kernels.decode_attention import decode_attention, split_count
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import (B3_FAULTS, cluster_shares, decode_attention_ref,
                                         decode_cluster_ref)

    dtype = str(case["q"].dtype).replace("torch.", "")
    w, cap = case["window"], case["softcap"]
    q, k, v, lens, tabs = case["q"], case["k"], case["v"], case["lens"], case["tables"]
    if tabs is None:
        kernel_name = "decode_attention"
        call = lambda **kw: decode_attention(q, k, v, lens, **kw)  # noqa: E731
        plain = lambda k, v, **kw: decode_attention_ref(  # noqa: E731
            q.float(), k.float(), v.float(), lens, **kw)
    else:
        kernel_name = "paged_attention"
        call = lambda **kw: paged_attention(q, k, v, lens, tabs, tiles=case["tiles"],  # noqa: E731
                                            **kw)
        plain = lambda k, v, **kw: paged_ref_rows(  # noqa: E731
            q.float(), k.float(), v.float(), lens, tabs, **kw)
    got = call(window=w, softcap=cap)
    torch.cuda.synchronize()
    expect = plain(k, v, window=w, softcap=cap)
    # the faults read keys left of the window, which hold NaN: zero them there
    k0, v0 = k.float().nan_to_num(), v.float().nan_to_num()
    faults = {}
    if cap is not None:
        faults["no_softcap"] = plain(k0, v0, window=w)
    if w is not None:
        faults["no_window"] = plain(k0, v0, softcap=cap)
    N, KV, G, d = q.shape
    n_tiles = None if tabs is None else case["tiles"].shape[0]
    tiled = n_tiles is not None and n_tiles < N and q.dtype == torch.bfloat16
    shape = dict(rows=N, kv=KV, g=G, d=d, cap=case["cap"], page=case["page"],
                 len_min=min(case["lengths"]), len_max=max(case["lengths"]), window=w,
                 softcap=cap, row_tiles=n_tiles, tensor_core_tiles=tiled)
    cluster = tabs is None and q.dtype == torch.bfloat16
    if cluster:  # B3's bf16 cluster: its plan, and the combines it must not have
        plan = b3_plan(torch, q, case["cap"])
        # a combine without rescaling differs only where a row has two
        # non-empty shares
        shares = max(sum(hi > lo for lo, hi in cluster_shares(n, case["cap"], plan["cluster"], w))
                     for n in case["lengths"])
        plan["most_shares_a_row"] = shares
        for fault in B3_FAULTS if shares > 1 else ("lost_share",):
            faults[fault] = decode_cluster_ref(q.float(), k.float(), v.float(), lens,
                                               cluster=plan["cluster"], window=w, softcap=cap,
                                               fault=fault)
    else:
        shape["n_split"] = split_count((n_tiles if tiled else N) * KV, case["cap"] if tabs is None
                                       else tabs.shape[1] * case["page"])
    rec = parity_record(torch, name, kernel_name, dtype, got, expect, faults, shape)
    if cluster:
        rec.update(plan=plan, ok=rec["ok"] and plan["matches_ref"])
    if "segs" in case:  # a dense-engine step: segments share their slot's keys
        nbytes, flops = work(case)
        lib, rows = library_call(torch, dict(case, tables=case["seg_tables"]))
        lib_name = ("torch.nn.functional.scaled_dot_product_attention (padded segment "
                    "batch, boolean mask, KV pre-gathered)")
    else:
        nbytes, flops = row_work(case)
        lib, rows = row_library(torch, case)
        lib_name = ("torch.nn.functional.scaled_dot_product_attention (padded rows, "
                    "boolean mask, live keys pre-gathered, no softcap)")
    b, by = bound_of(nbytes, flops, dtype)
    rec.update(**timings(torch, lambda: call(window=w, softcap=cap),
                         lambda: plain(k, v, window=w, softcap=cap), lib, reps=20),
               bound_ms=b, bound_by=by, bytes=nbytes, flops=flops, library=lib_name,
               library_max_abs_err=float((rows(lib()).float() - expect).abs().max()))
    if cluster:  # one launch a call: one kernel in the trace, once a call
        rec["launches_per_call"] = {key: round(n / rec["timed_calls"])
                                    for key, n in rec["kernel_records"].items()}
        rec["ok"] = rec["ok"] and rec["timing"] == "profiler" and list(
            rec["launches_per_call"].values()) == [1]
    return finish(rec)


def b3_graph_replay(torch):
    """One ``b3_serial_bf16`` call captured in a CUDA graph, replayed twice
    after new q, K/V and lengths are copied into its inputs: each replay
    must give the bits an eager call gives on those inputs, and the eager
    call must pass the parity check."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    llama = dict(kv=8, g=4, d=128, dtype=torch.bfloat16, cap=8192)
    first = row_case(torch, 180, [4096], **llama)
    q, k, v, lens = (first[x].clone() for x in ("q", "k", "v", "lens"))
    decode_attention(q, k, v, lens)  # the first call opts in, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, lens)
    replays = []
    for seed, length in ((181, 3000), (182, 7777)):
        new = row_case(torch, seed, [length], **llama)
        for name in ("q", "k", "v", "lens"):
            {"q": q, "k": k, "v": v, "lens": lens}[name].copy_(new[name])
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        eager = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        plain = decode_attention_ref(q.float(), k.float(), v.float(), lens)
        replays.append(dict(length=length, bit_equal=bool(torch.equal(replayed, eager)),
                            tol_used=tol_used(eager.float(), plain, "bfloat16"),
                            finite=bool(torch.isfinite(replayed.float()).all())))
    rec = dict(phase="kernel_parity", case="b3_graph_replay_bf16", kernel="decode_attention",
               replays=replays)
    rec["ok"] = all(r["bit_equal"] and r["finite"] and r["tol_used"] <= 1 for r in replays)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"b3_graph_replay_bf16: {rec}")


# ---------------------------------------------------------------------------
# kernel_parity: B4 flash_attention
# ---------------------------------------------------------------------------


def flash_case(torch, seed, B, S, *, kv, g, d, dtype, window=None, softcap=None, cache=None,
               q_scale=1.0):
    """Prompts of S tokens over themselves. K/V are the first S rows of a
    (B, cache, KV, d) cache whose other rows hold NaN, read through the view's
    strides as the serial prefill reads them; queries scaled by ``q_scale``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = cache or S
    q = q_scale * torch.randn((B, S, kv * g, d), generator=gen, device="cuda")
    kc = torch.full((B, cache, kv, d), float("nan"), device="cuda")
    vc = kc.clone()
    kc[:, :S] = torch.randn((B, S, kv, d), generator=gen, device="cuda")
    vc[:, :S] = torch.randn((B, S, kv, d), generator=gen, device="cuda")
    kc, vc = kc.to(dtype), vc.to(dtype)
    return dict(q=q.to(dtype), k=kc[:, :S], v=vc[:, :S], window=window, softcap=softcap,
                cache=cache)


def flash_work(case):
    B, S, H, d = case["q"].shape
    kv = case["k"].shape[2]
    elem = case["q"].element_size()
    w = case["window"]
    pairs = sum(i + 1 if w is None else min(i + 1, w) for i in range(S))
    nbytes = (2 * B * S * H * d + 2 * B * S * kv * d) * elem
    return nbytes, 4 * B * H * d * pairs


def flash_library(torch, case):
    """``scaled_dot_product_attention`` on the same prompts, K/V expanded to
    the query heads (outside the timed call); causal, or a boolean mask for
    a window; no softcap."""
    import torch.nn.functional as F

    q, k, v, w = case["q"], case["k"], case["v"], case["window"]
    B, S, H, d = q.shape
    G = H // k.shape[2]
    qb = q.transpose(1, 2)
    kb = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vb = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    mask = None
    if w is not None:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def call():
        if mask is None:
            return F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    return call, lambda o: o.transpose(1, 2)


def run_flash_case(torch, name, case):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    dtype = str(case["q"].dtype).replace("torch.", "")
    w, cap = case["window"], case["softcap"]
    q, k, v = case["q"], case["k"], case["v"]
    B, S, H, d = q.shape
    rows = lambda o: o.reshape(B * S, H, d, 1)  # noqa: E731  (a token's heads are a row)
    call = lambda **kw: flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda **kw: flash_attention_ref(q.float(), k.float(), v.float(), **kw)  # noqa: E731
    got = call(window=w, softcap=cap)
    torch.cuda.synchronize()
    expect = rows(plain(window=w, softcap=cap))
    faults = {}
    if cap is not None:
        faults["no_softcap"] = rows(plain(window=w))
    if w is not None:
        faults["no_window"] = rows(plain(softcap=cap))
    rec = parity_record(torch, name, "flash_attention", dtype, rows(got), expect, faults,
                        dict(batch=B, seq=S, kv=k.shape[2], g=H // k.shape[2], d=d,
                             cache=case["cache"], window=w, softcap=cap))
    nbytes, flops = flash_work(case)
    b, by = bound_of(nbytes, flops, dtype)
    lib, to_rows = flash_library(torch, case)
    rec.update(**timings(torch, lambda: call(window=w, softcap=cap),
                         lambda: plain(window=w, softcap=cap), lib, reps=10),
               bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
               library="torch.nn.functional.scaled_dot_product_attention (K/V expanded "
                       "to the query heads, causal or window mask, no softcap)",
               library_max_abs_err=float((rows(to_rows(lib())).float() - expect)
                                         .abs().max()))
    return finish(rec)


def single_query_and_flash_parity(torch):
    """B2, B3 and B4 cases: the main paths' shapes (the serial decode at
    4096 of 8192, the dense engine's decode-only and prefill-bearing steps,
    the serial prefill of a 4096-token prompt), kernels_micro's, the reduced model's, pages of 1,
    16 and max_len, window and softcap; every case timed."""
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    llama = dict(kv=8, g=4, d=128)
    micro = dict(kv=2, g=4, d=64)  # benchmarks/kernels_micro.py: H 8, KV 2, d 64
    spread = [int(x) for x in np.linspace(512, 8192, 8)]
    micro_lens = [int(x) for x in np.linspace(64, 2048, 32)]  # kernels_micro's lengths
    small = [1, 37, 300, 1024]
    gemma = dict(kv=4, g=2, d=256)
    # queries scaled by 64: scores reach several times the cap; the keys
    # left of a row's window hold values, so that a kernel that ignored the
    # window would read them
    local = dict(window=4096, softcap=50.0, q_scale=64.0)
    held = dict(local, nan_left_of_window=False)
    recs = {}
    rows = [
        # B3: one query per row over a dense cache
        ("b3_serial_bf16", [4096], dict(llama, dtype=bf16, cap=8192)),
        ("b3_batch_bf16", spread, dict(llama, dtype=bf16, cap=8192)),
        ("b3_batch_fp32", spread, dict(llama, dtype=f32, cap=8192)),
        ("b3_window_softcap_bf16", spread[:4], dict(llama, dtype=bf16, cap=4096, window=1024,
                                                    softcap=3.0)),
        ("b3_window_softcap_fp32", small, dict(llama, dtype=f32, cap=1024, window=100,
                                               softcap=5.0)),
        ("b3_micro_fp32", micro_lens, dict(micro, dtype=f32, cap=8192)),
        ("b3_reduced_d16_fp32", [1, 5, 64], dict(kv=2, g=2, d=16, dtype=f32, cap=64)),
        # the bf16 cluster at its limits: C 16 with rows shorter than a block
        # a CTA (ranks left empty), one key, exactly C x 64 keys; C 16 over
        # a 131072-key row (128 blocks a CTA through a ring of 8) at G 16;
        # the smallest and middle head dims
        ("b3_short_bf16", [100], dict(llama, dtype=bf16, cap=8192)),
        ("b3_one_key_bf16", [1], dict(llama, dtype=bf16, cap=8192)),
        ("b3_exact_c64_bf16", [1024], dict(llama, dtype=bf16, cap=8192)),
        ("b3_long_g16_bf16", [131072], dict(kv=1, g=16, d=64, dtype=bf16, cap=131072)),
        ("b3_d16_g1_bf16", [1, 37, 300, 1024], dict(kv=2, g=1, d=16, dtype=bf16, cap=1024,
                                                    window=100, softcap=5.0)),
        ("b3_d32_g8_bf16", [65, 640, 2000], dict(kv=2, g=8, d=32, dtype=bf16, cap=2048,
                                                 window=700, softcap=3.0)),
        # two n8 tiles of query heads (G > 8) at d 128 and 256
        ("b3_d128_g12_bf16", [1000, 4000], dict(kv=2, g=12, d=128, dtype=bf16, cap=4096)),
        ("b3_d256_g16_bf16", [77, 3000], dict(kv=1, g=16, d=256, dtype=bf16, cap=4096,
                                              window=1000, softcap=50.0, q_scale=64.0,
                                              nan_left_of_window=False)),
        # B2: one query per row through a block table
        ("b2_dense_engine_bf16", [512 + 509 * i for i in range(8)],
         dict(llama, dtype=bf16, cap=8192, page=8192)),
        ("b2_page16_bf16", spread, dict(llama, dtype=bf16, cap=8192, page=16)),
        ("b2_page16_fp32", spread, dict(llama, dtype=f32, cap=8192, page=16)),
        ("b2_page1_fp32", small, dict(llama, dtype=f32, cap=1024, page=1)),
        ("b2_page1_bf16", small, dict(llama, dtype=bf16, cap=1024, page=1)),
        ("b2_window_softcap_bf16", spread, dict(llama, dtype=bf16, cap=8192, page=16,
                                                window=1024, softcap=3.0)),
        ("b2_window_softcap_fp32", small, dict(llama, dtype=f32, cap=1024, page=1,
                                               window=100, softcap=5.0)),
        ("b2_micro_fp32", micro_lens, dict(micro, dtype=f32, cap=8192, page=128)),
        ("b2_reduced_d16_fp32", [1, 5, 64], dict(kv=2, g=2, d=16, dtype=f32, cap=64,
                                                 page=64)),
        # gemma2-2b's attention: KV 4, G 2, d 256, window 4096, softcap 50
        ("b3_gemma2_serial_bf16", [6000], dict(gemma, dtype=bf16, cap=8192, **held)),
        ("b3_gemma2_batch_bf16", spread, dict(gemma, dtype=bf16, cap=8192, **held)),
        ("b3_gemma2_batch_fp32", spread, dict(gemma, dtype=f32, cap=8192, **held)),
        ("b2_gemma2_dense_engine_bf16", [600 + 1080 * i for i in range(8)],
         dict(gemma, dtype=bf16, cap=8192, page=8192, **held)),
        ("b2_gemma2_page16_bf16", spread, dict(gemma, dtype=bf16, cap=8192, page=16, **held)),
        ("b2_gemma2_page16_fp32", spread, dict(gemma, dtype=f32, cap=8192, page=16, **held)),
    ]
    for i, (name, lengths, kw) in enumerate(rows):
        case = row_case(torch, 100 + i, lengths, **kw)
        recs[name] = run_row_case(torch, name, case)
        del case
        torch.cuda.empty_cache()
    b3_graph_replay(torch)
    # B2 on a prefill-bearing step of the dense engine, over a 9 x 8192 slot
    # cache: the step's 512-token budget holds 6 decode rows, the last 235
    # tokens of a 2795-token prompt and the first 271 of the next; 512 rows,
    # the chunks' rows in tiles of 16 (bf16). At gemma2's shapes the same
    # step at lengths up to 8192, with window 4096 and softcap 50.
    dense_step = [(1, n) for n in (600, 1100, 1650, 2300, 2900, 3590)] + [(235, 2795),
                                                                          (271, 271)]
    gemma_step = [(1, n) for n in (1500, 3000, 4500, 6000, 7000, 8000)] + [(235, 5795),
                                                                           (271, 4400)]
    steps = [("b2_dense_prefill_bf16", dense_step, dict(llama, dtype=bf16)),
             ("b2_dense_prefill_fp32", dense_step, dict(llama, dtype=f32)),
             ("b2_gemma2_dense_prefill_bf16", gemma_step, dict(gemma, dtype=bf16, **local)),
             ("b2_gemma2_dense_prefill_fp32", gemma_step, dict(gemma, dtype=f32, **local))]
    for i, (name, segs, kw) in enumerate(steps):
        case = dense_step_case(torch, 150 + i, segs, **kw, cap=8192)
        recs[name] = run_row_case(torch, name, case)
        del case
        torch.cuda.empty_cache()
    flashes = [
        ("b4_prompt4096_bf16", 1, 4096, dict(llama, dtype=bf16, cache=8192)),
        ("b4_prompt1000_bf16", 2, 1000, dict(llama, dtype=bf16)),
        ("b4_prompt4096_fp32", 1, 4096, dict(llama, dtype=f32, cache=8192)),
        ("b4_prompt1000_fp32", 2, 1000, dict(llama, dtype=f32)),
        ("b4_window_softcap_bf16", 1, 1500, dict(llama, dtype=bf16, window=256, softcap=3.0)),
        ("b4_window_softcap_fp32", 2, 300, dict(llama, dtype=f32, window=40, softcap=5.0)),
        ("b4_micro_fp32", 1, 1024, dict(micro, dtype=f32)),  # kernels_micro.py:47
        ("b4_reduced_d16_fp32", 2, 30, dict(kv=2, g=2, d=16, dtype=f32, cache=64)),
        ("b4_g8_d64_bf16", 1, 777, dict(kv=2, g=8, d=64, dtype=bf16)),
        ("b4_reduced_d16_bf16", 2, 100, dict(kv=2, g=2, d=16, dtype=bf16, cache=128, window=16,
                                              softcap=3.0)),
        # gemma2-2b's attention: a local layer's 6000-token prompt read from
        # an 8192 cache, and a global layer's two 1000-token prompts
        ("b4_gemma2_prompt6000_bf16", 1, 6000, dict(gemma, dtype=bf16, cache=8192, **local)),
        ("b4_gemma2_prompt6000_fp32", 1, 6000, dict(gemma, dtype=f32, cache=8192, **local)),
        ("b4_gemma2_prompt1000_bf16", 2, 1000, dict(gemma, dtype=bf16, softcap=50.0,
                                                     q_scale=64.0)),
        ("b4_gemma2_prompt1000_fp32", 2, 1000, dict(gemma, dtype=f32, softcap=50.0,
                                                     q_scale=64.0)),
    ]
    for i, (name, B, S, kw) in enumerate(flashes):
        case = flash_case(torch, 200 + i, B, S, **kw)
        recs[name] = run_flash_case(torch, name, case)
        del case
        torch.cuda.empty_cache()
    return recs


def group_parity(torch):
    """B1-B4 at the GQA groups of qwen2-1.5b (12 query heads over 2 KV heads,
    G 6: a q-tile of 10 rows holds 60 of its 64 query vectors) and
    chatglm3-6b (32 over 2, G 16: a q-tile of 4 rows), d 128, bf16 and fp32,
    at the shapes of their main paths: B1's mixed step and 16 decode rows,
    B2's dense decode-only and prefill-bearing steps, B3's serial decode (G
    6), B4's 4096-token prompt; every case timed."""
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    decode16 = [(1, int(c)) for c in np.linspace(1024, 32768, 16)]
    mixed = [(1, int(c)) for c in np.linspace(1024, 4096, 8)] + [(512, 4096 + 512)]
    dense_step = [(1, n) for n in (600, 1100, 1650, 2300, 2900, 3590)] + [(235, 2795),
                                                                          (271, 271)]
    recs = {}
    for g, seed in ((6, 700), (16, 720)):
        grp = dict(kv=2, g=g, d=128)
        for i, (dtype, tag) in enumerate(((bf16, "bf16"), (f32, "fp32"))):
            name = f"g{g}_mixed_{tag}"
            recs[name] = run_case(torch, name, make_case(torch, seed + i, mixed, page=16,
                                                         dtype=dtype, **grp))
            name = f"g{g}_decode16_{tag}"
            recs[name] = run_case(torch, name, make_case(torch, seed + 2 + i, decode16,
                                                         page=16, dtype=dtype, **grp))
            name = f"b2_g{g}_dense_engine_{tag}"
            recs[name] = run_row_case(torch, name, row_case(
                torch, seed + 4 + i, [512 + 509 * j for j in range(8)], dtype=dtype, cap=8192,
                page=8192, **grp))
            name = f"b2_g{g}_dense_prefill_{tag}"
            recs[name] = run_row_case(torch, name, dense_step_case(
                torch, seed + 6 + i, dense_step, dtype=dtype, cap=8192, **grp))
            if g == 6:
                name = f"b3_g{g}_serial_{tag}"
                recs[name] = run_row_case(torch, name, row_case(
                    torch, seed + 8 + i, [4096], dtype=dtype, cap=8192, **grp))
            name = f"b4_g{g}_prompt4096_{tag}"
            recs[name] = run_flash_case(torch, name, flash_case(
                torch, seed + 10 + i, 1, 4096, dtype=dtype, cache=8192, **grp))
            torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# kernel_parity: B5 ssd_chunk_scan
# ---------------------------------------------------------------------------


def ssd_case(torch, seed, B, S, *, nh, hd, G, ds, dtype, mamba_decay=True, dt_top=False):
    """One Mamba2 layer's B5 inputs on the card. x, B and C are column slices
    of one (B, S, nh hd + 2 G ds) conv output, read through its strides as
    ``mamba2_apply`` hands them over; h0 is a carried state. With
    ``mamba_decay`` the decay rates are Mamba2-2.7B's own (A_log = log(1..nh),
    dt = softplus(raw + dt_bias) with dt_bias from the init's range), else
    A = -exp(0.3 N) and dt = softplus(N); ``dt_top`` pins dt at the top of
    the init's range, 0.1, where the strongest head's decay exponent falls by
    8 a token."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    d_in = nh * hd
    xbc = torch.randn((B, S, d_in + 2 * G * ds), generator=gen, device=dev)
    xbc[..., d_in:] *= 0.5
    xbc = xbc.to(dtype)
    x = xbc[..., :d_in].unflatten(-1, (nh, hd))
    Bm = xbc[..., d_in:d_in + G * ds].unflatten(-1, (G, ds))
    Cm = xbc[..., d_in + G * ds:].unflatten(-1, (G, ds))
    raw = torch.randn((B, S, nh), generator=gen, device=dev)
    if mamba_decay:
        A = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
        u = torch.rand((nh,), generator=gen, device=dev)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt = F.softplus(0.5 * raw + torch.log(torch.expm1(dt_init)))
        if dt_top:
            dt = torch.full_like(dt, 0.1)
    else:
        A = -torch.exp(0.3 * torch.randn((nh,), generator=gen, device=dev))
        dt = F.softplus(raw)
    h0 = torch.randn((B, nh, hd, ds), generator=gen, device=dev)
    return dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0)


def ssd_work(case):
    """Bytes (x, dt, A, B, C and h0 read once; y and hT written once) and
    operations of the chunked scan at the kernel's chunk L on this case's
    sequence: per chunk C B^T per group (2 L^2 ds), and per head the
    lower-triangular W x (L (L + 1) hd), the inter-chunk C h (2 L ds hd) and
    the state update (2 L hd ds)."""
    from repro_torch.kernels.ref import SSD_CHUNK as L

    x, Bm = case["x"], case["Bm"]
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    elem = x.element_size()
    nbytes = (2 * x.numel() * elem + 2 * Bm.numel() * elem + case["dt"].numel() * 4 + nh * 4
              + 2 * B * nh * hd * ds * 4)
    nc = -(-S // L)
    flops = B * nc * (G * 2 * L * L * ds + nh * (L * (L + 1) * hd + 4 * L * ds * hd))
    return nbytes, flops


def ssd_no_carry(case):
    """The plain version with the state dropped between the kernel's chunks:
    each chunk starts again from h0."""
    import torch

    from repro_torch.kernels.ref import SSD_CHUNK as L
    from repro_torch.kernels.ref import ssd_chunk_ref

    S = case["x"].shape[1]
    parts = [ssd_chunk_ref(*(case[k][:, t:t + L].float() for k in ("x", "dt")), case["A"],
                           *(case[k][:, t:t + L].float() for k in ("Bm", "Cm")), case["h0"])[0]
             for t in range(0, S, L)]
    return torch.cat(parts, dim=1)


def ssd_rows(t):
    """y (B, S, nh, hd) as token rows, hT (B, nh, hd, ds) as head rows, for
    ``tol_used``."""
    return t.reshape(t.shape[0] * t.shape[1], t.shape[2], t.shape[3], 1)


def ssd_schedule_check(torch, case):
    """The schedule the kernel's library makes for this case (grid, hd
    columns an item, items a chunk, ring slots, chunks, scratch bytes)
    against its Python copy, ``ref.ssd_chunk_schedule``."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.decode_attention import DTYPE_CODES
    from repro_torch.kernels.ref import ssd_chunk_schedule

    x, Bm = case["x"], case["Bm"]
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = ssd.schedule(B, S, nh, hd, G, ds, DTYPE_CODES[x.dtype], sms)
    plain = ssd_chunk_schedule(B, S, nh, hd, G, ds, bf16=x.dtype == torch.bfloat16, sms=sms)
    return dict(card, sms=sms, matches=all(card[k] == plain[k] for k in card))


def run_ssd_case(torch, name, case):
    from repro_torch.kernels.ref import SSD_CHUNK, ssd_chunk_parallel_ref, ssd_chunk_ref
    from repro_torch.kernels.ssd import ssd_chunk_scan

    x = case["x"]
    dtype = str(x.dtype).replace("torch.", "")
    args = (x, case["dt"], case["A"], case["Bm"], case["Cm"], case["h0"])
    y, hT = ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    fargs = (x.float(), case["dt"], case["A"], case["Bm"].float(), case["Cm"].float())
    y_p, h_p = ssd_chunk_ref(*fargs, case["h0"])
    # the check must see a kernel that dropped h0 or the carry between
    # chunks, that carried the predecessor's state without its decay, or
    # that read chunk c - 2's end state in place of chunk c - 1's
    faults = {"no_h0": ssd_rows(ssd_chunk_ref(*fargs)[0]), "no_carry": ssd_rows(ssd_no_carry(case))}
    for fault in ("no_chunk_decay", "stale_state"):
        faults[fault] = ssd_rows(ssd_chunk_parallel_ref(*fargs, case["h0"], fault=fault)[0])
    B, S, nh, hd = x.shape
    G, ds = case["Bm"].shape[2], case["Bm"].shape[3]
    rec = parity_record(torch, name, "ssd_chunk_scan", dtype, ssd_rows(y), ssd_rows(y_p), faults,
                        dict(batch=B, seq=S, nh=nh, hd=hd, groups=G, ds=ds, h0=True,
                             kernel_chunk=SSD_CHUNK, strided_xbc=not x.is_contiguous()))
    del faults
    rec["schedule"] = ssd_schedule_check(torch, case)
    # a second call on the same inputs reuses the scratch under the next
    # epoch, with no reset between: it must give the same result
    y2, h2 = ssd_chunk_scan(*args)
    rec["repeat_equal"] = bool(torch.equal(y2, y) and torch.equal(h2, hT))
    # the final state is fp32 on both sides, from the same inputs
    h_used = tol_used(ssd_rows(hT), ssd_rows(h_p), "float32")
    cum = torch.cumsum(case["dt"] * case["A"], dim=1)
    L = min(S, SSD_CHUNK)
    rec.update(hT_max_abs_err=float((hT - h_p).abs().max()), hT_tol_used=h_used,
               hT_finite=bool(torch.isfinite(hT).all()),
               # the largest exponent the masked triangle would take: the
               # decay over a chunk of the strongest head
               above_diag_max_exponent=float(-(cum[:, L - 1] - cum[:, 0]).min()))
    rec["ok"] = (rec["ok"] and h_used <= 1 and rec["hT_finite"] and rec["schedule"]["matches"]
                 and rec["repeat_equal"])
    nbytes, flops = ssd_work(case)
    b, by = bound_of(nbytes, flops, dtype)
    rec.update(**timings(torch, lambda: ssd_chunk_scan(*args), lambda: ssd_chunk_ref(*args), None,
                         reps=10),
               bound_ms=b, bound_by=by, bytes=nbytes, flops=flops, library=NO_LIBRARY)
    return finish(rec)


def ssd_parity(torch):
    """B5 cases: Mamba2-2.7B's widths (nh 80, hd 64, G 1, ds 128) at a
    ragged 100 tokens, a 512-token serving segment and a 4096-token prompt;
    two groups; the reduced model's widths; and the overflow case (the real
    decay rates with dt at 0.1); fp32 and bf16, h0 given throughout."""
    bf16, f32 = torch.bfloat16, torch.float32
    m2 = dict(nh=80, hd=64, G=1, ds=128)
    cases = [
        ("b5_s512_bf16", 1, 512, dict(m2, dtype=bf16)),
        ("b5_s100_bf16", 1, 100, dict(m2, dtype=bf16)),
        ("b5_s4096_bf16", 1, 4096, dict(m2, dtype=bf16)),
        ("b5_s512_fp32", 1, 512, dict(m2, dtype=f32)),
        ("b5_s100_fp32", 1, 100, dict(m2, dtype=f32)),
        ("b5_s4096_fp32", 1, 4096, dict(m2, dtype=f32)),
        ("b5_g2_fp32", 2, 256, dict(nh=8, hd=32, G=2, ds=32, dtype=f32, mamba_decay=False)),
        ("b5_g2_bf16", 2, 200, dict(nh=8, hd=32, G=2, ds=32, dtype=bf16, mamba_decay=False)),
        ("b5_reduced_fp32", 2, 77, dict(nh=16, hd=8, G=1, ds=16, dtype=f32)),
        ("b5_overflow_fp32", 1, 300, dict(m2, dtype=f32, dt_top=True)),
        ("b5_overflow_bf16", 1, 300, dict(m2, dtype=bf16, dt_top=True)),
    ]
    recs = {}
    for i, (name, B, S, kw) in enumerate(cases):
        case = ssd_case(torch, 500 + i, B, S, **kw)
        recs[name] = run_ssd_case(torch, name, case)
        del case
        torch.cuda.empty_cache()
    return recs


def b5_scratch_checks(torch):
    """B5's scratch under graph replay, on a second stream and at the wrap of
    its epoch, at b5_s512_bf16's shape:

    * ``b5_graph_replay_bf16``: the scratch reserved on a side stream
      (``ssd.reserve_scratch``), one call captured there, the graph replayed
      twice after new inputs are copied into its inputs: each replay equals
      an eager call on those inputs bit for bit, is within tolerance of the
      plain version, and moves the captured scratch's epoch word on by one;
    * ``b5_second_stream``: a call on a second stream runs on a scratch of
      its own and gives the default stream's bits;
    * ``b5_epoch_wrap``: with the epoch word at 2^32 - 1 the call is right,
      its last CTA zeroes the ticket, the flags and the states and sets the
      word to 1, and the next call gives the same bits at epoch 1;
    * ``b5_capture_unreserved``: capturing a call on a stream whose scratch
      was never sized raises before anything is launched."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ref import ssd_chunk_ref

    m2 = dict(nh=80, hd=64, G=1, ds=128, dtype=torch.bfloat16)
    names = ("x", "dt", "A", "Bm", "Cm", "h0")
    case = ssd_case(torch, 600, 1, 512, **m2)
    args = tuple(case[k] for k in names)
    cur = torch.cuda.current_stream()

    def word(stream):
        return int(ssd._SCRATCH[(0, stream.cuda_stream)].tensor.view(torch.int32)[
            ssd.EPOCH_WORD]) & 0xFFFFFFFF

    def plain_used(y, hT):
        fargs = (case["x"].float(), case["dt"], case["A"], case["Bm"].float(),
                 case["Cm"].float(), case["h0"])
        y_p, h_p = ssd_chunk_ref(*fargs)
        return max(tol_used(ssd_rows(y.float()), ssd_rows(y_p), "bfloat16"),
                   tol_used(ssd_rows(hT), ssd_rows(h_p), "float32"))

    side = torch.cuda.Stream()
    reserved = ssd.reserve_scratch(1, 512, 80, 64, 1, 128, torch.bfloat16, stream=side)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        ssd.ssd_chunk_scan(*args)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y, hT = ssd.ssd_chunk_scan(*args)
    replays = []
    for seed in (601, 602):
        new = ssd_case(torch, seed, 1, 512, **m2)
        for k in names:
            case[k].copy_(new[k])
        torch.cuda.synchronize()
        before = word(side)
        graph.replay()
        torch.cuda.synchronize()
        got = (y.clone(), hT.clone())
        eager = ssd.ssd_chunk_scan(*args)
        torch.cuda.synchronize()
        replays.append(dict(seed=seed, epoch_before=before, epoch_after=word(side),
                            bit_equal=all(torch.equal(a, b) for a, b in zip(got, eager)),
                            tol_used=plain_used(*got)))
    rec = dict(phase="kernel_parity", case="b5_graph_replay_bf16", kernel="ssd_chunk_scan",
               reserved_bytes=reserved, replays=replays)
    rec["ok"] = all(r["bit_equal"] and r["tol_used"] <= 1
                    and r["epoch_after"] == r["epoch_before"] + 1 for r in replays)
    finish(rec)
    del graph, y, hT

    eager = ssd.ssd_chunk_scan(*args)
    two = torch.cuda.Stream()
    two.wait_stream(cur)
    with torch.cuda.stream(two):
        got = ssd.ssd_chunk_scan(*args)
    cur.wait_stream(two)
    torch.cuda.synchronize()
    own = ssd._SCRATCH[(0, two.cuda_stream)].tensor
    rec = dict(phase="kernel_parity", case="b5_second_stream", kernel="ssd_chunk_scan",
               scratches=len(ssd._SCRATCH),
               own_scratch=own.data_ptr() != ssd._SCRATCH[(0, cur.cuda_stream)].tensor.data_ptr(),
               bit_equal=all(torch.equal(a, b) for a, b in zip(got, eager)))
    rec["ok"] = rec["own_scratch"] and rec["bit_equal"]
    finish(rec)

    scratch = ssd._SCRATCH[(0, cur.cuda_stream)].tensor
    scratch.view(torch.int32)[ssd.EPOCH_WORD] = -1  # 2^32 - 1
    wrapped = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    header = [v & 0xFFFFFFFF for v in scratch.view(torch.int32)[:3].tolist()]
    body_zero = bool((scratch[16:] == 0).all())
    after = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    rec = dict(phase="kernel_parity", case="b5_epoch_wrap", kernel="ssd_chunk_scan",
               header_after_wrap=header, body_zero_after_wrap=body_zero,
               epoch_after_next=word(cur),
               wrap_bit_equal=all(torch.equal(a, b) for a, b in zip(wrapped, eager)),
               next_bit_equal=all(torch.equal(a, b) for a, b in zip(after, eager)))
    rec["ok"] = (header == [0, 0, 1] and body_zero and rec["epoch_after_next"] == 2
                 and rec["wrap_bit_equal"] and rec["next_bit_equal"])
    finish(rec)

    fresh = torch.cuda.Stream()
    raised = None
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            ssd.ssd_chunk_scan(*args)
    except RuntimeError as err:
        raised = str(err)
    torch.cuda.synchronize()
    rec = dict(phase="kernel_parity", case="b5_capture_unreserved", kernel="ssd_chunk_scan",
               raised=raised)
    rec["ok"] = raised is not None and "reserve_scratch" in raised
    finish(rec)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _engine_class():
    from repro_torch.serving.engine import Engine

    class CheckedEngine(Engine):
        """The port's engine, counting non-finite logits among the rows it
        samples (the logits the engine consumes)."""

        nonfinite = 0

        def _sample_rows(self, logits_rows):
            self.nonfinite += int((~logits_rows.isfinite()).sum())
            return super()._sample_rows(logits_rows)

    return CheckedEngine


def reduced_serve(torch):
    """Reduced llama3.1-8b in fp32: the engine on the card (kernel) and on the
    CPU (plain version, itself held to the JAX engine by the CPU tests) must
    give the same greedy tokens."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.paged_attention import mixed_paged_attention
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request

    cfg = reduce_config(get_config("llama3.1-8b"), periods=2)
    cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 17, 9, 30)]
    sched = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                 max_concurrent_prefills=2, kv_block_size=4, num_kv_blocks=16)
    outs, steps = {}, {}
    before = mixed_paged_attention.launches
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device)
        eng = _engine_class()(model, _to(params, device), SchedulerConfig(**sched), max_len=64,
                              device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
        eng.run(max_steps=400)
        outs[device] = [eng.scheduler.requests[r].output for r in range(len(prompts))]
        steps[device] = eng.steps_run
    launches = mixed_paged_attention.launches - before
    rec = dict(phase="reduced_serve", arch=cfg.name, dtype="float32", steps=steps["cuda"],
               kernel_launches=launches, tokens_identical=outs["cpu"] == outs["cuda"],
               preemptions=eng.scheduler.stats.preemptions)
    rec["ok"] = (rec["tokens_identical"] and steps["cpu"] == steps["cuda"]
                 and launches == steps["cuda"] * cfg.n_layers
                 and all(len(o) == 12 for o in outs["cuda"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"reduced_serve: {rec} cpu={outs['cpu']} cuda={outs['cuda']}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def engine_bf16(torch):
    """The engine in bf16 with Llama3.1-8B's attention heads (KV 8, G 4,
    d 128; page 16) at reduced depth and width. Every attention call of the
    run launches the kernel and is also computed by the plain version in fp32
    from the same bf16 tensors (the engine's pool, tables, segments and
    q-tile list), held to the bf16 parity tolerance row by row."""
    import dataclasses

    import numpy as np

    import repro_torch.core.packed_step as packed
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.paged_attention import mixed_paged_attention
    from repro_torch.kernels.ref import mixed_attention_ref
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request

    used, plans = [], []

    def checked(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, **kw):
        with recorded_scratch() as made:
            out = mixed_paged_attention(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables,
                                        **kw)
        plans.append(plan_check(torch, made[0], q, k_pages, cu_q_lens, kv_lens, block_tables,
                                kw["tiles"], kw["window"]))
        plain = mixed_attention_ref(q.float(), k_pages.float(), v_pages.float(), cu_q_lens,
                                    kv_lens, block_tables, window=kw["window"],
                                    softcap=kw["softcap"])
        n = int(cu_q_lens[-1])
        used.append(tol_used(out[:n].float(), plain[:n], "bfloat16"))
        return out

    cfg = dataclasses.replace(reduce_config(get_config("llama3.1-8b"), periods=2, vocab=1024),
                              d_model=256, d_ff=512, n_heads=32, n_kv_heads=8, head_dim=128)
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    eng = _engine_class()(model, model.init(torch.Generator(device="cuda").manual_seed(2)),
                          SchedulerConfig(chunk_size=64, max_decode_batch=3,
                                          prefetch_buffer_bytes=1 << 20,
                                          max_concurrent_prefills=2, kv_block_size=16,
                                          num_kv_blocks=64), max_len=512, device="cuda")
    rng = np.random.default_rng(2)
    for rid, n in enumerate((40, 170, 75, 300)):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                           max_new_tokens=16))
    launches = mixed_paged_attention.launches
    packed.mixed_paged_attention = checked
    eng.run(max_steps=400)
    packed.mixed_paged_attention = mixed_paged_attention
    launches = mixed_paged_attention.launches - launches
    done = all(len(eng.scheduler.requests[r].output) == 16 for r in range(4))
    rec = dict(phase="engine_bf16", arch=cfg.name, kv=cfg.n_kv_heads,
               g=cfg.n_heads // cfg.n_kv_heads, d=cfg.head_dim, layers=cfg.n_layers,
               steps=eng.steps_run, kernel_launches=launches, calls_checked=len(used),
               tol_used_max=max(used), tol_used_median=float(np.median(used)),
               plans_checked=len(plans),
               plans_matching=sum(p["matches"] and p["slots"] <= p["slot_cap"] for p in plans),
               decode_only_calls=sum(p["decode_only"] for p in plans),
               mixed_calls=sum(p["mixed"] for p in plans),
               max_decode_splits=max(p["max_decode_splits"] for p in plans),
               nonfinite_logits=eng.nonfinite, all_completed=done)
    rec["ok"] = (done and launches == len(used) == len(plans) == eng.steps_run * cfg.n_layers
                 and max(used) <= 1 and eng.nonfinite == 0
                 and rec["plans_matching"] == len(plans) and rec["decode_only_calls"] > 0
                 and rec["mixed_calls"] > 0 and rec["max_decode_splits"] > 1)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"engine_bf16: {rec}")


# the archs that share Llama3.1-8B's paths, each with its published GQA group
ARCH_GROUPS = {"gemma2-2b": 2, "qwen2-1.5b": 6, "chatglm3-6b": 16, "qwen3-32b": 8,
               "llama3.1-70b": 8}


def _drawn_leaves(torch, tree, gen):
    """The parameters with every bias drawn from N(0, 0.5^2) and every norm
    scale from 1 + N(0, 0.3^2) (the init makes zeros and ones, which would
    hide a leaf that the path dropped)."""
    if isinstance(tree, dict):
        return {k: (0.5 * torch.randn(v.shape, generator=gen) if k == "b" else
                    1 + 0.3 * torch.randn(v.shape, generator=gen) if k == "scale" else
                    _drawn_leaves(torch, v, gen)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_drawn_leaves(torch, v, gen) for v in tree]
    return tree


def _serial_gap(torch, model, params, prompt, n_new, max_len):
    """The smallest top-2 logit gap over a prompt's greedy serial steps."""
    cache = model.init_cache(1, max_len)
    logits, _ = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                              cache, 0)
    gaps = []
    for i in range(n_new):
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
        tok = torch.tensor([[int(logits[0].argmax())]], dtype=torch.int32)
        if i < n_new - 1:
            logits, _ = model.decode_step(params, tok, cache, len(prompt) + i)
    return min(gaps)


def reduced_archs(torch):
    """The five archs of ``ARCH_GROUPS`` at reduced widths (d_model 64,
    head_dim 16, two periods) with each one's published group (2 KV heads,
    2 G query heads: G 2, 6, 16, 8, 8), fp32, biases and norm scales drawn
    from a seed, gemma2's softcaps at 2.0 and its window of 16 below three
    of the four prompts: the paged engine on the card (B1) gives the CPU's
    greedy tokens (plain versions, which the CPU tests hold to the JAX
    package), and for gemma2 so do the dense engine (B2) and the serial
    path (B4, B3). Each record carries the smallest top-2 logit gap of the
    CPU's serial steps."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request
    from repro_torch.serving.serial import serial_reference

    sched = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                 max_concurrent_prefills=2, kv_block_size=4, num_kv_blocks=16)
    new, max_len = 12, 64
    for arch, g in ARCH_GROUPS.items():
        kw = dict(n_heads=2 * g, n_kv_heads=2)
        if arch == "gemma2-2b":
            kw.update(attn_logit_softcap=2.0, final_logit_softcap=2.0)
        cfg = dataclasses.replace(reduce_config(get_config(arch), periods=2), **kw)
        cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(0)
        params = _drawn_leaves(torch, cpu_model.init(gen), gen)
        model = build_model(cfg, dtype=torch.float32, device="cuda")
        cuda_params = _to(params, "cuda")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 17, 9, 30)]
        kernels = ("paged", "dense") if arch == "gemma2-2b" else ("paged",)
        outs, launches, steps, plain = {}, {}, {}, 0
        for kernel in kernels:
            for device, m, p in (("cpu", cpu_model, params), ("cuda", model, cuda_params)):
                eng = _engine_class()(m, p, SchedulerConfig(**sched), max_len=max_len,
                                      attn_kernel=kernel, device=device)
                for rid, prompt in enumerate(prompts):
                    eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
                reset_counts()
                eng.run(max_steps=400)
                counts, p_calls = read_counts()
                key = f"{kernel}_{device}"
                outs[key] = [eng.scheduler.requests[r].output for r in range(len(prompts))]
                steps[key] = eng.steps_run
                if device == "cuda":
                    launches[kernel], plain = counts, plain + p_calls
        if arch == "gemma2-2b":
            outs["serial_cpu"] = [serial_reference(cpu_model, params, p, new, max_len=max_len)
                                  for p in prompts]
            reset_counts()
            outs["serial_cuda"] = [serial_reference(model, cuda_params, p, new,
                                                    max_len=max_len) for p in prompts]
            launches["serial"], p_calls = read_counts()
            plain += p_calls
        L = cfg.n_layers
        rec = dict(phase="reduced_archs", arch=arch, layers=L, heads=cfg.n_heads,
                   kv_heads=cfg.n_kv_heads, group=g, head_dim=cfg.head_dim, dtype="float32",
                   steps=steps, launches=launches, plain_cuda_calls=plain,
                   min_top2_gap=min(_serial_gap(torch, cpu_model, params, p, new, max_len)
                                    for p in prompts),
                   tokens_identical={k[:-5]: outs[k] == outs[k[:-5] + "_cpu"]
                                     for k in outs if k.endswith("_cuda")})
        rec["ok"] = (all(rec["tokens_identical"].values()) and plain == 0
                     and launches["paged"]["mixed_paged_attention"] == L * steps["paged_cuda"]
                     and steps["paged_cuda"] == steps["paged_cpu"]
                     and all(len(o) == new for o in outs["paged_cuda"]))
        if arch == "gemma2-2b":
            rec["ok"] = (rec["ok"] and launches["dense"]["paged_attention"] > 0
                         and launches["serial"]["flash_attention"] == L * len(prompts)
                         and launches["serial"]["decode_attention"]
                         == L * len(prompts) * (new - 1))
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"reduced_archs {arch}: {rec} {outs}")


def full_model(torch, arch="llama3.1-8b", layers=None):
    """A model at its published widths, bf16, weights drawn on the card from
    seed 0, at its published depth or, with ``layers``, its first layers
    (``launch.serve.depth_cut``): Llama3.1-8B (all 32 layers; shared by
    serve, serve_dense and serial), Mamba2-2.7B (all 64; serve_mamba),
    gemma2-2b (all 26; its three paths) or an arch of ``ARCH_SERVES``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import depth_cut
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = depth_cut(cfg, layers)
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model, params, dict(init_s=time.perf_counter() - t0,
                               weight_gib=torch.cuda.memory_allocated() / 2**30,
                               published_layers=published,
                               reduced=[] if layers is None else
                               [f"depth: {layers} of {published} layers"])


def serve_prompts(vocab, c=SERVE):
    """A workload's seeded requests (SERVE's by default): prompt lengths,
    then each prompt's tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(c["prompt_lo"], c["prompt_hi"] + 1, c["requests"])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def _wrappers_and_plain():
    from repro_torch.kernels import decode_attention, flash_attention, paged_attention, ref, ssd

    return ((paged_attention.mixed_paged_attention, paged_attention.paged_attention,
             decode_attention.decode_attention, flash_attention.flash_attention,
             ssd.ssd_chunk_scan),
            (ref.mixed_attention_ref, ref.paged_attention_ref, ref.decode_attention_ref,
             ref.flash_attention_ref, ref.ssd_chunk_ref))


def reset_counts():
    """Every kernel's launch count and every plain version's count of calls
    on the card to 0, just before a main path runs."""
    wrappers, plains = _wrappers_and_plain()
    for fn in wrappers:
        fn.launches = 0
    for fn in plains:
        fn.cuda_calls = 0


def read_counts():
    """Each kernel's launches and all plain versions' calls on the card."""
    wrappers, plains = _wrappers_and_plain()
    return {fn.__name__: fn.launches for fn in wrappers}, sum(fn.cuda_calls for fn in plains)


def serve_engine(torch, model, params, attn_kernel, c=SERVE, sched=None, prompts=None,
                 engine_cls=None):
    """An engine with a workload's settings and requests submitted (SERVE's
    by default):
    ``paged`` over a page pool sized by the launcher's rule, ``dense`` over
    a slot cache (for Mamba2, the two-call path over its fixed state).
    ``sched`` adds scheduler settings (swap, the prefix cache), ``prompts``
    replaces the workload's prompts and ``engine_cls`` the engine class.
    Returns (engine, pool pages, pool basis, prompt lengths)."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.launch.serve import sized_kv_pool
    from repro_torch.serving.request import Request

    cfg = model.cfg
    dev = torch.device("cuda")
    pool, basis = None, "dense slot cache" if cfg.n_attn_layers else "two-call state"
    if attn_kernel == "paged":
        pool, basis = sized_kv_pool(cfg, dev, torch.bfloat16, c["max_batch"], c["max_len"],
                                    c["page"])
    eng = (engine_cls or _engine_class())(model, params, SchedulerConfig(
        chunk_size=c["chunk"], max_decode_batch=c["max_batch"],
        max_concurrent_prefills=c["max_prefills"], kv_block_size=c["page"],
        num_kv_blocks=pool, **(sched or {})), max_len=c["max_len"], attn_kernel=attn_kernel,
        device=dev)
    prompts = prompts or serve_prompts(cfg.vocab_size, c)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=c["max_new"]))
    return eng, pool, basis, [len(p) for p in prompts]


def dense_engine_check(torch, model, params, c=SERVE, phase="serve_dense_check"):
    """A workload (SERVE's by default) through the dense engine at full width, checked
    before ``serve_dense`` times it: every layer's B2 call of the first step
    that carries prefill chunks beside decode rows (the chunks' rows in
    multi-row tiles on the tensor cores, unsplit), and of the first
    decode-only step (one-row tiles: a few rows, split over keys and
    combined), is also computed by the plain version in fp32 from the same
    bf16 tensors (the slot cache, lengths and tables) and held to the bf16
    row tolerance. Stops once both steps are checked."""
    import repro_torch.core.packed_step as packed
    from repro_torch.kernels.decode_attention import split_count
    from repro_torch.kernels.paged_attention import paged_attention

    L = model.cfg.n_layers
    eng, _, _, _ = serve_engine(torch, model, params, "dense", c)
    steps = {"prefill": [], "decode": []}  # each checked call's record
    state = dict(calls=0, kind=None)

    def checked(q, k_cache, v_cache, lengths, tables, *, tiles, **kw):
        out = paged_attention(q, k_cache, v_cache, lengths, tables, tiles=tiles, **kw)
        N, KV = q.shape[:2]
        n_tiles = tiles.shape[0]
        n_split = split_count((n_tiles if n_tiles < N else N) * KV, k_cache.shape[1])
        if state["calls"] % L == 0:  # a step's first layer: is it one to check?
            per_slot = torch.unique(tables[:, 0], return_counts=True)[1]
            kind = ("decode" if int(per_slot.max()) == 1 else
                    "prefill" if int(per_slot.min()) == 1 else None)
            state["kind"] = kind if kind and not steps[kind] else None
        state["calls"] += 1
        if state["kind"]:
            plain = paged_ref_rows(q.float(), k_cache.float(), v_cache.float(), lengths, tables,
                                   **kw)
            steps[state["kind"]].append(dict(
                rows=N, n_tiles=n_tiles, n_split=n_split,
                tol_used=tol_used(out.float(), plain, "bfloat16")))
        return out

    packed.paged_attention = checked
    try:
        while eng.scheduler.has_work and not all(len(v) == L for v in steps.values()):
            eng.step(now=float(eng.steps_run))
    finally:
        packed.paged_attention = paged_attention
    rec = dict(phase=phase, arch=model.cfg.name, steps_run=eng.steps_run,
               **{kind: dict(calls_checked=len(v), **{key: v[0][key] if v else None
                                                      for key in ("rows", "n_tiles", "n_split")},
                             tol_used_max=max((c["tol_used"] for c in v), default=None))
                  for kind, v in steps.items()})
    rec["ok"] = (all(len(v) == L and max(c["tol_used"] for c in v) <= 1
                     for v in steps.values()) and rec["decode"]["n_split"] > 1
                 and rec["decode"]["n_tiles"] == rec["decode"]["rows"]
                 and rec["prefill"]["n_tiles"] < rec["prefill"]["rows"])
    emit(rec)
    del eng
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise AssertionError(f"{phase}: {rec}")


def serve(torch, smi, model, params, setup, attn_kernel="paged", c=SERVE, phase=None,
          profile=True, sched=None, prompts=None, engine_cls=None, extra=None):
    """A workload (SERVE's by default) through the engine: ``paged`` (B1,
    the main path; then a profiled window) or ``dense`` (B2, the dense
    fallback) for an attention arch; for Mamba2-2.7B the two-call path (B5
    in every layer of every prefill segment; then a profiled window).
    ``phase`` names the record (default: serve, serve_dense or
    serve_mamba); ``profile`` False skips the profiled window. ``sched``,
    ``prompts`` and ``engine_cls`` go to ``serve_engine``; ``extra(eng,
    step_ms)``, after the timed run, returns more of the record, whose
    ``a5_ok`` the run must also pass."""
    import numpy as np

    from repro_torch.serving.request import State

    cfg = model.cfg
    eng, pool, basis, lens = serve_engine(torch, model, params, attn_kernel, c, sched, prompts,
                                          engine_cls)
    if eng.two_call:
        default, kernel = "serve_mamba", "ssd_chunk_scan"
    elif attn_kernel == "paged":
        default, kernel = "serve", "mixed_paged_attention"
    else:
        default, kernel = "serve_dense", "paged_attention"
    phase = phase or default

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, prefill_tok, decode_tok, has_prefill, step_tok, segments = [], 0, 0, [], [], 0
    t_run = time.perf_counter()
    while eng.scheduler.has_work and eng.steps_run < 2000:
        t = time.perf_counter()
        plan = eng.step(now=float(eng.steps_run))
        torch.cuda.synchronize()
        if plan is None:
            break
        step_ms.append((time.perf_counter() - t) * 1e3)
        prefill_tok += plan.total_prefill_tokens
        decode_tok += len(plan.decode_rids)
        has_prefill.append(plan.total_prefill_tokens > 0)
        step_tok.append((plan.total_prefill_tokens, len(plan.decode_rids)))
        segments += len(plan.prefill_segments)
    run_s = time.perf_counter() - t_run
    counts, plain_cuda = read_counts()
    launches = counts[kernel]
    reqs = [eng.scheduler.requests[r] for r in range(c["requests"])]
    done = all(r.state is State.DONE and len(r.output) == c["max_new"] for r in reqs)
    pre = [i for i, f in enumerate(has_prefill) if f]
    dec = [i for i, f in enumerate(has_prefill) if not f]
    pre_s = sum(step_ms[i] for i in pre) / 1e3
    dec_s = sum(step_ms[i] for i in dec) / 1e3
    state_gib = (sum(t.numel() * t.element_size() for layer in eng.cache for t in layer.values())
                 / 2**30)
    rec = dict(
        phase=phase, attn_kernel=eng.attn_kernel, two_call=eng.two_call,
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype="bfloat16", requests=c["requests"], prompt_lens=lens,
        max_new_tokens=c["max_new"], chunk=c["chunk"], max_decode_batch=c["max_batch"],
        max_concurrent_prefills=c["max_prefills"], kv_block=c["page"], max_len=c["max_len"],
        pool_pages=pool, pool_basis=basis, cache_gib=state_gib, **setup, steps=eng.steps_run,
        prefill_segments=segments, run_s=run_s,
        prefill_tokens=prefill_tok, decode_tokens=decode_tok,
        # end to end: every token the run computed over its whole window
        tok_per_s=(prefill_tok + decode_tok) / run_s,
        # each phase over its own steps: prefill tokens over the steps that
        # carry a prefill chunk, decode tokens over the decode-only steps
        prefill_tok_per_s=sum(step_tok[i][0] for i in pre) / pre_s if pre else None,
        decode_tok_per_s=sum(step_tok[i][1] for i in dec) / dec_s if dec else None,
        mean_step_ms=float(np.mean(step_ms)), median_step_ms=float(np.median(step_ms)),
        first_step_ms=step_ms[0], prefill_steps=len(pre),
        prefill_step_ms=1e3 * pre_s / len(pre) if pre else None,
        decode_only_step_ms=1e3 * dec_s / len(dec) if dec else None,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        kernel=kernel, kernel_launches=launches, launches_by_kernel=counts,
        plain_cuda_calls=plain_cuda, nonfinite_logits=eng.nonfinite,
        all_completed=done, preemptions=eng.scheduler.stats.preemptions,
        outputs=[r.output for r in reqs], nvidia_smi=smi)
    # the attention kernels launch once per layer and step; B5 once per
    # layer and prefill segment (the decode call is plain PyTorch)
    expect = cfg.n_layers * (segments if eng.two_call else eng.steps_run)
    if extra is not None:
        rec.update(extra(eng, step_ms))
    rec["ok"] = (done and launches == expect and plain_cuda == 0 and eng.nonfinite == 0
                 and rec.get("a5_ok", True))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{rec['phase']}: {rec}")
    del eng
    torch.cuda.empty_cache()
    if profile and attn_kernel != "dense":
        profile_serve(torch, model, params, phase, kernel)
    return rec


def profile_serve(torch, model, params, phase, kernel):
    """Where the device time of a serving run goes. One workload (a 2048- and
    a 1024-token prompt, 16 new tokens each) runs twice on fresh engines:
    untraced for its wall time, then under torch.profiler (device activity
    only) for device time summed by kernel (``kernel``'s own, GEMMs, the
    rest). The idle share is one minus the traced device time over the
    untraced wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.request import Request

    c = SERVE
    cfg = model.cfg

    def engine():
        eng = _engine_class()(model, params, SchedulerConfig(
            chunk_size=c["chunk"], max_decode_batch=c["max_batch"],
            max_concurrent_prefills=c["max_prefills"], kv_block_size=c["page"],
            num_kv_blocks=2 * c["max_len"] // c["page"]), max_len=c["max_len"], device="cuda")
        rng = np.random.default_rng(1)
        for rid, n in enumerate((2048, 1024)):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                               max_new_tokens=16))
        torch.cuda.synchronize()
        return eng

    eng = engine()
    t0 = time.perf_counter()
    eng.run(max_steps=200)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.steps_run
    del eng
    eng = engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(max_steps=200)
        torch.cuda.synchronize()
    groups, kernels = {kernel: 0.0, "gemm": 0.0, "other": 0.0}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their device time is their kernels'
        ms = evt.self_device_time_total / 1e3
        if ms <= 0:
            continue
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
        low = evt.key.lower()
        group = (kernel if kernel in low else
                 "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet"))
                 else "other")
        groups[group] += ms
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit(dict(phase=f"{phase}_profile", steps=steps, traced_steps=eng.steps_run,
              wall_ms=wall_ms, device_ms=groups, device_busy_ms=busy,
              idle_share=(1 - busy / wall_ms) if busy else None, device_time_seen=busy > 0,
              top_kernels=[dict(name=k[:120], ms=v) for k, v in top]))


def reduced_two_call(torch):
    """Reduced mamba2-2.7b (2 layers) in fp32: the two-call engine on the card
    (B5), the same engine on the CPU (plain version, itself held to the JAX
    engine by the CPU tests) and the serial path on the card must give the
    same greedy tokens. Slots are reused, and the engine's chunks of 8 hand
    the state from segment to segment (B5's h0) where the serial path
    prefills each prompt in one call."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request
    from repro_torch.serving.serial import serial_reference

    cfg = reduce_config(get_config("mamba2-2.7b"), periods=2)
    cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 17, 9, 23, 100)]
    new, max_len = 12, 128
    outs, steps, launches, segments = {}, {}, {}, {}
    plain = 0
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device)
        eng = _engine_class()(model, _to(params, device), SchedulerConfig(
            chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
            max_concurrent_prefills=2), max_len=max_len, device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
        reset_counts()
        segments[device] = 0
        while eng.scheduler.has_work and eng.steps_run < 400:
            plan = eng.step(now=float(eng.steps_run))
            if plan is None:
                break
            segments[device] += len(plan.prefill_segments)
        counts, p_calls = read_counts()
        launches[device] = counts["ssd_chunk_scan"]
        plain += p_calls
        outs[device] = [eng.scheduler.requests[r].output for r in range(len(prompts))]
        steps[device] = eng.steps_run
    reset_counts()
    outs["serial_cuda"] = [serial_reference(model, _to(params, "cuda"), p, new, max_len=max_len)
                           for p in prompts]
    counts, p_calls = read_counts()
    launches["serial_cuda"] = counts["ssd_chunk_scan"]
    plain += p_calls
    L = cfg.n_layers
    rec = dict(phase="reduced_two_call", arch=cfg.name, layers=L, dtype="float32", steps=steps,
               prefill_segments=segments["cuda"], launches=launches, plain_cuda_calls=plain,
               engine_card_equals_cpu=outs["cuda"] == outs["cpu"],
               engine_equals_serial_card=outs["cuda"] == outs["serial_cuda"])
    rec["ok"] = (rec["engine_card_equals_cpu"] and rec["engine_equals_serial_card"]
                 and plain == 0 and launches["cpu"] == 0
                 and launches["cuda"] == L * segments["cuda"]
                 and launches["serial_cuda"] == L * len(prompts)
                 and all(len(o) == new for o in outs["cuda"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"reduced_two_call: {rec} {outs}")


def mamba_engine_check(torch, model, params):
    """SERVE's workload through the two-call engine at full width, checked
    before ``serve_mamba`` times it: every layer's B5 call of the first
    prefill segment that carries a state from an earlier chunk (h0 not
    zero) is also computed by the plain version in fp32 from the same bf16
    tensors, y held to the bf16 row tolerance and hT to the fp32 one. Stops once that
    segment is checked."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_chunk_ref

    L = model.cfg.n_layers
    eng, _, _, _ = serve_engine(torch, model, params, "auto")
    checked, real = [], ops.ssd

    def check(x, dt, A, Bm, Cm, h0=None):
        y, hT = real(x, dt, A, Bm, Cm, h0)
        if checked or bool(h0.abs().max() > 0):  # the segment's first layer decides
            # the plain version in fp32 from the same bf16 tensors, as in kernel_parity
            y_p, h_p = ssd_chunk_ref(x.float(), dt, A, Bm.float(), Cm.float(), h0)
            checked.append(dict(seq=x.shape[1], y=tol_used(ssd_rows(y.float()), ssd_rows(y_p),
                                                           "bfloat16"),
                                hT=tol_used(ssd_rows(hT), ssd_rows(h_p), "float32"),
                                finite=bool(torch.isfinite(y).all() and torch.isfinite(hT).all())))
        return y, hT

    ops.ssd = check
    try:
        while eng.scheduler.has_work and len(checked) < L:
            eng.step(now=float(eng.steps_run))
    finally:
        ops.ssd = real
    rec = dict(phase="serve_mamba_check", steps_run=eng.steps_run, calls_checked=len(checked),
               seqs=sorted({c["seq"] for c in checked}),
               y_tol_used_max=max((c["y"] for c in checked), default=None),
               hT_tol_used_max=max((c["hT"] for c in checked), default=None),
               finite=all(c["finite"] for c in checked))
    rec["ok"] = (len(checked) == L and rec["finite"] and rec["y_tol_used_max"] <= 1
                 and rec["hT_tol_used_max"] <= 1)
    emit(rec)
    del eng
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise AssertionError(f"serve_mamba_check: {rec}")


def reduced_serial(torch):
    """Reduced llama3.1-8b in fp32 on the card: serial per-request prefill +
    decode (B4, B3), the paged engine (B1) and the dense engine (B2) must
    give the same greedy tokens (test_engine_matches_serial on the card),
    and so must the serial run on the CPU (plain versions)."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request
    from repro_torch.serving.serial import serial_reference

    cfg = reduce_config(get_config("llama3.1-8b"), periods=2)
    cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    model = build_model(cfg, dtype=torch.float32, device="cuda")
    cuda_params = _to(params, "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 17, 9, 30)]
    new, max_len = 12, 64
    outs, launches = {}, {}
    outs["serial_cpu"] = [serial_reference(cpu_model, params, p, new, max_len=max_len)
                          for p in prompts]
    reset_counts()
    outs["serial"] = [serial_reference(model, cuda_params, p, new, max_len=max_len)
                      for p in prompts]
    launches["serial"], plain = read_counts()
    for kernel in ("paged", "dense"):
        eng = _engine_class()(model, cuda_params, SchedulerConfig(
            chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
            max_concurrent_prefills=2, kv_block_size=4), max_len=max_len, attn_kernel=kernel,
            device="cuda")
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
        reset_counts()
        eng.run(max_steps=400)
        launches[kernel], p_calls = read_counts()
        plain += p_calls
        outs[kernel] = [eng.scheduler.requests[r].output for r in range(len(prompts))]
    L = cfg.n_layers
    rec = dict(phase="reduced_serial", arch=cfg.name, dtype="float32", launches=launches,
               plain_cuda_calls=plain,
               tokens_identical={k: v == outs["serial"] for k, v in outs.items()})
    rec["ok"] = (all(rec["tokens_identical"].values()) and plain == 0
                 and launches["serial"]["flash_attention"] == L * len(prompts)
                 and launches["serial"]["decode_attention"] == L * len(prompts) * (new - 1)
                 and launches["paged"]["mixed_paged_attention"] > 0
                 and launches["dense"]["paged_attention"] > 0
                 and all(len(o) == new for o in outs["serial"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"reduced_serial: {rec} {outs}")


def serial(torch, smi, model, params, served, c=SERVE, phase="serial"):
    """A workload's requests (SERVE's by default) served one at a time at
    full width (B4 prefill of each whole prompt, then B3 per token over a
    dense cache of max_len): the serial execution the paper's packing is
    measured against. The first
    request's attention calls are also computed by the plain version on the
    same bf16 tensors and held to the bf16 row tolerance."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref
    from repro_torch.models import attention
    from repro_torch.serving.serial import serial_tokens

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size, c)
    used, nonfinite = [], [0]
    real_flash, real_decode = ops.flash_attention_bshd, ops.decode_attention_bhd

    def checked_flash(q, k, v, **kw):
        out = real_flash(q, k, v, **kw)
        B, S, H, d = q.shape
        plain = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        used.append(tol_used(out.reshape(B * S, H, d, 1).float(), plain.reshape(B * S, H, d, 1),
                             "bfloat16"))
        return out

    def checked_decode(q, k, v, lengths, **kw):
        out = real_decode(q, k, v, lengths, **kw)
        B, _, H, d = q.shape
        KV = k.shape[2]
        plain = decode_attention_ref(q.float().reshape(B, KV, H // KV, d), k.float(), v.float(),
                                     lengths.to(torch.int32), **kw)
        used.append(tol_used(out.reshape(B, KV, H // KV, d).float(), plain, "bfloat16"))
        return out

    real_head = model._head

    def counted_head(params, h):
        logits = real_head(params, h)
        nonfinite[0] += int((~logits.isfinite()).sum())
        return logits

    model._head = counted_head  # every logit the run computes is checked
    ops.flash_attention_bshd, ops.decode_attention_bhd = checked_flash, checked_decode
    first = list(serial_tokens(model, params, prompts[0], 2, max_len=c["max_len"]))
    ops.flash_attention_bshd, ops.decode_attention_bhd = real_flash, real_decode

    torch.cuda.synchronize()
    reset_counts()
    outs, prefill_ms, decode_ms = [], [], []
    t_run = time.perf_counter()
    for prompt in prompts:
        t = time.perf_counter()
        toks = []
        for tok in serial_tokens(model, params, prompt, c["max_new"], max_len=c["max_len"]):
            now = time.perf_counter()
            (decode_ms if toks else prefill_ms).append((now - t) * 1e3)
            toks.append(tok)
            t = now
        outs.append(toks)
    run_s = time.perf_counter() - t_run
    counts, plain_cuda = read_counts()
    del model._head
    prefill_tok = sum(len(p) for p in prompts)
    decode_tok = len(prompts) * (c["max_new"] - 1)
    tok_per_s = (prefill_tok + decode_tok) / run_s
    agree = float(np.mean([a == b for o, s_ in zip(outs, served["outputs"])
                           for a, b in zip(o, s_)]))
    L = cfg.n_layers
    rec = dict(
        phase=phase, arch=cfg.name, layers=L, dtype="bfloat16", requests=len(prompts),
        prompt_lens=[len(p) for p in prompts], max_new_tokens=c["max_new"],
        max_len=c["max_len"], run_s=run_s, prefill_tokens=prefill_tok, decode_tokens=decode_tok,
        tok_per_s=tok_per_s, prefill_ms=prefill_ms,
        prefill_tok_per_s=prefill_tok / (sum(prefill_ms) / 1e3),
        decode_ms_per_token=float(np.mean(decode_ms)),
        decode_ms_per_token_median=float(np.median(decode_ms)),
        decode_tok_per_s=decode_tok / (sum(decode_ms) / 1e3),
        serve_tok_per_s=served["tok_per_s"], serve_over_serial=served["tok_per_s"] / tok_per_s,
        serve_decode_over_serial_decode=(served["decode_tok_per_s"]
                                         / (decode_tok / (sum(decode_ms) / 1e3))
                                         if served["decode_tok_per_s"] else None),
        launches_by_kernel=counts, plain_cuda_calls=plain_cuda,
        checked_calls=len(used), checked_tol_used_max=max(used),
        nonfinite_logits=nonfinite[0], tokens_equal_to_serve=agree,
        first_request_head=first, nvidia_smi=smi)
    rec["ok"] = (counts["flash_attention"] == L * len(prompts)
                 and counts["decode_attention"] == L * decode_tok
                 and plain_cuda == 0 and nonfinite[0] == 0 and len(used) == 2 * L
                 and max(used) <= 1 and outs[0][:2] == first
                 and all(len(o) == c["max_new"] for o in outs))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{phase}: {rec}")
    return rec


# ---------------------------------------------------------------------------
# swap preemption, the prefix cache and async prefetch staging (ROADMAP A5)
# ---------------------------------------------------------------------------

# serve_swap / serve_swap_sync: SERVE with a KV budget of 8192 tokens, so
# decodes are swapped out to the host and back; serve_prefix: SERVE's
# settings over 8 prompts that share 2008 tokens (not a multiple of the
# 16-token page: each resume copies its partial page)
SWAP_SCHED = dict(kv_capacity_tokens=8192, preemption="swap")
PREFIX_REQUESTS = dict(n=8, shared_len=2008, unique_len=600, max_new_tokens=32, jitter=100,
                       seed=0)


def page_digest(torch, x):
    """One int64 per page (row) of ``x``: its bits as int32 words, weighted
    by fixed pseudo-random factors below 2**16 and summed (no overflow), so a
    changed, moved or swapped word changes it."""
    words = x.reshape(x.shape[0], -1).view(torch.int32)
    w = torch.randint(1, 1 << 16, (words.shape[1],), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(words.shape[1])).to(x.device)
    return (words.to(torch.int64) * w).sum(dim=1)


def _a5_engine_class(torch, digest):
    """The checked engine, keeping every swap's pages (or slot rows) as the
    step found them, before any of its device writes, and as the swap-in
    left them, with their physical ids: whole copies, or with ``digest`` one
    ``page_digest`` a page and leaf, kept on the device until the run's end.
    With ``digest`` on the card, CUDA events time the digests' device work
    of each step (``digest_events``), which the step's ms then include."""
    base = _engine_class()

    class A5Engine(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trips = []  # [rid, ids out, pages out, ids in, pages in]
            self.plans = []
            self.out_pages = []  # per step: the physical ids its swap-outs gathered
            self.digest_events = []  # (step, start, end) around each step's digests
            self._before = {}
            # host ms of each swap-out (its buffer's take included), buffer
            # take, staged copy and swap-in, and the device memory segments
            # (cudaMalloc calls) each staged copy added
            self.host_ms = {"swap_out": [], "take": [], "stage": [], "swap_in": []}
            self.stage_segments = []
            take, took = self.host_pool.take, self.host_ms["take"]

            def timed_take(nbytes):  # refers to no engine: no cycle keeps one alive
                t = time.perf_counter()
                buf = take(nbytes)
                took.append((time.perf_counter() - t) * 1e3)
                return buf

            self.host_pool.take = timed_take

        def _segments(self):
            if not self.cuda:
                return 0
            return torch.cuda.memory_stats(self.device).get("segment.all.allocated", 0)

        def _stage(self, plan, rid, entry):
            before = self._segments()
            t = time.perf_counter()
            staged = super()._stage(plan, rid, entry)
            self.host_ms["stage"].append((time.perf_counter() - t) * 1e3)
            self.stage_segments.append(self._segments() - before)
            return staged

        def _pages(self, rid, slot, positions=None, record=None):
            if self.attn_kernel != "paged":
                ids, leaves = [slot], [v[slot:slot + 1] for layer in self.cache
                                       for v in layer.values()]
            else:
                blocks = (record.table.blocks if record is not None
                          else self.scheduler.mem.allocator.tables[rid].blocks)
                ids = [blocks[i] for i in positions]
                index = torch.tensor(ids, dtype=torch.long, device=self.device)
                leaves = [v.index_select(0, index) for layer in self.cache
                          for v in layer.values()]
            return ids, [page_digest(torch, x) if digest else x.clone() for x in leaves]

        def _timed_pages(self, plan, *args):
            if not (digest and self.cuda):
                return self._pages(*args)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            got = self._pages(*args)
            ev[1].record()
            self.digest_events.append((plan.step, *ev))
            return got

        def _refuse_round_trips(self, plan):
            # the engine's first call after planning: no device write of the
            # step has run yet, so the victims' pages are as the step found them
            super()._refuse_round_trips(plan)
            self._before = {}
            self.out_pages.append([])
            for rid, slot in plan.swapped_out:
                rec = (self.scheduler.mem.swapped[rid].record if self.attn_kernel == "paged"
                       else None)
                self._before[rid] = self._timed_pages(plan, rid, slot,
                                                      rec and rec.spilled_indices, rec)

        def _swap_out(self, plan, rid, slot):
            ids, pages = self._before.pop(rid)
            t = time.perf_counter()
            super()._swap_out(plan, rid, slot)
            self.host_ms["swap_out"].append((time.perf_counter() - t) * 1e3)
            self.trips.append([rid, ids, pages, None, None])
            self.out_pages[-1].extend(ids)

        def _swap_in(self, plan, rid, slot):
            idx = self.swap_store[rid]["idx"]
            t = time.perf_counter()
            super()._swap_in(plan, rid, slot)
            self.host_ms["swap_in"].append((time.perf_counter() - t) * 1e3)
            trip = next(t for t in self.trips if t[0] == rid and t[3] is None)
            trip[3], trip[4] = self._timed_pages(plan, rid, slot, idx)

        def reused_copy_pages(self):
            """(step, page) of each prefix copy whose destination is a page
            a swap-out of the same step gathered."""
            return [(p.step, c[2]) for p, out in zip(self.plans, self.out_pages)
                    for c in p.prefix_copies if c[2] in out]

        def digest_ms(self):
            """Device ms of each step's digests (after a synchronize)."""
            got = {}
            for step, a, b in self.digest_events:
                got[step] = got.get(step, 0.0) + a.elapsed_time(b)
            return got

        def step(self, now=0.0):
            plan = super().step(now)
            if plan is not None:
                self.plans.append(plan)
            return plan

        def round_trips(self):
            """(restores checked, all bit-equal, any relocated)."""
            done = [t for t in self.trips if t[3] is not None]
            equal = all(len(t[1]) == len(t[3]) and all(torch.equal(a, b)
                                                       for a, b in zip(t[2], t[4]))
                        for t in done)
            return dict(swap_outs_seen=len(self.trips), restores_checked=len(done),
                        restored_bit_equal=equal and len(done) == len(self.trips),
                        relocated=any(t[1] != t[3] for t in done))

    return A5Engine


def plan_key(plan):
    """What a step computes: its decode rows and its prefill segments."""
    return (list(plan.decode_rids),
            [(s.rid, s.start, s.length) for s in plan.prefill_segments])


def copy_timing(torch, eng):
    """The engine's ``copy_log`` resolved after a synchronize: each swap
    copy's ms and GB/s, and for each staged copy the share of its time that
    lies inside the kernel window (first kernel to last) of the step that
    issued it."""
    torch.cuda.synchronize()
    log = eng.copy_log
    ref = log[0]["start"]
    windows = {r["step"]: (ref.elapsed_time(r["start"]), ref.elapsed_time(r["end"]))
               for r in log if r["kind"] == "kernels"}
    copies = []
    for r in log:
        if r["kind"] == "kernels":
            continue
        a, b = ref.elapsed_time(r["start"]), ref.elapsed_time(r["end"])
        rec = dict(kind=r["kind"], step=r["step"], rid=r["rid"], bytes=r["nbytes"], ms=b - a,
                   gb_per_s=r["nbytes"] / max(b - a, 1e-9) / 1e6)
        if r["kind"] == "h2d_staged":
            ka, kb = windows[r["step"]]
            rec["kernel_window_ms"] = kb - ka
            rec["inside_kernel_window"] = max(0.0, min(b, kb) - max(a, ka)) / max(b - a, 1e-9)
        copies.append(rec)

    def rate(kinds):
        got = [c for c in copies if c["kind"] in kinds]
        return (sum(c["bytes"] for c in got) / sum(c["ms"] for c in got) / 1e6) if got else None

    return dict(copies=copies, d2h_gb_per_s=rate(("d2h",)),
                h2d_gb_per_s=rate(("h2d_staged", "h2d_direct")),
                staged_inside_kernel_window=[c["inside_kernel_window"] for c in copies
                                             if c["kind"] == "h2d_staged"])


def reduced_a5(torch):
    """Swap preemption, async staging, the prefix cache and a fault plan with
    retries on reduced models in fp32, the engine on the card against the
    same engine on the CPU (itself held to the JAX engine by
    tests/test_torch_a5.py), on that file's fixed workloads: the same greedy
    tokens, and every page (or slot row) a swap-in restored bit-equal to what
    its swap-out gathered, some under another physical page id."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import build_model
    from repro_torch.robustness import VERDICT_DELAY, VERDICT_FAIL, FaultPlan, FaultSpec
    from repro_torch.serving.request import Request
    from repro_torch.serving.workload import shared_prefix_requests

    swap_knobs = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=0,
                      max_concurrent_prefills=2, kv_capacity_tokens=30, preemption="swap",
                      kv_block_size=4)
    engine_swap = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                       max_concurrent_prefills=2, kv_capacity_tokens=30, preemption="swap")
    prefix_knobs = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                        max_concurrent_prefills=2, kv_block_size=4, enable_prefix_cache=True)
    models = {}
    # one layer each, as the CPU tests run them: the workloads' smallest
    # top-2 logit gaps there are 3.2e-3 (Llama's swaps), 3.8e-4 (Mamba2's),
    # 7.8e-3 and 1.1e-3 (the prefix cases); at two layers the swap workload's
    # falls to 3.2e-5, too close for card against CPU (each record carries
    # its own)
    for arch in ("llama3.1-8b", "mamba2-2.7b"):
        cfg = reduce_config(get_config(arch))
        cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
        models[arch] = (cfg, cpu_model.init(torch.Generator().manual_seed(0)))
    vocab = models["llama3.1-8b"][0].vocab_size
    rng = np.random.default_rng(3)
    swap_reqs = [(rng.integers(0, vocab, n).tolist(), o) for n, o in [(17, 6), (23, 5), (12, 7)]]
    rng = np.random.default_rng(44)
    engine_reqs = [(rng.integers(0, vocab, n).tolist(), o) for n, o in [(5, 6), (17, 4), (9, 8)]]
    rng = np.random.default_rng(17)
    base = rng.integers(0, vocab, size=26).tolist()
    mid_block = [(base, 5), (base[:14] + [(t + 1) % vocab for t in base[14:24]], 5),
                 (base[:22] + [(t + 3) % vocab for t in base[22:26]], 5)]
    shared = [(r.prompt, r.max_new_tokens) for r in shared_prefix_requests(
        n=4, shared_len=20, unique_len=8, max_new_tokens=5, jitter=2, seed=11, vocab_size=vocab)]
    # step 5 swaps a victim out and copies a prefix page into a page it gave up
    reused = [(r.prompt, r.max_new_tokens) for r in shared_prefix_requests(
        n=4, shared_len=19, unique_len=8, max_new_tokens=5, jitter=2, seed=0, vocab_size=vocab)]
    faults = FaultPlan(seed=2, fail_rate=0.4, delay_rate=0.2, scripted={
        (0, 0): FaultSpec(VERDICT_FAIL), (1, 0): FaultSpec(VERDICT_DELAY, delay_steps=2)})
    cases = {  # name: (arch, attn_kernel, scheduler settings, requests, one at a time)
        "swap_paged_async": ("llama3.1-8b", "paged", dict(swap_knobs, async_prefetch=True),
                             swap_reqs, False),
        "swap_paged_sync": ("llama3.1-8b", "paged", dict(swap_knobs, async_prefetch=False),
                            swap_reqs, False),
        "swap_dense": ("llama3.1-8b", "dense", swap_knobs, swap_reqs, False),
        "swap_two_call": ("mamba2-2.7b", "auto", engine_swap, engine_reqs, False),
        "prefix_mid_block": ("llama3.1-8b", "paged", prefix_knobs, mid_block, True),
        "prefix_pool16_swap": ("llama3.1-8b", "paged",
                               dict(prefix_knobs, num_kv_blocks=16, preemption="swap"),
                               shared, False),
        "prefix_swap_reused_page": ("llama3.1-8b", "paged",
                                    dict(prefix_knobs, num_kv_blocks=16, preemption="swap"),
                                    reused, False),
        "chaos_retries": ("llama3.1-8b", "paged",
                          dict(swap_knobs, fault_plan=faults, max_transfer_retries=2),
                          swap_reqs, False),
    }
    kernel_of = {"paged": "mixed_paged_attention", "dense": "paged_attention",
                 "auto": "ssd_chunk_scan"}
    records, ok = [], True
    for name, (arch, kernel, knobs, reqs, one_at_a_time) in cases.items():
        cfg, params = models[arch]
        got, gaps = {}, []
        for device in ("cpu", "cuda"):
            model = build_model(cfg, dtype=torch.float32, device=device)
            eng = _a5_engine_class(torch, digest=False)(
                model, _to(params, device), SchedulerConfig(**knobs), max_len=64,
                attn_kernel=kernel, device=device)
            if device == "cpu":
                sample = eng._sample_rows

                def gap_sample(logits, sample=sample):
                    top = torch.topk(logits, 2, dim=-1).values
                    gaps.append(float((top[:, 0] - top[:, 1]).min()))
                    return sample(logits)

                eng._sample_rows = gap_sample
            reset_counts()
            for rid, (prompt, n_out) in enumerate(reqs):
                eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
                if one_at_a_time:
                    eng.run(max_steps=400)
            eng.run(max_steps=2000)
            counts, plain = read_counts()
            stats = eng.scheduler.stats
            computing = sum(1 for p in eng.plans if p.total_tokens)
            got[device] = dict(
                outputs=[eng.scheduler.requests[r].output for r in range(len(reqs))],
                steps=eng.steps_run, swap_outs=stats.swap_outs, swap_ins=stats.swap_ins,
                prefix_hits=stats.prefix_hits,
                prefix_copies=sum(len(p.prefix_copies) for p in eng.plans),
                swap_in_intents=sum(t.kind == "swap_in" for p in eng.plans for t in p.issued),
                transfer_failures=eng.scheduler.prefetch_queue.stats.transfer_failures,
                launches=counts[kernel_of[kernel]], plain_cuda_calls=plain,
                computing_steps=computing, layers=cfg.n_layers,
                segments=sum(len(p.prefill_segments) for p in eng.plans),
                swap_store_left=len(eng.swap_store), staged_left=len(eng._staged),
                host_buffers=dict(pinned=eng.host_pool.pinned, reused=eng.host_pool.reused),
                bytes_moved=dict(eng.swap_bytes_moved),
                reused_copy_pages=eng.reused_copy_pages(), **eng.round_trips())
        card, cpu = got["cuda"], got["cpu"]
        rec = dict(phase="reduced_a5", case=name, arch=cfg.name, attn_kernel=kernel,
                   dtype="float32", min_top2_gap_cpu=min(gaps),
                   tokens_identical=card["outputs"] == cpu["outputs"],
                   same_schedule=all(card[k] == cpu[k] for k in (
                       "steps", "swap_outs", "swap_ins", "prefix_hits", "prefix_copies",
                       "transfer_failures", "bytes_moved", "reused_copy_pages")),
                   **{k: card[k] for k in card if k != "outputs"})
        # B1/B2 run once a layer and computing step, B5 once a layer and
        # prefill segment
        rec["launches_expected"] = card["layers"] * (
            card["segments"] if kernel == "auto" else card["computing_steps"])
        rec["ok"] = (rec["tokens_identical"] and rec["same_schedule"] and cpu["launches"] == 0
                     and card["plain_cuda_calls"] == 0 and card["launches"] > 0
                     and rec["launches_expected"] == card["launches"]
                     and card["swap_store_left"] == 0 and card["staged_left"] == 0
                     and card["restored_bit_equal"] and cpu["restored_bit_equal"]
                     and all(len(o) == n for o, (_, n) in zip(card["outputs"], reqs)))
        if knobs.get("preemption") == "swap":
            rec["ok"] = rec["ok"] and card["swap_outs"] == card["swap_ins"] > 0
            if kernel == "paged":
                rec["ok"] = rec["ok"] and card["relocated"]
        if name == "swap_paged_async":
            rec["ok"] = rec["ok"] and card["swap_in_intents"] > 0
        if name.startswith("prefix"):
            rec["ok"] = rec["ok"] and card["prefix_hits"] > 0
        if name == "prefix_mid_block":
            rec["ok"] = rec["ok"] and card["prefix_copies"] == 2
        if name == "prefix_swap_reused_page":
            rec["ok"] = rec["ok"] and bool(card["reused_copy_pages"])
        if name == "chaos_retries":
            rec["ok"] = rec["ok"] and card["transfer_failures"] > 0
        emit(rec)
        records.append(rec)
        ok = ok and rec["ok"]
    if not ok:
        raise AssertionError(f"reduced_a5: {[r for r in records if not r['ok']]}")


def swap_extra(torch, keys, compare_to=None):
    """``serve``'s ``extra`` for the swap runs: the round trips' digests,
    the swap steps and their ms (with and without the digests' device ms),
    the copies' rates and overlap, bytes moved
    against the memory manager's counts; with ``compare_to`` (the other
    run's plan keys and outputs) whether the plans match step by step, and
    if they do, the tokens too. A run with staging must have staged."""

    def extra(eng, step_ms):
        plans = eng.plans
        timing = copy_timing(torch, eng)
        digest_ms = eng.digest_ms()
        mem = eng.scheduler.mem
        trips = eng.round_trips()
        swap_steps = [dict(step=i, ms=step_ms[i], digest_ms=digest_ms.get(p.step, 0.0),
                           ms_less_digests=step_ms[i] - digest_ms.get(p.step, 0.0),
                           swapped_out=[r for r, _ in p.swapped_out],
                           swapped_in=[r for r, _ in p.swapped_in],
                           staged=[t.rid for t in p.issued if t.kind == "swap_in"])
                      for i, p in enumerate(plans)
                      if p.swapped_out or p.swapped_in or p.issued]
        keys.extend(plan_key(p) for p in plans)
        outputs = [eng.scheduler.requests[r].output for r in range(len(eng.scheduler.requests))]
        rec = dict(swap_outs=eng.scheduler.stats.swap_outs, swap_ins=eng.scheduler.stats.swap_ins,
                   digest_ms_total=sum(digest_ms.values()),
                   swap_out_gib=mem.swap_out_bytes_total / 2**30,
                   swap_in_gib=mem.swap_in_bytes_total / 2**30,
                   bytes_moved=dict(eng.swap_bytes_moved),
                   bytes_moved_equal_ledger=(
                       eng.swap_bytes_moved["d2h"] == mem.swap_out_bytes_total
                       and eng.swap_bytes_moved["h2d"] == mem.swap_in_bytes_total),
                   host_buffers=dict(pinned=eng.host_pool.pinned, reused=eng.host_pool.reused,
                                     pinned_gib=eng.host_pool.pinned_bytes / 2**30),
                   host_ms=eng.host_ms, stage_segments=eng.stage_segments,
                   swap_steps=swap_steps, **trips, **{k: v for k, v in timing.items()
                                                      if k != "copies"},
                   copies=timing["copies"])
        ok = (trips["restored_bit_equal"] and trips["relocated"]
              and rec["swap_outs"] == rec["swap_ins"] == 4 and rec["bytes_moved_equal_ledger"]
              and not eng.swap_store and not eng._staged)
        if compare_to is not None:
            rec["plans_match_sync"] = keys == compare_to["keys"]
            rec["tokens_equal_sync"] = outputs == compare_to["outputs"]
            ok = ok and (rec["tokens_equal_sync"] or not rec["plans_match_sync"])
        if eng.sched_cfg.async_prefetch:
            ok = ok and len(rec["staged_inside_kernel_window"]) > 0
        rec["a5_ok"] = ok
        return rec

    return extra


def prefix_extra(eng, step_ms):
    plans = eng.plans
    stats = eng.scheduler.stats
    copies = sum(len(p.prefix_copies) for p in plans)
    rec = dict(prefix_hits=stats.prefix_hits, prefix_hit_tokens=stats.prefix_hit_tokens,
               prefix_copies=copies,
               copy_steps=[dict(step=i, ms=step_ms[i], copies=len(p.prefix_copies))
                           for i, p in enumerate(plans) if p.prefix_copies])
    rec["a5_ok"] = stats.prefix_hits == 6 and copies == 6
    return rec


def a5_serves(torch, smi, model, params, setup):
    """Llama3.1-8B at full width through the A5 paths: ``serve_swap_sync``
    (swap preemption without staging), ``serve_swap`` (the same with async
    staging; its plans and tokens against the first run's; each engine pins
    its own host buffers, so both runs start from none), ``serve_prefix`` (the
    prefix cache over a shared 2008-token prefix) and ``serve_prefix_off``
    (the same prompts without the cache). Returns their records."""
    from repro_torch.serving.workload import shared_prefix_requests

    cls = _a5_engine_class(torch, digest=True)

    class Timed(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.copy_log = []

    keys_sync, keys_async = [], []
    runs = [serve(torch, smi, model, params, setup, phase="serve_swap_sync", profile=False,
                  sched=dict(SWAP_SCHED, async_prefetch=False), engine_cls=Timed,
                  extra=swap_extra(torch, keys_sync))]
    runs.append(serve(torch, smi, model, params, setup, phase="serve_swap", profile=False,
                      sched=dict(SWAP_SCHED, async_prefetch=True), engine_cls=Timed,
                      extra=swap_extra(torch, keys_async, dict(keys=keys_sync,
                                                               outputs=runs[0]["outputs"]))))
    prompts = [r.prompt for r in shared_prefix_requests(vocab_size=model.cfg.vocab_size,
                                                         **PREFIX_REQUESTS)]
    runs.append(serve(torch, smi, model, params, setup, phase="serve_prefix", profile=False,
                      sched=dict(enable_prefix_cache=True), prompts=prompts, engine_cls=cls,
                      extra=prefix_extra))
    runs.append(serve(torch, smi, model, params, setup, phase="serve_prefix_off",
                      profile=False, prompts=prompts))
    runs[2]["cache_off"] = dict(tok_per_s=runs[3]["tok_per_s"],
                                prefill_tokens=runs[3]["prefill_tokens"], steps=runs[3]["steps"])
    return runs


def micro(torch, parity):
    """kernels_micro's two comparisons at its full shapes (fp32; H 8, KV 2,
    d 64; 32 rows of a 8192-token cache at lengths 64..2048; page 128):
    (1) dense-cache decode (B3) against ragged paged decode (B2), from the
    parity cases of those shapes; (2) the unified mixed call (B1: 32
    decode rows plus 2 chunks of 512 after a 256-token prefix) against the
    per-token expansion (B2: 32 + 1024 rows), with the prefill KV tokens
    each reads from ``core.opcost.kv_tokens_touched``."""
    import numpy as np

    from repro_torch.core.opcost import kv_tokens_touched
    from repro_torch.kernels.paged_attention import mixed_paged_attention, paged_attention, q_tiles
    from repro_torch.kernels.ref import mixed_attention_ref, paged_attention_ref

    Bd, Sd, page, KV, G, d = 32, 8192, 128, 2, 4, 64
    lens = [int(x) for x in np.linspace(64, 2048, Bd)]
    elem = 4
    row_bytes = KV * d * 2 * elem
    dense, ragged = parity["b3_micro_fp32"], parity["b2_micro_fp32"]
    gather = dict(
        dense_decode_ms=dense["kernel_ms"], ragged_paged_ms=ragged["kernel_ms"],
        # what kernels_micro's dense gather reads (every row to S_max), what
        # B3 reads (each row to its length) and what the page-granular
        # ragged path is priced at (whole pages)
        dense_gather_bytes=Bd * Sd * row_bytes, dense_kernel_bytes=sum(lens) * row_bytes,
        ragged_bytes=kv_tokens_touched(lens, page) * row_bytes)
    gather["bytes_ratio"] = gather["ragged_bytes"] / gather["dense_gather_bytes"]

    # the unified mixed batch against its per-token expansion
    chunk, C, prefix = 512, 2, 2 * page
    seg_q = [1] * Bd + [chunk] * C
    seg_kv = lens + [prefix + chunk] * C
    pps = Sd // page
    nb = -(-max(seg_kv) // page)
    gen = torch.Generator(device="cuda").manual_seed(7)
    pool_k = torch.randn((Bd * pps + 1, page, KV, d), generator=gen, device="cuda")
    pool_v = torch.randn((Bd * pps + 1, page, KV, d), generator=gen, device="cuda")
    tables = ((np.arange(len(seg_q)) % Bd)[:, None] * pps + np.arange(nb)[None, :]).astype(
        np.int32)
    cu = np.zeros(len(seg_q) + 1, np.int32)
    cu[1:] = np.cumsum(seg_q)
    N = int(cu[-1])
    q = torch.randn((N, KV, G, d), generator=gen, device="cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    d_cu, d_kv, d_tab, d_tiles = t(cu), t(np.asarray(seg_kv, np.int32)), t(tables), \
        t(q_tiles(cu, G))
    row_len = lens + [prefix + j + 1 for _ in range(C) for j in range(chunk)]
    row_tab = t(np.concatenate([tables[:Bd]] + [np.repeat(tables[Bd + s][None], chunk, 0)
                                                  for s in range(C)]))
    d_len = t(np.asarray(row_len, np.int32))
    # the per-token expansion as kernels_micro prices it: every row reads its
    # own prefix, a tile of one row each (fp32 runs that way in any case)
    one_row = t(np.stack([np.arange(N), np.ones(N)], axis=1).astype(np.int32))
    unified = lambda: mixed_paged_attention(q, pool_k, pool_v, d_cu, d_kv, d_tab,  # noqa: E731
                                            tiles=d_tiles)
    per_token = lambda: paged_attention(q, pool_k, pool_v, d_len, row_tab,  # noqa: E731
                                        tiles=one_row)
    plain = paged_attention_ref(q, pool_k, pool_v, d_len, row_tab)
    err = dict(unified=tol_used(unified(), mixed_attention_ref(q, pool_k, pool_v, d_cu, d_kv,
                                                                d_tab), "float32"),
               per_token=tol_used(per_token(), plain, "float32"))
    uni_prefill = kv_tokens_touched(seg_kv[Bd:], page)
    pt_prefill = kv_tokens_touched(row_len[Bd:], page)
    mixed = dict(unified_ms=device_ms(torch, unified, reps=20)[0],
                 per_token_ms=device_ms(torch, per_token, reps=20)[0],
                 unified_prefill_kv_tokens=uni_prefill, per_token_prefill_kv_tokens=pt_prefill,
                 prefill_bytes_ratio=uni_prefill / pt_prefill, rows=N, tol_used=err)
    rec = dict(phase="micro", shape=dict(rows=Bd, cap=Sd, page=page, kv=KV, g=G, d=d,
                                         dtype="float32"),
               dense_vs_ragged=gather, unified_vs_per_token=mixed)
    rec["ok"] = max(err.values()) <= 1 and uni_prefill < pt_prefill
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"micro: {rec}")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda,
              allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    t0 = time.perf_counter()
    built = _build.build_all(sorted({Path(src).stem for src, _ in KERNELS.values()}))
    ptxas = {b.name: ptxas_report(b.log) for b in built}
    spills = [f for fs in ptxas.values() for f in fs
              if f.get("spill_stores", 0) or f.get("spill_loads", 0)]
    rec = dict(phase="build", seconds=time.perf_counter() - t0,
               kernels={b.name: dict(path=str(b.path.relative_to(ROOT)), nvcc_s=b.seconds,
                                     ptxas=ptxas[b.name]) for b in built},
               instantiations=sum(len(fs) for fs in ptxas.values()),
               spilling=[f["function"] for f in spills],
               d256_spilling=[f["function"] for f in spills if f["head_dim"] == 256],
               b1_spilling=[f["function"] for f in spills
                            if "mixed_paged_attention" in f["function"]],
               b5_spilling=[f["function"] for f in spills if "ssd_chunk_scan" in f["function"]],
               b3_cluster_spilling=[f["function"] for f in spills
                                    if "cluster_decode" in f["function"]])
    # every head-dim-256 instantiation, and every one of B1's, B3's bf16
    # cluster's and B5's, must keep its registers (a rebuilt library reports
    # nothing: build_all skips a source that is up to date)
    rec["ok"] = not (rec["d256_spilling"] or rec["b1_spilling"] or rec["b5_spilling"]
                     or rec["b3_cluster_spilling"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"build: instantiations spill: {rec}")

    parity = kernel_parity(torch)
    parity.update(single_query_and_flash_parity(torch))
    parity.update(group_parity(torch))
    parity.update(ssd_parity(torch))
    b5_scratch_checks(torch)
    reduced_serve(torch)
    engine_bf16(torch)
    reduced_serial(torch)
    reduced_two_call(torch)
    reduced_archs(torch)
    reduced_a5(torch)
    model, params, setup = full_model(torch)
    served = serve(torch, smi, model, params, setup)
    dense_engine_check(torch, model, params)
    served_dense = serve(torch, smi, model, params, setup, attn_kernel="dense")
    serial_rec = serial(torch, smi, model, params, served)
    a5_runs = a5_serves(torch, smi, model, params, setup)
    del model, params
    torch.cuda.empty_cache()
    micro(torch, parity)
    model, params, setup = full_model(torch, "mamba2-2.7b")
    mamba_engine_check(torch, model, params)
    served_mamba = serve(torch, smi, model, params, setup, attn_kernel="auto")
    del model, params
    torch.cuda.empty_cache()
    # gemma2-2b at full depth through its three paths, every prompt past
    # its local window; then the other archs through the paged engine
    model, params, setup = full_model(torch, "gemma2-2b")
    arch_runs = [serve(torch, smi, model, params, setup, c=GEMMA2_SERVE, phase="serve_gemma2",
                       profile=False)]
    dense_engine_check(torch, model, params, GEMMA2_SERVE, "serve_dense_gemma2_check")
    arch_runs.append(serve(torch, smi, model, params, setup, attn_kernel="dense",
                           c=GEMMA2_SERVE, phase="serve_dense_gemma2"))
    arch_runs.append(serial(torch, smi, model, params, arch_runs[0], GEMMA2_SERVE,
                            "serial_gemma2"))
    del model, params
    torch.cuda.empty_cache()
    for phase, arch, layers in ARCH_SERVES:
        model, params, setup = full_model(torch, arch, layers)
        arch_runs.append(serve(torch, smi, model, params, setup, phase=phase, profile=False))
        del model, params
        torch.cuda.empty_cache()

    # each kernel: its launches on the main path that runs it, timed at that
    # path's shapes (the first one heads the line); plain-version calls on
    # the card summed over those paths
    paths = {"mixed_paged_attention": (served, ["mixed_bf16", "gemma2_mixed_bf16",
                                                "decode16_bf16", "decode_long_bf16",
                                                "g6_mixed_bf16", "g6_decode16_bf16",
                                                "g16_mixed_bf16", "g16_decode16_bf16"]),
             "paged_attention": (served_dense, ["b2_dense_engine_bf16", "b2_dense_prefill_bf16",
                                                "b2_gemma2_dense_engine_bf16",
                                                "b2_gemma2_dense_prefill_bf16",
                                                "b2_g6_dense_engine_bf16",
                                                "b2_g6_dense_prefill_bf16",
                                                "b2_g16_dense_engine_bf16",
                                                "b2_g16_dense_prefill_bf16"]),
             "decode_attention": (serial_rec, ["b3_serial_bf16", "b3_gemma2_serial_bf16",
                                               "b3_g6_serial_bf16"]),
             "flash_attention": (serial_rec, ["b4_prompt4096_bf16", "b4_prompt1000_bf16",
                                              "b4_gemma2_prompt6000_bf16",
                                              "b4_g6_prompt4096_bf16", "b4_g16_prompt4096_bf16"]),
             "ssd_chunk_scan": (served_mamba, ["b5_s512_bf16", "b5_s100_bf16"])}
    runs = [served, served_dense, serial_rec, served_mamba] + a5_runs + arch_runs
    lines = []
    for kname, (source, replaces) in KERNELS.items():
        path, cases = paths[kname]
        main_case = parity[cases[0]]
        lines.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=path["launches_by_kernel"][kname],
            plain_cuda_calls=path["plain_cuda_calls"],
            max_abs_err=main_case["max_abs_err"], tol_used=main_case["tol_used"],
            ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], library=main_case["library"],
            timing=main_case["timing"], kernel_parts=main_case["kernel_parts"],
            event_ms=main_case["kernel_event_ms"], host_us=main_case["kernel_host_us"],
            shape_case=cases[0], main_path=path["phase"], plan=main_case.get("plan"),
            # every path that launched the kernel, each counted from 0 just
            # before it ran
            launches_by_path={r["phase"]: r["launches_by_kernel"][kname] for r in runs
                              if r["launches_by_kernel"].get(kname)},
            main_path_cases=[dict(case=n, ms=parity[n]["kernel_ms"],
                                  plain_ms=parity[n]["plain_ms"],
                                  bound_ms=parity[n]["bound_ms"],
                                  bound_by=parity[n]["bound_by"],
                                  library_ms=parity[n]["library_ms"],
                                  max_abs_err=parity[n]["max_abs_err"],
                                  tol_used=parity[n]["tol_used"]) for n in cases],
            max_abs_err_all_cases=max(r["max_abs_err"] for r in parity.values()
                                      if r["kernel"] == kname),
            tol_used_all_cases=max(r["tol_used"] for r in parity.values()
                                   if r["kernel"] == kname)))
    emit({"kernels": lines})
    if not all(k["launches"] > 0 and k["plain_cuda_calls"] == 0 for k in lines) \
            or any(r["plain_cuda_calls"] for r in runs):
        raise AssertionError(f"a kernel of a main path did not launch: {lines}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
