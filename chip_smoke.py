#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from a checkout of the repository, on a machine with a CUDA card and the
CUDA toolkit; it needs no network. Phases, each printing one JSON line:

  device         card, power limit, torch/CUDA versions; TF32 off for fp32 checks
  build          nvcc builds every kernel of the port from src/repro_torch
  kernel_parity  each kernel against its plain PyTorch version on the card, at
                 the main path's shapes (Llama3.1-8B heads: KV 8, G 4, d 128,
                 page 16) and at the reduced test shape, with times beside the
                 card's bound and one PyTorch library call
  reduced_serve  the engine at reduced width in fp32 on the card (kernel) and on
                 the CPU (plain version): the same greedy tokens
  engine_bf16    the engine in bf16 at Llama3.1-8B's attention heads, reduced
                 depth and width: every attention call of the run against
                 the plain version on the same bf16 tensors
  serve          the port's Engine on Llama3.1-8B at full width, all 32 layers,
                 bf16, seeded random weights: 8 requests, 32 new tokens each

then the kernels line, the card's name and power limit as nvidia-smi gives
them, and, last, {"ok": true, "device": {...}}. Any failure raises: the
script exits nonzero and prints no result. Without a CUDA card it exits 1.
"""
from __future__ import annotations

import json
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
FAULT_MARGIN = 3.0  # dropping softcap or window must break the check this many times over
SERVE = dict(requests=8, prompt_lo=512, prompt_hi=4096, max_new=32, chunk=512,
             max_batch=8, max_prefills=2, page=16, max_len=8192)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel_parity
# ---------------------------------------------------------------------------


def make_case(torch, seed, segs, *, kv, g, d, page, dtype, window=None, softcap=None,
              pad_rows=7):
    """A packed step's attention inputs on the card: ``segs`` (q_len, kv_len)
    segments plus zero-width padding segments up to a power of two (as the
    engine pads), ``pad_rows`` padding rows, pages shuffled over the pool, and
    every dead slot — unused pages, the scratch page, the unwritten tail of
    each last live page — filled with NaN. Metadata from a numpy seed, values
    drawn on the card from the same seed. The q-tile list is built once, as
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
    q = torch.randn((n_real + pad_rows, kv, g, d), generator=gen, device=dev)
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


def bound_ms(case):
    nbytes, flops = work(case)
    dtype = str(case["q"].dtype).replace("torch.", "")
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


def run_case(torch, name, case, *, timed):
    from repro_torch.kernels.paged_attention import mixed_paged_attention
    from repro_torch.kernels.ref import mixed_attention_ref

    dtype = str(case["q"].dtype).replace("torch.", "")
    args = (case["q"], case["k"], case["v"], case["cu"], case["kv_lens"], case["tables"])
    w, cap = case["window"], case["softcap"]
    kw = dict(window=w, softcap=cap)
    got = mixed_paged_attention(*args, **kw, tiles=case["tiles"])
    torch.cuda.synchronize()
    # the plain version in fp32 from the same inputs
    plain_args = (*(a.float() for a in args[:3]), *args[3:])
    plain = mixed_attention_ref(*plain_args, **kw)
    n = case["n_real"]
    real, plain = got[:n].float(), plain[:n]
    finite = bool(torch.isfinite(real).all())
    used = tol_used(real, plain, dtype)
    # the check must see a kernel that ignored the softcap or the window
    faults = {}
    if cap is not None:
        faults["no_softcap"] = mixed_attention_ref(*plain_args, window=w)
    if w is not None:
        faults["no_window"] = mixed_attention_ref(*plain_args, softcap=cap)
    fault_used = {k: tol_used(f[:n], plain, dtype) for k, f in faults.items()}
    rec = dict(phase="kernel_parity", case=name, kernel="mixed_paged_attention", dtype=dtype,
               shape=dict(rows=n, segments=len(case["segs"]), kv=case["q"].shape[1],
                          g=case["q"].shape[2], d=case["q"].shape[3], page=case["page"],
                          window=w, softcap=cap),
               max_abs_err=float((real - plain).abs().max()),
               plain_rms=float(plain.pow(2).mean().sqrt()), tol_used=used,
               fault_tol_used=fault_used, finite=finite,
               ok=finite and used <= 1 and all(u >= FAULT_MARGIN for u in fault_used.values()))
    if timed:
        b, by = bound_ms(case)
        call, rows = library_call(torch, case)
        lib_err = float((rows(call()).float() - plain).abs().max())
        rec.update(
            kernel_ms=time_ms(torch, lambda: mixed_paged_attention(*args, **kw,
                                                                   tiles=case["tiles"]), reps=20),
            plain_ms=time_ms(torch, lambda: mixed_attention_ref(*args, **kw), reps=3,
                             warmup=1),
            bound_ms=b, bound_by=by, library_ms=time_ms(torch, call, reps=10),
            library="torch.nn.functional.scaled_dot_product_attention (padded batch, "
                    "boolean mask, KV pre-gathered)",
            library_max_abs_err=lib_err)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"kernel_parity {name}: {rec}")
    return rec


def kernel_parity(torch):
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    llama = dict(kv=8, g=4, d=128, page=16)
    decode16 = [(1, int(c)) for c in np.linspace(1024, 32768, 16)]
    mixed = [(1, int(c)) for c in np.linspace(1024, 4096, 8)] + [(512, 4096 + 512)]
    small = [(1, 37), (1, 300), (64, 64 + 700), (17, 17), (1, 1)]
    cases = [
        ("decode16_bf16", 1, decode16, dict(llama, dtype=bf16), True),
        ("mixed_bf16", 2, mixed, dict(llama, dtype=bf16), True),
        ("decode16_fp32", 3, decode16, dict(llama, dtype=f32), False),
        ("mixed_fp32", 4, mixed, dict(llama, dtype=f32), False),
        ("page1_fp32", 5, small, dict(llama, page=1, dtype=f32), False),
        ("page1_bf16", 6, small, dict(llama, page=1, dtype=bf16), False),
        # caps of 3-5 bend unit-normal scores (a cap of 50 would not)
        ("window_softcap_bf16", 7, mixed,
         dict(llama, dtype=bf16, window=1024, softcap=3.0), False),
        ("window_softcap_fp32", 8, small,
         dict(llama, dtype=f32, window=100, softcap=5.0), False),
        ("reduced_d16_fp32", 9, small, dict(kv=2, g=2, d=16, page=4, dtype=f32), False),
        ("reduced_d16_bf16", 10, small, dict(kv=2, g=2, d=16, page=4, dtype=bf16,
                                              window=16, softcap=3.0), False),
        ("d32_g8_fp32", 11, small, dict(kv=1, g=8, d=32, page=8, dtype=f32), False),
        ("d64_g1_bf16", 12, small, dict(kv=4, g=1, d=64, page=8, dtype=bf16), False),
    ]
    recs = {}
    for name, seed, segs, kw, timed in cases:
        case = make_case(torch, seed, segs, **kw)
        recs[name] = run_case(torch, name, case, timed=timed)
        del case
        torch.cuda.empty_cache()
    return recs


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

    used = []

    def checked(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, **kw):
        out = mixed_paged_attention(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, **kw)
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
               nonfinite_logits=eng.nonfinite, all_completed=done)
    rec["ok"] = (done and launches == len(used) == eng.steps_run * cfg.n_layers
                 and max(used) <= 1 and eng.nonfinite == 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"engine_bf16: {rec}")


def serve(torch, smi):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.paged_attention import mixed_paged_attention
    from repro_torch.kernels.ref import mixed_attention_ref
    from repro_torch.launch.serve import sized_kv_pool
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request, State

    c = SERVE
    cfg = get_config("llama3.1-8b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = torch.cuda.memory_allocated()
    pool, basis = sized_kv_pool(cfg, dev, torch.bfloat16, c["max_batch"], c["max_len"],
                                c["page"])
    eng = _engine_class()(model, params, SchedulerConfig(
        chunk_size=c["chunk"], max_decode_batch=c["max_batch"],
        max_concurrent_prefills=c["max_prefills"], kv_block_size=c["page"],
        num_kv_blocks=pool), max_len=c["max_len"], device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(c["prompt_lo"], c["prompt_hi"] + 1, c["requests"])
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                           max_new_tokens=c["max_new"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mixed_paged_attention.launches = 0
    mixed_attention_ref.cuda_calls = 0
    step_ms, prefill_tok, decode_tok, has_prefill, step_tok = [], 0, 0, [], []
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
    run_s = time.perf_counter() - t_run
    launches = mixed_paged_attention.launches
    plain_cuda = mixed_attention_ref.cuda_calls
    reqs = [eng.scheduler.requests[r] for r in range(c["requests"])]
    done = all(r.state is State.DONE and len(r.output) == c["max_new"] for r in reqs)
    pre = [i for i, f in enumerate(has_prefill) if f]
    dec = [i for i, f in enumerate(has_prefill) if not f]
    pre_s = sum(step_ms[i] for i in pre) / 1e3
    dec_s = sum(step_ms[i] for i in dec) / 1e3
    rec = dict(
        phase="serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype="bfloat16", requests=c["requests"], prompt_lens=[int(x) for x in lens],
        max_new_tokens=c["max_new"], chunk=c["chunk"], max_decode_batch=c["max_batch"],
        max_concurrent_prefills=c["max_prefills"], kv_block=c["page"], max_len=c["max_len"],
        pool_pages=pool, pool_basis=basis, weight_gib=weight_bytes / 2**30,
        init_s=init_s, steps=eng.steps_run, run_s=run_s,
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
        kernel_launches=launches, plain_cuda_calls=plain_cuda, nonfinite_logits=eng.nonfinite,
        all_completed=done, preemptions=eng.scheduler.stats.preemptions, nvidia_smi=smi)
    rec["ok"] = (done and launches == cfg.n_layers * eng.steps_run and plain_cuda == 0
                 and eng.nonfinite == 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve: {rec}")
    del eng
    torch.cuda.empty_cache()
    profile_serve(torch, model, params)
    return rec


def profile_serve(torch, model, params):
    """Where the device time of a serving run goes. One workload (a 2048- and
    a 1024-token prompt, 16 new tokens each) runs twice on fresh engines:
    untraced for its wall time, then under torch.profiler (device activity
    only) for device time summed by kernel. The idle share is one minus the
    traced device time over the untraced wall time."""
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
    groups, kernels = {"mixed_paged_attention": 0.0, "gemm": 0.0, "other": 0.0}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their device time is their kernels'
        ms = evt.self_device_time_total / 1e3
        if ms <= 0:
            continue
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
        low = evt.key.lower()
        group = ("mixed_paged_attention" if "mixed_paged_attention" in low else
                 "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet"))
                 else "other")
        groups[group] += ms
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit(dict(phase="serve_profile", steps=steps, traced_steps=eng.steps_run,
              wall_ms=wall_ms, device_ms=groups, device_busy_ms=busy,
              idle_share=(1 - busy / wall_ms) if busy else None, device_time_seen=busy > 0,
              top_kernels=[dict(name=k[:120], ms=v) for k, v in top]))


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
    built = _build.build("mixed_paged_attention")
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels={built.name: dict(path=str(built.path.relative_to(ROOT)),
                                        nvcc_s=built.seconds,
                                        ptxas=[ln.strip() for ln in built.log.splitlines()
                                               if "registers" in ln or "spill" in ln])}))

    parity = kernel_parity(torch)
    reduced_serve(torch)
    engine_bf16(torch)
    served = serve(torch, smi)

    main_case = parity["mixed_bf16"]
    emit({"kernels": [dict(
        name="mixed_paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/mixed_paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:268",
        launches=served["kernel_launches"],
        max_abs_err=main_case["max_abs_err"], tol_used=main_case["tol_used"],
        ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], shape_case="mixed_bf16",
        max_abs_err_all_cases=max(r["max_abs_err"] for r in parity.values()))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
