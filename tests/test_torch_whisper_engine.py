"""Greedy serving of whisper (encoder-decoder) through the two-call engine:
the port's ``Engine`` against the JAX package's, at reduced width in fp32
(``test_torch_encdec.models``: 2 encoder and 2 decoder layers, biases and
norm scales drawn from a numpy seed).

The workload is JAX's ``tests/test_engine.py``'s shape: four prompts of 5,
17, 9 and 23 tokens (6, 4, 8 and 5 new tokens; chunk 8, three decode slots,
so a slot is reused), each with ``frontend_len`` frame embeddings of std 1,
all drawn from seed 1, chosen among 0..7 for the largest smallest top-2
logit gap over every greedy step of the port's serial path (``GAP``).

* the two engines give the same tokens, step for step, the port's serial
  path agrees, and the two traces compare clean (``tools/check_trace.py
  --compare``); each attention call goes where ``models/attention.py``
  sends it: per prefill segment B4 once an encoder layer and once a
  decoder layer's cross-attention (more than one token; B3 for one), the
  decoder's self-attention B4 from offset 0, B1 later, B3 for one token;
  per decode call B3 twice a decoder layer;
* a request without frames is encoded from zeros, as JAX's engine does;
* a reused slot's cross rows are its new request's;
* the decode call over slots that are not contiguous gathers their rows,
  cross rows included, and gives the serial path's tokens;
* swap preemption under a KV budget gives the unbudgeted tokens; a swap
  moves every leaf's slot row, the cross K/V rows too, bit for bit;
* the launcher serves reduced whisper on the CPU;
* a check that can fail: two requests' frames swapped change their tokens.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.obs.perfetto import export_chrome as jax_export_chrome  # noqa: E402
from repro.obs.trace import TraceRecorder as JaxTraceRecorder  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.obs.perfetto import export_chrome  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.serial import serial_reference  # noqa: E402
from test_torch_a5 import SWAP_KNOBS, Recording, _assert_restores_bit_exact  # noqa: E402
from test_torch_archs_engine import CHECKER  # noqa: E402
from test_torch_encdec import models  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 64
LENS, NEW = (5, 17, 9, 23), (6, 4, 8, 5)
SEED, GAP = 1, 0.004000
SCHED = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
             max_concurrent_prefills=2)
ATTN_OPS = ("flash_attention_bshd", "mixed_attention_rows", "decode_attention_bhd")


def workload(vocab, F, d, seed=SEED, lens=LENS):
    """Prompts, then each request's (F, d) frames, from one numpy seed."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    frames = [rng.standard_normal((F, d)).astype(np.float32) for _ in lens]
    return prompts, frames


def _workload(model, **kw):
    cfg = model.cfg
    return workload(cfg.vocab_size, cfg.frontend_len, cfg.d_model, **kw)


def serial_with_gap(model, params, prompt, frames, n_new):
    """Greedy tokens of the port's serial path and the smallest top-2 logit
    gap among the steps that chose them."""
    cache = model.init_cache(1, MAX_LEN)
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32),
             "frames": torch.from_numpy(frames)[None]}
    logits, _ = model.prefill(params, batch, cache, 0)
    toks, gaps = [], []
    for i in range(n_new):
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n_new - 1:
            step = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, _ = model.decode_step(params, step, cache, len(prompt) + i)
    return toks, min(gaps)


def _submit(engine, request_cls, prompts, news, frames):
    for rid, (prompt, n, f) in enumerate(zip(prompts, news, frames)):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n, frames=f))


def _outputs(engine, n):
    return [list(engine.scheduler.requests[rid].output) for rid in range(n)]


class Counting(Engine):
    """The port's engine, keeping each step's plan and, after each prefill
    segment, its slot's cross K rows of the first decoder layer."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.plans, self.cross_rows = [], []

    def step(self, now=0.0):
        plan = super().step(now)
        if plan is not None:
            self.plans.append(plan)
        return plan

    def _run_two_call(self, plan):
        out = super()._run_two_call(plan)
        for seg in plan.prefill_segments:
            self.cross_rows.append((seg.rid, seg.slot,
                                    self.cache[0]["cross_k"][seg.slot].clone()))
        return out


def test_workload_gap_is_the_recorded_one():
    _, _, model, params, _ = models()
    prompts, frames = _workload(model)
    gaps = [serial_with_gap(model, params, p, f, n)[1] for p, f, n in zip(prompts, frames, NEW)]
    assert min(gaps) == pytest.approx(GAP, abs=1e-5)
    assert min(gaps) > 3e-3


def test_engine_tokens_match_jax(tmp_path, monkeypatch):
    jmodel, jparams, model, params, _ = models()
    prompts, frames = _workload(model)
    calls = {name: 0 for name in ATTN_OPS}
    for name in ATTN_OPS:
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **kw))
    jtr, tr = JaxTraceRecorder("engine"), TraceRecorder("engine")
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN, tracer=jtr)
    _submit(jeng, JaxRequest, prompts, NEW, frames)
    jeng.run(max_steps=300)
    eng = Counting(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu",
                   tracer=tr)
    assert eng.two_call and eng.attn_kernel == "dense"
    _submit(eng, Request, prompts, NEW, frames)
    eng.run(max_steps=300)
    engine_calls = dict(calls)  # the serial path below calls them too
    got = _outputs(eng, len(prompts))
    assert [len(o) for o in got] == list(NEW)
    assert got == _outputs(jeng, len(prompts)) and eng.steps_run == jeng.steps_run
    assert got == [serial_reference(model, params, p, n, max_len=MAX_LEN, frames=f)
                   for p, f, n in zip(prompts, frames, NEW)]
    # each attention call where models/attention.py sends it
    cfg = model.cfg
    segs = [s for p in eng.plans for s in p.prefill_segments]
    first = sum(s.start == 0 < s.length - 1 for s in segs)
    later = sum(s.start > 0 < s.length - 1 for s in segs)
    one = sum(s.length == 1 for s in segs)
    decodes = sum(bool(p.decode_slots) for p in eng.plans)
    L, E = cfg.n_layers, cfg.n_enc_layers
    assert engine_calls == {"flash_attention_bshd": E * len(segs) + L * (len(segs) - one) + L * first,
                            "mixed_attention_rows": L * later,
                            "decode_attention_bhd": 2 * L * (decodes + one)}
    assert first and later and decodes
    # the slot of request 3 was another request's before
    slots = {}
    for rid, slot, _ in eng.cross_rows:
        slots.setdefault(slot, set()).add(rid)
    assert any(len(r) > 1 for r in slots.values())
    # the two engines' traces: the same steps, spans and counters
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    eng.scheduler.ledger.record_totals(tr, eng.attribution_aggregates())
    jeng.scheduler.ledger.record_totals(jtr, jeng.attribution_aggregates())
    paths = [tmp_path / "port.json", tmp_path / "jax.json"]
    export_chrome(tr, str(paths[0]))
    jax_export_chrome(jtr, str(paths[1]))
    run = subprocess.run([sys.executable, str(CHECKER), str(paths[0]), "--compare",
                          str(paths[1])], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_requests_without_frames_are_encoded_from_zeros():
    """Frames None: the port's engine gives JAX's engine's tokens, and its
    own with explicit zero frames."""
    jmodel, jparams, model, params, _ = models()
    cfg = model.cfg
    prompts, _ = _workload(model)
    none = [None] * len(prompts)
    zeros = [np.zeros((cfg.frontend_len, cfg.d_model), np.float32)] * len(prompts)
    runs = []
    for cls, frames in ((Engine, none), (Engine, zeros), (JaxEngine, none)):
        if cls is Engine:
            eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu")
            _submit(eng, Request, prompts, NEW, frames)
        else:
            eng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN)
            _submit(eng, JaxRequest, prompts, NEW, frames)
        eng.run(max_steps=300)
        runs.append(_outputs(eng, len(prompts)))
    assert runs[0] == runs[1] == runs[2]
    assert [len(o) for o in runs[0]] == list(NEW)


def test_reused_slot_holds_its_new_requests_cross_rows():
    _, _, model, params, _ = models()
    prompts, frames = _workload(model)
    eng = Counting(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, prompts, NEW, frames)
    eng.run(max_steps=300)
    owners = {}
    for rid, slot, rows in eng.cross_rows:
        want = encdec.cross_kv_all(params, model.cfg, encdec.encode(
            params, model.cfg, torch.from_numpy(frames[rid])[None]))[0]["k"][0]
        torch.testing.assert_close(rows, want, rtol=1e-6, atol=1e-6)
        owners.setdefault(slot, []).append(rid)
    # some slot served two requests, one after the other
    assert any(len(set(r)) > 1 for r in owners.values())


# slots 0 and 2 decode while slot 1 still prefills: (lens, new tokens, seed,
# smallest top-2 gap), the seed chosen among 0..39 as the first whose gap
# passes 3e-3 (none of 0..7 does)
SCATTERED = ((6, 41, 7), (10, 3, 10), 30, 0.003321)


def test_decode_on_scattered_slots_gathers_and_matches_serial():
    """The decode call over slots that are not contiguous gathers their
    rows (self and cross K/V), decodes them and writes them back: the
    serial path's tokens, and ``decode_gather_bytes`` counts each decode
    row of every leaf twice (out and back)."""
    _, _, model, params, _ = models()
    lens, new, seed, gap = SCATTERED
    prompts, frames = _workload(model, seed=seed, lens=lens)
    eng = Counting(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, prompts, new, frames)
    eng.run(max_steps=300)
    serial = [serial_with_gap(model, params, p, f, n) for p, f, n in zip(prompts, frames, new)]
    assert min(g for _, g in serial) == pytest.approx(gap, abs=1e-5)
    assert _outputs(eng, len(prompts)) == [t for t, _ in serial]
    runs = [sorted(p.decode_slots) for p in eng.plans if p.decode_slots]
    scattered = [r for r in runs if r[-1] - r[0] != len(r) - 1]
    assert scattered
    row = sum(t[0].numel() * t.element_size() for layer in eng.cache for t in layer.values())
    cross = sum(t[0].numel() * t.element_size() for layer in eng.cache
                for k, t in layer.items() if k.startswith("cross_"))
    assert cross > 0
    assert eng.decode_gather_bytes == 2 * row * sum(len(r) for r in scattered)


SWAP_LENS, SWAP_NEW = (17, 23, 12), (6, 5, 7)  # test_overlap.py's swap workload


def _swap_run(model, params, frames, prompts, **knobs):
    eng = Recording(model, params, SchedulerConfig(**knobs), max_len=MAX_LEN, device="cpu",
                    cache_dtype=torch.bfloat16)
    _submit(eng, Request, prompts, SWAP_NEW, frames)
    eng.run(max_steps=500)
    return eng, _outputs(eng, len(prompts))


def test_swap_under_a_budget_gives_the_unbudgeted_tokens():
    _, _, model, params, _ = models()
    prompts, frames = _workload(model, lens=SWAP_LENS)
    free = dict(SWAP_KNOBS, kv_capacity_tokens=None, preemption="recompute")
    _, want = _swap_run(model, params, frames, prompts, **free)
    eng, got = _swap_run(model, params, frames, prompts, **SWAP_KNOBS)
    assert got == want and [len(o) for o in got] == list(SWAP_NEW)
    stats = eng.scheduler.stats
    assert stats.swap_outs == stats.swap_ins > 0
    assert not eng.swap_store and not eng._staged
    _assert_restores_bit_exact(eng, relocated=False)
    # a swap moves the slot's row of every leaf: each decoder layer's
    # max_len self K/V rows and its F cross K/V rows, bf16
    cfg = model.cfg
    leaves = [(k, t) for layer in eng.cache for k, t in layer.items()]
    assert sorted({k for k, _ in leaves}) == ["cross_k", "cross_v", "k", "v"]
    assert all(t.dtype == torch.bfloat16 for _, t in leaves)
    row = 2 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * (MAX_LEN + cfg.frontend_len)
    assert eng.swap_bytes_moved["d2h"] == stats.swap_outs * row
    assert eng.swap_bytes_moved["h2d"] == eng.swap_bytes_moved["d2h"]


def test_swapped_frames_change_the_tokens():
    """A check that can fail: serving requests 0 and 1 with each other's
    frames gives other tokens, so the engine's tokens above depend on
    whose audio a request brought."""
    _, _, model, params, _ = models()
    prompts, frames = _workload(model)
    runs = []
    for fr in (frames, [frames[1], frames[0]] + frames[2:]):
        eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu")
        _submit(eng, Request, prompts, NEW, fr)
        eng.run(max_steps=300)
        runs.append(_outputs(eng, len(prompts)))
    assert runs[0][0] != runs[1][0] and runs[0][1] != runs[1][1]
    assert runs[0][2:] == runs[1][2:]


def test_launcher_serves_reduced_whisper_on_the_cpu():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "whisper-small",
         "--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "4", "--chunk",
         "16", "--max-batch", "3", "--max-prefills", "2", "--max-len", "96", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stdout + run.stderr
    line = run.stdout.strip().splitlines()[-1]
    assert "mode=two-call" in line and "completed=4/4" in line
    # 4 slot rows of one decoder layer's self K/V (max_len) and cross K/V
    # (frontend_len), fp32
    cfg = t_reduce_config(t_get_config("whisper-small"))
    per = 2 * cfg.n_kv_heads * cfg.head_dim * 4 * 4 * cfg.n_layers
    assert f"state={per * (96 + cfg.frontend_len)}B(two-call state:cpu)" in line
    assert f"cross={per * cfg.frontend_len}B" in line
