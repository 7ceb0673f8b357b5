"""Greedy serving of jamba (Mamba1 + attention + MoE) through the two-call
engine: the port's ``Engine`` against the JAX package's, at reduced width in
fp32 (``test_torch_mamba1.models``: one period of 8 layers, attention on
layer 4, MoE on the odd layers, biases, norm scales and routers drawn from
a numpy seed).

The workload is ``test_torch_archs_engine.py``'s (three prompts of 20, 33
and 9 tokens, 6, 5 and 8 new tokens; chunk 8, three decode slots, two
prefills a step) drawn from seed 7, chosen among 0..7 for the largest
smallest top-2 logit gap over every greedy step of the port's serial path
(``GAP``); the smallest gap between a token's K-th and (K+1)-th router
probability in those steps is ``ROUTER_MARGIN``.

* the two engines give the same tokens, step for step, the port's serial
  path agrees, and the two traces compare clean (``tools/check_trace.py
  --compare``);
* the attention layer's calls go where ``models/attention.py`` sends them:
  a segment of more than one token from offset 0 to B4
  (``flash_attention_bshd``), a later one to B1 (``mixed_attention_rows``,
  the slot's row one page), the decode call and a one-token segment (the
  33-token prompt's last) to B3 (``decode_attention_bhd``), once a segment
  or step each; no B5;
* the decode call runs in place on contiguous slots (every step of that
  workload) and on a gathered copy otherwise (a workload whose slots 0 and 2
  decode while slot 1 prefills), with the serial path's tokens;
* swap preemption under a KV budget of 30 tokens gives the tokens of the run
  without a budget; a swap moves the slot's rows of every leaf, each
  attention layer's whole ``max_len`` K/V rows (in bf16: the memory
  manager's bytes a token) and each Mamba1 layer's fp32 state, restored bit
  for bit;
* the launcher sizes no KV pool for jamba, as the JAX launcher does, and
  the GQA and MLA archs' pools are what they were.
"""
from __future__ import annotations

import argparse
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
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs.perfetto import export_chrome  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from test_torch_a5 import SWAP_KNOBS, Recording  # noqa: E402
from test_torch_a5 import _assert_restores_bit_exact, _outputs, _submit  # noqa: E402
from test_torch_archs_engine import CHECKER, LENS, MAX_LEN, NEW, SCHED  # noqa: E402
from test_torch_archs_engine import router_margin, serial_with_gap  # noqa: E402
from test_torch_mamba1 import models  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED, GAP, ROUTER_MARGIN = 7, 0.006968, 0.000170
ATTN_OPS = ("flash_attention_bshd", "mixed_attention_rows", "decode_attention_bhd", "ssd")


def prompts(vocab, seed=SEED, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def test_workload_gap_is_the_recorded_one():
    _, _, model, params, _ = models()
    with router_margin() as smallest:
        gaps = [serial_with_gap(model, params, p, n)[1]
                for p, n in zip(prompts(model.cfg.vocab_size), NEW)]
    assert min(gaps) == pytest.approx(GAP, abs=1e-5)
    assert min(gaps) > 3e-3
    assert smallest[0] == pytest.approx(ROUTER_MARGIN, abs=1e-6)
    assert smallest[0] > 1e-4


class Counting(Engine):
    """The port's engine, keeping each step's plan."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.plans = []

    def step(self, now=0.0):
        plan = super().step(now)
        if plan is not None:
            self.plans.append(plan)
        return plan


def test_engine_tokens_match_jax(tmp_path, monkeypatch):
    jmodel, jparams, model, params, _ = models()
    reqs = prompts(model.cfg.vocab_size)
    calls = {name: 0 for name in ATTN_OPS}
    for name in ATTN_OPS:
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **kw))
    jtr, tr = JaxTraceRecorder("engine"), TraceRecorder("engine")
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN, tracer=jtr)
    _submit(jeng, JaxRequest, list(zip(reqs, NEW)))
    jeng.run(max_steps=300)
    eng = Counting(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu",
                   tracer=tr)
    assert eng.two_call and eng.attn_kernel == "dense" and not hasattr(eng, "block_mirror")
    _submit(eng, Request, list(zip(reqs, NEW)))
    eng.run(max_steps=300)
    got = _outputs(eng, len(reqs))
    assert [len(o) for o in got] == NEW
    assert got == _outputs(jeng, len(reqs)) and eng.steps_run == jeng.steps_run
    # each attention call where models/attention.py sends it, and no B5
    segs = [s for p in eng.plans for s in p.prefill_segments]
    n_attn = model.cfg.n_attn_layers
    one = sum(s.length == 1 for s in segs)  # a one-token segment is a decode call's shape
    assert one > 0
    assert calls == {"flash_attention_bshd": n_attn * sum(s.start == 0 < s.length - 1
                                                          for s in segs),
                     "mixed_attention_rows": n_attn * sum(s.start > 0 < s.length - 1
                                                          for s in segs),
                     "decode_attention_bhd": n_attn * (sum(bool(p.decode_slots)
                                                           for p in eng.plans) + one),
                     "ssd": 0}
    assert all(calls[n] > 0 for n in ATTN_OPS[:3])
    # every decode call here ran in place, on contiguous slots
    assert all(r[-1] - r[0] == len(r) - 1 for r in
               (sorted(p.decode_slots) for p in eng.plans if p.decode_slots))
    assert eng.decode_gather_bytes == 0
    assert got == [serial_with_gap(model, params, p, n)[0] for p, n in zip(reqs, NEW)]
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


# slots 0 and 2 decode while slot 1 still prefills: (lens, new tokens, prompt
# seed, smallest top-2 gap, router margin), the seed chosen among 0..7 as
# the first whose gap passes 3e-3
SCATTERED = ((6, 41, 7), (10, 3, 10), 0, 0.005080, 0.000952)


def test_decode_on_scattered_slots_gathers_and_matches_serial():
    """The decode call over slots that are not contiguous gathers their rows
    (K/V and states), decodes them and writes them back: the tokens are the
    serial path's, and ``decode_gather_bytes`` counts each decode row of
    every leaf twice (out and back)."""
    _, _, model, params, _ = models()
    lens, new, seed, gap, margin = SCATTERED
    reqs = prompts(model.cfg.vocab_size, seed=seed, lens=lens)
    eng = Counting(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, list(zip(reqs, new)))
    eng.run(max_steps=300)
    with router_margin() as smallest:
        serial = [serial_with_gap(model, params, p, n) for p, n in zip(reqs, new)]
    assert min(g for _, g in serial) == pytest.approx(gap, abs=1e-5)
    assert smallest[0] == pytest.approx(margin, abs=1e-6)
    assert _outputs(eng, len(reqs)) == [t for t, _ in serial]
    runs = [sorted(p.decode_slots) for p in eng.plans if p.decode_slots]
    scattered = [r for r in runs if r[-1] - r[0] != len(r) - 1]
    assert scattered
    row = sum(t[0].numel() * t.element_size() for layer in eng.cache for t in layer.values())
    assert eng.decode_gather_bytes == 2 * row * sum(len(r) for r in scattered)


SWAP_LENS, SWAP_NEW = (17, 23, 12), (6, 5, 7)  # test_overlap.py's swap workload


def _swap_run(model, params, **knobs):
    reqs = list(zip(prompts(model.cfg.vocab_size, lens=SWAP_LENS), SWAP_NEW))
    eng = Recording(model, params, SchedulerConfig(**knobs), max_len=MAX_LEN, device="cpu",
                    cache_dtype=torch.bfloat16)
    _submit(eng, Request, reqs)
    eng.run(max_steps=500)
    return eng, _outputs(eng, len(reqs))


def test_swap_under_a_budget_gives_the_unbudgeted_tokens():
    _, _, model, params, _ = models()
    free = dict(SWAP_KNOBS, kv_capacity_tokens=None, preemption="recompute")
    _, want = _swap_run(model, params, **free)
    eng, got = _swap_run(model, params, **SWAP_KNOBS)
    assert got == want and [len(o) for o in got] == list(SWAP_NEW)
    stats, mem = eng.scheduler.stats, eng.scheduler.mem
    assert stats.swap_outs == stats.swap_ins > 0
    assert not eng.swap_store and not eng._staged
    _assert_restores_bit_exact(eng, relocated=False)
    cfg = model.cfg
    # a swap moves the slot's row of every leaf: each attention layer's
    # max_len K/V rows, in bf16 the memory manager's bytes a token, and each
    # Mamba1 layer's fp32 {conv, ssm}
    kv = [t for layer in eng.cache for k, t in layer.items() if k in ("k", "v")]
    state = [t for layer in eng.cache for k, t in layer.items() if k in ("conv", "ssm")]
    assert all(t.dtype == torch.bfloat16 for t in kv) and len(kv) == 2 * cfg.n_attn_layers
    assert all(t.dtype == torch.float32 for t in state)
    assert mem.kv_bytes_per_token == 2 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_attn_layers
    row = MAX_LEN * mem.kv_bytes_per_token + sum(t[0].numel() * 4 for t in state)
    assert eng.swap_bytes_moved["d2h"] == stats.swap_outs * row
    assert eng.swap_bytes_moved["h2d"] == eng.swap_bytes_moved["d2h"]


# ---------------------------------------------------------------------------
# the launcher's pool
# ---------------------------------------------------------------------------


def _args(**kw):
    base = dict(num_kv_blocks=None, attn_kernel="auto", max_batch=8, max_len=8192, kv_block=16)
    return argparse.Namespace(**dict(base, **kw))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-2.7b"])
def test_launcher_sizes_no_pool_for_two_call_archs(arch):
    """As the JAX launcher asks ``supports_packed``: a two-call arch gets
    ``num_kv_blocks=None`` over its fixed state, jamba's KV rows included,
    whatever ``--attn-kernel`` says; ``--num-kv-blocks`` still wins."""
    cfg = t_reduce_config(t_get_config(arch))
    cpu = torch.device("cpu")
    for kernel in ("auto", "paged", "dense"):
        assert tserve.pool_plan(cfg, cpu, torch.bfloat16, _args(attn_kernel=kernel)) == (
            None, "two-call state")
    assert tserve.pool_plan(cfg, cpu, torch.bfloat16, _args(num_kv_blocks=12)) == (12, "flag")


@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_launcher_pools_of_packed_archs_are_unchanged(arch, monkeypatch):
    """The GQA and MLA archs' pools: ``sized_kv_pool`` as before, on the CPU
    (the dense cap) and on a card with 1000 blocks' worth of free memory."""
    cfg = t_get_config(arch)
    cpu = torch.device("cpu")
    assert tserve.pool_plan(cfg, cpu, torch.bfloat16, _args()) == (8 * 8192 // 16, "dense")
    assert tserve.pool_plan(cfg, cpu, torch.bfloat16, _args(attn_kernel="dense")) == (
        None, "dense slot cache")
    block = tserve.kv_block_bytes(cfg, torch.bfloat16, 16)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (tserve.ACTIVATION_RESERVE + 1000 * block + 7, 0))
    assert tserve.pool_plan(cfg, torch.device("cuda"), torch.bfloat16, _args()) == (
        1000, "free_memory")


def test_launcher_serves_reduced_jamba_on_the_cpu():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "jamba-v0.1-52b",
         "--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "4", "--chunk",
         "16", "--max-batch", "3", "--max-prefills", "2", "--max-len", "96", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stdout + run.stderr
    line = run.stdout.strip().splitlines()[-1]
    assert "mode=two-call" in line and "completed=4/4" in line
    # the state: 4 slot rows of the attention layer's K/V (max_len tokens)
    # and of seven Mamba1 layers' {conv, ssm}, fp32
    cfg = t_reduce_config(t_get_config("jamba-v0.1-52b"))
    d_in, ds = cfg.m_expand * cfg.d_model, cfg.m_d_state_m1
    kv = 2 * 96 * cfg.n_kv_heads * cfg.head_dim * cfg.n_attn_layers
    ssm = (cfg.m_conv - 1 + ds) * d_in * (cfg.n_layers - cfg.n_attn_layers)
    assert f"state={4 * (kv + ssm) * 4}B(two-call state:cpu)" in line
