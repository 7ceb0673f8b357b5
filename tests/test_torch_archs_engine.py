"""Greedy serving of the five dense GQA archs the port adds (gemma2-2b,
qwen2-1.5b, chatglm3-6b, qwen3-32b, llama3.1-70b) against the JAX
package's ``Engine``: the port's paged engine for each, and its dense
engine for gemma2, give JAX's tokens, step for step. Models as in
``test_torch_archs.py``: reduced widths with each arch's published group,
biases and norm scales drawn from a numpy seed, gemma2's softcaps at 2.0
and its window of 16 keys below every prompt but one.

The workload is fixed: three prompts of 20, 33 and 9 tokens (6, 5 and 8
new tokens; page 4, chunk 8, three decode slots, two prefills a step),
drawn from the seed in ``WORKLOADS``. Each seed was chosen among 0..7 for
the largest smallest top-2 logit gap over every greedy step of the port's
serial path, and that gap is recorded beside it: a tie within fp32's
drift (about 1e-6 here) could flip a token without a fault, and a gap of
3e-3 or more cannot.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from test_torch_archs import ARCHS, models  # noqa: E402

MAX_LEN = 64
LENS, NEW = [20, 33, 9], [6, 5, 8]
SCHED = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
             max_concurrent_prefills=2, kv_block_size=4)
# arch -> (prompt seed, smallest top-2 logit gap of its greedy steps)
WORKLOADS = {"gemma2-2b": (1, 0.011034), "qwen2-1.5b": (7, 0.006420),
             "chatglm3-6b": (4, 0.010016), "qwen3-32b": (1, 0.010587),
             "llama3.1-70b": (6, 0.004147)}


def prompts(arch, vocab):
    rng = np.random.default_rng(WORKLOADS[arch][0])
    return [rng.integers(0, vocab, n).tolist() for n in LENS]


def serial_with_gap(model, params, prompt, n_new):
    """Greedy tokens of the port's serial path and the smallest top-2 logit
    gap among the steps that chose them."""
    cache = model.init_cache(1, MAX_LEN)
    logits, _ = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                              cache, 0)
    toks, gaps = [], []
    for i in range(n_new):
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n_new - 1:
            logits, _ = model.decode_step(params, torch.tensor([[toks[-1]]], dtype=torch.int32),
                                          cache, len(prompt) + i)
    return toks, min(gaps)


def _serve(engine, request_cls, reqs):
    for rid, (prompt, n_out) in enumerate(zip(reqs, NEW)):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
    engine.run(max_steps=300)
    return [engine.scheduler.requests[rid].output for rid in range(len(reqs))]


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_gap_is_the_recorded_one(arch):
    _, _, model, params, _ = models(arch)
    gaps = [serial_with_gap(model, params, p, n)[1]
            for p, n in zip(prompts(arch, model.cfg.vocab_size), NEW)]
    assert min(gaps) == pytest.approx(WORKLOADS[arch][1], abs=1e-5)
    assert min(gaps) > 3e-3


@pytest.mark.parametrize("arch,kernel", [(a, "paged") for a in ARCHS]
                         + [("gemma2-2b", "dense")])
def test_engine_tokens_match_jax(arch, kernel):
    jmodel, jparams, model, params, _ = models(arch)
    reqs = prompts(arch, model.cfg.vocab_size)
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN,
                     attn_kernel=kernel)
    expect = _serve(jeng, JaxRequest, reqs)
    eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, attn_kernel=kernel,
                 device="cpu")
    got = _serve(eng, Request, reqs)
    assert eng.attn_kernel == kernel and eng.steps_run == jeng.steps_run
    assert [len(o) for o in got] == NEW
    assert got == expect
    # and the port's serial path agrees
    assert got == [serial_with_gap(model, params, p, n)[0] for p, n in zip(reqs, NEW)]
