"""The port's engine and scheduler against the JAX package's.

* greedy token identity between ``repro_torch``'s ``Engine(device="cpu")``
  and ``repro``'s ``Engine`` on the workload of
  ``test_paged_attention.py``'s paged-engine test (page 4, chunk 8), with
  weights bridged from ``Model.init``;
* the same on an over-subscribed 16-page pool under recompute preemption;
* the copied ``Scheduler`` emits the same ``StepPlan`` sequence as the
  original, field by field.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    cfg_j = reduce_config(get_config("llama3.1-8b"))
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"))
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg_t)
    return jmodel, jparams, model, params


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _serve(engine, request_cls, prompts, outs, max_steps):
    for rid, (prompt, n_out) in enumerate(zip(prompts, outs)):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
    engine.run(max_steps=max_steps)
    return {rid: engine.scheduler.requests[rid].output for rid in range(len(prompts))}


@pytest.mark.parametrize("workload", ["paged_mix", "oversubscribed_recompute"])
def test_engine_token_identity_with_jax(models, workload):
    jmodel, jparams, model, params = models
    sched = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                 max_concurrent_prefills=2, kv_block_size=4)
    if workload == "paged_mix":
        lens, outs, steps = [5, 17, 9], [6, 4, 8], 300
    else:
        # 40/36/32-token contexts = 27 pages of demand against 16 pages
        lens, outs, steps = [24, 20, 16], [16, 16, 16], 400
        sched.update(num_kv_blocks=16, preemption="recompute")
    prompts = _prompts(42, lens, model.cfg.vocab_size)

    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**sched), max_len=MAX_LEN)
    expect = _serve(jeng, JaxRequest, prompts, outs, steps)
    eng = Engine(model, params, SchedulerConfig(**sched), max_len=MAX_LEN, device="cpu")
    got = _serve(eng, Request, prompts, outs, steps)

    assert eng.steps_run == jeng.steps_run
    for rid in expect:
        assert len(got[rid]) == outs[rid]
        assert got[rid] == expect[rid], f"request {rid} diverged"
    if workload == "oversubscribed_recompute":
        assert eng.scheduler.stats.preemptions > 0, "pool never over-subscribed"
        assert eng.scheduler.stats.preemptions == jeng.scheduler.stats.preemptions
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()


def _plain(x):
    """A StepPlan (or anything in it) as plain data, so plans built from the
    two packages' classes compare field by field."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "value") and hasattr(x, "name"):  # enums
        return x.value
    return x


def _drive(sched, requests, max_steps=2000):
    for r in requests:
        sched.add_request(r)
    plans, step = [], 0
    while sched.has_work and step < max_steps:
        plan = sched.next_step(now=float(step))
        if plan is None:
            break
        plans.append(_plain(plan))
        for rid in list(plan.decode_rids) + plan.finishing_rids:
            sched.requests[rid].output.append(step % 7)
        sched.complete_step(plan, now=float(step))
        step += 1
    return plans, _plain(sched.stats)


@pytest.mark.parametrize("policy,kv_cap,pool", [("fcfs", None, None), ("sjf", 64, None),
                                                ("priority", None, 24), ("fcfs", 48, 30)])
def test_scheduler_plans_identical(policy, kv_cap, pool):
    cfg_j = get_config("llama3.1-8b")
    cfg_t = t_get_config("llama3.1-8b")
    kw = dict(chunk_size=16, max_decode_batch=4, max_concurrent_prefills=2, policy=policy,
              kv_capacity_tokens=kv_cap, kv_block_size=4, num_kv_blocks=pool,
              prefetch_buffer_bytes=1 << 22)
    rng = np.random.default_rng(5)
    spec = [(rng.integers(0, 1000, int(rng.integers(3, 40))).tolist(),
             int(rng.integers(1, 24)), int(rng.integers(0, 3))) for _ in range(10)]

    def reqs(cls):
        return [cls(rid=i, prompt=list(p), max_new_tokens=n, priority=pr,
                    arrival_time=float(i // 3))
                for i, (p, n, pr) in enumerate(spec)]

    expect, expect_stats = _drive(JaxScheduler(JaxSchedulerConfig(**kw), cfg_j),
                                  reqs(JaxRequest))
    got, got_stats = _drive(Scheduler(SchedulerConfig(**kw), cfg_t), reqs(Request))
    assert len(got) == len(expect) > 5
    for i, (a, b) in enumerate(zip(got, expect)):
        assert a == b, f"plan {i} differs"
    assert got_stats == expect_stats
    if kv_cap or pool:  # the bounded cases really preempt
        assert got_stats["preemptions"] > 0
