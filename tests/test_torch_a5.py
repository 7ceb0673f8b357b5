"""The port's swap preemption, prefix cache and async prefetch staging
against the JAX engine's.

Every workload is fixed (the JAX package's own engine tests name them:
``test_engine.py``, ``test_overlap.py``, ``test_prefix_cache.py``,
``test_robustness.py``); nothing is drawn at random. The port runs on the
CPU with the JAX engine's parameters (``from_jax_params``) at fp32 and
reduced width, and must give the same greedy tokens, the same scheduler
counters and the same byte attribution. Restored pages are held bit for bit
to the pages gathered at their swap-out.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs.perfetto import export_chrome as jax_export_chrome  # noqa: E402
from repro.obs.trace import TraceRecorder as JaxTraceRecorder  # noqa: E402
from repro.robustness import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.robustness import FaultSpec as JaxFaultSpec  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.core.scheduler import StepPlan  # noqa: E402
from repro_torch.memory.prefetch_queue import SWAP_IN  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs.perfetto import export_chrome  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.robustness import VERDICT_DELAY, VERDICT_FAIL, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.engine import Engine, HostPool  # noqa: E402
from repro_torch.serving.request import Request, State  # noqa: E402
from repro_torch.serving.workload import shared_prefix_requests  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MAX_LEN = 64
CHECKER = Path(__file__).resolve().parent.parent / "tools" / "check_trace.py"
# test_overlap.py / test_robustness.py's swap-thrash knobs
SWAP_KNOBS = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=0,
                  max_concurrent_prefills=2, kv_capacity_tokens=30, preemption="swap",
                  kv_block_size=4)
# test_engine.py's swap-preemption knobs (kv_block_size 1 unless given)
ENGINE_SWAP = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                   max_concurrent_prefills=2, kv_capacity_tokens=30, preemption="swap")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    cfg_j = dropless(reduce_config(get_config(arch)))
    cfg_t = t_reduce_config(t_get_config(arch))
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, from_jax_params(_np(jparams), cfg_t)


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.1-8b")


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-2.7b")


def _engine_requests(seed, n, vocab):
    """``test_engine.py``'s ``make_requests(cfg, PRNGKey(seed), n)``."""
    rng = jax.random.PRNGKey(seed)
    lens, outs = [5, 17, 9, 23, 12][:n], [6, 4, 8, 5, 7][:n]
    return [(np.asarray(jax.random.randint(jax.random.fold_in(rng, i), (lens[i],), 0,
                                           vocab)).tolist(), outs[i]) for i in range(n)]


def _swap_requests(vocab, seed=3):
    """``test_overlap.py`` / ``test_robustness.py``'s ``_swap_reqs``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, L).tolist(), o) for L, o in [(17, 6), (23, 5), (12, 7)]]


def _submit(engine, request_cls, reqs):
    for rid, (prompt, n_out) in enumerate(reqs):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))


def _outputs(engine, n):
    return [list(engine.scheduler.requests[rid].output) for rid in range(n)]


class Recording(Engine):
    """The port's engine, keeping a copy of every page (or slot row) a
    swap-out gathers, as the step found it before any of its device writes,
    and of the same pages where the swap-in put them, with their physical
    ids; and each step's swap-out page ids."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.round_trips = []  # [rid, ids out, pages out, ids in, pages in]
        self.plans = []
        self.out_pages = []  # per step: the physical ids its swap-outs gathered

    def _where(self, rid, slot, positions=None, record=None, cache=None):
        cache = self.cache if cache is None else cache
        if self.attn_kernel != "paged":
            return [slot], [{k: v[slot].clone() for k, v in layer.items()} for layer in cache]
        blocks = (record.table.blocks if record is not None
                  else self.scheduler.mem.allocator.tables[rid].blocks)
        ids = [blocks[i] for i in positions]
        index = torch.tensor(ids, dtype=torch.long)
        return ids, [{k: v.index_select(0, index) for k, v in layer.items()} for layer in cache]

    def _swap_out(self, plan, rid, slot):
        rec = (self.scheduler.mem.swapped[rid].record if self.attn_kernel == "paged"
               else None)
        ids, pages = self._where(rid, slot, rec and rec.spilled_indices, rec, self._at_start)
        super()._swap_out(plan, rid, slot)
        self.round_trips.append([rid, ids, pages, None, None])
        self.out_pages[-1].extend(ids)

    def _swap_in(self, plan, rid, slot):
        idx = self.swap_store[rid]["idx"]
        super()._swap_in(plan, rid, slot)
        trip = next(t for t in self.round_trips if t[0] == rid and t[3] is None)
        trip[3], trip[4] = self._where(rid, slot, idx)

    def step(self, now=0.0):
        # the cache as the step finds it: each swap-out is held to it
        self._at_start = [{k: v.clone() for k, v in layer.items()} for layer in self.cache]
        self.out_pages.append([])
        plan = super().step(now)
        if plan is not None:
            self.plans.append(plan)
        return plan


def _assert_restores_bit_exact(eng, relocated=True):
    trips = eng.round_trips
    assert trips and all(t[3] is not None for t in trips), "a swap-out was never restored"
    for rid, ids_out, out, ids_in, back in trips:
        assert len(ids_out) == len(ids_in)
        for a, b in zip(out, back):
            for k in a:
                assert torch.equal(a[k], b[k]), f"rid {rid}: {k} changed across its round trip"
    if relocated:
        # physical ids are not sticky: some restore landed in other pages
        assert any(t[1] != t[3] for t in trips)


# ---------------------------------------------------------------------------
# swap preemption: test_engine.py:167 (paged, dense, two-call) and :201
# ---------------------------------------------------------------------------

SWAP_CASES = {
    # test_engine_swap_preemption_matches_serial, Llama: paged pages of 1
    "llama_paged": ("llama3.1-8b", "paged", 44, {}),
    "llama_dense": ("llama3.1-8b", "dense", 44, {}),
    # test_engine_swap_restore_is_block_exact: pages of 4
    "llama_paged_block4": ("llama3.1-8b", "paged", 45, dict(kv_block_size=4)),
    # the same test's two-call arch: Mamba2's {conv, ssm} slot rows
    "mamba_two_call": ("mamba2-2.7b", "auto", 44, {}),
}


@pytest.mark.parametrize("case", sorted(SWAP_CASES))
def test_swap_preemption_matches_jax(llama, mamba, case):
    arch, kernel, seed, extra = SWAP_CASES[case]
    jmodel, jparams, model, params = llama if arch.startswith("llama") else mamba
    knobs = dict(ENGINE_SWAP, **extra)
    reqs = _engine_requests(seed, 3, model.cfg.vocab_size)
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**knobs), max_len=MAX_LEN,
                     attn_kernel=kernel)
    _submit(jeng, JaxRequest, reqs)
    jeng.run(max_steps=500)
    eng = Recording(model, params, SchedulerConfig(**knobs), max_len=MAX_LEN,
                    attn_kernel=kernel, device="cpu")
    assert eng.attn_kernel == jeng.attn_kernel and eng.two_call == (arch == "mamba2-2.7b")
    _submit(eng, Request, reqs)
    eng.run(max_steps=500)

    assert _outputs(eng, 3) == _outputs(jeng, 3)
    assert all(len(o) == n for o, (_, n) in zip(_outputs(eng, 3), reqs))
    stats = eng.scheduler.stats
    assert stats.swap_outs == stats.swap_ins > 0
    assert stats.swap_outs == jeng.scheduler.stats.swap_outs
    assert eng.steps_run == jeng.steps_run
    assert not eng.swap_store and not eng._staged
    assert all(r.restart_output_len == 0 for r in eng.scheduler.requests.values())
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    _assert_restores_bit_exact(eng, relocated=kernel == "paged")
    if kernel == "paged":
        # a swap moves exactly the spilled pages: no padding crosses the link
        elem = model.cfg.n_kv_heads * model.cfg.head_dim * 4 * 2 * model.cfg.n_layers
        pages = sum(len(t[1]) for t in eng.round_trips)
        assert eng.swap_bytes_moved["d2h"] == pages * eng.page_size * elem
        assert eng.swap_bytes_moved["h2d"] == eng.swap_bytes_moved["d2h"]
    # every swap-out took a buffer from the host pool, new or given back
    assert eng.host_pool.reused + eng.host_pool.pinned == stats.swap_outs


def test_host_pool_reuses_a_buffer_that_fits():
    pool = HostPool(pin=False)
    a = pool.take(3000)
    assert a.numel() >= 3000 and pool.pinned == 1
    pool.give(a, [])
    b = pool.take(1000)
    assert b.data_ptr() == a.data_ptr() and pool.reused == 1 and pool.pinned == 1
    c = pool.take(a.numel() + 1)  # too big for any free buffer: a new one
    assert pool.pinned == 2 and c.numel() > a.numel()
    # each pool keeps its own buffers
    pool.give(c, [])
    other = HostPool(pin=False)
    assert other.take(1000).data_ptr() not in (a.data_ptr(), c.data_ptr())
    assert other.reused == 0 and other.pinned == 1


# ---------------------------------------------------------------------------
# async staging on and off: test_overlap.py:138, :150
# ---------------------------------------------------------------------------

def test_verify_landed_raises(llama):
    _, _, model, params = llama
    eng = Engine(model, params, SchedulerConfig(chunk_size=16, kv_block_size=4),
                 max_len=MAX_LEN, device="cpu")
    eng.scheduler.prefetch_queue.issue(rid=5, kind=SWAP_IN, nbytes=128, step=0)
    with pytest.raises(RuntimeError, match="has not landed"):
        eng._verify_landed(StepPlan(decode_slots=[0], decode_rids=[5]))


@pytest.mark.parametrize("async_on", [True, False])
def test_async_staging_on_and_off_match_jax(llama, async_on):
    jmodel, jparams, model, params = llama
    reqs = _swap_requests(model.cfg.vocab_size)
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(async_prefetch=async_on, **SWAP_KNOBS),
                     max_len=MAX_LEN)
    _submit(jeng, JaxRequest, reqs)
    jeng.run(max_steps=2000)
    eng = Recording(model, params, SchedulerConfig(async_prefetch=async_on, **SWAP_KNOBS),
                    max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, reqs)
    eng.run(max_steps=2000)

    assert _outputs(eng, 3) == _outputs(jeng, 3)
    qs, jqs = eng.scheduler.prefetch_queue.stats, jeng.scheduler.prefetch_queue.stats
    assert eng.scheduler.stats.swap_ins > 0
    assert qs.bytes_overlapped == jqs.bytes_overlapped
    assert qs.bytes_sync == jqs.bytes_sync
    if async_on:
        assert qs.bytes_overlapped > 0
    else:
        assert qs.bytes_overlapped == 0
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    assert not eng._staged and not eng.swap_store
    _assert_restores_bit_exact(eng)


# ---------------------------------------------------------------------------
# prefix cache: test_prefix_cache.py:389, :411, and a mid-block prefix
# ---------------------------------------------------------------------------

PREFIX_KNOBS = dict(chunk_size=16, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                    max_concurrent_prefills=2, kv_block_size=4)


def _prefix_run(engine_cls, model, params, reqs, request_cls, cfg_cls, **kw):
    eng = engine_cls(model, params, cfg_cls(**dict(PREFIX_KNOBS, **kw)), max_len=MAX_LEN,
                     **({} if engine_cls is JaxEngine else {"device": "cpu"}))
    for r in reqs:
        eng.submit(request_cls(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens))
    eng.run(max_steps=800)
    return eng


PREFIX_CASES = {
    # test_engine_prefix_cache_token_identical
    "hits": (dict(n=4, shared_len=24, unique_len=8, max_new_tokens=5, jitter=2, seed=3), {}),
    # test_engine_prefix_cache_oversubscribed_identity, both preemptions
    "pool16_recompute": (dict(n=4, shared_len=20, unique_len=8, max_new_tokens=5, jitter=2,
                              seed=11), dict(num_kv_blocks=16, preemption="recompute")),
    "pool16_swap": (dict(n=4, shared_len=20, unique_len=8, max_new_tokens=5, jitter=2,
                         seed=11), dict(num_kv_blocks=16, preemption="swap")),
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_cache_matches_jax(llama, case):
    jmodel, jparams, model, params = llama
    wl, kw = PREFIX_CASES[case]
    reqs = shared_prefix_requests(vocab_size=model.cfg.vocab_size, **wl)
    jeng = _prefix_run(JaxEngine, jmodel, jparams, reqs, JaxRequest, JaxSchedulerConfig,
                       enable_prefix_cache=True, **kw)
    eng = _prefix_run(Recording, model, params, reqs, Request, SchedulerConfig,
                      enable_prefix_cache=True, **kw)
    n = len(reqs)
    assert _outputs(eng, n) == _outputs(jeng, n)
    stats, jstats = eng.scheduler.stats, jeng.scheduler.stats
    assert stats.prefix_hits == jstats.prefix_hits > 0
    assert stats.prefill_tokens == jstats.prefill_tokens
    assert stats.preemptions == jstats.preemptions
    assert stats.swap_outs == jstats.swap_outs
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    assert not eng.swap_store and not eng._staged
    if case == "hits":
        off = _prefix_run(Engine, model, params, reqs, Request, SchedulerConfig)
        assert off.scheduler.stats.prefill_tokens > stats.prefill_tokens
        assert _outputs(off, n) == _outputs(eng, n)
    else:
        assert stats.out_of_block_stalls > 0 or stats.preemptions > 0
    if kw.get("preemption") == "swap":
        assert stats.swap_outs > 0
        _assert_restores_bit_exact(eng, relocated=False)


def test_mid_block_prefix_copies_match_jax(llama):
    """test_engine_mid_block_prefix_resume_token_identity's two requests (a
    shared prefix of 14 tokens: 3 pages of 4 and 2 tokens), and a third whose
    prefix of 22 ends inside its sixth page, admitted after the first two
    finish: each resume copies its partial page."""
    jmodel, jparams, model, params = llama
    rng = np.random.default_rng(17)
    base = rng.integers(0, model.cfg.vocab_size, size=26).tolist()
    tail = [(t + 1) % model.cfg.vocab_size for t in base[14:24]]
    third = base[:22] + [(t + 3) % model.cfg.vocab_size for t in base[22:26]]
    prompts = [base, base[:14] + tail, third]
    outs = {}
    for name, eng, request_cls in (
            ("jax", JaxEngine(jmodel, jparams, JaxSchedulerConfig(
                enable_prefix_cache=True, **PREFIX_KNOBS), max_len=MAX_LEN), JaxRequest),
            ("port", Recording(model, params, SchedulerConfig(
                enable_prefix_cache=True, **PREFIX_KNOBS), max_len=MAX_LEN, device="cpu"),
             Request)):
        for rid, prompt in enumerate(prompts):
            eng.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=5))
            eng.run(max_steps=200)
        outs[name] = (_outputs(eng, 3), eng.scheduler.stats.prefix_hit_tokens)
    port = eng
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == 14 + 22
    copies = [c for p in port.plans for c in p.prefix_copies]
    assert len(copies) == 2 and {c[0] for c in copies} == {1, 2}
    assert sorted(c[3] for c in copies) == [2, 2]  # tokens of the copied page that match
    assert not port.scheduler.mem.pending_prefix_copies


def test_prefix_copy_into_a_page_a_victim_freed(llama):
    """Pool pressure under the prefix cache and swap: step 5 swaps a victim
    out and admits a mid-block resume whose fresh destination page is one
    the victim just gave up. The swap-out must save the victim's page, not
    the prefix page copied into it: every restore is bit-equal to the
    victim's pages as the step found them, and the tokens equal those of a
    run with no pressure at all. The JAX engine copies the prefix page first
    and restores it in the victim's place (ROADMAP.md §C), so its tokens
    drift."""
    jmodel, jparams, model, params = llama
    reqs = shared_prefix_requests(vocab_size=model.cfg.vocab_size, n=4, shared_len=19,
                                  unique_len=8, max_new_tokens=5, jitter=2, seed=0)
    pressure = dict(enable_prefix_cache=True, num_kv_blocks=16, preemption="swap")
    eng = _prefix_run(Recording, model, params, reqs, Request, SchedulerConfig, **pressure)
    reused = [(i, c[2]) for i, (p, out) in enumerate(zip(eng.plans, eng.out_pages))
              for c in p.prefix_copies if c[2] in out]
    assert reused and reused[0][0] == 5
    _assert_restores_bit_exact(eng, relocated=False)
    free = _prefix_run(JaxEngine, jmodel, jparams, reqs, JaxRequest, JaxSchedulerConfig,
                       enable_prefix_cache=True)
    assert free.scheduler.stats.preemptions == 0
    assert _outputs(eng, 4) == _outputs(free, 4)
    jeng = _prefix_run(JaxEngine, jmodel, jparams, reqs, JaxRequest, JaxSchedulerConfig,
                       **pressure)
    assert jeng.scheduler.stats.swap_outs == eng.scheduler.stats.swap_outs > 0
    assert _outputs(jeng, 4) != _outputs(eng, 4)


# ---------------------------------------------------------------------------
# chaos: test_robustness.py:417, :438, :456, :501
# ---------------------------------------------------------------------------

def _fault_plans():
    scripted = {(0, 0): (VERDICT_FAIL, 0), (1, 0): (VERDICT_DELAY, 2)}
    kw = dict(seed=2, fail_rate=0.4, delay_rate=0.2)
    return (JaxFaultPlan(scripted={k: JaxFaultSpec(v, delay_steps=d)
                                   for k, (v, d) in scripted.items()}, **kw),
            FaultPlan(scripted={k: FaultSpec(v, delay_steps=d)
                                for k, (v, d) in scripted.items()}, **kw))


def _swap_pair(llama, jax_kw, port_kw, reqs, engine_cls=Engine):
    jmodel, jparams, model, params = llama
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SWAP_KNOBS, **jax_kw), max_len=MAX_LEN)
    _submit(jeng, JaxRequest, reqs)
    jeng.run(max_steps=2000)
    eng = engine_cls(model, params, SchedulerConfig(**SWAP_KNOBS, **port_kw), max_len=MAX_LEN,
                     device="cpu")
    _submit(eng, Request, reqs)
    eng.run(max_steps=2000)
    return jeng, eng


def test_chaos_retries_match_jax(llama):
    reqs = _swap_requests(llama[2].cfg.vocab_size)
    jplan, plan = _fault_plans()
    jeng, eng = _swap_pair(llama, dict(fault_plan=jplan, max_transfer_retries=2),
                           dict(fault_plan=plan, max_transfer_retries=2), reqs, Recording)
    _, clean = _swap_pair(llama, {}, {}, reqs)
    assert _outputs(eng, 3) == _outputs(jeng, 3) == _outputs(clean, 3)
    qs, jqs = eng.scheduler.prefetch_queue.stats, jeng.scheduler.prefetch_queue.stats
    assert qs.transfer_failures == jqs.transfer_failures > 0
    assert qs.transfer_retries == jqs.transfer_retries > 0
    assert qs.bytes_refetched == jqs.bytes_refetched
    q = eng.scheduler.prefetch_queue
    assert q.outstanding() == 0 and q.fully_terminal()
    assert not eng._staged and not eng.swap_store
    assert eng.scheduler.mem.allocator.used_blocks == 0
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    _assert_restores_bit_exact(eng)


def test_chaos_fallback_to_recompute_matches_jax(llama):
    reqs = _swap_requests(llama[2].cfg.vocab_size)
    jeng, eng = _swap_pair(llama, dict(fault_plan=JaxFaultPlan(seed=0, fail_rate=1.0),
                                       max_transfer_retries=1),
                           dict(fault_plan=FaultPlan(seed=0, fail_rate=1.0),
                                max_transfer_retries=1), reqs)
    assert _outputs(eng, 3) == _outputs(jeng, 3)
    ss = eng.scheduler.stats
    assert ss.fallback_recomputes == jeng.scheduler.stats.fallback_recomputes > 0
    assert eng.scheduler.prefetch_queue.stats.transfers_aborted > 0
    assert not eng.swap_store and not eng._staged
    assert eng.scheduler.mem.allocator.used_blocks == 0
    # the purged host buffers went back to the pool
    assert eng.host_pool.reused + eng.host_pool.pinned == ss.swap_outs


def test_chaos_cancel_while_transfer_in_flight(llama):
    """A swapped request whose SWAP_IN stays in flight is cancelled: its host
    copy and staged copy go, and the others still give JAX's tokens."""
    _, _, model, params = llama
    reqs = _swap_requests(model.cfg.vocab_size)
    jeng, _ = _swap_pair(llama, {}, {}, reqs)
    base = _outputs(jeng, 3)
    plan = FaultPlan(seed=0, scripted={(tid, 0): FaultSpec(VERDICT_DELAY, delay_steps=500)
                                       for tid in range(8)})
    eng = Engine(model, params, SchedulerConfig(fault_plan=plan, **SWAP_KNOBS),
                 max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, reqs)
    victim = None
    for _ in range(200):
        if eng.step(now=float(eng.steps_run)) is None:
            break
        q = eng.scheduler.prefetch_queue
        swapped = [r.rid for r in eng.scheduler.swapped if not q.readable(r.rid, SWAP_IN)]
        if swapped:
            victim = swapped[0]
            break
    assert victim is not None, "no swap-in ever left in flight"
    assert victim in eng.swap_store
    assert eng.scheduler.cancel_request(victim, "test_cancel", now=float(eng.steps_run))
    eng._purge_released()
    assert victim not in eng.swap_store and victim not in eng._staged
    q = eng.scheduler.prefetch_queue
    assert not q.blocked(victim) and q.readable(victim, SWAP_IN)
    assert eng.scheduler.requests[victim].state is State.CANCELLED
    eng.run(max_steps=2000)
    for rid in range(3):
        if rid != victim:
            assert _outputs(eng, 3)[rid] == base[rid], f"survivor {rid} diverged"
    assert q.outstanding() == 0 and q.fully_terminal()
    assert eng.scheduler.mem.allocator.used_blocks == 0
    assert not eng.swap_store and not eng._staged


def test_shutdown_purges_host_tier(llama):
    _, _, model, params = llama
    eng = Engine(model, params, SchedulerConfig(**SWAP_KNOBS), max_len=MAX_LEN, device="cpu")
    _submit(eng, Request, [(p, 30) for p, _ in _swap_requests(model.cfg.vocab_size)])
    for _ in range(6):
        eng.step(now=float(eng.steps_run))
    held = len(eng.swap_store)
    reg = MetricsRegistry()
    eng.register_metrics(reg)
    assert reg.get("engine_swap_store_entries").value == float(held)
    assert eng.shutdown("interrupt") == 3
    assert all(r.state in (State.DONE, State.CANCELLED)
               for r in eng.scheduler.requests.values())
    q = eng.scheduler.prefetch_queue
    assert q.outstanding() == 0 and q.fully_terminal()
    assert not eng.swap_store and not eng._staged
    assert eng.scheduler.mem.allocator.used_blocks == 0
    assert not eng.scheduler.has_work


# ---------------------------------------------------------------------------
# attribution and trace order, swap and async staging on
# ---------------------------------------------------------------------------

def test_traces_compare_clean_with_jax(llama, tmp_path):
    jmodel, jparams, model, params = llama
    reqs = _swap_requests(model.cfg.vocab_size)
    paths = {}
    for name, eng_cls, cfg_cls, req_cls, tr, export, kw in (
            ("jax", JaxEngine, JaxSchedulerConfig, JaxRequest, JaxTraceRecorder("engine"),
             jax_export_chrome, {}),
            ("port", Engine, SchedulerConfig, Request, TraceRecorder("engine"), export_chrome,
             {"device": "cpu"})):
        eng = eng_cls(model if name == "port" else jmodel, params if name == "port" else jparams,
                      cfg_cls(async_prefetch=True, **SWAP_KNOBS), max_len=MAX_LEN, tracer=tr,
                      **kw)
        _submit(eng, req_cls, reqs)
        eng.run(max_steps=2000)
        assert eng.scheduler.stats.swap_outs > 0
        eng.scheduler.ledger.record_totals(tr, eng.attribution_aggregates())
        paths[name] = tmp_path / f"{name}.json"
        export(tr, str(paths[name]))
        paths[name + "_agg"] = eng.attribution_aggregates()
    assert paths["port_agg"] == paths["jax_agg"]
    run = subprocess.run([sys.executable, str(CHECKER), str(paths["port"]), "--compare",
                          str(paths["jax"])], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


# ---------------------------------------------------------------------------
# the reference-side fault: a request swapped out and back in in one plan
# ---------------------------------------------------------------------------

# test_swap_preemption_invariants' falsifying example under
# --hypothesis-seed=1: chunk 4, 3 slots, a KV budget of 8 tokens, pages of 1,
# priority eviction; five requests of priority 0
ROUND_TRIP = dict(chunk_size=4, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
                  kv_capacity_tokens=8, max_concurrent_prefills=2, preemption="swap",
                  eviction="priority", kv_block_size=1)
ROUND_TRIP_REQS = [([1] * 1, 4), ([2] * 1, 1), ([3] * 1, 1), ([4] * 4, 2), ([5] * 1, 2)]


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_same_step_round_trip_raises_before_any_write(llama, kernel):
    jmodel, jparams, model, params = llama
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**ROUND_TRIP), max_len=MAX_LEN,
                     attn_kernel=kernel)
    _submit(jeng, JaxRequest, ROUND_TRIP_REQS)
    with pytest.raises(KeyError):
        jeng.run(max_steps=100)
    assert jeng.steps_run == 3
    eng = Engine(model, params, SchedulerConfig(**ROUND_TRIP), max_len=MAX_LEN,
                 attn_kernel=kernel, device="cpu")
    _submit(eng, Request, ROUND_TRIP_REQS)
    for _ in range(3):
        eng.step(now=float(eng.steps_run))
    before = [{k: v.clone() for k, v in layer.items()} for layer in eng.cache]
    store = dict(eng.swap_store)
    with pytest.raises(RuntimeError, match=r"step 3: request 4 .*ROADMAP\.md §C"):
        eng.step(now=float(eng.steps_run))
    assert eng.steps_run == 3
    assert all(torch.equal(b[k], layer[k]) for b, layer in zip(before, eng.cache) for k in b)
    assert eng.swap_store == store
    assert _outputs(eng, 5) == _outputs(jeng, 5)
