"""Greedy serving of deepseek-v2 (MLA, MoE) at reduced width: the port's
paged and dense engines against the JAX package's ``Engine``, and the A5
features (swap preemption, the prefix cache) on MLA's latent pages.

Models as in ``test_torch_mla.py``: ``reduce_config`` widths, two MoE
periods past the dense layer 0, norm scales and routers drawn from a numpy
seed, dispatch dropless, fp32. The absorbed attention's key tile is 8 keys
(``mla_key_tile``, by monkeypatch), so every context of 9 or more tokens
spans several tiles.

The engine workload is ``test_torch_archs_engine.py``'s (three prompts of
20, 33 and 9 tokens, 6, 5 and 8 new tokens; page 4, chunk 8, three decode
slots, two prefills a step) drawn from seed 6, chosen among 0..7 for the
largest smallest top-2 logit gap over every greedy step of the port's
serial path (``GAP``); the smallest gap between a token's K-th and
(K+1)-th router probability in those steps is ``ROUTER_MARGIN``.

A5 on latent leaves: a run under a KV budget of 30 tokens with swap
preemption gives the tokens of the same run without a budget, the bytes
each way equal the memory manager's counts (the pool in bf16, the 2 bytes
an element the manager counts: 2 (kv_lora_rank + qk_rope_head_dim) a
token-layer), and every restored page is bit-equal to its swap-out's; a run
with the prefix cache gives the tokens of the run without it.
``launch.serve.kv_block_bytes`` sizes a block from the leaves
``init_page_pool`` allocates: MLA's latent, and GQA's K and V as before.
"""
from __future__ import annotations

import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.obs.perfetto import export_chrome as jax_export_chrome  # noqa: E402
from repro.obs.trace import TraceRecorder as JaxTraceRecorder  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.obs.perfetto import export_chrome  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.workload import shared_prefix_requests  # noqa: E402
from test_torch_a5 import PREFIX_KNOBS, SWAP_KNOBS, Recording  # noqa: E402
from test_torch_a5 import _assert_restores_bit_exact, _outputs, _submit  # noqa: E402
from test_torch_archs_engine import CHECKER, LENS, MAX_LEN, NEW, SCHED  # noqa: E402
from test_torch_archs_engine import router_margin, serial_with_gap  # noqa: E402
from test_torch_mla import KEY_TILE, models  # noqa: E402

SEED, GAP, ROUTER_MARGIN = 6, 0.008064, 0.000222


@pytest.fixture(autouse=True)
def small_key_tile(monkeypatch):
    monkeypatch.setattr(attention, "mla_key_tile", lambda *a: KEY_TILE)


def prompts(vocab, seed=SEED, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _serve(engine, request_cls, reqs):
    for rid, (prompt, n_out) in enumerate(zip(reqs, NEW)):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
    engine.run(max_steps=300)
    return [engine.scheduler.requests[rid].output for rid in range(len(reqs))]


def test_workload_gap_is_the_recorded_one():
    _, _, model, params, _ = models()
    with router_margin() as smallest:
        gaps = [serial_with_gap(model, params, p, n)[1]
                for p, n in zip(prompts(model.cfg.vocab_size), NEW)]
    assert min(gaps) == pytest.approx(GAP, abs=1e-5)
    assert min(gaps) > 3e-3
    assert smallest[0] == pytest.approx(ROUTER_MARGIN, abs=1e-6)
    assert smallest[0] > 1e-4


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_engine_tokens_match_jax(kernel, tmp_path):
    """The port's engine gives JAX's tokens step for step, the port's serial
    path agrees, and the two traces compare clean. MLA launches none of the
    kernels: no attention tiles are built."""
    jmodel, jparams, model, params, _ = models()
    reqs = prompts(model.cfg.vocab_size)
    jtr, tr = JaxTraceRecorder("engine"), TraceRecorder("engine")
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN,
                     attn_kernel=kernel, tracer=jtr)
    expect = _serve(jeng, JaxRequest, reqs)
    eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, attn_kernel=kernel,
                 device="cpu", tracer=tr)
    assert getattr(eng, "_group", None) is None
    got = _serve(eng, Request, reqs)
    assert eng.attn_kernel == kernel and eng.steps_run == jeng.steps_run
    assert [len(o) for o in got] == NEW
    assert got == expect
    assert got == [serial_with_gap(model, params, p, n)[0] for p, n in zip(reqs, NEW)]
    assert eng.attribution_aggregates() == jeng.attribution_aggregates()
    eng.scheduler.ledger.record_totals(tr, eng.attribution_aggregates())
    jeng.scheduler.ledger.record_totals(jtr, jeng.attribution_aggregates())
    paths = [tmp_path / "port.json", tmp_path / "jax.json"]
    export_chrome(tr, str(paths[0]))
    jax_export_chrome(jtr, str(paths[1]))
    run = subprocess.run([sys.executable, str(CHECKER), str(paths[0]), "--compare",
                          str(paths[1])], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


# ---------------------------------------------------------------------------
# A5 on latent pages
# ---------------------------------------------------------------------------

SWAP_LENS, SWAP_NEW = (17, 23, 12), (6, 5, 7)  # test_overlap.py's swap workload


def _swap_run(model, params, kernel, **knobs):
    reqs = list(zip(prompts(model.cfg.vocab_size, lens=SWAP_LENS), SWAP_NEW))
    eng = Recording(model, params, SchedulerConfig(**knobs), max_len=MAX_LEN,
                    attn_kernel=kernel, device="cpu", cache_dtype=torch.bfloat16)
    _submit(eng, Request, reqs)
    eng.run(max_steps=500)
    return eng, _outputs(eng, len(reqs))


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_swap_under_a_budget_gives_the_unbudgeted_tokens(kernel):
    _, _, model, params, _ = models()
    free = dict(SWAP_KNOBS, kv_capacity_tokens=None, preemption="recompute")
    _, want = _swap_run(model, params, kernel, **free)
    eng, got = _swap_run(model, params, kernel, **SWAP_KNOBS)
    assert got == want and [len(o) for o in got] == list(SWAP_NEW)
    stats, mem = eng.scheduler.stats, eng.scheduler.mem
    assert stats.swap_outs == stats.swap_ins > 0
    assert not eng.swap_store and not eng._staged
    assert set(eng.cache[0]) == {"ckv", "krope"}
    _assert_restores_bit_exact(eng, relocated=kernel == "paged")
    cfg = model.cfg
    assert mem.kv_bytes_per_token == 2 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * cfg.n_layers
    if kernel == "paged":
        # whole spilled pages of the latent, each way: the manager's count
        assert eng.swap_bytes_moved["d2h"] == mem.swap_out_bytes_total > 0
        assert eng.swap_bytes_moved["h2d"] == mem.swap_in_bytes_total
        pages = sum(len(t[1]) for t in eng.round_trips)
        assert eng.swap_bytes_moved["d2h"] == pages * eng.page_size * mem.kv_bytes_per_token
    else:
        # a dense swap moves the slot's whole latent rows, max_len tokens
        rows = len(eng.round_trips)
        assert eng.swap_bytes_moved["d2h"] == rows * MAX_LEN * mem.kv_bytes_per_token
        assert eng.swap_bytes_moved["h2d"] == eng.swap_bytes_moved["d2h"]


def test_prefix_cache_gives_the_uncached_tokens():
    """Four prompts sharing 22 tokens (five pages of 4 and 2 tokens, so
    resumes copy a partial page): the same tokens with the cache on and off,
    fewer prefill tokens with it on."""
    _, _, model, params, _ = models()
    reqs = shared_prefix_requests(vocab_size=model.cfg.vocab_size, n=4, shared_len=22,
                                  unique_len=8, max_new_tokens=5, jitter=2, seed=3)
    runs = {}
    for on in (True, False):
        eng = Engine(model, params, SchedulerConfig(**dict(PREFIX_KNOBS,
                                                           enable_prefix_cache=on)),
                     max_len=MAX_LEN, device="cpu")
        for r in reqs:
            eng.submit(Request(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens))
        eng.run(max_steps=800)
        runs[on] = eng
    on, off = runs[True], runs[False]
    assert _outputs(on, len(reqs)) == _outputs(off, len(reqs))
    assert on.scheduler.stats.prefix_hits > 0
    assert on.scheduler.stats.prefill_tokens < off.scheduler.stats.prefill_tokens


# ---------------------------------------------------------------------------
# the launcher's pool sizing
# ---------------------------------------------------------------------------


def test_kv_block_bytes_follow_the_pool_leaves(monkeypatch):
    """A block of 16 tokens: deepseek-v2's latent, (512 + 64) x 2 B x 60
    layers, against 65,536 B a token-layer if it were sized as GQA K/V;
    Llama3.1-8B's K and V unchanged, 16 x 2 x 8 x 128 x 2 B x 32. At
    reduced width the block's bytes are what ``init_page_pool`` allocates a
    page; and ``sized_kv_pool`` divides the free memory by them."""
    ds, llama = t_get_config("deepseek-v2-236b"), t_get_config("llama3.1-8b")
    assert tserve.kv_block_bytes(ds, torch.bfloat16, 16) == 16 * (512 + 64) * 2 * 60
    assert tserve.kv_block_bytes(llama, torch.bfloat16, 16) == 16 * 2 * 8 * 128 * 2 * 32
    _, _, model, _, _ = models()
    for dtype in (torch.float32, torch.bfloat16):
        pool = model.init_page_pool(3, 4, dtype)
        per_page = sum(t[:1].numel() * t.element_size() for layer in pool for t in layer.values())
        assert tserve.kv_block_bytes(model.cfg, dtype, 4) == per_page
    block = tserve.kv_block_bytes(ds, torch.bfloat16, 16)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (tserve.ACTIVATION_RESERVE + 1000 * block + 7, 0))
    got = tserve.sized_kv_pool(ds, torch.device("cuda"), torch.bfloat16, 8, 8192, 16)
    assert got == (1000, "free_memory")
    gqa = tserve.kv_block_bytes(llama, torch.bfloat16, 16)
    assert math.isclose(gqa / block, 2097152 / 1105920)
