"""The port's serial (dense-cache) execution and the engine's dense fallback
against the JAX package, on reduced llama3.1-8b (two layers, so the
period-stacked bridge is exercised), fp32, weights bridged from JAX's
``Model.init`` and inputs from numpy seeds.

* ``forward``, ``prefill`` at index 0 and at nonzero (scalar and per-row)
  indices, and ``decode_step`` with a scalar and a ``(B,)`` index: logits and
  every layer's cache at 1e-4, through the kernel dispatch the card takes
  (B4, B3 or B1 by case; on CPU tensors each kernel runs its plain version);
* the port's serial reference, paged engine and dense engine agree token
  for token, and the dense engine gives JAX's dense engine's tokens on the
  workload of ``test_paged_attention.py``'s engine test.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.serial import serial_reference  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64
B = 2


@pytest.fixture(scope="module")
def models():
    cfg_j = reduce_config(get_config("llama3.1-8b"), periods=2)
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"), periods=2)
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg_t)
    return jmodel, jparams, model, params


def test_forward_matches_jax(models):
    jmodel, jparams, model, params = models
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, 11)).astype(np.int32)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (B, 11, model.cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


# (kind, T, index): prefill from 0, a chunk at a scalar offset, a chunk at
# per-row offsets, decode at a scalar and at per-row offsets
STEPS = [("prefill", 6, 0), ("prefill", 5, 6), ("prefill", 3, [11, 8]),
         ("decode", 1, 14), ("decode", 1, [15, 12])]


def test_prefill_and_decode_match_jax(models):
    jmodel, jparams, model, params = models
    cfg = model.cfg
    rng = np.random.default_rng(1)
    jcache = jmodel.init_cache(B, MAX_LEN, jnp.float32)
    cache = model.init_cache(B, MAX_LEN)
    for kind, T, index in STEPS:
        tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jindex = jnp.asarray(index, jnp.int32)
        tindex = index if isinstance(index, int) else torch.tensor(index, dtype=torch.int32)
        if kind == "prefill":
            jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache,
                                             jindex)
            logits, out = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache,
                                        tindex)
        else:
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), jcache, jindex)
            logits, out = model.decode_step(params, torch.from_numpy(tokens), cache, tindex)
        assert out is cache  # written in place
        msg = f"{kind} T={T} index={index}"
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL, err_msg=msg)
        expect = caches_from_jax(jax.tree.map(np.asarray, jcache), cfg)
        for layer, (got_l, exp_l) in enumerate(zip(cache, expect)):
            for kv in ("k", "v"):
                np.testing.assert_allclose(got_l[kv].numpy(), exp_l[kv].numpy(), **TOL,
                                           err_msg=f"{msg} layer {layer} {kv}")


def test_kernel_dispatch_by_case(models, monkeypatch):
    """Each case of ``attention._attend`` reaches the kernel that computes it."""
    _, _, model, params = models
    from repro_torch.kernels import ops

    seen = []
    for name in ("flash_attention_bshd", "decode_attention_bhd", "mixed_attention_rows"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **kw:
                            seen.append(_n) or _f(*a, **kw))
    cfg, L = model.cfg, model.cfg.n_layers
    cache = model.init_cache(1, MAX_LEN)
    tok = lambda n: {"tokens": torch.zeros((1, n), dtype=torch.int32)}  # noqa: E731
    model.forward(params, tok(4))
    model.prefill(params, tok(4), cache, 0)
    model.prefill(params, tok(3), cache, 4)
    model.decode_step(params, tok(1)["tokens"], cache, 7)
    assert seen == (["flash_attention_bshd"] * 2 * L + ["mixed_attention_rows"] * L
                    + ["decode_attention_bhd"] * L), (cfg.n_layers, seen)


@pytest.mark.parametrize("T,index", [(3, 4), (3, [4, 9]), (1, 7), (1, [7, 2])])
def test_call_metadata_built_once(models, monkeypatch, T, index):
    """A chunked prefill or a decode step builds its attention metadata once
    and hands every layer the same tensors."""
    _, _, model, params = models
    from repro_torch.kernels import ops

    tiles_built, meta = [], []
    real_tiles = attention.q_tiles
    monkeypatch.setattr(attention, "q_tiles",
                        lambda *a: tiles_built.append(1) or real_tiles(*a))
    for name, arg in (("mixed_attention_rows", 3), ("decode_attention_bhd", 3)):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=real, _i=arg, **kw:
                            meta.append(a[_i]) or _f(*a, **kw))
    cache = model.init_cache(B, MAX_LEN)
    tindex = index if isinstance(index, int) else torch.tensor(index, dtype=torch.int32)
    model.prefill(params, {"tokens": torch.zeros((B, T), dtype=torch.int32)}, cache, tindex)
    assert len(meta) == model.cfg.n_layers and all(m is meta[0] for m in meta)
    assert len(tiles_built) == (1 if T > 1 else 0)


def _jax_requests(vocab):
    """The prompts of ``test_paged_attention.py``'s engine test (lens 5, 17,
    9; 6, 4, 8 new tokens), drawn as it draws them."""
    rng = jax.random.PRNGKey(42)
    lens, outs = [5, 17, 9], [6, 4, 8]
    return [(np.asarray(jax.random.randint(jax.random.fold_in(rng, i), (lens[i],), 0,
                                           vocab)).tolist(), outs[i]) for i in range(3)]


SCHED = dict(chunk_size=8, max_decode_batch=3, prefetch_buffer_bytes=1 << 20,
             max_concurrent_prefills=2, kv_block_size=4)


def _serve(engine, request_cls, reqs):
    for rid, (prompt, n_out) in enumerate(reqs):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
    engine.run(max_steps=300)
    return [engine.scheduler.requests[rid].output for rid in range(len(reqs))]


@pytest.fixture(scope="module")
def reduced():
    """Reduced llama3.1-8b at one period, as the JAX engine tests build it."""
    cfg_j = reduce_config(get_config("llama3.1-8b"))
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"))
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg_t)
    return jmodel, jparams, model, params, _jax_requests(cfg_t.vocab_size)


def test_serial_paged_and_dense_engines_agree(reduced):
    _, _, model, params, reqs = reduced
    serial = [serial_reference(model, params, p, n, max_len=MAX_LEN) for p, n in reqs]
    for kernel, max_len in (("paged", MAX_LEN), ("dense", MAX_LEN), ("auto", MAX_LEN - 2)):
        eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=max_len,
                     attn_kernel=kernel, device="cpu")
        assert eng.attn_kernel == (kernel if kernel != "auto" else "dense")
        assert _serve(eng, Request, reqs) == serial, kernel


def test_dense_engine_matches_jax_dense_engine(reduced):
    jmodel, jparams, model, params, reqs = reduced
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN,
                     attn_kernel="dense")
    eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, attn_kernel="dense",
                 device="cpu")
    assert _serve(eng, Request, reqs) == _serve(jeng, JaxRequest, reqs)
    assert eng.steps_run == jeng.steps_run
    assert eng.cache[0]["k"].shape == (SCHED["max_decode_batch"] + 1, MAX_LEN,
                                       model.cfg.n_kv_heads, model.cfg.head_dim)
