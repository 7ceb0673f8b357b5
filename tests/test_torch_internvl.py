"""internvl2-76b's backbone with its prepended frontend embeddings, the
learned-position branch, and every registered arch, against the JAX
package on the CPU.

Reduced internvl2-76b (``reduce_config(periods=2)``: d_model 64, its
published group G 8 as 16 query heads over 2 KV heads of 16, two layers,
``frontend_len`` 8), fp32, weights from JAX's ``Model.init`` after
``test_torch_encdec.drawn``, bridged by ``repro_torch.weights``;
frontend embeddings (std 1) and tokens from numpy seeds.

* ``forward`` with ``frontend_embeds`` (the embeddings' rows dropped from
  the logits), and ``prefill`` of embeddings and prompt then decode steps
  from position F + len(prompt): logits at 1e-4 and the caches, whose first
  F rows are the embeddings' K/V;
* a check that can fail: other embeddings move the prompt's logits;
* the packed engine (paged, B1) serves the backbone text-only, as JAX's
  packed engine does: JAX's tokens, workload seed chosen as in
  ``test_torch_archs_engine.py`` (smallest top-2 gap recorded);
* the ``learned_pos`` branch (``Model.init``'s ``pos`` table, added at each
  position in ``_embed``) on reduced llama3.1-8b with ``learned_pos``
  on: ``forward``, ``prefill`` and decode logits;
* every arch of JAX's ``ASSIGNED + PAPER_MODELS`` builds in the port at
  ``reduce_config``'s widths and runs one ``forward`` that gives JAX's
  logits (MoE dropless; whisper with frames, internvl2 with frontend
  embeddings).
"""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs.archs import ASSIGNED, PAPER_MODELS  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.serial import serial_reference  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402
from test_torch_archs_engine import LENS, NEW, SCHED  # noqa: E402
from test_torch_encdec import drawn  # noqa: E402

ARCH = "internvl2-76b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64
ENGINE_SEED, ENGINE_GAP = 6, 0.004147


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(arch, periods=2, **over):
    """(JAX model, JAX params, port model, port params) at reduced widths,
    ``over`` replacing config fields on both sides; biases, norm scales and
    routers drawn from a numpy seed."""
    cfg_j = dropless(dataclasses.replace(reduce_config(get_config(arch), periods=periods),
                                         **over))
    cfg_t = t_dropless(dataclasses.replace(t_reduce_config(t_get_config(arch), periods=periods),
                                           **over))
    jmodel = jax_build_model(cfg_j)
    tree = drawn(_np(jmodel.init(jax.random.PRNGKey(0))), np.random.default_rng(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, from_jax_params(tree, cfg_t)


@functools.lru_cache(maxsize=None)
def internvl():
    return pair(ARCH, n_heads=16, n_kv_heads=2)


def _embeds(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_reduced_internvl2_keeps_its_structure():
    _, _, model, params = internvl()
    cfg = model.cfg
    assert cfg.frontend == "vision" and cfg.frontend_len == 8 and not cfg.encdec
    assert cfg.n_heads // cfg.n_kv_heads == 8 and cfg.n_layers == 2
    assert "pos" not in params  # rotary positions, no table


def test_forward_with_frontend_embeds_matches_jax():
    jmodel, jparams, model, params = internvl()
    cfg = model.cfg
    fe, tokens = _embeds(cfg, 2, 1), _tokens(cfg, 2, 12, 1)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens),
                                          "frontend_embeds": jnp.asarray(fe)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens),
                                    "frontend_embeds": torch.from_numpy(fe)})
    assert logits.shape == (2, 12, cfg.vocab_size)  # the embeddings' rows dropped
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    # a check that can fail: other embeddings move every prompt position
    other = model.forward(params, {"tokens": torch.from_numpy(tokens),
                                   "frontend_embeds": torch.from_numpy(_embeds(cfg, 2, 2))})
    assert float((other - logits).abs().amin(dim=-1).max()) > 0
    assert float((other - logits).abs().max()) > 100 * MODEL_TOL["atol"]


def test_prefill_with_frontend_embeds_then_decode_matches_jax():
    jmodel, jparams, model, params = internvl()
    cfg = model.cfg
    F = cfg.frontend_len
    fe, tokens = _embeds(cfg, 2, 3), _tokens(cfg, 2, 10, 3)
    jcache = jmodel.init_cache(2, MAX_LEN, jnp.float32)
    cache = model.init_cache(2, MAX_LEN, torch.float32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "frontend_embeds": jnp.asarray(fe)}, jcache, 0)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                       "frontend_embeds": torch.from_numpy(fe)}, cache, 0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    for step in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, F + 10 + step)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache, F + 10 + step)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    bridged = caches_from_jax(_np(jcache), cfg)
    for mine, theirs in zip(cache, bridged):
        for k in ("k", "v"):
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), **MODEL_TOL)
    assert float(cache[0]["k"][:, :F].abs().max()) > 0  # the embeddings' K/V come first
    # the serial path decodes from F + len(prompt): its tokens are these
    toks = serial_reference(model, params, tokens[0].tolist(), 3, max_len=MAX_LEN,
                            frontend_embeds=fe[0])
    cache = model.init_cache(1, MAX_LEN)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:1]),
                                       "frontend_embeds": torch.from_numpy(fe[:1])}, cache, 0)
    want = [int(lg[0].argmax())]
    for i in range(2):
        lg, cache = model.decode_step(params, torch.tensor([[want[-1]]], dtype=torch.int32),
                                      cache, F + 10 + i)
        want.append(int(lg[0].argmax()))
    assert toks == want


def _serial_gap(model, params, prompt, n_new):
    cache = model.init_cache(1, MAX_LEN)
    lg, _ = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.int32)}, cache,
                          0)
    gaps = []
    for i in range(n_new):
        top = torch.topk(lg[0], 2).values
        gaps.append(float(top[0] - top[1]))
        if i < n_new - 1:
            tok = torch.tensor([[int(lg[0].argmax())]], dtype=torch.int32)
            lg, _ = model.decode_step(params, tok, cache, len(prompt) + i)
    return min(gaps)


def _prompts(vocab, seed=ENGINE_SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in LENS]


def test_text_only_engine_matches_jax():
    """The packed paged engine (B1) serves the backbone text-only, as JAX's
    packed engine does (``supports_packed`` asks only for attention-only
    layers): JAX's tokens and step count."""
    jmodel, jparams, model, params = internvl()
    reqs = _prompts(model.cfg.vocab_size)
    assert min(_serial_gap(model, params, p, n) for p, n in zip(reqs, NEW)) == pytest.approx(
        ENGINE_GAP, abs=1e-5)
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**SCHED), max_len=MAX_LEN,
                     attn_kernel="paged")
    eng = Engine(model, params, SchedulerConfig(**SCHED), max_len=MAX_LEN, attn_kernel="paged",
                 device="cpu")
    assert not eng.two_call
    outs = []
    for e, cls in ((jeng, JaxRequest), (eng, Request)):
        for rid, (prompt, n) in enumerate(zip(reqs, NEW)):
            e.submit(cls(rid=rid, prompt=list(prompt), max_new_tokens=n))
        e.run(max_steps=300)
        outs.append([list(e.scheduler.requests[r].output) for r in range(len(reqs))])
    assert outs[0] == outs[1] and eng.steps_run == jeng.steps_run
    assert [len(o) for o in outs[1]] == NEW


def test_learned_positions_match_jax():
    """``learned_pos`` (no registered arch but whisper's decoder uses it;
    JAX's ``Model`` has the branch): reduced llama3.1-8b with it on."""
    jmodel, jparams, model, params = pair("llama3.1-8b", learned_pos=True)
    cfg = model.cfg
    assert params["pos"].shape == (cfg.max_seq_len, cfg.d_model)
    own = model.init(torch.Generator().manual_seed(0))
    assert own["pos"].shape == params["pos"].shape
    tokens = _tokens(cfg, 2, 9, 4)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    jcache = jmodel.init_cache(2, MAX_LEN, jnp.float32)
    cache = model.init_cache(2, MAX_LEN, torch.float32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache, 0)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache, 0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    for step in range(3):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, 9 + step)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache, 9 + step)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    # the table moves the logits: without it they differ
    params_zero = dict(params, pos=torch.zeros_like(params["pos"]))
    moved = model.forward(params_zero, {"tokens": torch.from_numpy(tokens)})
    assert float((moved - logits).abs().max()) > 100 * MODEL_TOL["atol"]


def test_the_port_registers_every_arch_jax_does():
    assert sorted(list_archs()) == sorted(ASSIGNED + PAPER_MODELS)


@pytest.mark.parametrize("arch", ASSIGNED + PAPER_MODELS)
def test_every_arch_builds_and_runs_forward(arch):
    jmodel, jparams, model, params = pair(arch, periods=1)
    cfg = model.cfg
    tokens = _tokens(cfg, 2, 7, 5)
    batch = {"tokens": tokens}
    if cfg.encdec:
        batch["frames"] = _embeds(cfg, 2, 6)
    elif cfg.frontend:
        batch["frontend_embeds"] = _embeds(cfg, 2, 6)
    jlogits, _ = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits = model.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert logits.shape == (2, 7, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
