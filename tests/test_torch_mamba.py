"""The port's Mamba2 path against the JAX package, on the CPU.

Every input comes from a numpy seed or from JAX's ``init`` at a fixed key;
nothing is drawn per run. Reduced widths (d_model 64, 16 heads of 8, state
16), fp32, tolerance 1e-4 (rtol and atol; the two sides sum in other orders)
unless a test says otherwise.

* ``causal_conv`` with and without a carried state; ``mamba2_apply`` for a
  prefill with and without a state and for the S = 1 decode step: outputs
  and both state leaves;
* ``Model.forward``, ``prefill`` and ``decode_step`` of reduced mamba2-2.7b
  with 2 layers, weights bridged from JAX's ``Model.init``;
* the weight and state bridge, and its fp32 leaves in a bf16 model;
* greedy tokens of the two-call ``Engine`` equal to the JAX ``Engine``'s on
  the two mamba2-2.7b workloads of ``test_engine.py`` and to the port's
  serial path (Mamba1, which jamba runs, has its own tests in
  ``test_torch_mamba1.py`` and ``test_torch_jamba_engine.py``).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.launch.serve import sized_kv_pool  # noqa: E402
from repro_torch.models import build_model, mamba  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.serial import serial_reference  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), _np(tree))


@pytest.fixture(scope="module")
def layer():
    """One reduced Mamba2 layer's parameters from JAX's ``mamba2_init``."""
    cfg_j = reduce_config(get_config("mamba2-2.7b"))
    cfg_t = t_reduce_config(t_get_config("mamba2-2.7b"))
    jp = jax_mamba.mamba2_init(jax.random.PRNGKey(3), cfg_j)
    return cfg_j, cfg_t, jp, _torch(jp)


def _state(cfg_j, seed, B):
    """A nonzero carried state of the layer, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape, jax_mamba.mamba2_state_init(cfg_j, B))
    return {k: rng.standard_normal(s).astype(np.float32) * 0.5 for k, s in shapes.items()}


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    rng = np.random.default_rng(1)
    B, S, C, W = 2, 9, 12, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    state = rng.standard_normal((B, W - 1, C)).astype(np.float32) if carried else None
    jy, js = jax_mamba.causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                   None if state is None else jnp.asarray(state))
    y, s = mamba.causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                             None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


# (S, carried state): a ragged prefill from zeros, a prefill continuing a
# state, the O(1) decode step
APPLY_CASES = [(37, False), (70, True), (1, True)]


@pytest.mark.parametrize("S,carried", APPLY_CASES)
def test_mamba2_apply_matches_jax(layer, S, carried):
    cfg_j, cfg_t, jp, tp = layer
    B = 2
    u = np.random.default_rng(S).standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    jstate = _state(cfg_j, 5, B) if carried else None
    jy, jnew = jax_mamba.mamba2_apply(jp, cfg_j, jnp.asarray(u),
                                      state=None if jstate is None else
                                      jax.tree.map(jnp.asarray, jstate), want_state=True)
    state = None if jstate is None else {k: torch.from_numpy(v.copy()) for k, v in jstate.items()}
    y, new = mamba.mamba2_apply(tp, cfg_t, torch.from_numpy(u), state=state, want_state=True)
    if state is not None:
        assert new is state  # updated in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("conv", "ssm"):
        assert new[k].dtype == torch.float32
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k], np.float32), **TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def models():
    """Reduced mamba2-2.7b with 2 layers; the port's weights bridged from JAX."""
    cfg_j = reduce_config(get_config("mamba2-2.7b"), periods=2)
    cfg_t = t_reduce_config(t_get_config("mamba2-2.7b"), periods=2)
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, from_jax_params(_np(jparams), cfg_t)


def test_forward_matches_jax(models):
    jmodel, jparams, model, params = models
    assert model.cfg.n_layers == 2 and model.inv_freq is None
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 150)).astype(np.int32)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 150, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


# (T, index): a ragged prefill from 0, a chunk continuing it, two decode steps
STEPS = [(20, 0), (70, 20), (1, 90), (1, 91)]


def test_prefill_and_decode_match_jax(models):
    jmodel, jparams, model, params = models
    cfg = model.cfg
    rng = np.random.default_rng(2)
    jcache = jmodel.init_cache(2, MAX_LEN, jnp.float32)
    cache = model.init_cache(2, MAX_LEN)
    for T, index in STEPS:
        tokens = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
        if T > 1:
            jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache,
                                             jnp.int32(index))
            logits, out = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache,
                                        index)
        else:
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), jcache,
                                                 jnp.int32(index))
            logits, out = model.decode_step(params, torch.from_numpy(tokens), cache, index)
        assert out is cache  # written in place
        msg = f"T={T} index={index}"
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL, err_msg=msg)
        for i, (got, exp) in enumerate(zip(cache, caches_from_jax(_np(jcache), cfg))):
            for k in ("conv", "ssm"):
                np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(), **TOL,
                                           err_msg=f"{msg} layer {i} {k}")


def test_prefill_runs_the_ssd_kernel_once_per_layer(models, monkeypatch):
    _, _, model, params = models
    from repro_torch.kernels import ops

    seen = []
    real = ops.ssd
    monkeypatch.setattr(ops, "ssd", lambda *a: seen.append(a[0].shape) or real(*a))
    cache = model.init_cache(1, MAX_LEN)
    model.prefill(params, {"tokens": torch.zeros((1, 5), dtype=torch.int32)}, cache, 0)
    model.decode_step(params, torch.zeros((1, 1), dtype=torch.int32), cache, 5)
    assert seen == [(1, 5, 16, 8)] * model.cfg.n_layers  # decode is plain PyTorch


def test_bridge_keeps_fp32_leaves_in_a_bf16_model(models):
    _, jparams, model, _ = models
    p16 = from_jax_params(_np(jparams), model.cfg, dtype=torch.bfloat16)
    for layer in p16["layers"]:
        mixer = layer["mixer"]
        assert mixer["A_log"].dtype == mixer["dt_bias"].dtype == torch.float32
        assert mixer["in_proj"]["w"].dtype == mixer["D"].dtype == torch.bfloat16
    # the fp32 leaves are JAX's values exactly (layer 1: period 1 of 2)
    periods = _np(jparams)["stack"]["periods"]["0"]["mixer"]
    for key in mamba.FP32_LEAVES:
        np.testing.assert_array_equal(p16["layers"][1]["mixer"][key].numpy(), periods[key][1])
    assert p16["embed"].dtype == torch.bfloat16


def test_seeded_init_matches_jax_layout_and_fp32_leaves(models):
    _, jparams, model, params = models
    bf16 = build_model(model.cfg, dtype=torch.bfloat16, device="cpu")
    own = bf16.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(lambda t: list(t.shape), tree)  # noqa: E731
    assert shapes(own["layers"][0]) == shapes(params["layers"][0])  # JAX's tree, key for key
    mixer = own["layers"][0]["mixer"]
    assert mixer["A_log"].dtype == mixer["dt_bias"].dtype == torch.float32
    np.testing.assert_allclose(mixer["A_log"].numpy(), np.log(np.arange(1, 17)), rtol=1e-6)
    dt = np.log1p(np.exp(mixer["dt_bias"].numpy()))  # softplus: the init's step sizes
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 0.1 * (1 + 1e-5)).all()


def test_state_bridge_stays_fp32(models):
    jmodel, _, model, _ = models
    jcache = jmodel.init_cache(3, MAX_LEN, jnp.bfloat16)
    cache = caches_from_jax(_np(jcache), model.cfg, dtype=torch.bfloat16)
    own = model.init_cache(3, MAX_LEN, torch.bfloat16)
    assert len(cache) == len(own) == model.cfg.n_layers
    for got, mine in zip(cache, own):
        for k in ("conv", "ssm"):
            assert got[k].dtype == mine[k].dtype == torch.float32
            assert got[k].shape == mine[k].shape


def _requests(seed, vocab):
    """``test_engine.py``'s ``make_requests(cfg, PRNGKey(seed), n=4)``."""
    rng = jax.random.PRNGKey(seed)
    lens, outs = [5, 17, 9, 23], [6, 4, 8, 5]
    return [(np.asarray(jax.random.randint(jax.random.fold_in(rng, i), (lens[i],), 0,
                                           vocab)).tolist(), outs[i]) for i in range(4)]


def _serve(engine, request_cls, reqs):
    for rid, (prompt, n_out) in enumerate(reqs):
        engine.submit(request_cls(rid=rid, prompt=list(prompt), max_new_tokens=n_out))
    engine.run(max_steps=500)
    return [engine.scheduler.requests[rid].output for rid in range(len(reqs))]


@pytest.fixture(scope="module")
def reduced():
    """Reduced mamba2-2.7b at one period, as ``test_engine.py`` builds it."""
    cfg_j = dropless(reduce_config(get_config("mamba2-2.7b")))
    cfg_t = t_reduce_config(t_get_config("mamba2-2.7b"))
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, from_jax_params(_np(jparams), cfg_t)


# test_engine_matches_serial (chunk 8, 3 slots for 4 requests: slots are
# reused) and test_engine_multi_prefill_matches_serial (chunk 16, 4 slots,
# 3 concurrent prefills)
WORKLOADS = {
    "matches_serial": (42, dict(chunk_size=8, max_decode_batch=3,
                                prefetch_buffer_bytes=1 << 20)),
    "multi_prefill": (43, dict(chunk_size=16, max_decode_batch=4, prefetch_buffer_bytes=1 << 20,
                               max_concurrent_prefills=3)),
}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_two_call_engine_matches_jax_engine(reduced, workload):
    jmodel, jparams, model, params = reduced
    seed, sched = WORKLOADS[workload]
    reqs = _requests(seed, model.cfg.vocab_size)
    jeng = JaxEngine(jmodel, jparams, JaxSchedulerConfig(**sched), max_len=MAX_LEN)
    eng = Engine(model, params, SchedulerConfig(**sched), max_len=MAX_LEN, device="cpu")
    assert eng.two_call and eng.attn_kernel == "dense" and not hasattr(eng, "block_mirror")
    got = _serve(eng, Request, reqs)
    assert got == _serve(jeng, JaxRequest, reqs)
    assert eng.steps_run == jeng.steps_run
    assert got == [serial_reference(model, params, p, n, max_len=MAX_LEN) for p, n in reqs]
    assert eng.cache[0]["ssm"].shape[0] == sched["max_decode_batch"] + 1


def test_two_call_engine_refuses_a_page_pool(reduced):
    _, _, model, params = reduced
    with pytest.raises(ValueError, match="packed mode"):
        Engine(model, params, SchedulerConfig(kv_block_size=4), max_len=MAX_LEN,
               attn_kernel="paged", device="cpu")


def test_launcher_sizes_no_kv_pool_without_attention():
    cfg = t_get_config("mamba2-2.7b")
    assert cfg.n_attn_layers == 0
    with pytest.raises(ValueError, match="no attention layers"):
        sized_kv_pool(cfg, torch.device("cpu"), torch.bfloat16, 8, 8192, 16)
