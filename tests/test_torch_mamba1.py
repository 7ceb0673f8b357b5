"""The port's Mamba1 mixer and jamba's hybrid model path against the JAX
package, on the CPU.

Every input comes from a numpy seed or from JAX's ``init`` at a fixed key.
Reduced jamba-v0.1-52b widths (d_model 64, d_in 128, state 8, dt_rank 4;
one period of 8 layers: Mamba1 everywhere but the attention layer 4, MoE on
the odd layers, 8 experts top 2, dropless), fp32.

* ``mamba1_apply`` at rtol = atol = 1e-5: one-shot prefills (S 200 and 1),
  prefills from a carried state (S 200 and 37), the S = 1 decode step from a
  state, and a 300-token prompt in chained pieces against one shot; the
  output and both state leaves (``ssm``, the final h, and ``conv``). The
  layer's ``D``, ``conv_b`` and ``dt_proj`` bias are drawn from a numpy seed
  so that a leaf lost on the way shows; a carried state must move the
  output, so the from-a-state cases could not pass without it;
* the chunked scan against a token-by-token loop, at chunks of 1, 5 and
  ``CHUNK``;
* faults made by source mutation of the port's module (the carried h
  dropped, the log-step scan composing b without a's powers) that the same
  comparison must reject;
* ``mamba1_init``'s tree and fp32 leaves, and the weight bridge;
* reduced jamba's ``Model.forward``, ``prefill`` and ``decode_step``
  (logits at 1e-4) and the caches they write (``{k, v}`` on the attention
  layer, ``{conv, ssm}`` on the others), weights bridged from JAX's
  ``Model.init`` with biases, norm scales and routers drawn as in
  ``test_torch_archs.py`` (the init's router std of 0.02 puts expert
  choices within 1e-5 of a tie at this width).
"""
from __future__ import annotations

import functools
import inspect
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs.reduced import dropless  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402
from repro_torch.models import build_model, mamba  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402
from test_torch_archs import drawn_leaves  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
FAULT_MARGIN = 100  # a fault moves some output this many tolerances
MAX_LEN = 256


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), _np(tree))


@functools.lru_cache(maxsize=None)
def layer():
    """One reduced Mamba1 layer: JAX's ``mamba1_init`` at a fixed key, with
    D, conv_b and dt_proj's bias drawn from a numpy seed."""
    cfg_j = reduce_config(get_config(ARCH))
    cfg_t = t_reduce_config(t_get_config(ARCH))
    jp = _np(jax_mamba.mamba1_init(jax.random.PRNGKey(3), cfg_j))
    rng = np.random.default_rng(7)
    jp["D"] = (1.0 + rng.normal(0.0, 0.3, jp["D"].shape)).astype(np.float32)
    jp["conv_b"] = rng.normal(0.0, 0.1, jp["conv_b"].shape).astype(np.float32)
    jp["dt_proj"]["b"] = rng.normal(0.0, 0.5, jp["dt_proj"]["b"].shape).astype(np.float32)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, jp), _torch(jp)


def _state(cfg_j, seed, B):
    """A nonzero carried state of the layer, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape, jax_mamba.mamba1_state_init(cfg_j, B))
    return {k: rng.standard_normal(s).astype(np.float32) * 0.5 for k, s in shapes.items()}


def _u(cfg, S, B=2, seed=None):
    rng = np.random.default_rng(S if seed is None else seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def run_port(tp, cfg_t, u, jstate, module=mamba):
    state = None if jstate is None else {k: torch.from_numpy(v.copy()) for k, v in jstate.items()}
    y, new = module.mamba1_apply(tp, cfg_t, torch.from_numpy(u), state=state, want_state=True)
    if state is not None:
        assert new is state  # updated in place
    return y.numpy(), {k: v.numpy() for k, v in new.items()}


def run_jax(jp, cfg_j, u, jstate):
    y, new = jax_mamba.mamba1_apply(jp, cfg_j, jnp.asarray(u),
                                    state=None if jstate is None else
                                    jax.tree.map(jnp.asarray, jstate), want_state=True)
    return np.asarray(y), {k: np.asarray(v, np.float32) for k, v in new.items()}


# (S, carried state): one-shot prefills (S 200, spanning two chunks with a
# ragged tail, and a single token), prefills from a state, the decode step
APPLY_CASES = [(200, False), (1, False), (200, True), (37, True), (1, True)]


@pytest.mark.parametrize("S,carried", APPLY_CASES)
def test_mamba1_apply_matches_jax(S, carried):
    cfg_j, cfg_t, jp, tp = layer()
    jstate = _state(cfg_j, 5, 2) if carried else None
    jy, jnew = run_jax(jp, cfg_j, _u(cfg_t, S), jstate)
    y, new = run_port(tp, cfg_t, _u(cfg_t, S), jstate)
    np.testing.assert_allclose(y, jy, **TOL)
    for k in ("conv", "ssm"):
        assert new[k].dtype == np.float32
        np.testing.assert_allclose(new[k], jnew[k], **TOL, err_msg=k)
    if carried:  # the state moves the output: a scan that lost it would fail
        y0, _ = run_port(tp, cfg_t, _u(cfg_t, S), None)
        assert np.abs(y0 - jy).max() > FAULT_MARGIN * TOL["atol"]


# a 300-token prompt as the engine feeds it: ragged pieces, one of a single
# token (the prefill path at S = 1 with a state is the decode step)
PIECES = [130, 1, 41, 128]


def test_chained_pieces_equal_one_shot_and_jax():
    cfg_j, cfg_t, jp, tp = layer()
    u = _u(cfg_t, sum(PIECES), seed=11)
    y_one, s_one = run_port(tp, cfg_t, u, None)
    state = {k: np.zeros_like(v) for k, v in _state(cfg_j, 0, 2).items()}
    jstate = dict(state)
    ys, jys, t0 = [], [], 0
    for n in PIECES:
        y, state = run_port(tp, cfg_t, u[:, t0:t0 + n], state)
        jy, jstate = run_jax(jp, cfg_j, u[:, t0:t0 + n], jstate)
        ys.append(y)
        jys.append(jy)
        t0 += n
    np.testing.assert_allclose(np.concatenate(ys, 1), y_one, **TOL)
    np.testing.assert_allclose(np.concatenate(ys, 1), np.concatenate(jys, 1), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k], s_one[k], **TOL, err_msg=k)
        np.testing.assert_allclose(state[k], jstate[k], **TOL, err_msg=k)


def _sequential(dt, x, A, B_, C_, h):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t; y_t = h_t . C_t, token by
    token."""
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[..., None] * B_[:, t,
                                                                                      None, :]
        ys.append(torch.einsum("bds,bs->bd", h, C_[:, t]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("chunk", [1, 5, mamba.CHUNK])
def test_chunked_scan_matches_a_token_loop(chunk):
    g = torch.Generator().manual_seed(chunk)
    B, S, d_in, ds = 2, 150, 12, 8
    dt = torch.nn.functional.softplus(torch.randn((B, S, d_in), generator=g))
    x = torch.randn((B, S, d_in), generator=g)
    A = -torch.exp(torch.randn((d_in, ds), generator=g))
    B_, C_ = torch.randn((B, S, ds), generator=g), torch.randn((B, S, ds), generator=g)
    h0 = torch.randn((B, d_in, ds), generator=g)
    h = h0.clone()
    y = mamba._m1_scan_chunked(dt, x, A, B_, C_, h, chunk=chunk)
    y_ref, h_ref = _sequential(dt, x, A, B_, C_, h0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), **TOL)


def mutated(old, new):
    """A copy of the port's mamba module with one source replacement."""
    src = inspect.getsource(mamba)
    assert old in src, old
    module = types.ModuleType("mamba_fault")
    exec(compile(src.replace(old, new), "mamba_fault", "exec"), module.__dict__)
    return module


FAULTS = {
    # the carried state dropped: every chunk starts from zero
    "h0_dropped": ("h_all = b.addcmul_(a, h[:, None])", "h_all = b"),
    # b composed without the decays' running products
    "a_not_composed": ("torch.mul(a[:, :-step], a[:, step:], out=a2[:, step:])",
                       "a2[:, step:] = a[:, step:]"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_scan_fault_is_rejected(fault):
    cfg_j, cfg_t, jp, tp = layer()
    jstate = _state(cfg_j, 5, 2)
    u = _u(cfg_t, 200)
    jy, _ = run_jax(jp, cfg_j, u, jstate)
    y, _ = run_port(tp, cfg_t, u, jstate, mutated(*FAULTS[fault]))
    moved = np.abs(y - jy).max() / (TOL["atol"] + TOL["rtol"] * np.abs(jy).max())
    assert moved > FAULT_MARGIN, moved


def test_unmutated_copy_passes():
    cfg_j, cfg_t, jp, tp = layer()
    jstate = _state(cfg_j, 5, 2)
    u = _u(cfg_t, 200)
    jy, _ = run_jax(jp, cfg_j, u, jstate)
    y, _ = run_port(tp, cfg_t, u, jstate, mutated("", ""))
    np.testing.assert_allclose(y, jy, **TOL)


def test_init_tree_matches_jax_with_fp32_leaves():
    cfg_j, cfg_t, _, _ = layer()
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax_mamba.mamba1_init(jax.random.PRNGKey(0), cfg_j))
    got = mamba.mamba1_init(cfg_t, generator=torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert got["A_log"].dtype == torch.float32
    assert got["in_proj"]["w"].dtype == got["D"].dtype == torch.bfloat16
    d_in, _, ds = mamba._m1_dims(cfg_t)
    np.testing.assert_allclose(got["A_log"].numpy(),
                               np.log(np.tile(np.arange(1, ds + 1), (d_in, 1))), rtol=1e-6)
    state = mamba.mamba1_state_init(cfg_t, 3, device="cpu")
    jstate = jax_mamba.mamba1_state_init(cfg_j, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in jstate.items()}


# ---------------------------------------------------------------------------
# reduced jamba: the model path
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def models(seed=0):
    """Reduced jamba (one period of 8 layers), dispatch dropless, both
    models and their parameters, the port's bridged from JAX's
    ``Model.init`` after ``drawn_leaves``; and the tree as numpy."""
    cfg_j = dropless(reduce_config(get_config(ARCH)))
    cfg_t = t_dropless(t_reduce_config(t_get_config(ARCH)))
    jmodel = jax_build_model(cfg_j)
    tree = drawn_leaves(_np(jmodel.init(jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, from_jax_params(tree, cfg_t), tree


def test_reduced_jamba_keeps_its_structure():
    _, _, model, params, _ = models()
    cfg = model.cfg
    assert [s.mixer for s in cfg.layer_specs] == ["mamba1"] * 4 + ["attn"] + ["mamba1"] * 3
    assert [s.ffn for s in cfg.layer_specs] == ["dense", "moe"] * 4
    assert cfg.n_attn_layers == 1 and model.inv_freq is None  # no positional encoding
    mixer = params["layers"][0]["mixer"]
    assert set(mixer) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "A_log", "D",
                          "out_proj"}
    assert set(mixer["dt_proj"]) == {"w", "b"}


def test_forward_matches_jax():
    jmodel, jparams, model, params, _ = models()
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 150)).astype(np.int32)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 150, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)


# (T, index): a prompt from 0 (B4 on the attention layer), a chunk after it
# (B1 over the row as one page), two decode steps (B3); then per-row offsets
STEPS = [(20, 0), (70, 20), (1, 90), (1, 91)]


def test_prefill_and_decode_match_jax():
    jmodel, jparams, model, params, _ = models()
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
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL, err_msg=msg)
        for i, (got, exp) in enumerate(zip(cache, caches_from_jax(_np(jcache), cfg))):
            assert set(got) == set(exp) == ({"k", "v"} if i == 4 else {"conv", "ssm"})
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(), **MODEL_TOL,
                                           err_msg=f"{msg} layer {i} {k}")


def test_decode_step_with_per_row_offsets():
    """The two-call engine's decode call: rows at different offsets (a (B,)
    index), against the same rows decoded one at a time."""
    _, _, model, params, _ = models()
    cfg = model.cfg
    rng = np.random.default_rng(3)
    lens = [13, 40]
    cache = model.init_cache(2, MAX_LEN)
    singles = [model.init_cache(1, MAX_LEN) for _ in lens]
    for b, n in enumerate(lens):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32))
        row = [{k: v[b:b + 1] for k, v in layer.items()} for layer in cache]
        model.prefill(params, {"tokens": tokens}, row, 0)
        model.prefill(params, {"tokens": tokens}, singles[b], 0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32))
    logits, _ = model.decode_step(params, tok, cache, torch.tensor(lens))
    for b, n in enumerate(lens):
        one, _ = model.decode_step(params, tok[b:b + 1], singles[b], n)
        np.testing.assert_allclose(logits[b:b + 1].numpy(), one.numpy(), **MODEL_TOL)


def test_bridge_keeps_fp32_leaves_in_a_bf16_model():
    _, _, model, _, tree = models()
    p16 = from_jax_params(tree, model.cfg, dtype=torch.bfloat16)
    for spec, layer in zip(model.cfg.layer_specs, p16["layers"]):
        if spec.mixer == "mamba1":
            assert layer["mixer"]["A_log"].dtype == torch.float32
            assert layer["mixer"]["dt_proj"]["b"].dtype == torch.bfloat16
    # the fp32 leaf is JAX's value exactly (layer 1: period position 1)
    np.testing.assert_array_equal(p16["layers"][1]["mixer"]["A_log"].numpy(),
                                  tree["stack"]["periods"]["1"]["mixer"]["A_log"][0])
