"""The port's encoder-decoder (whisper-small) against the JAX package, on the
CPU.

Reduced whisper-small (``reduce_config(periods=2)``: d_model 64, 4 heads of
16 over 4 KV heads, d_ff 128, 2 encoder and 2 decoder layers,
``frontend_len`` 8, vocabulary 256), fp32. Weights come from JAX's
``Model.init`` at a fixed key with every bias drawn from N(0, 0.5^2) and
every norm scale from 1 + N(0, 0.3^2) (``test_torch_archs.drawn_leaves``;
the LayerNorm biases too), so that a leaf lost on the way moves the
output, and cross into the port through ``repro_torch.weights``. Every
input comes from a numpy seed.

* ``layer_norm`` (1e-5 and whisper's 1e-6) and ``sinusoids`` (bit for bit);
* ``cross_kv`` and ``cross_attn_apply`` at T 1 (B3) and T 5 (B4 with
  ``causal`` off), and ``encode``, at rtol = atol = 1e-5;
* the port's init tree against ``encdec_init``'s, key for key and shape for
  shape, and the bridge's leaves against JAX's stacked ones;
* ``forward`` logits, ``prefill`` of 10 tokens then decode steps at one
  offset for every row and at per-row offsets (a chunk and decode steps,
  B1 and B3), logits at 1e-4 and both cache parts (self and cross K/V)
  against JAX's;
* a prefill in two chunks (the second on B1) against one prefill;
* a fault that the comparison must catch: an encoder made causal.
"""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, build_model, encdec, layers  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402
from test_torch_archs import drawn_leaves  # noqa: E402

ARCH = "whisper-small"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def drawn(tree, rng):
    """``drawn_leaves``, with LayerNorm's ``bias`` leaves drawn as biases."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32) if k == "bias"
                    else drawn(v, rng) if isinstance(v, dict) else
                    drawn_leaves({k: v}, rng)[k])
                for k, v in tree.items()}
    return drawn_leaves(tree, rng)


@functools.lru_cache(maxsize=None)
def models(seed=0):
    """Reduced whisper on both sides: (JAX model, JAX params, port model,
    port params, the tree as numpy)."""
    cfg_j = reduce_config(get_config(ARCH), periods=2)
    cfg_t = t_reduce_config(t_get_config(ARCH), periods=2)
    jmodel = jax_build_model(cfg_j)
    tree = drawn(_np(jmodel.init(jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, from_jax_params(tree, cfg_t), tree


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_reduced_whisper_keeps_its_structure():
    _, _, model, params, _ = models()
    cfg = model.cfg
    assert cfg.encdec and cfg.n_enc_layers == 2 and cfg.n_layers == 2
    assert cfg.n_heads == cfg.n_kv_heads == 4 and cfg.frontend_len == 8
    assert model.inv_freq is None  # rotary_pct 0: learned positions only
    assert len(params["enc"]) == 2 and len(params["dec"]) == 2


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_jax(eps):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    p = {"scale": (1 + 0.3 * rng.standard_normal(64)).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = np.asarray(jax_layers.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), eps))
    got = layers.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), eps)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    init = layers.layer_norm_init(64, dtype=torch.float32, device="cpu")
    assert {k: v.tolist() for k, v in init.items()} == {
        k: np.asarray(v).tolist() for k, v in jax_layers.layer_norm_init(64).items()}


@pytest.mark.parametrize("length,channels", [(8, 64), (1500, 768)])
def test_sinusoids_match_jax_bit_for_bit(length, channels):
    got = encdec.sinusoids(length, channels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_encdec.sinusoids(length, channels)))


@pytest.mark.parametrize("T", [1, 5])
def test_cross_attention_matches_jax(T, monkeypatch):
    _, _, model, params, tree = models()
    cfg = model.cfg
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["dec"])["cross_attn"]  # layer 1
    tp = params["dec"][1]["cross_attn"]
    assert set(tp) == {"wq", "wk", "wv", "wo"} and set(tp["wq"]) == {"w", "b"}
    assert set(tp["wk"]) == {"w"} and set(tp["wv"]) == {"w", "b"}
    rng = np.random.default_rng(T)
    enc_out = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jkv = jax_attention.cross_kv(jp, model.cfg, jnp.asarray(enc_out))
    kv = attention.cross_kv(tp, cfg, torch.from_numpy(enc_out))
    for k in ("k", "v"):
        np.testing.assert_allclose(kv[k].numpy(), np.asarray(jkv[k]), **TOL)
    calls = []
    for name in ("flash_attention_bshd", "decode_attention_bhd"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append((_n, kw.get("causal"))) or _r(*a, **kw))
    want = jax_attention.cross_attn_apply(jp, model.cfg, jnp.asarray(x), jkv)
    got = attention.cross_attn_apply(tp, cfg, torch.from_numpy(x), kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # B3 over every encoder key for one query a row, B4 without the mask else
    assert calls == ([("decode_attention_bhd", None)] if T == 1 else
                     [("flash_attention_bshd", False)])


def test_encode_matches_jax():
    jmodel, jparams, model, params, _ = models()
    frames = _frames(model.cfg, 2, 3)
    want = jax_encdec.encode(jparams, jmodel.cfg, jnp.asarray(frames))
    got = encdec.encode(params, model.cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_causal_encoder_is_caught(monkeypatch):
    """The comparison above sees an encoder whose attention kept the causal
    mask."""
    jmodel, jparams, model, params, _ = models()
    frames = _frames(model.cfg, 2, 3)
    want = np.asarray(jax_encdec.encode(jparams, jmodel.cfg, jnp.asarray(frames)))
    real = ops.flash_attention_bshd
    monkeypatch.setattr(ops, "flash_attention_bshd",
                        lambda q, k, v, **kw: real(q, k, v, **dict(kw, causal=True)))
    got = encdec.encode(params, model.cfg, torch.from_numpy(frames)).numpy()
    assert np.abs(got - want).max() > 100 * TOL["atol"]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_init_tree_matches_jax_key_for_key():
    _, _, model, params, tree = models()
    cfg = model.cfg
    own = model.init(torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(params)
    # the bridge: a list entry per stacked layer, every leaf JAX's slice
    for part, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
        for i in range(n):
            jax.tree.map(lambda a, t: np.testing.assert_array_equal(t.numpy(), a[i]),
                         tree[part], params[part][i])
    for key in ("enc_norm", "dec_norm", "embed", "pos_dec"):
        jax.tree.map(lambda a, t: np.testing.assert_array_equal(t.numpy(), a), tree[key],
                     params[key])
    assert _shapes(params)["pos_dec"] == (cfg.max_seq_len, cfg.d_model)


def test_forward_matches_jax():
    jmodel, jparams, model, params, _ = models()
    cfg = model.cfg
    frames, tokens = _frames(cfg, 2, 5), _tokens(cfg, 2, 12, 5)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)})
    logits = model.forward(params, {"tokens": torch.from_numpy(tokens),
                                    "frames": torch.from_numpy(frames)})
    assert logits.shape == (2, 12, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)


def _compare_caches(cache, jcache, cfg):
    bridged = caches_from_jax(_np(jcache), cfg)
    assert len(cache) == len(bridged) == cfg.n_layers
    for mine, theirs in zip(cache, bridged):
        assert set(mine) == set(theirs) == {"k", "v", "cross_k", "cross_v"}
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), **MODEL_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match_jax(per_row):
    """A 10-token prefill at 0, then (per-row) a 3-token chunk at offsets
    10 and 7 (B1; row 1 drops its last three prompt tokens) and decode
    steps (B3) at per-row offsets; or decode steps at one offset."""
    jmodel, jparams, model, params, _ = models()
    cfg = model.cfg
    frames, tokens = _frames(cfg, 2, 6), _tokens(cfg, 2, 10, 6)
    jcache = jmodel.init_cache(2, MAX_LEN, jnp.float32)
    cache = model.init_cache(2, MAX_LEN, torch.float32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)}, jcache, 0)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                       "frames": torch.from_numpy(frames)}, cache, 0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    _compare_caches(cache, jcache, cfg)
    index = np.array([10, 7], np.int32) if per_row else 10
    if per_row:
        chunk = _tokens(cfg, 2, 3, 7)
        jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(chunk),
                                              "frames": jnp.asarray(frames)}, jcache,
                                    jnp.asarray(index))
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(chunk),
                                           "frames": torch.from_numpy(frames)}, cache,
                                  torch.from_numpy(index))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
        index = index + 3
    for step in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        idx = index + step
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(idx))
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(np.asarray(idx)) if per_row else idx)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **MODEL_TOL)
    _compare_caches(cache, jcache, cfg)


def test_prefill_in_two_chunks_equals_one(monkeypatch):
    """6 tokens at 0 (B4), then 4 at 6 (B1, the row's cache one page),
    against all 10 at once: the same logits and caches."""
    _, _, model, params, _ = models()
    cfg = model.cfg
    frames, tokens = _frames(cfg, 2, 8), _tokens(cfg, 2, 10, 8)
    calls = {"mixed_attention_rows": 0}
    real = ops.mixed_attention_rows
    monkeypatch.setattr(ops, "mixed_attention_rows", lambda *a, **kw:
                        calls.__setitem__("mixed_attention_rows", calls["mixed_attention_rows"]
                                          + 1) or real(*a, **kw))
    one = model.init_cache(2, MAX_LEN)
    want, one = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                       "frames": torch.from_numpy(frames)}, one, 0)
    assert calls["mixed_attention_rows"] == 0
    two = model.init_cache(2, MAX_LEN)
    batch = {"frames": torch.from_numpy(frames)}
    _, two = model.prefill(params, dict(batch, tokens=torch.from_numpy(tokens[:, :6])), two, 0)
    got, two = model.prefill(params, dict(batch, tokens=torch.from_numpy(tokens[:, 6:])), two,
                             6)
    assert calls["mixed_attention_rows"] == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for a, b in zip(one, two):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **TOL)
