"""The port's MLA (DeepSeek-V2's multi-head latent attention) against the
JAX package, at ``reduce_config`` widths of deepseek-v2-236b (d_model 64, 4
heads, q_lora_rank 32, kv_lora_rank 16, no-RoPE 16 and RoPE 8 dims a head,
values 16; three layers: the dense layer 0 and two MoE layers of 8 experts
of width 64, top 2, two shared experts, dispatch dropless as serving runs
it). Norm scales and routers are drawn from a numpy seed in the parameter
tree before either side gets it (``test_torch_archs.drawn_leaves``).

* every MLA leaf reaches the port through ``from_jax_params``, and the
  port's own ``Model.init`` makes the same names and shapes;
* ``_mla_apply`` on each of JAX's branches: direct (no cache), absorbed
  (a cache: decode and a short chunk at per-row offsets over stale cache
  rows) and expanded (T * S past ``FLASH_THRESHOLD``, with and without a
  cache; the chunk spans three 512-row query blocks and eight key blocks);
* packed-step logits and latent caches through ``PagedView`` and
  ``DenseView``;
* serial ``forward``, chunked ``prefill`` and ``decode_step`` logits and
  caches;
* two faults made on the port's side only, that the same comparison must
  reject: the online softmax without its rescale, and a causal limit one
  key too far.

The absorbed branch's key tile is set to 8 keys here (``mla_key_tile``, by
monkeypatch), so the contexts of 13-29 keys span two to four tiles; it is
not a setting of the serving path. fp32 throughout, rtol = atol = 1e-4; a
fault must move the logits 100 times past it.
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
from repro.core.packed_step import PagedView as JaxPagedView  # noqa: E402
from repro.core.packed_step import packed_step as jax_packed_step  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import _mla_apply as jax_mla_apply  # noqa: E402
from repro.serving.engine import _init_page_pool  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402
from repro_torch.core.packed_step import DenseView, PagedView, packed_step  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import CacheCall  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402
from test_torch_archs import _leaves, _paged_inputs, drawn_leaves  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-4, atol=1e-4)
FAULT_MARGIN = 100  # a fault moves some logit this many tolerances
PAGE, N_SLOTS, PPS = 4, 3, 10  # page size, decode slots, pages per slot
MAX_LEN = 64
KEY_TILE = 8
MLA_LEAVES = {"q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up", "wo"}


@pytest.fixture(autouse=True)
def small_key_tile(monkeypatch):
    """Eight keys a tile of the absorbed branch, so that every context here
    spans several tiles and the online softmax rescales between them."""
    monkeypatch.setattr(attention, "mla_key_tile", lambda *a: KEY_TILE)


def reduced_pair():
    """(JAX config, port config): deepseek-v2 at reduced widths, two MoE
    periods past its dense layer, dropless."""
    return (dropless(reduce_config(get_config(ARCH), periods=2)),
            t_dropless(t_reduce_config(t_get_config(ARCH), periods=2)))


@functools.lru_cache(maxsize=None)
def models(seed=0):
    """Both models and their parameters, the port's bridged from JAX's
    ``Model.init`` after ``drawn_leaves`` (made once a seed; nothing here
    writes them)."""
    cfg_j, cfg_t = reduced_pair()
    jmodel = jax_build_model(cfg_j)
    tree = drawn_leaves(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed))),
                        np.random.default_rng(seed))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, from_jax_params(tree, cfg_t), tree


def latent_mutated(old, new):
    """``attention.latent_attention`` with one source replacement made (the
    old text must be in its source)."""
    src = inspect.getsource(attention.latent_attention)
    assert old in src, old
    module = types.ModuleType("latent_fault")
    module.__dict__.update(attention.__dict__)
    exec(compile(src.replace(old, new), "latent_fault", "exec"), module.__dict__)
    return module.latent_attention


FAULTS = {
    # the online softmax without its rescale: each tile's sums and output
    # are added as if every earlier tile had used the same running max
    "no_rescale": ("alpha = torch.exp(m - m_new)", "alpha = torch.ones_like(m)"),
    # each row also attends the key after its position (stale in a decode
    # row's cache, the next token's in a chunk)
    "causal_limit": ("torch.arange(k0, k1, device=dev) > limit",
                     "torch.arange(k0, k1, device=dev) > limit + 1"),
}


def moved(got, want):
    """How many tolerances the worst output is off by (a non-finite output
    counts as off by infinitely many)."""
    return max(np.where(np.isfinite(g), np.abs(g - w), np.inf).max()
               / (TOL["atol"] + TOL["rtol"] * np.abs(w).max()) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the weights bridge
# ---------------------------------------------------------------------------


def test_every_mla_leaf_arrives():
    """JAX's tree lands in the port's value for value, with every MLA leaf
    in every layer, and the port's own ``Model.init`` makes the same names
    and shapes."""
    _, _, model, params, tree = models()
    cfg = model.cfg
    for layer in params["layers"]:
        assert set(layer["mixer"]) == MLA_LEAVES
    layers = list(tree["stack"]["prefix"])
    for c in range(cfg.n_periods):
        for i in range(cfg.scan_period):
            layers.append(jax.tree.map(lambda a, c=c: np.asarray(a)[c],
                                       tree["stack"]["periods"][str(i)]))
    expect = dict(embed=tree["embed"], final_norm=tree["final_norm"], layers=layers,
                  lm_head=tree["lm_head"])
    got, want = dict(_leaves(params)), dict(_leaves(expect))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    own = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in got.items()}


# ---------------------------------------------------------------------------
# _mla_apply's branches
# ---------------------------------------------------------------------------

# name -> (B, T, cache length or None, index per row or None)
BRANCHES = {
    "direct": (2, 24, None, None),
    "absorbed_decode": (2, 1, MAX_LEN, [29, 13]),
    "absorbed_chunk": (2, 5, MAX_LEN, [20, 13]),
    "expanded_no_cache": (1, 2100, None, None),  # T * T past 2^22
    "expanded_cache": (1, 1100, 4096, [100]),  # T * S past 2^22
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_mla_apply_matches_jax_on_each_branch(branch):
    """Layer 0's mixer on numpy-seeded activations; with a cache, over a
    cache of random rows (keys past each row's positions hold stale values
    that must stay unread), with the call's latent written at per-row
    offsets."""
    B, T, S, index = BRANCHES[branch]
    jmodel, jparams, model, params, _ = models(seed=3)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    start = np.zeros(B, np.int64) if index is None else np.asarray(index)
    positions = (start[:, None] + np.arange(T)[None, :]).astype(np.int32)
    jp = jparams["stack"]["prefix"][0]["mixer"]
    tp = params["layers"][0]["mixer"]
    angles = rope_angles(torch.from_numpy(positions), model.inv_freq)
    if S is None:
        jy, _ = jax_mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(positions), jmodel.inv_freq,
                              cache=None, cache_index=None)
        ty, _ = attention._mla_apply(tp, cfg, torch.from_numpy(x), angles)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        return
    cache = {"ckv": rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32),
             "krope": rng.standard_normal((B, S, cfg.qk_rope_head_dim)).astype(np.float32)}
    jy, jcache = jax_mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(positions), jmodel.inv_freq,
                               cache=jax.tree.map(jnp.asarray, cache),
                               cache_index=jnp.asarray(start, jnp.int32))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, _ = attention._mla_apply(tp, cfg, torch.from_numpy(x), angles, cache=tcache,
                                 call=CacheCall(torch.from_numpy(start.astype(np.int32))))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in cache:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL, err_msg=k)


def test_branch_rule_is_jax():
    """The expanded branch is taken exactly where JAX takes ``flash_sdpa``:
    a cached call of T > 1 with T * S past 2^22, an uncached one with T * T
    past it."""
    assert attention.FLASH_THRESHOLD == 1 << 22
    for name, (B, T, S, _) in BRANCHES.items():
        expanded = (T * T if S is None else (T > 1) * T * S) > attention.FLASH_THRESHOLD
        assert expanded == name.startswith("expanded"), name


# ---------------------------------------------------------------------------
# the packed step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_paged_step():
    """JAX's side of ``paged_step``: its inputs, pool, logits and pool
    after the step (computed once)."""
    jmodel, jparams, _, _, _ = models()
    rng = np.random.default_rng(1)
    c = _paged_inputs(rng, jmodel.cfg.vocab_size)
    pool = _init_page_pool(jmodel, N_SLOTS * PPS + 1, PAGE, jnp.float32)
    pool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pool)
    jlogits, jpool = jax_packed_step(
        jmodel, jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(c["tokens"]),
        jnp.asarray(c["slots"]), jnp.asarray(c["positions"]),
        paged=JaxPagedView(jnp.asarray(c["bt"]), PAGE, use_kernel=False,
                           cu_q_lens=jnp.asarray(c["cu"]), kv_lens=jnp.asarray(c["kv"]),
                           seg_slots=jnp.asarray(c["seg_slots"]), q_block=c["qb"]))
    return c, pool, np.asarray(jlogits), jax.tree.map(np.asarray, jpool)


def paged_step(fault=None):
    """(port logits, JAX logits) of one paged packed step's real rows
    (``test_torch_archs._paged_inputs``: decode rows at contexts 13 and 29,
    a 6-row chunk at 21..26, padding to 12 rows and 8 segments, shuffled
    pages); also checks every real latent page the step wrote, where
    nothing is broken."""
    _, _, model, params, _ = models()
    cfg = model.cfg
    c, pool, jlogits, jpool = jax_paged_step()
    tpool = caches_from_jax(pool, cfg)
    assert set(tpool[0]) == {"ckv", "krope"}
    t = torch.from_numpy
    paged = PagedView(t(c["bt"]), PAGE, cu_q_lens=t(c["cu"]), kv_lens=t(c["kv"]),
                      seg_slots=t(c["seg_slots"]))
    logits, _ = packed_step(model, params, tpool, t(c["tokens"]), t(c["slots"]),
                            t(c["positions"]), paged)
    n = c["n_real"]
    if not fault:
        expect = caches_from_jax(jpool, cfg)
        scratch = N_SLOTS * PPS
        for layer, (got_l, exp_l) in enumerate(zip(tpool, expect)):
            for kind in ("ckv", "krope"):
                np.testing.assert_allclose(got_l[kind][:scratch].numpy(),
                                           exp_l[kind][:scratch].numpy(), **TOL,
                                           err_msg=f"layer {layer} {kind}")
    return logits[:n].numpy(), jlogits[:n]


@functools.lru_cache(maxsize=None)
def jax_dense_step():
    """JAX's side of ``dense_step``: its rows, cache, logits and cache after
    the step (computed once)."""
    jmodel, jparams, _, _, _ = models(seed=1)
    rng = np.random.default_rng(2)
    slots = np.asarray([0, 1] + [2] * 9, np.int32)
    positions = np.asarray([12, 28] + list(range(15, 24)), np.int32)
    tokens = rng.integers(0, jmodel.cfg.vocab_size, len(slots)).astype(np.int32)
    cache = jmodel.init_cache(N_SLOTS + 1, MAX_LEN, jnp.float32)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), cache)
    jlogits, jcache = jax_packed_step(jmodel, jparams, jax.tree.map(jnp.asarray, cache),
                                      jnp.asarray(tokens), jnp.asarray(slots),
                                      jnp.asarray(positions))
    return (tokens, slots, positions), cache, np.asarray(jlogits), jax.tree.map(np.asarray,
                                                                                jcache)


def dense_step(fault=None):
    """(port logits, JAX logits) of one dense packed step: decode rows of
    slots 0 and 1 at 12 and 28, slot 2's chunk at 15..23, over a slot cache
    of random rows; the latent caches are checked where nothing is
    broken."""
    _, _, model, params, _ = models(seed=1)
    cfg = model.cfg
    (tokens, slots, positions), cache, jlogits, jcache = jax_dense_step()
    tcache = caches_from_jax(cache, cfg)
    t = torch.from_numpy
    logits, _ = packed_step(model, params, tcache, t(tokens), t(slots), t(positions),
                            DenseView(t(slots), t(positions)))
    if not fault:
        expect = caches_from_jax(jcache, cfg)
        for layer, (got_l, exp_l) in enumerate(zip(tcache, expect)):
            for kind in ("ckv", "krope"):
                np.testing.assert_allclose(got_l[kind][:N_SLOTS].numpy(),
                                           exp_l[kind][:N_SLOTS].numpy(), **TOL,
                                           err_msg=f"layer {layer} {kind}")
    return logits.numpy(), jlogits


STEPS = {"paged": paged_step, "dense": dense_step}


@pytest.mark.parametrize("view", list(STEPS))
def test_packed_step_matches_jax(view):
    got, expect = STEPS[view]()
    np.testing.assert_allclose(got, expect, **TOL)


@pytest.mark.parametrize("view", list(STEPS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_packed_step_fault_is_rejected(view, fault, monkeypatch):
    monkeypatch.setattr(attention, "latent_attention", latent_mutated(*FAULTS[fault]))
    got, expect = STEPS[view](fault=fault)
    assert moved([got], [expect]) > FAULT_MARGIN


def test_paged_step_gathers_each_segment_once(monkeypatch):
    """The paged view gathers each segment's pages once a layer and hands
    ``latent_attention`` one key tile at a time: no buffer the size of every
    row's whole context."""
    seen = []
    inner = attention.latent_attention

    def recording(q_eff, q_rope, q_pos, keys, n_keys, **kw):
        def tiles(k0, k1):
            kv = keys(k0, k1)
            seen.append(tuple(kv.shape))
            return kv
        return inner(q_eff, q_rope, q_pos, tiles, n_keys, **kw)

    monkeypatch.setattr(attention, "latent_attention", recording)
    paged_step()
    _, cfg = reduced_pair()
    n_keys = PPS * PAGE
    assert len(seen) == cfg.n_layers * (n_keys // KEY_TILE)
    assert set(seen) == {(12, KEY_TILE, cfg.kv_lora_rank + cfg.qk_rope_head_dim)}


# ---------------------------------------------------------------------------
# the serial path
# ---------------------------------------------------------------------------

B = 2
# (kind, T, index): a prefill from 0, a chunk at a scalar offset, one at
# per-row offsets, decode at a scalar and per-row offsets
SERIAL_STEPS = [("prefill", 20, 0), ("prefill", 5, 20), ("prefill", 3, [25, 22]),
                ("decode", 1, 28), ("decode", 1, [29, 26])]


@functools.lru_cache(maxsize=None)
def jax_serial():
    """JAX's side of ``serial_logits``: the token batches, then the logits
    and the cache after each call (computed once)."""
    jmodel, jparams, _, _, _ = models(seed=2)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jmodel.cfg.vocab_size, (B, 40)).astype(np.int32)]
    jl, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(batches[0])})
    want, caches = [np.asarray(jl)], [None]
    jcache = jmodel.init_cache(B, MAX_LEN, jnp.float32)
    for kind, T, index in SERIAL_STEPS:
        tokens = rng.integers(0, jmodel.cfg.vocab_size, (B, T)).astype(np.int32)
        jindex = jnp.asarray(index, jnp.int32)
        if kind == "prefill":
            jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache, jindex)
        else:
            jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), jcache, jindex)
        batches.append(tokens)
        want.append(np.asarray(jl))
        caches.append(jax.tree.map(np.asarray, jcache))
    return batches, want, caches


def serial_logits(fault=None):
    """(port, JAX) logits of ``forward`` on a 40-token batch, then of each
    of ``SERIAL_STEPS`` over a dense latent cache; the caches are checked
    where nothing is broken."""
    _, _, model, params, _ = models(seed=2)
    cfg = model.cfg
    batches, want, jcaches = jax_serial()
    got = [model.forward(params, {"tokens": torch.from_numpy(batches[0])}).numpy()]
    cache = model.init_cache(B, MAX_LEN)
    assert set(cache[0]) == {"ckv", "krope"}
    for (kind, T, index), tokens, jcache in zip(SERIAL_STEPS, batches[1:], jcaches[1:]):
        tindex = index if isinstance(index, int) else torch.tensor(index, dtype=torch.int32)
        run = model.prefill if kind == "prefill" else model.decode_step
        arg = {"tokens": torch.from_numpy(tokens)} if kind == "prefill" else \
            torch.from_numpy(tokens)
        tl, _ = run(params, arg, cache, tindex)
        got.append(tl.numpy())
        if not fault:
            expect = caches_from_jax(jcache, cfg)
            for layer, (got_l, exp_l) in enumerate(zip(cache, expect)):
                for kv in ("ckv", "krope"):
                    np.testing.assert_allclose(got_l[kv].numpy(), exp_l[kv].numpy(), **TOL,
                                               err_msg=f"{kind} {index} layer {layer} {kv}")
    return got, want


def test_serial_forward_prefill_and_decode_match_jax():
    got, want = serial_logits()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"call {i}")


@pytest.mark.parametrize("fault", list(FAULTS))
def test_serial_fault_is_rejected(fault, monkeypatch):
    monkeypatch.setattr(attention, "latent_attention", latent_mutated(*FAULTS[fault]))
    got, want = serial_logits(fault)
    assert moved(got, want) > FAULT_MARGIN


def test_depth_cut_keeps_deepseek_widths():
    """``launch.serve.depth_cut`` at 8 of 60 layers: the dense layer 0 and 7
    MoE layers at every published width."""
    from repro_torch.launch.serve import depth_cut

    full = t_get_config(ARCH)
    cut = depth_cut(full, 8)
    assert [s.ffn for s in cut.layer_specs] == ["dense"] + ["moe"] * 7
    for field in ("d_model", "n_heads", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
                  "qk_rope_head_dim", "v_head_dim", "n_experts", "top_k", "moe_d_ff",
                  "n_shared_experts", "vocab_size"):
        assert getattr(cut, field) == getattr(full, field)
    assert abs(cut.param_count() / 1e9 - 29.2) < 0.1
