"""The port's model path on the archs it serves beside llama3.1-8b --
gemma2-2b, qwen2-1.5b, chatglm3-6b, qwen3-32b, llama3.1-70b and the MoE
qwen3-moe-30b-a3b -- against the JAX package, at ``reduce_config`` widths
(d_model 64, head_dim 16, two periods; qwen3-moe: 8 experts of width 64, top
2, dispatch dropless as serving runs it) but with each arch's published GQA
group: 2 KV heads and ``2 * G`` query heads, G 2, 6, 16, 8, 8 and 8.

* every leaf these archs add (q/k/v biases, q/k norm scales, post-norms,
  tied embeddings) reaches the port: JAX initialises biases to zeros and
  norm scales to ones, so the tests draw them from a numpy seed in the
  parameter tree before either side gets it;
* packed-step logits through ``PagedView`` and through ``DenseView`` with
  the engine's row tiles, and the caches the step writes;
* serial ``forward``, chunked ``prefill`` and ``decode_step`` logits;
* a fault case for each feature, made on the port's side only, that the
  same comparison must reject: gemma2 without its softcaps, its window or
  its post-norms; chatglm3 with RoPE over the whole head; qwen2 without
  its biases; qwen3 without its q/k norms; qwen3-moe with its top-k
  router weights left unnormalised.

gemma2's softcaps are set on both sides to 2.0 (attention and final), small
enough to bend reduced-width scores and logits; one case keeps the
published 50 / 30. Its reduced window is 16 keys, and every prompt and
context here is longer. fp32 throughout, rtol = atol = 1e-4 (the packed-step
tests' tolerance); a fault must move the logits 100 times past it.
"""
from __future__ import annotations

import dataclasses

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
from repro.serving.engine import _init_page_pool  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.configs.reduced import dropless as t_dropless  # noqa: E402
from repro_torch.core.packed_step import DenseView, PagedView, packed_step  # noqa: E402
from repro_torch.kernels.paged_attention import q_tile_rows, row_tiles  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.weights import caches_from_jax, from_jax_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FAULT_MARGIN = 100  # a fault moves some logit this many tolerances
GROUPS = {"gemma2-2b": 2, "qwen2-1.5b": 6, "chatglm3-6b": 16, "qwen3-32b": 8,
          "llama3.1-70b": 8, "qwen3-moe-30b-a3b": 8}
ARCHS = list(GROUPS)
SMALL_CAPS = dict(attn_logit_softcap=2.0, final_logit_softcap=2.0)
PAGE, N_SLOTS, PPS = 4, 3, 10  # page size, decode slots, pages per slot
MAX_LEN = 64


def reduced_pair(arch, **over):
    """(JAX config, port config) of ``arch`` at reduced widths with its
    published group; gemma2's softcaps small unless ``over`` says."""
    g = GROUPS[arch]
    kw = dict(n_heads=2 * g, n_kv_heads=2)
    if arch == "gemma2-2b":
        kw.update(SMALL_CAPS)
    kw.update(over)
    # MoE dispatch without drops, as serving runs it (no row depends on another)
    return (dropless(dataclasses.replace(reduce_config(get_config(arch), periods=2), **kw)),
            t_dropless(dataclasses.replace(t_reduce_config(t_get_config(arch), periods=2),
                                           **kw)))


def drawn_leaves(tree, rng):
    """The parameter tree (numpy) with every bias drawn from N(0, 0.5^2) and
    every norm scale from 1 + N(0, 0.3^2), so that a leaf lost on the way
    moves the logits; and every MoE router from N(0, 1/d_model) (the init's
    std of 0.02 leaves the router's probabilities so nearly equal that its
    top-k choices sit within 1e-5 of a tie)."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32) if k == "b" else
                    (1.0 + rng.normal(0.0, 0.3, np.shape(v))).astype(np.float32)
                    if k == "scale" else
                    {"w": rng.normal(0.0, np.shape(v["w"])[-2] ** -0.5,
                                     np.shape(v["w"])).astype(np.float32)}
                    if k == "router" else drawn_leaves(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [drawn_leaves(v, rng) for v in tree]
    return np.asarray(tree)


def models(arch, seed=0, **over):
    """Both models and their parameters, the port's bridged from JAX's
    ``Model.init`` after ``drawn_leaves``."""
    cfg_j, cfg_t = reduced_pair(arch, **over)
    jmodel = jax_build_model(cfg_j)
    tree = drawn_leaves(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed))),
                        np.random.default_rng(seed))
    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, from_jax_params(tree, cfg_t), tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _faulty(arch, fault, model, params):
    """The port's model and parameters with one feature broken."""
    cfg = model.cfg
    if fault == "no_softcaps":
        cfg = dataclasses.replace(cfg, attn_logit_softcap=None, final_logit_softcap=None)
    elif fault == "no_window":
        cfg = dataclasses.replace(cfg, local_window=None)
    elif fault == "no_post_norms":
        cfg = dataclasses.replace(cfg, post_norm=False)
    elif fault == "full_rotary":
        cfg = dataclasses.replace(cfg, rotary_pct=1.0)
    elif fault == "no_qk_norm":
        cfg = dataclasses.replace(cfg, qk_norm=False)
    elif fault == "no_norm_topk":
        cfg = dataclasses.replace(cfg, norm_topk=False)
    elif fault == "no_biases":
        params = dict(params, layers=[
            dict(layer, mixer={k: ({"w": v["w"]} if isinstance(v, dict) and "w" in v else v)
                               for k, v in layer["mixer"].items()})
            for layer in params["layers"]])
    else:
        raise ValueError(fault)
    return build_model(cfg, dtype=torch.float32, device="cpu"), params


FAULTS = [("gemma2-2b", "no_softcaps"), ("gemma2-2b", "no_window"),
          ("gemma2-2b", "no_post_norms"), ("chatglm3-6b", "full_rotary"),
          ("qwen2-1.5b", "no_biases"), ("qwen3-32b", "no_qk_norm"),
          ("qwen3-moe-30b-a3b", "no_norm_topk")]


# ---------------------------------------------------------------------------
# the weights bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_arrives(arch):
    """Every leaf of JAX's tree lands in the port's, value for value, and the
    port's own ``Model.init`` makes the same tree (names and shapes): the
    biases (qwen2, chatglm3), q/k norm scales (qwen3), post-norms (gemma2),
    and no ``lm_head`` where the embeddings are tied."""
    _, _, model, params, tree = models(arch)
    cfg = model.cfg
    mixer = params["layers"][0]["mixer"]
    assert ("b" in mixer["wq"] and "b" in mixer["wk"] and "b" in mixer["wv"]) == cfg.qkv_bias
    assert "b" not in mixer["wo"]
    assert ("q_norm" in mixer and "k_norm" in mixer) == cfg.qk_norm
    assert ("post_norm1" in params["layers"][0]) == cfg.post_norm
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    # value for value: the bridged tree against JAX's, layer by layer
    layers = list(tree["stack"]["prefix"])
    for c in range(cfg.n_periods):
        for i in range(cfg.scan_period):
            layers.append(jax.tree.map(lambda a, c=c: np.asarray(a)[c],
                                       tree["stack"]["periods"][str(i)]))
    expect = dict(embed=tree["embed"], final_norm=tree["final_norm"], layers=layers,
                  **({"lm_head": tree["lm_head"]} if "lm_head" in tree else {}))
    got = dict(_leaves(params))
    want = dict(_leaves(expect))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    drawn = [v for k, v in want.items() if k.endswith("/b") or k.endswith("/scale")]
    assert drawn and all(np.abs(v - np.round(v)).max() > 0 for v in drawn)
    own = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in got.items()}


# ---------------------------------------------------------------------------
# the packed step
# ---------------------------------------------------------------------------


def _paged_inputs(rng, vocab):
    """Two decode rows (slots 0, 1 at contexts 13 and 29) and a 6-token
    prefill chunk of slot 2 at positions 21..26, padded to 12 rows and 8
    segments; shuffled physical pages. The decode row at 29 and the chunk
    reach past the reduced window of 16."""
    P = N_SLOTS * PPS
    perm = rng.permutation(P).astype(np.int32)
    bt = np.full((N_SLOTS + 1, PPS), P, np.int32)  # scratch page = P
    ctx = [13, 29, 27]
    for s in range(N_SLOTS):
        n = -(-ctx[s] // PAGE)
        bt[s, :n] = perm[s * PPS:s * PPS + n]
    N = 12
    tokens = np.zeros(N, np.int32)
    slots = np.full(N, N_SLOTS, np.int32)
    positions = np.zeros(N, np.int32)
    tokens[:8] = rng.integers(0, vocab, 8)
    slots[:8] = [0, 1] + [2] * 6
    positions[:8] = [12, 28] + list(range(21, 27))
    cu = np.asarray([0, 1, 2, 8, 8, 8, 8, 8, 8], np.int32)
    kv = np.asarray(ctx + [0] * 5, np.int32)
    seg_slots = np.asarray([0, 1, 2] + [N_SLOTS] * 5, np.int32)
    return dict(bt=bt, tokens=tokens, slots=slots, positions=positions, cu=cu, kv=kv,
                seg_slots=seg_slots, n_real=8, qb=8)


def paged_step(arch, fault=None, **over):
    """(port logits, JAX logits) of one paged packed step of real rows; with
    ``fault`` the port's side runs broken. Also checks every real page the
    step wrote, where nothing is broken."""
    jmodel, jparams, model, params, _ = models(arch, **over)
    rng = np.random.default_rng(1)
    c = _paged_inputs(rng, model.cfg.vocab_size)
    pool = _init_page_pool(jmodel, N_SLOTS * PPS + 1, PAGE, jnp.float32)
    pool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pool)
    jlogits, jpool = jax_packed_step(
        jmodel, jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(c["tokens"]),
        jnp.asarray(c["slots"]), jnp.asarray(c["positions"]),
        paged=JaxPagedView(jnp.asarray(c["bt"]), PAGE, use_kernel=False,
                           cu_q_lens=jnp.asarray(c["cu"]), kv_lens=jnp.asarray(c["kv"]),
                           seg_slots=jnp.asarray(c["seg_slots"]), q_block=c["qb"]))
    if fault:
        model, params = _faulty(arch, fault, model, params)
    cfg = model.cfg
    tpool = caches_from_jax(pool, cfg)
    t = torch.from_numpy
    paged = PagedView(t(c["bt"]), PAGE, cu_q_lens=t(c["cu"]), kv_lens=t(c["kv"]),
                      seg_slots=t(c["seg_slots"]))
    logits, _ = packed_step(model, params, tpool, t(c["tokens"]), t(c["slots"]),
                            t(c["positions"]), paged)
    n = c["n_real"]
    if not fault:
        expect = caches_from_jax(jax.tree.map(np.asarray, jpool), cfg)
        scratch = N_SLOTS * PPS
        for layer, (got_l, exp_l) in enumerate(zip(tpool, expect)):
            for kind in ("k", "v"):
                np.testing.assert_allclose(got_l[kind][:scratch].numpy(),
                                           exp_l[kind][:scratch].numpy(), **TOL,
                                           err_msg=f"{arch} layer {layer} {kind}")
    return logits[:n].numpy(), np.asarray(jlogits)[:n]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_packed_step_matches_jax(arch):
    got, expect = paged_step(arch)
    np.testing.assert_allclose(got, expect, **TOL)


def test_gemma2_published_softcaps_match_jax():
    got, expect = paged_step("gemma2-2b", attn_logit_softcap=50.0, final_logit_softcap=30.0)
    np.testing.assert_allclose(got, expect, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_packed_step_with_row_tiles_matches_jax(arch):
    """Decode rows of slots 0 and 1, then slot 2's rows at positions 15..23
    as one chunk: the engine's row tiles cut it in tiles of ``64 // G`` rows
    (one of 9 at G 2 and 6, two of 4 and one of 1 at G 16, one of 8 and one
    of 1 at G 8), which the CPU's plain version ignores."""
    jmodel, jparams, model, params, _ = models(arch, seed=1)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    slots = np.asarray([0, 1] + [2] * 9, np.int32)
    positions = np.asarray([12, 28] + list(range(15, 24)), np.int32)
    tokens = rng.integers(0, cfg.vocab_size, len(slots)).astype(np.int32)
    G = cfg.n_heads // cfg.n_kv_heads
    tiles = row_tiles(slots[:, None], positions + 1, G)
    qt = q_tile_rows(G)
    assert tiles.tolist() == [[0, 1], [1, 1]] + [[2 + r, min(qt, 9 - r)]
                                                 for r in range(0, 9, qt)]
    cache = jmodel.init_cache(N_SLOTS + 1, MAX_LEN, jnp.float32)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), cache)
    jlogits, jcache = jax_packed_step(jmodel, jparams, jax.tree.map(jnp.asarray, cache),
                                      jnp.asarray(tokens), jnp.asarray(slots),
                                      jnp.asarray(positions))
    tcache = caches_from_jax(cache, cfg)
    t = torch.from_numpy
    logits, _ = packed_step(model, params, tcache, t(tokens), t(slots), t(positions),
                            DenseView(t(slots), t(positions), tiles=t(tiles)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    expect = caches_from_jax(jax.tree.map(np.asarray, jcache), cfg)
    for layer, (got_l, exp_l) in enumerate(zip(tcache, expect)):
        for kind in ("k", "v"):
            np.testing.assert_allclose(got_l[kind][:N_SLOTS].numpy(),
                                       exp_l[kind][:N_SLOTS].numpy(), **TOL,
                                       err_msg=f"layer {layer} {kind}")


@pytest.mark.parametrize("arch,fault", FAULTS)
def test_packed_step_fault_is_rejected(arch, fault):
    """Each feature's fault, on the port's side only, moves the packed
    step's logits well past the tolerance that the right port meets."""
    got, expect = paged_step(arch, fault=fault)
    assert np.abs(got - expect).max() > FAULT_MARGIN * (TOL["atol"] + TOL["rtol"]
                                                        * np.abs(expect).max())


# ---------------------------------------------------------------------------
# the serial path
# ---------------------------------------------------------------------------

B = 2
# (kind, T, index): a prefill from 0 past the window, a chunk at a scalar
# offset, one at per-row offsets, decode at a scalar and per-row offsets
STEPS = [("prefill", 20, 0), ("prefill", 5, 20), ("prefill", 3, [25, 22]),
         ("decode", 1, 28), ("decode", 1, [29, 26])]


def serial_logits(arch, fault=None):
    """(port, JAX) logits of ``forward`` on a 40-token batch, then of each
    of ``STEPS`` over a dense cache; the caches are checked where nothing
    is broken."""
    jmodel, jparams, model, params, _ = models(arch, seed=2)
    if fault:
        model, params = _faulty(arch, fault, model, params)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, 40)).astype(np.int32)
    jl, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got = [model.forward(params, {"tokens": torch.from_numpy(tokens)}).numpy()]
    want = [np.asarray(jl)]
    jcache = jmodel.init_cache(B, MAX_LEN, jnp.float32)
    cache = model.init_cache(B, MAX_LEN)
    for kind, T, index in STEPS:
        tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jindex = jnp.asarray(index, jnp.int32)
        tindex = index if isinstance(index, int) else torch.tensor(index, dtype=torch.int32)
        if kind == "prefill":
            jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache, jindex)
            tl, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache, tindex)
        else:
            jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), jcache, jindex)
            tl, _ = model.decode_step(params, torch.from_numpy(tokens), cache, tindex)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
        if not fault:
            expect = caches_from_jax(jax.tree.map(np.asarray, jcache), cfg)
            for layer, (got_l, exp_l) in enumerate(zip(cache, expect)):
                for kv in ("k", "v"):
                    np.testing.assert_allclose(got_l[kv].numpy(), exp_l[kv].numpy(), **TOL,
                                               err_msg=f"{kind} {index} layer {layer} {kv}")
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_serial_forward_prefill_and_decode_match_jax(arch):
    got, want = serial_logits(arch)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{arch} call {i}")


@pytest.mark.parametrize("arch,fault", FAULTS)
def test_serial_fault_is_rejected(arch, fault):
    got, want = serial_logits(arch, fault)
    moved = max(np.abs(g - w).max() / (TOL["atol"] + TOL["rtol"] * np.abs(w).max())
                for g, w in zip(got, want))
    assert moved > FAULT_MARGIN


# ---------------------------------------------------------------------------
# the launcher's depth cut
# ---------------------------------------------------------------------------


def test_depth_cut_keeps_the_published_widths():
    """``launch.serve.depth_cut``: llama3.1-70b at 32 of its 80 layers keeps
    every width (heads, KV heads, head_dim, d_ff, vocab) and its layer
    specs; gemma2-2b's cut keeps its local/global alternation; a depth
    outside 1..n_layers is refused."""
    from repro_torch.launch.serve import depth_cut

    full = t_get_config("llama3.1-70b")
    cut = depth_cut(full, 32)
    assert cut.n_layers == len(cut.layer_specs) == 32
    for field in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size"):
        assert getattr(cut, field) == getattr(full, field)
    gemma = depth_cut(t_get_config("gemma2-2b"), 4)
    assert [s.attn_kind for s in gemma.layer_specs] == ["local", "full"] * 2
    for bad in (0, 81):
        with pytest.raises(ValueError):
            depth_cut(full, bad)
