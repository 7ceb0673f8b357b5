"""The port's ``packed_step`` against the JAX package's on reduced
llama3.1-8b (two layers, so the period-stacked bridge is exercised): same
weights (bridged from ``Model.init``), same page pool (or dense slot
cache), same step metadata. Logits of the real rows and every non-scratch
page (slot) of the updated caches must agree at 1e-4 in fp32. The dense
step carries B2's row tiles as the engine builds them, over a step that
holds two chunks of one slot back to back beside decode rows."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core.packed_step import PagedView as JaxPagedView  # noqa: E402
from repro.core.packed_step import packed_step as jax_packed_step  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import _init_page_pool  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402
from repro_torch.core.packed_step import DenseView, PagedView, packed_step  # noqa: E402
from repro_torch.kernels.paged_attention import row_tiles  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.weights import from_jax_params, caches_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE, N_SLOTS, PPS = 4, 3, 8  # page size, decode slots, pages per slot


def _step_inputs(rng, vocab):
    """Two decode rows (slots 0, 1) + one 6-token prefill chunk (slot 2)
    mid-prompt, padded to 12 rows and 8 segments; shuffled physical pages."""
    P = N_SLOTS * PPS
    perm = rng.permutation(P).astype(np.int32)
    bt = np.full((N_SLOTS + 1, PPS), P, np.int32)  # scratch page = P
    ctx = [13, 29, 11]  # keys each slot holds after this step
    for s in range(N_SLOTS):
        n = -(-ctx[s] // PAGE)
        bt[s, :n] = perm[s * PPS:s * PPS + n]
    N = 12
    tokens = np.zeros(N, np.int32)
    slots = np.full(N, N_SLOTS, np.int32)
    positions = np.zeros(N, np.int32)
    tokens[:8] = rng.integers(0, vocab, 8)
    slots[:8] = [0, 1] + [2] * 6
    positions[:8] = [12, 28] + list(range(5, 11))
    cu = np.asarray([0, 1, 2, 8, 8, 8, 8, 8, 8], np.int32)
    kv = np.asarray([13, 29, 11, 0, 0, 0, 0, 0], np.int32)
    seg_slots = np.asarray([0, 1, 2] + [N_SLOTS] * 5, np.int32)
    return dict(bt=bt, tokens=tokens, slots=slots, positions=positions, cu=cu, kv=kv,
                seg_slots=seg_slots, n_real=8, qb=8)


def test_packed_step_matches_jax():
    cfg_j = reduce_config(get_config("llama3.1-8b"), periods=2)
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"), periods=2)
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    c = _step_inputs(rng, cfg_j.vocab_size)

    # a pool full of (random) earlier KV, identical on both sides
    pool = _init_page_pool(jmodel, N_SLOTS * PPS + 1, PAGE, jnp.float32)
    pool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pool)

    jlogits, jpool = jax_packed_step(
        jmodel, jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(c["tokens"]),
        jnp.asarray(c["slots"]), jnp.asarray(c["positions"]),
        paged=JaxPagedView(jnp.asarray(c["bt"]), PAGE, use_kernel=False,
                           cu_q_lens=jnp.asarray(c["cu"]), kv_lens=jnp.asarray(c["kv"]),
                           seg_slots=jnp.asarray(c["seg_slots"]), q_block=c["qb"]))

    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg_t)
    tpool = caches_from_jax(pool, cfg_t)
    t = torch.from_numpy
    paged = PagedView(t(c["bt"]), PAGE, cu_q_lens=t(c["cu"]), kv_lens=t(c["kv"]),
                      seg_slots=t(c["seg_slots"]))
    logits, tpool_out = packed_step(model, params, tpool, t(c["tokens"]), t(c["slots"]),
                                    t(c["positions"]), paged)
    assert tpool_out is tpool  # updated in place

    n = c["n_real"]
    assert logits.shape == (12, cfg_t.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits[:n].numpy(), np.asarray(jlogits)[:n], **TOL)
    # padding rows attend differently on the two sides (zeros vs clamped
    # garbage), so from the second layer on their K/V in the scratch page
    # differ; every real page must match
    expect = caches_from_jax(jax.tree.map(np.asarray, jpool), cfg_t)
    scratch = N_SLOTS * PPS
    for layer, (got_l, exp_l) in enumerate(zip(tpool, expect)):
        for kind in ("k", "v"):
            np.testing.assert_allclose(got_l[kind][:scratch].numpy(),
                                       exp_l[kind][:scratch].numpy(), **TOL,
                                       err_msg=f"layer {layer} {kind}")
    # the step really wrote: the decode rows' new keys differ from the old pool
    old = caches_from_jax(pool, cfg_t)
    page, off = c["bt"][0, 12 // PAGE], 12 % PAGE
    assert not np.allclose(tpool[0]["k"][page, off].numpy(), old[0]["k"][page, off].numpy())


def test_dense_packed_step_with_row_tiles_matches_jax():
    """Decode rows of slots 0 and 1, then slot 2's rows at positions 5..8
    and 9..13 as two chunks back to back: the engine's row tiles run the
    two chunks on as one tile of 9 rows; the CPU's plain version reads each
    row alone, and both match JAX's dense step."""
    cfg_j = reduce_config(get_config("llama3.1-8b"), periods=2)
    cfg_t = t_reduce_config(t_get_config("llama3.1-8b"), periods=2)
    jmodel = jax_build_model(cfg_j)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    max_len = 32
    slots = np.asarray([0, 1] + [2] * 9, np.int32)
    positions = np.asarray([12, 28] + list(range(5, 14)), np.int32)
    tokens = rng.integers(0, cfg_j.vocab_size, len(slots)).astype(np.int32)
    G = cfg_t.n_heads // cfg_t.n_kv_heads
    tiles = row_tiles(slots[:, None], positions + 1, G)
    assert tiles.tolist() == [[0, 1], [1, 1], [2, 9]]

    cache = jmodel.init_cache(N_SLOTS + 1, max_len, jnp.float32)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), cache)
    jlogits, jcache = jax_packed_step(jmodel, jparams, jax.tree.map(jnp.asarray, cache),
                                      jnp.asarray(tokens), jnp.asarray(slots),
                                      jnp.asarray(positions))

    model = build_model(cfg_t, dtype=torch.float32, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg_t)
    tcache = caches_from_jax(cache, cfg_t)
    t = torch.from_numpy
    view = DenseView(t(slots), t(positions), tiles=t(tiles))
    logits, tcache_out = packed_step(model, params, tcache, t(tokens), t(slots), t(positions),
                                     view)
    assert tcache_out is tcache  # updated in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    expect = caches_from_jax(jax.tree.map(np.asarray, jcache), cfg_t)
    for layer, (got_l, exp_l) in enumerate(zip(tcache, expect)):
        for kind in ("k", "v"):
            np.testing.assert_allclose(got_l[kind][:N_SLOTS].numpy(),
                                       exp_l[kind][:N_SLOTS].numpy(), **TOL,
                                       err_msg=f"layer {layer} {kind}")
