"""Plain version of the port's mixed-batch paged attention against the JAX
package: its oracle and its Pallas kernel in interpret mode.

The random-mix axes are those of ``test_paged_attention.py``'s property test
(decode rows, prefill chunks, zero-width segments, padding rows, shuffled
tables, corrupted dead pages, window, softcap, GQA), drawn from numpy seeds.
fp32 throughout; rtol = atol = 2e-5 (the two sides sum in different orders).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def mixed_case(seed, *, window=None, softcap=None, page=8, d=32, dead_fill=999.0):
    """A random mixed batch over a shuffled page pool whose dead pages (and
    the dead tail of each last live page) hold ``dead_fill``."""
    rng = np.random.default_rng(seed)
    KV = int(rng.choice([1, 2]))
    G = int(rng.choice([1, 2, 4]))
    segs = []  # (q_len, kv_len)
    for _ in range(int(rng.integers(1, 5))):
        kind = rng.choice(["decode", "chunk", "chunk", "dead"])
        if kind == "decode":
            segs.append((1, int(rng.integers(1, 41))))
        elif kind == "chunk":
            q_len = int(rng.integers(2, 7))
            segs.append((q_len, int(rng.integers(q_len, 41))))
        else:
            segs.append((0, 0))
    pad = int(rng.integers(0, 4))
    live = [-(-kv // page) for _, kv in segs]
    nb = max(max(live) + 1, 2)
    P = sum(live) + 4
    ids = rng.permutation(P)
    dead = ids[sum(live):]
    tables = np.asarray(rng.choice(dead, size=(len(segs), nb)), np.int32)
    pool_k = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_k[dead] = dead_fill
    pool_v[dead] = -dead_fill
    off = 0
    for s, ((_, kv), n) in enumerate(zip(segs, live)):
        tables[s, :n] = ids[off:off + n]
        off += n
        if n:  # the unwritten tail of the last live page is dead too
            pool_k[tables[s, n - 1], kv - (n - 1) * page:] = dead_fill
            pool_v[tables[s, n - 1], kv - (n - 1) * page:] = -dead_fill
    n_real = sum(q for q, _ in segs)
    q = rng.standard_normal((n_real + pad, KV, G, d)).astype(np.float32)
    cu = np.zeros((len(segs) + 1,), np.int32)
    cu[1:] = np.cumsum([q_len for q_len, _ in segs])
    kv_lens = np.asarray([kv for _, kv in segs], np.int32)
    qb = 1
    while qb < max(q_len for q_len, _ in segs):
        qb *= 2
    return dict(q=q, pool_k=pool_k, pool_v=pool_v, cu=cu, kv_lens=kv_lens, tables=tables,
                window=window, softcap=softcap, n_real=n_real, qb=qb)


def torch_mixed(c, **kw):
    t = torch.from_numpy
    return pa.mixed_paged_attention(
        t(c["q"]), t(c["pool_k"]), t(c["pool_v"]), t(c["cu"]), t(c["kv_lens"]),
        t(c["tables"]), window=c["window"], softcap=c["softcap"], **kw).numpy()


def jax_mixed(c, **kw):
    N, KV, G, d = c["q"].shape
    got = ops.mixed_attention_rows(
        jnp.asarray(c["q"].reshape(N, KV * G, d)), jnp.asarray(c["pool_k"]),
        jnp.asarray(c["pool_v"]), jnp.asarray(c["cu"]), jnp.asarray(c["kv_lens"]),
        jnp.asarray(c["tables"]), qb=c["qb"], window=c["window"], softcap=c["softcap"], **kw)
    return np.asarray(got).reshape(N, KV, G, d)


CASES = [(seed, w, cap) for seed in range(6) for w, cap in
         [(None, None), (5, None), (None, 20.0), (16, 20.0)]]


@pytest.mark.parametrize("seed,window,softcap", CASES)
def test_mixed_plain_matches_jax_oracle(seed, window, softcap):
    c = mixed_case(seed, window=window, softcap=softcap)
    got = torch_mixed(c)
    expect = jax_mixed(c, use_kernel=False)
    n = c["n_real"]
    np.testing.assert_allclose(got[:n], expect[:n], **TOL)
    assert np.all(got[n:] == 0), "padding rows must come back zero"


@pytest.mark.parametrize("seed,window,softcap", CASES[::3])
def test_mixed_plain_matches_pallas_interpret(seed, window, softcap):
    c = mixed_case(seed, window=window, softcap=softcap)
    n = c["n_real"]
    np.testing.assert_allclose(torch_mixed(c)[:n], jax_mixed(c, interpret=True)[:n], **TOL)


def test_mixed_plain_never_reads_nan_dead_pages():
    """NaN in dead pages, the scratch page and dead page tails changes
    nothing: the plain version zeroes dead keys instead of masking them."""
    for seed in range(6):
        clean = mixed_case(seed, window=5, softcap=20.0)
        poisoned = mixed_case(seed, window=5, softcap=20.0, dead_fill=np.nan)
        np.testing.assert_array_equal(torch_mixed(poisoned), torch_mixed(clean))


@pytest.mark.parametrize("window,softcap", [(None, None), (48, None), (None, 30.0)])
def test_paged_plain_matches_jax_oracle(window, softcap):
    rng = np.random.default_rng(7)
    N, KV, G, d, page, nb = 4, 2, 2, 32, 16, 5
    P = N * nb + 1
    q = rng.standard_normal((N, KV, G, d)).astype(np.float32)
    pool_k = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    tables = rng.permutation(P)[:N * nb].reshape(N, nb).astype(np.int32)
    lengths = np.asarray([1, 37, page, nb * page], np.int32)
    got = ref.paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(lengths), torch.from_numpy(tables), window=window, softcap=softcap)
    expect = jax_ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(lengths),
        jnp.asarray(tables), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("group", [1, 4, 8, 64])
def test_q_tiles_cover_every_real_row_once(group):
    cu = np.asarray([0, 1, 1, 40, 41, 41, 141, 141], np.int32)  # zero-width segments too
    tiles = pa.q_tiles(cu, group)
    qt = pa.q_tile_rows(group)
    assert qt * group <= pa.M_MAX
    covered = []
    for seg, row0 in tiles:
        assert cu[seg] <= row0 < cu[seg + 1]
        covered.extend(range(row0, min(row0 + qt, cu[seg + 1])))
    assert covered == list(range(cu[-1]))


def test_wrapper_checks_inputs():
    c = mixed_case(0)
    t = torch.from_numpy
    args = [t(c["q"]), t(c["pool_k"]), t(c["pool_v"]), t(c["cu"]), t(c["kv_lens"]),
            t(c["tables"])]
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].double()
    with pytest.raises(TypeError):
        pa.mixed_paged_attention(*bad_dtype)
    bad_index = list(args)
    bad_index[4] = bad_index[4].long()
    with pytest.raises(TypeError):
        pa.mixed_paged_attention(*bad_index)
    bad_shape = list(args)
    bad_shape[3] = bad_shape[3][:-1]
    with pytest.raises(ValueError):
        pa.mixed_paged_attention(*bad_shape)
    with pytest.raises(ValueError):
        pa.q_tile_rows(65)
    before = pa.mixed_paged_attention.launches
    pa.mixed_paged_attention(*args)  # CPU tensors: the plain version, no launch
    assert pa.mixed_paged_attention.launches == before
