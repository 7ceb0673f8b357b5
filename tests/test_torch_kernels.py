"""Plain versions of the port's kernels against the JAX package: its oracles
and its Pallas kernels in interpret mode.

B1 (mixed paged): the random-mix axes of ``test_paged_attention.py``'s
property test (decode rows, prefill chunks, zero-width segments, padding
rows, shuffled tables, corrupted dead pages, window, softcap, GQA), drawn
from numpy seeds. B2 (paged), B3 (decode) and B4 (flash): window, softcap,
lengths of 1 and of the whole cache, NaN in every dead key, through the
port's ``kernels.ops`` wrappers in the model layouts. fp32 throughout;
rtol = atol = 2e-5 (the two sides sum in different orders).

B5 (SSD chunk scan): ``ops.ssd`` against JAX's ``ops.ssd`` in interpret mode
(chunk 64, the port kernel's) and against the sequential ``ssd_ref``, with
ragged S, with and without h0, two groups, and Mamba2-2.7B's own decay rates
with dt at 0.1 (where the masked triangle's exponent overflows); and the
chunked-prefill handoff over fixed seeds. fp32; rtol = atol = 1e-4 against
the sequential oracle and 2e-5 against the chunked kernel, which sums in the
same order.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as t_ssd  # noqa: E402

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


# ---------------------------------------------------------------------------
# B4 flash, B3 decode, B2 paged
# ---------------------------------------------------------------------------

WINDOW_CAP = [(None, None), (7, None), (None, 20.0), (5, 20.0)]


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
@pytest.mark.parametrize("S", [1, 40])
def test_flash_plain_matches_jax(S, window, softcap):
    """B=2, H=4 over KV=2 (GQA), d=32; S=40 is no multiple of the Pallas
    block (16), so the JAX wrapper pads where the port does not."""
    q, k, v = _np(1, (2, S, 4, 32)), _np(2, (2, S, 2, 32)), _np(3, (2, S, 2, 32))
    t = torch.from_numpy
    got = t_ops.flash_attention_bshd(t(q), t(k), t(v), window=window, softcap=softcap).numpy()
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    oracle = jax_ref.flash_attention_ref(tr(q), tr(k), tr(v), window=window, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(oracle.transpose(0, 2, 1, 3)), **TOL)
    pallas = ops.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=window, softcap=softcap, interpret=True,
                                      block_q=16, block_k=16)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_flash_plain_full_attention_matches_jax():
    q, k, v = _np(4, (1, 24, 2, 16)), _np(5, (1, 24, 2, 16)), _np(6, (1, 24, 2, 16))
    t = torch.from_numpy
    got = fa.flash_attention(t(q), t(k), t(v), causal=False).numpy()
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    expect = jax_ref.flash_attention_ref(tr(q), tr(k), tr(v), causal=False)
    np.testing.assert_allclose(got, np.asarray(expect.transpose(0, 2, 1, 3)), **TOL)


def test_flash_plain_reads_strided_cache_prefix():
    """The prompt over itself, read as a prefix view of a larger cache whose
    unwritten tail is NaN: the same as the contiguous keys."""
    q, k, v = _np(7, (2, 9, 4, 16)), _np(8, (2, 9, 2, 16)), _np(9, (2, 9, 2, 16))
    kc = np.full((2, 32, 2, 16), np.nan, np.float32)
    vc = kc.copy()
    kc[:, :9], vc[:, :9] = k, v
    t = torch.from_numpy
    view_k, view_v = t(kc)[:, :9], t(vc)[:, :9]
    assert not view_k.is_contiguous()
    np.testing.assert_array_equal(fa.flash_attention(t(q), view_k, view_v).numpy(),
                                  fa.flash_attention(t(q), t(k), t(v)).numpy())


def _decode_case(seed, dead_fill):
    """B=4 rows of a 48-token cache, lengths 1 .. S, dead tail = dead_fill."""
    B, S, KV, G, d = 4, 48, 2, 2, 32
    q = _np(seed, (B, 1, KV * G, d))
    k, v = _np(seed + 1, (B, S, KV, d)), _np(seed + 2, (B, S, KV, d))
    lengths = np.asarray([1, 17, 33, S], np.int32)
    for b, n in enumerate(lengths):
        k[b, n:], v[b, n:] = dead_fill, -dead_fill
    return q, k, v, lengths


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
def test_decode_plain_matches_jax(window, softcap):
    q, k, v, lengths = _decode_case(10, 999.0)
    t = torch.from_numpy
    got = t_ops.decode_attention_bhd(t(q), t(k), t(v), t(lengths), window=window,
                                     softcap=softcap).numpy()
    B, _, H, d = q.shape
    KV = k.shape[2]
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    oracle = jax_ref.decode_attention_ref(jnp.asarray(q[:, 0].reshape(B, KV, H // KV, d)),
                                          tr(k), tr(v), jnp.asarray(lengths), window=window,
                                          softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(oracle).reshape(B, 1, H, d), **TOL)
    pallas = ops.decode_attention_bhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lengths), window=window, softcap=softcap,
                                      interpret=True, block_k=16)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_decode_plain_never_reads_nan_dead_keys():
    t = torch.from_numpy
    clean = _decode_case(20, 999.0)
    poisoned = _decode_case(20, np.nan)
    for window, softcap in WINDOW_CAP:
        a = t_ops.decode_attention_bhd(*map(t, clean), window=window, softcap=softcap)
        b = t_ops.decode_attention_bhd(*map(t, poisoned), window=window, softcap=softcap)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _paged_case(seed, page, dead_fill):
    """N=4 rows of lengths 1 .. nb * page over a shuffled pool whose dead
    pages and dead page tails hold dead_fill."""
    rng = np.random.default_rng(seed)
    N, KV, G, d, nb = 4, 2, 2, 32, 5
    P = N * nb + 3
    q = rng.standard_normal((N, KV * G, d)).astype(np.float32)
    pool_k = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    lengths = np.asarray([1, page + 3, 3 * page, nb * page], np.int32)
    ids = rng.permutation(P)
    tables = ids[:N * nb].reshape(N, nb).astype(np.int32)
    live = np.zeros((P, page), bool)
    for n, L in enumerate(lengths):
        for j in range(L):
            live[tables[n, j // page], j % page] = True
    pool_k[~live], pool_v[~live] = dead_fill, -dead_fill
    return q, pool_k, pool_v, lengths, tables


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
@pytest.mark.parametrize("page", [1, 8])
def test_paged_rows_plain_matches_jax(page, window, softcap):
    q, pk, pv, lengths, tables = _paged_case(30, page, 999.0)
    t = torch.from_numpy
    got = t_ops.paged_attention_rows(t(q), t(pk), t(pv), t(lengths), t(tables), window=window,
                                     softcap=softcap).numpy()
    j = [jnp.asarray(a) for a in (q, pk, pv, lengths, tables)]
    expect = ops.paged_attention_rows(*j, window=window, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(expect), **TOL)
    pallas = ops.paged_attention_rows(*j, window=window, softcap=softcap, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_paged_plain_never_reads_nan_dead_pages():
    t = torch.from_numpy
    for page in (1, 8):
        clean = _paged_case(40, page, 999.0)
        poisoned = _paged_case(40, page, np.nan)
        for window, softcap in WINDOW_CAP:
            a = t_ops.paged_attention_rows(*map(t, clean), window=window, softcap=softcap)
            b = t_ops.paged_attention_rows(*map(t, poisoned), window=window, softcap=softcap)
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dense_cache_as_one_page_matches_decode():
    """The dense engine's call: B2 over a (slots, max_len) cache as pages of
    max_len tokens with table slots[:, None] computes B3 on those rows."""
    q, k, v, lengths = _decode_case(50, np.nan)
    t = torch.from_numpy
    B, _, H, d = q.shape
    KV = k.shape[2]
    slots = np.asarray([[2], [0], [3], [1]], np.int32)
    perm = slots[:, 0]
    qg = t(q).reshape(B, KV, H // KV, d)
    got = pa.paged_attention(qg, t(k), t(v), t(lengths[perm]), t(slots))
    expect = da.decode_attention(qg, t(k[perm]), t(v[perm]), t(lengths[perm]))
    np.testing.assert_array_equal(got.numpy(), expect.numpy())


def test_split_count_fills_the_card_without_short_splits():
    assert da.split_count(8, 8192) == 32  # serial decode: 8 (row, head) pairs
    assert da.split_count(8, 600) == 3  # no split below 256 keys of capacity
    assert da.split_count(520 * 8, 8192) == 1  # a prefill chunk's rows fill the card
    assert da.split_count(64, 8192) == 5


def test_new_wrappers_check_inputs_and_never_count_cpu_calls():
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_case(60, 0.0))
    B, _, H, d = q.shape
    qg = q.reshape(B, 2, H // 2, d)
    before = (da.decode_attention.launches, pa.paged_attention.launches,
              fa.flash_attention.launches)
    with pytest.raises(ValueError):
        da.decode_attention(qg, k, v, lengths.long())  # lengths must be int32
    with pytest.raises(ValueError):
        da.decode_attention(qg, k[:, :, :1], v[:, :, :1], lengths)  # KV heads differ
    with pytest.raises(TypeError):
        da.decode_attention(qg, k.double(), v.double(), lengths)
    with pytest.raises(ValueError):
        pa.paged_attention(qg, k, v, lengths, torch.zeros((B, 1), dtype=torch.int64))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[:, :3])
    da.decode_attention(qg, k, v, lengths)
    pa.paged_attention(qg, k, v, lengths, torch.arange(B, dtype=torch.int32)[:, None])
    fa.flash_attention(q.expand(B, 4, H, d).contiguous(), k[:, :4], v[:, :4])
    assert (da.decode_attention.launches, pa.paged_attention.launches,
            fa.flash_attention.launches) == before


# ---------------------------------------------------------------------------
# B5: SSD chunk scan
# ---------------------------------------------------------------------------


def ssd_inputs(seed, B, S, nh, hd, G, ds, *, h0=True, mamba_decay=False):
    """numpy inputs of one SSD call. ``mamba_decay``: Mamba2-2.7B's decay
    rates A = -(1..nh) with dt = 0.1, the top of its init range (the
    strongest head's log-decay falls by 0.1 nh a token)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    if mamba_decay:
        A = -np.arange(1, nh + 1, dtype=np.float32)
        dt = np.full((B, S, nh), 0.1, np.float32)
    else:
        A = -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, G, ds))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, G, ds))).astype(np.float32)
    h = rng.standard_normal((B, nh, hd, ds)).astype(np.float32) if h0 else None
    return x, dt, A, Bm, Cm, h


def _port_ssd(x, dt, A, Bm, Cm, h0):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y, hT = t_ops.ssd(t(x), t(dt), t(A), t(Bm), t(Cm), t(h0))
    return y.numpy(), hT.numpy()


def _jax(a):
    return None if a is None else jnp.asarray(a)


# (B, S, nh, hd, G, ds, h0): one chunk, ragged, several chunks, two groups
SSD_CASES = [
    (1, 64, 4, 16, 1, 16, False),
    (1, 100, 4, 16, 1, 16, True),
    (2, 200, 8, 8, 2, 16, True),
    (2, 77, 16, 8, 1, 16, False),
    (1, 300, 4, 32, 1, 32, True),
]


@pytest.mark.parametrize("B,S,nh,hd,G,ds,h0", SSD_CASES)
def test_ssd_plain_matches_pallas_interpret(B, S, nh, hd, G, ds, h0):
    x, dt, A, Bm, Cm, h = ssd_inputs(B * S + nh, B, S, nh, hd, G, ds, h0=h0)
    y, hT = _port_ssd(x, dt, A, Bm, Cm, h)
    jy, jh = ops.ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), h0=_jax(h), chunk=64,
                     interpret=True)
    assert y.shape == (B, S, nh, hd) and hT.shape == (B, nh, hd, ds)
    np.testing.assert_allclose(y, np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT, np.asarray(jh), **TOL)


@pytest.mark.parametrize("mamba_decay", [False, True], ids=["mixed_decay", "overflow"])
@pytest.mark.parametrize("B,S,nh,hd,G,ds,h0", SSD_CASES[1:4])
def test_ssd_plain_matches_sequential_ref(B, S, nh, hd, G, ds, h0, mamba_decay):
    x, dt, A, Bm, Cm, h = ssd_inputs(7 * S, B, S, nh, hd, G, ds, h0=h0, mamba_decay=mamba_decay)
    y, hT = _port_ssd(x, dt, A, Bm, Cm, h)
    jy, jh = jax_ref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), h0=_jax(h))
    assert np.isfinite(y).all() and np.isfinite(hT).all()
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hT, np.asarray(jh), rtol=1e-4, atol=1e-4)
    # the port's own sequential oracle is JAX's
    ty, th = ref.ssd_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                         None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_ssd_overflow_regime_stays_finite():
    """Mamba2-2.7B's 80 decay rates with dt = 0.1: above the diagonal the
    chunk's decay exponent reaches 0.1 * 80 * 63 = 504, exp of which is inf
    in fp32; the plain version never forms it."""
    x, dt, A, Bm, Cm, h = ssd_inputs(11, 1, 130, 80, 4, 1, 8, mamba_decay=True)
    cum = np.cumsum(dt[0, :64] * A, axis=0)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(np.float32(cum[0] - cum[-1]))).all()
    y, hT = _port_ssd(x, dt, A, Bm, Cm, h)
    jy, jh = ops.ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), h0=jnp.asarray(h),
                     chunk=64, interpret=True)
    assert np.isfinite(y).all() and np.isfinite(hT).all()
    np.testing.assert_allclose(y, np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT, np.asarray(jh), **TOL)


@pytest.mark.parametrize("seed,half", [(0, 64), (1, 17), (2, 100), (3, 127)])
def test_ssd_state_handoff(seed, half):
    """ssd(x[:half])'s final state fed as h0 to ssd(x[half:]) equals ssd(x):
    the chunked-prefill handoff (the property of ``test_kernels.py``'s
    ``test_ssd_state_handoff``, over fixed seeds and split points)."""
    x, dt, A, Bm, Cm, _ = ssd_inputs(100 + seed, 1, 128, 2, 16, 1, 8, h0=False)
    y, hT = _port_ssd(x, dt, A, Bm, Cm, None)
    first = [a[:, :half] for a in (x, dt)] + [A] + [a[:, :half] for a in (Bm, Cm)]
    rest = [a[:, half:] for a in (x, dt)] + [A] + [a[:, half:] for a in (Bm, Cm)]
    y1, h1 = _port_ssd(*first, None)
    y2, h2 = _port_ssd(*rest, h1)
    np.testing.assert_allclose(y1, y[:, :half], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y2, y[:, half:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h2, hT, rtol=1e-4, atol=1e-4)
    # and JAX's kernel hands over the same state
    jy, jh = ops.ssd(*(jnp.asarray(a) for a in first), chunk=32, interpret=True)
    np.testing.assert_allclose(h1, np.asarray(jh), rtol=1e-4, atol=1e-4)


def test_ssd_wrapper_checks_inputs_and_never_counts_cpu_calls():
    x, dt, A, Bm, Cm, h = (torch.from_numpy(a) for a in ssd_inputs(5, 1, 20, 4, 8, 2, 8))
    before = t_ssd.ssd_chunk_scan.launches
    with pytest.raises(ValueError):
        t_ssd.ssd_chunk_scan(x, dt[:, :3], A, Bm, Cm)  # dt covers 3 of 20 tokens
    with pytest.raises(ValueError):
        t_ssd.ssd_chunk_scan(x, dt, A, Bm[:, :, :1], Cm)  # B and C differ
    with pytest.raises(ValueError):
        t_ssd.ssd_chunk_scan(x[:, :, :3], dt[:, :, :3], A[:3], Bm, Cm)  # 3 heads, 2 groups
    with pytest.raises(ValueError):
        t_ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, h[:, :2])
    y, hT = t_ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, h)
    assert y.dtype == x.dtype and hT.dtype == torch.float32
    assert t_ssd.ssd_chunk_scan.launches == before
