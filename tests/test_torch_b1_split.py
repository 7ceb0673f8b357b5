"""B1's split over keys, on the CPU.

The plain split-and-combine version (``ref.mixed_split_ref``: each CTA's
keys cut into spans, each span's partial (O, m, l), then the rescaled sum)
against ``mixed_attention_ref`` and against the JAX package's Pallas
``mixed_paged_attention`` in interpret mode: one to five splits, rows that
see no key of a split, a window left of whole splits, softcap, page 1,
zero-width segments. Then the split the wrapper hands the kernel
(``key_splits``) and the plain version of the kernel's plan pass
(``ref.mixed_split_plan``, which ``chip_smoke.py`` holds the card's plan
to) against the split's rules, and the wrapper's CPU path. Inputs from
fixed numpy seeds; fp32 throughout; rtol = atol = 2e-5 (the two sides sum
in different orders).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def split_case(seed, segs, *, KV=2, G=2, d=16, page=8, window=None, softcap=None,
               dead_fill=float("nan"), pad=3):
    """``segs`` (q_len, kv_len) over a shuffled page pool whose dead pages,
    and the dead tail of each last live page, hold ``dead_fill``."""
    rng = np.random.default_rng(seed)
    live = [-(-kv // page) for _, kv in segs]
    nb = max(max(live), 1) + 1
    P = sum(live) + 3
    ids = rng.permutation(P)
    dead = ids[sum(live):]
    tables = np.asarray(rng.choice(dead, size=(len(segs), nb)), np.int32)
    pool_k = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, KV, d)).astype(np.float32)
    pool_k[dead] = dead_fill
    pool_v[dead] = dead_fill
    off = 0
    for s, ((_, kv), n) in enumerate(zip(segs, live)):
        tables[s, :n] = ids[off:off + n]
        off += n
        if n:
            pool_k[tables[s, n - 1], kv - (n - 1) * page:] = dead_fill
            pool_v[tables[s, n - 1], kv - (n - 1) * page:] = dead_fill
    n_real = sum(q for q, _ in segs)
    cu = np.zeros(len(segs) + 1, np.int32)
    cu[1:] = np.cumsum([q for q, _ in segs])
    t = torch.from_numpy
    return dict(q=t(rng.standard_normal((n_real + pad, KV, G, d)).astype(np.float32)),
                k=t(pool_k), v=t(pool_v), cu=t(cu),
                kv_lens=t(np.asarray([kv for _, kv in segs], np.int32)), tables=t(tables),
                window=window, softcap=softcap, n_real=n_real, segs=segs)


def args(c):
    return c["q"], c["k"], c["v"], c["cu"], c["kv_lens"], c["tables"]


# (name, segs, case options, CTA rows, span_keys): span_keys is small here so
# that rows of at most 300 keys split as a long row does on the card
CASES = [
    # decode rows of 1 to 5 spans of 64 keys
    ("one_to_five_splits", [(1, 64), (1, 128), (1, 192), (1, 256), (1, 300)], {}, 4, 64),
    # chunks whose early rows see no key of their CTA's later spans
    ("chunks_beside_decodes", [(1, 37), (20, 150), (1, 300), (7, 7)], {}, 8, 16),
    # a window left of whole spans: keys below it are never a split's
    ("window_left_of_splits", [(1, 300), (30, 280), (1, 9)], dict(window=40), 8, 8),
    ("softcap", [(1, 250), (12, 200)], dict(softcap=3.0), 4, 32),
    ("window_softcap", [(1, 290), (25, 260)], dict(window=100, softcap=5.0), 16, 4),
    ("page1", [(1, 300), (9, 120), (1, 1)], dict(page=1), 4, 40),
    ("zero_width_segments", [(0, 0), (1, 200), (0, 0), (17, 170), (0, 0)], {}, 8, 24),
    ("gqa_g8_d32", [(1, 280), (10, 90)], dict(KV=1, G=8, d=32), 8, 64),
    ("one_span_each", [(1, 50), (30, 60)], {}, 64, 256),
    # spans of 16 keys over a 16-row CTA at positions 100..115: its last
    # span, keys 112..115, holds no key rows 0..11 may see
    ("rows_with_empty_splits", [(16, 116), (1, 40)], {}, 16, 1),
]


@pytest.mark.parametrize("name,segs,opts,cta_rows,span_keys", CASES, ids=[c[0] for c in CASES])
def test_split_ref_matches_mixed_ref(name, segs, opts, cta_rows, span_keys):
    """NaN fills every dead key: a split that read one would show it."""
    c = split_case(len(name), segs, **opts)
    kw = dict(window=c["window"], softcap=c["softcap"])
    got = ref.mixed_split_ref(*args(c), cta_rows=cta_rows, span_keys=span_keys, **kw)
    expect = ref.mixed_attention_ref(*args(c), **kw)
    n = c["n_real"]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:n].numpy(), expect[:n].numpy(), **TOL)
    assert torch.all(got[n:] == 0), "padding rows must come back zero"


def jax_mixed(c):
    N, KV, G, d = c["q"].shape
    qb = 1
    while qb < max(q for q, _ in c["segs"]):
        qb *= 2
    got = ops.mixed_attention_rows(
        jnp.asarray(c["q"].numpy().reshape(N, KV * G, d)), jnp.asarray(c["k"].numpy()),
        jnp.asarray(c["v"].numpy()), jnp.asarray(c["cu"].numpy()),
        jnp.asarray(c["kv_lens"].numpy()), jnp.asarray(c["tables"].numpy()), qb=qb,
        window=c["window"], softcap=c["softcap"], interpret=True)
    return np.asarray(got).reshape(N, KV, G, d)


@pytest.mark.parametrize("name,segs,opts,cta_rows,span_keys",
                         [CASES[i] for i in (0, 2, 3, 5, 6)], ids=lambda v: v
                         if isinstance(v, str) else None)
def test_split_ref_matches_pallas_interpret(name, segs, opts, cta_rows, span_keys):
    """The Pallas kernel reads dead keys and relies on finite garbage there
    (its oracle multiplies them by 0), so the dead fill is finite here."""
    c = split_case(len(name), segs, dead_fill=999.0, **opts)
    got = ref.mixed_split_ref(*args(c), cta_rows=cta_rows, span_keys=span_keys,
                              window=c["window"], softcap=c["softcap"])
    n = c["n_real"]
    np.testing.assert_allclose(got[:n].numpy(), jax_mixed(c)[:n], **TOL)


@pytest.mark.parametrize("name,segs,opts,cta_rows,span_keys", [CASES[0], CASES[1], CASES[5]],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_combine_without_rescaling_is_wrong(name, segs, opts, cta_rows, span_keys):
    """Summing the partials without their e^(m_s - M) weights changes the
    rows that span several splits by far more than the tolerance: the
    fault that chip_smoke.py's split cases must reject."""
    c = split_case(len(name), segs, **opts)
    kw = dict(cta_rows=cta_rows, span_keys=span_keys, window=c["window"],
              softcap=c["softcap"])
    right = ref.mixed_split_ref(*args(c), **kw)[:c["n_real"]]
    wrong = ref.mixed_split_ref(*args(c), rescale=False, **kw)[:c["n_real"]]
    assert float((right - wrong).abs().max()) > 1e3 * TOL["atol"]


def test_a_split_a_row_cannot_see_gives_it_no_weight():
    """Rows whose keys all lie left of a split get m = NEG_INF, l = 0 there,
    and the combine's e^(m_s - M) drops that split for them."""
    c = split_case(11, [(16, 116)])
    kw = dict(window=None, softcap=None)
    got = ref.mixed_split_ref(*args(c), cta_rows=16, span_keys=1, **kw)
    first = ref.mixed_split_ref(*args(c), cta_rows=16, span_keys=1 << 10, **kw)
    np.testing.assert_allclose(got.numpy(), first.numpy(), **TOL)


def test_one_split_is_the_unsplit_attention():
    c = split_case(5, [(1, 120), (40, 100)])
    kw = dict(window=None, softcap=None)
    whole = ref.mixed_split_ref(*args(c), cta_rows=64, span_keys=4096, **kw)
    np.testing.assert_allclose(whole.numpy(), ref.mixed_attention_ref(*args(c), **kw).numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# the split the wrapper hands the kernel
# ---------------------------------------------------------------------------


def test_key_splits_values():
    assert pa.key_splits(100) == (1, pa.SPLIT_KEYS)
    assert pa.key_splits(512) == (2, 256)  # engine_bf16's tables split decode rows
    assert pa.key_splits(8192) == (32, 256)  # the serving engine at max_len 8192
    assert pa.key_splits(32768) == (64, 512)  # decode16's longest row
    assert pa.key_splits(131072) == (64, 2048)  # Llama3.1's context


@pytest.mark.parametrize("capacity", [1, 63, 64, 255, 256, 257, 1000, 4096, 16384 + 16,
                                      65536 - 1, 131072, 1 << 20])
def test_key_splits_cover_the_capacity(capacity):
    n_split, span = pa.key_splits(capacity)
    assert span % 64 == 0 and span >= pa.SPLIT_KEYS
    assert 1 <= n_split <= pa.MAX_KEY_SPLITS
    assert (n_split - 1) * span < capacity <= n_split * span


def plan(cu, kv_lens, group, span, *, pair, window=None, kv=8, sms=132):
    """``ref.mixed_split_plan`` over ``q_tiles``, as the wrapper's bf16
    (``pair``) or fp32 launch plans it on a card of ``sms`` SMs."""
    return ref.mixed_split_plan(pa.q_tiles(cu, group), cu, kv_lens,
                                tile_rows=pa.q_tile_rows(group), group=group, span_keys=span,
                                pair=pair, light_max=16 if pair else 0, n_kv=kv, sms=sms,
                                window=window)[0]


STEPS = [
    # (cu_q_lens, kv_lens, G, capacity, window): a decode-only step, a mixed
    # step, decode16's mix, Gemma-2's windowed mix, zero-width segments
    ([0, 1, 2, 3, 4, 5, 6, 7, 8], [600, 900, 1200, 4600, 2000, 3100, 700, 1500], 4, 8192, None),
    ([0, 1, 2, 3, 515, 515], [1024, 2048, 4096, 4608, 0], 4, 8192, None),
    (list(range(17)), [int(x) for x in np.linspace(1024, 32768, 16)], 4, 32768, None),
    ([0, 1, 2, 302, 502], [1000, 8192, 7000, 3000], 2, 8192, 4096),
    ([0, 0, 1, 1, 65, 66], [0, 300, 0, 264, 1], 1, 512, None),
]


@pytest.mark.parametrize("cu,kv_lens,group,capacity,window", STEPS)
@pytest.mark.parametrize("pair,kv,sms", [(False, 8, 132), (True, 8, 132), (True, 1, 132),
                                         (True, 2, 1000)])
def test_plan_covers_every_live_key_once(cu, kv_lens, group, capacity, window, pair, kv, sms):
    """kv 1 and 2 leave the chunks' CTAs few enough to split."""
    cu, kv_lens = np.asarray(cu, np.int32), np.asarray(kv_lens, np.int32)
    n_split, span = pa.key_splits(capacity)
    ctas = plan(cu, kv_lens, group, span, pair=pair, window=window, kv=kv, sms=sms)
    rows = sorted(r for c in ctas for r in range(c["row0"], c["row0"] + c["nrow"]))
    assert rows == list(range(int(cu[-1])))  # every real row in one CTA
    for c in ctas:
        # no CTA crosses a segment; its spans tile its keys, in blocks of 64
        assert cu[c["seg"]] <= c["row0"] and c["row0"] + c["nrow"] <= cu[c["seg"] + 1]
        keys = [k for lo, hi in c["spans"] for k in range(lo, hi)]
        assert keys == list(range(c["k_lo"], c["k_hi"]))
        sizes = [hi - lo for lo, hi in c["spans"]]
        assert all(s == c["step"] and s % 64 == 0 for s in sizes[:-1])
        assert len(c["spans"]) <= n_split <= pa.MAX_KEY_SPLITS


def test_plan_of_a_decode_only_and_a_mixed_step():
    """A decode row of L keys runs as ceil(L / 256) CTAs; a 512-row chunk at
    G 4 as 16 pairs of tiles (32 rows), unsplit: 16 x 8 KV heads fill the
    card. Gemma-2's chunks at KV 4 (8 heavy pairs, 32 CTAs; the 200-row
    chunk's last pair, 8 rows at G 2, is light) split into spans of their
    keys' share of 132 SMs."""
    decode = plan(np.asarray(STEPS[0][0]), np.asarray(STEPS[0][1]), 4, 256, pair=True)
    assert [len(c["spans"]) for c in decode] == [3, 4, 5, 18, 8, 13, 3, 6]
    mixed = plan(np.asarray(STEPS[1][0]), np.asarray(STEPS[1][1]), 4, 256, pair=True)
    assert [len(c["spans"]) for c in mixed] == [4, 8, 16] + [1] * 16
    assert [c["nrow"] for c in mixed[3:]] == [32] * 16
    unpaired = plan(np.asarray(STEPS[1][0]), np.asarray(STEPS[1][1]), 4, 256, pair=False)
    assert [c["nrow"] for c in unpaired[3:]] == [16] * 32
    gemma = plan(np.asarray(STEPS[3][0]), np.asarray(STEPS[3][1]), 2, 256, pair=True,
                 window=4096, kv=4)
    heavy = [c for c in gemma if c["m_eff"] > 16]
    assert len(heavy) == 8 and {c["step"] for c in heavy} == {896}
    assert [len(c["spans"]) for c in heavy] == [5] * 5 + [4] * 3


def test_cpu_path_takes_no_split_and_counts_no_launch():
    c = split_case(9, [(1, 300), (33, 200), (0, 0)])
    before = pa.mixed_paged_attention.launches
    got = pa.mixed_paged_attention(*args(c))  # the CPU ignores tiles
    assert pa.mixed_paged_attention.launches == before
    np.testing.assert_array_equal(got.numpy(), ref.mixed_attention_ref(*args(c)).numpy())


@pytest.mark.parametrize("pair", [False, True])
def test_plan_kinds_follow_the_dtype(pair):
    """bf16 (``pair``) runs CTAs of at most 16 query vectors on the light
    producer; fp32 runs every CTA on its one producer (kind 1), with the
    decode rows' spans all the same."""
    cu, kv_lens = np.asarray(STEPS[1][0], np.int32), np.asarray(STEPS[1][1], np.int32)
    ctas = plan(cu, kv_lens, 4, 256, pair=pair)
    decode = [c for c in ctas if c["nrow"] == 1]
    assert [c["kind"] for c in decode] == [0 if pair else 1] * 3
    assert [c["step"] for c in decode] == [256] * 3
    assert all(c["kind"] == 1 for c in ctas if c["nrow"] > 1)
