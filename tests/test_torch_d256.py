"""The port at head_dim 256 (gemma2-2b's attention: KV 4, G 2) on the CPU,
and the host side of B2's row tiles.

* The plain versions of B1-B4, through the port's ``kernels.ops`` wrappers,
  against the JAX package's Pallas kernels in interpret mode at d = 256,
  with and without window and softcap, NaN in every dead key on the port's
  side. fp32; rtol = atol = 2e-5, as at d <= 32 (the two sides sum in
  different orders; 256-term dot products of unit normals scaled by 1/16
  move the last bits only).
* ``row_tiles``: every row in exactly one tile, no tile across two tables,
  at consecutive lengths only, none longer than ``q_tile_rows(G)``; decode
  rows of distinct slots alone; a dense-engine step's expected tiles.
* The wrappers' card-side checks, reachable without a card: head_dim 256
  taken, 96 and 512 refused; B2 refuses a missing tile list; CPU calls at
  d = 256 count no launches.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
KV, G, D = 4, 2, 256
WINDOW_CAP = [(None, None), (6, None), (None, 30.0), (5, 30.0)]


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
def test_flash_d256_matches_pallas(window, softcap):
    S = 21  # not a multiple of the Pallas block (16): its wrapper pads, the port's does not
    q, k, v = _np(1, (1, S, KV * G, D)), _np(2, (1, S, KV, D)), _np(3, (1, S, KV, D))
    t = torch.from_numpy
    got = t_ops.flash_attention_bshd(t(q), t(k), t(v), window=window, softcap=softcap).numpy()
    pallas = ops.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=window, softcap=softcap, interpret=True,
                                      block_q=16, block_k=16)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
def test_decode_d256_matches_pallas(window, softcap):
    B, S = 3, 32
    q = _np(4, (B, 1, KV * G, D))
    k, v = _np(5, (B, S, KV, D)), _np(6, (B, S, KV, D))
    lengths = np.asarray([1, 13, S], np.int32)
    pallas = ops.decode_attention_bhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lengths), window=window, softcap=softcap,
                                      interpret=True, block_k=16)
    for b, n in enumerate(lengths):  # the port never reads a dead key
        k[b, n:], v[b, n:] = np.nan, np.nan
    t = torch.from_numpy
    got = t_ops.decode_attention_bhd(t(q), t(k), t(v), t(lengths), window=window,
                                     softcap=softcap).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def _pool(seed, lengths, page, nb):
    """One block-table row per entry of ``lengths`` over a shuffled pool."""
    rng = np.random.default_rng(seed)
    P = len(lengths) * nb + 1
    pk, pv = _np(seed + 1, (P, page, KV, D)), _np(seed + 2, (P, page, KV, D))
    tables = rng.permutation(P - 1)[:len(lengths) * nb].reshape(len(lengths), nb)
    return pk, pv, tables.astype(np.int32)


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
def test_paged_rows_d256_matches_pallas(window, softcap):
    page, nb = 8, 3
    lengths = np.asarray([1, 9, 24], np.int32)
    q = _np(10, (len(lengths), KV * G, D))
    pk, pv, tables = _pool(11, lengths, page, nb)
    j = [jnp.asarray(a) for a in (q, pk, pv, lengths, tables)]
    pallas = ops.paged_attention_rows(*j, window=window, softcap=softcap, interpret=True)
    t = torch.from_numpy
    got = t_ops.paged_attention_rows(t(q), t(pk), t(pv), t(lengths), t(tables), window=window,
                                     softcap=softcap).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("window,softcap", WINDOW_CAP)
def test_mixed_rows_d256_matches_pallas(window, softcap):
    """A decode row, a 5-token chunk after 9 cached tokens, a zero-width
    segment and a 3-token chunk from the start; two padding rows."""
    page, nb = 8, 2
    segs = [(1, 11), (5, 14), (0, 0), (3, 3)]
    pk, pv, tables = _pool(20, [kv for _, kv in segs], page, nb)
    cu = np.concatenate([[0], np.cumsum([ql for ql, _ in segs])]).astype(np.int32)
    kv_lens = np.asarray([kv for _, kv in segs], np.int32)
    n = int(cu[-1])
    q = _np(21, (n + 2, KV * G, D))
    j = [jnp.asarray(a) for a in (q, pk, pv, cu, kv_lens, tables)]
    pallas = ops.mixed_attention_rows(*j, qb=8, window=window, softcap=softcap, interpret=True)
    t = torch.from_numpy
    got = t_ops.mixed_attention_rows(t(q), t(pk), t(pv), t(cu), t(kv_lens), t(tables),
                                     window=window, softcap=softcap).numpy()
    np.testing.assert_allclose(got[:n], np.asarray(pallas)[:n], **TOL)


# ---------------------------------------------------------------------------
# B2's row tiles
# ---------------------------------------------------------------------------


def _dense_step(segs):
    """A dense-engine step's rows: segment (slot, start, q_len) gives rows
    at positions start .. start + q_len - 1 of its slot."""
    slots = np.asarray([s for s, _, ql in segs for _ in range(ql)], np.int32)
    positions = np.asarray([p for _, st, ql in segs for p in range(st, st + ql)], np.int32)
    return slots[:, None], positions + 1


def _check_tiling(tiles, tables, lengths, group):
    covered = []
    for first, rows in tiles:
        assert 1 <= rows <= pa.q_tile_rows(group)
        block = range(first, first + rows)
        assert all((tables[r] == tables[first]).all() for r in block), "a tile mixes tables"
        assert all(lengths[r] == lengths[first] + (r - first) for r in block)
        covered.extend(block)
    assert covered == list(range(len(lengths))), "every row in exactly one tile, in order"


@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_row_tiles_cover_rows_once_within_one_table(group):
    rng = np.random.default_rng(group)
    # decode rows, chunks (some longer than a tile), two chunks of one slot
    # back to back, and a slot whose rows repeat a length (no run)
    segs = [(0, 40, 1), (1, 7, 1), (2, 0, 70), (3, 100, 5), (3, 105, 9), (4, 3, 1), (5, 0, 33),
            (1, 8, 1)]
    tables, lengths = _dense_step(segs)
    lengths[-3:-1] = 12  # two rows of slot 5 at one length
    tiles = pa.row_tiles(tables, lengths, group)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    _check_tiling(tiles, tables, lengths, group)
    # paged tables: rows of one length run only where their whole table rows agree
    pages = rng.integers(0, 5, (len(lengths), 3)).astype(np.int32)
    _check_tiling(pa.row_tiles(pages, lengths, group), pages, lengths, group)


def test_row_tiles_of_decode_rows_are_single():
    tables = np.asarray([[3], [0], [5], [1]], np.int32)  # distinct slots
    tiles = pa.row_tiles(tables, np.asarray([9, 10, 11, 12]), 2)
    assert tiles.tolist() == [[0, 1], [1, 1], [2, 1], [3, 1]]
    assert pa.row_tiles(np.zeros((0, 1), np.int32), np.zeros(0, np.int32), 2).shape == (0, 2)


def test_row_tiles_of_a_dense_engine_step():
    """Two decode rows, a 40-token chunk, then a 3-token and a 5-token chunk
    of one slot back to back: at G 2 (32 rows a tile) the 40 rows cut at
    32, and the two chunks of one slot run on as one tile of 8."""
    tables, lengths = _dense_step([(0, 99, 1), (1, 5, 1), (2, 200, 40), (3, 10, 3),
                                   (3, 13, 5)])
    assert pa.row_tiles(tables, lengths, 2).tolist() == [[0, 1], [1, 1], [2, 32], [34, 8],
                                                         [42, 8]]
    assert pa.row_tiles(tables, lengths, 4).tolist() == [[0, 1], [1, 1], [2, 16], [18, 16],
                                                         [34, 8], [42, 8]]
    with pytest.raises(ValueError):
        pa.row_tiles(tables[:-1], lengths, 2)


# ---------------------------------------------------------------------------
# wrapper checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,g_max", [("mixed_paged_attention", pa.M_MAX),
                                        ("paged_attention", da.G_MAX),
                                        ("decode_attention", da.G_MAX),
                                        ("flash_attention", fa.G_MAX)])
def test_kernel_shape_check_takes_d256(name, g_max):
    for dtype in (torch.float32, torch.bfloat16):
        da.check_kernel_shape(name, dtype, 256, G, g_max)
        for d in (96, 512):
            with pytest.raises(ValueError):
                da.check_kernel_shape(name, dtype, d, G, g_max)
    with pytest.raises(ValueError):
        da.check_kernel_shape(name, torch.float32, 256, g_max + 1, g_max)
    with pytest.raises(TypeError):
        da.check_kernel_shape(name, torch.float16, 256, G, g_max)


def test_b2_refuses_missing_tiles_on_the_card():
    q = torch.zeros((3, KV, G, D))
    with pytest.raises(ValueError):
        pa.check_tiles(None, q, "row_tiles(block_tables, lengths, G)")
    with pytest.raises(ValueError):
        pa.check_tiles(torch.zeros((3, 2), dtype=torch.int64), q, "row_tiles")
    with pytest.raises(ValueError):
        pa.check_tiles(torch.zeros((3, 3), dtype=torch.int32), q, "row_tiles")
    pa.check_tiles(torch.zeros((3, 2), dtype=torch.int32), q, "row_tiles")


def test_cpu_calls_at_d256_count_no_launches():
    t = torch.from_numpy
    counters = (pa.mixed_paged_attention, pa.paged_attention, da.decode_attention,
                fa.flash_attention)
    before = [f.launches for f in counters]
    q = t(_np(30, (2, 1, KV * G, D)))
    k, v = t(_np(31, (2, 9, KV, D))), t(_np(32, (2, 9, KV, D)))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    t_ops.decode_attention_bhd(q, k, v, lengths)
    t_ops.flash_attention_bshd(t(_np(33, (2, 9, KV * G, D))), k, v)
    qg = q.reshape(2, KV, G, D)
    tables = torch.tensor([[0], [1]], dtype=torch.int32)
    pa.paged_attention(qg, k, v, lengths, tables)  # the CPU ignores tiles
    pa.mixed_paged_attention(qg, k, v, torch.tensor([0, 1, 2], dtype=torch.int32), lengths,
                             tables)
    assert [f.launches for f in counters] == before
