"""Paged attention: the wrappers of two Hopper kernels.

``mixed_paged_attention`` (B1) is the port of the JAX package's Pallas
kernel of the same name (``kernels/paged_attention.py``): one call per packed
serving step, every segment (a decode row or a prefill chunk) a causal block
of queries over its own paged KV prefix. On a CPU tensor it runs the plain
version (``kernels.ref.mixed_attention_ref``); on a CUDA tensor it launches
``csrc/mixed_paged_attention.cu`` or raises — it never falls back.

The CUDA kernel works in q-tiles of up to ``64 // G`` consecutive rows of
one segment; the tile list is built from ``cu_q_lens`` on the host
(``q_tiles``) by the caller, once per step in the engine, so the 32 layers
of a step reuse one device copy and a launch never waits on the device. A
CTA takes one tile (fp32) or two consecutive tiles of a segment (bf16,
``cta_rows``), and its keys in spans (``key_splits``: a decode row of L keys
runs as about L / 256 CTAs); a plan pass on the card lists the work from the
tiles and ``kv_lens``, and a combine pass sums the spans' partial outputs
(their scratch laid out by the kernel's library: ``key_split_workspace``).
One call is four launches (plan, a light and a heavy producer or the fp32
one, combine), counted once by ``mixed_paged_attention.launches``.

``paged_attention`` (B2) is the port of the Pallas ``paged_attention``: one
query per row, at position ``lengths[n] - 1``, over the pages its block
table names. On the CPU it runs ``kernels.ref.paged_attention_ref``; on the
card it launches ``csrc/decode_attention.cu`` (shared with B3,
``kernels.decode_attention``) with the table addressing policy. Its rows
come in tiles built on the host (``row_tiles``): consecutive rows that
read one block-table row at consecutive lengths — the rows of a prefill
chunk in the engine's dense fallback, which calls it with each slot's cache
row as one page of ``max_len`` tokens — share a tile of up to
``q_tile_rows(G)`` rows, whose keys the kernel stages once for all of them
and multiplies on the tensor cores (bf16). A call whose tiles are all one
row (decode rows of distinct slots), and every fp32 call, runs one CTA per
(row, KV head) split over keys, as B3 does. ``paged_attention.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    DTYPE_CODES,
    check_kernel_shape,
    check_query,
    launchers,
    split_count,
    workspace,
)
from repro_torch.kernels.ref import mixed_attention_ref, paged_attention_ref

M_MAX = 64  # query vectors per CTA (csrc/mixed_paged_attention.cu)
SPLIT_KEYS = 256  # B1: keys per split of a one-row tile (a multiple of 64)
MAX_KEY_SPLITS = 64  # B1: the most splits a tile's keys are cut into


def q_tile_rows(group: int) -> int:
    """Rows per q-tile for ``group`` query heads per KV head."""
    if not 1 <= group <= M_MAX:
        raise ValueError(f"GQA group {group} outside the kernel's 1..{M_MAX}")
    return M_MAX // group


def row_tiles(block_tables: np.ndarray, lengths: np.ndarray, group: int) -> np.ndarray:
    """(n_tiles, 2) int32 ``(first row, rows)`` of B2's one-query rows, in
    row order: each run of consecutive rows whose block-table rows are
    identical and whose lengths rise by one (a prefill chunk's rows) is cut
    into tiles of ``q_tile_rows(group)``; every other row is a tile of its
    own. Rows of different tables never share a tile, and the keys a tile's
    rows read together are exactly the union of what each reads."""
    qt = q_tile_rows(group)
    tabs = np.asarray(block_tables)
    lens = np.asarray(lengths, np.int64)
    n = lens.shape[0]
    if tabs.shape[0] != n:
        raise ValueError(f"block_tables has {tabs.shape[0]} rows, lengths {n}")
    if n == 0:
        return np.zeros((0, 2), np.int32)
    idx = np.arange(n)
    run_start = np.ones(n, bool)
    run_start[1:] = ~((tabs[1:] == tabs[:-1]).all(axis=1) & (lens[1:] == lens[:-1] + 1))
    first = np.maximum.accumulate(np.where(run_start, idx, 0))  # each row's run start
    starts = np.flatnonzero((idx - first) % qt == 0)
    return np.stack([starts, np.diff(np.append(starts, n))], axis=1).astype(np.int32)


def check_tiles(tiles: Optional[torch.Tensor], q: torch.Tensor, what: str) -> None:
    """A kernel's tile list, required for q on the card: a contiguous
    (n_tiles, 2) int32 tensor on q's device."""
    if tiles is None or tiles.dtype != torch.int32 or tiles.dim() != 2 \
            or tiles.shape[1] != 2 or tiles.device != q.device or not tiles.is_contiguous():
        raise ValueError(f"tiles must be {what} as a contiguous (n_tiles, 2) int32 tensor on "
                         f"{q.device}")


def q_tiles(cu_q_lens: np.ndarray, group: int) -> np.ndarray:
    """(n_tiles, 2) int32 ``(segment, first row)``: each segment's rows cut
    into tiles of ``q_tile_rows(group)``; zero-width segments get none."""
    qt = q_tile_rows(group)
    cu = np.asarray(cu_q_lens, np.int64)
    tiles = [(s, r) for s in range(len(cu) - 1) for r in range(cu[s], cu[s + 1], qt)]
    return np.asarray(tiles, np.int32).reshape(-1, 2)


def key_splits(capacity: int):
    """B1's split over keys for tables of ``capacity`` (nb * page) keys:
    ``(n_split, span)``. A light CTA (at most 16 query vectors, as a decode
    row) of r rows takes its live keys in spans of ``span * r``, so a decode
    row of L keys runs as ceil(L / span) CTAs and a long row no longer
    streams its context alone; the kernel's plan gives heavier CTAs (a
    chunk's tiles) a span of its own, never shorter. ``span`` is
    ``SPLIT_KEYS``, widened (in blocks of 64 keys) where the capacity would
    need more than ``MAX_KEY_SPLITS`` spans. ``n_split`` is the most spans
    any CTA can have."""
    span = max(SPLIT_KEYS, -(-capacity // (64 * MAX_KEY_SPLITS)) * 64)
    return max(1, -(-capacity // span)), span


def cta_rows(dtype: torch.dtype, group: int) -> int:
    """Rows of one segment a CTA of B1's kernel takes: two consecutive
    q-tiles in bf16 (one staged key block serves up to 128 query vectors),
    one in fp32."""
    return q_tile_rows(group) * (2 if dtype == torch.bfloat16 else 1)


class SplitScratch(NamedTuple):
    """One B1 launch's scratch (``tensor``, fp32 elements) and where the
    kernel's plan puts its parts, in elements from the start: the work list
    (2 kinds x ``n_tiles * n_split`` int32 pairs (tile, split)) at 0, each
    split CTA's first partial slot at ``tile_slot``, six int32 at ``counts``
    (light items, heavy items, slots used, the two queues, the heavy CTAs'
    span), the partial outputs at ``o_part`` and their (m, l) at
    ``ml_part``."""
    tensor: torch.Tensor
    tile_slot: int
    counts: int
    o_part: int
    ml_part: int


@functools.lru_cache(maxsize=256)
def _scratch_layout(n_tiles: int, KV: int, G: int, d: int, n_split: int, sms: int):
    at = (ctypes.c_longlong * 4)()
    total = _launcher()[2](n_tiles, KV, G, d, n_split, sms, at)
    return total, tuple(at)


def key_split_workspace(q: torch.Tensor, n_tiles: int, n_split: int, sms: int) -> SplitScratch:
    """The scratch of one B1 launch on a card of ``sms`` SMs: its size and
    layout come from the kernel's library (``scratch_layout`` in
    ``csrc/mixed_paged_attention.cu``, beside the plan that bounds it), which
    refuses a launch given less. On q's device; the card only."""
    _, KV, G, d = q.shape
    total, at = _scratch_layout(n_tiles, KV, G, d, n_split, sms)
    return SplitScratch(torch.empty(total, dtype=torch.float32, device=q.device), *at)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _launcher():
    """The kernel's C entry points, built and loaded on first use, with their
    ctypes signatures (every pointer and the stream as c_void_p): the
    launch, its error string and its scratch layout."""
    lib = _build.load("mixed_paged_attention")
    fn = lib.mixed_paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.mixed_paged_attention_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    layout = lib.mixed_paged_attention_scratch_layout
    layout.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    layout.restype = ctypes.c_longlong
    return fn, err, layout


def _check(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables):
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q (N,KV,G,d) and k/v pages (P,page,KV,d) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    N, KV, G, d = q.shape
    if k_pages.shape[2] != KV or k_pages.shape[3] != d:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    S = kv_lens.shape[0] if kv_lens.dim() == 1 else -1
    if cu_q_lens.shape != (S + 1,) or block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"want cu_q_lens (S+1,), kv_lens (S,), block_tables (S,nb); got "
                         f"{tuple(cu_q_lens.shape)}, {tuple(kv_lens.shape)}, "
                         f"{tuple(block_tables.shape)}")
    for name, t in (("cu_q_lens", cu_q_lens), ("kv_lens", kv_lens),
                    ("block_tables", block_tables)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("cu_q_lens", cu_q_lens), ("kv_lens", kv_lens),
                    ("block_tables", block_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mixed_paged_attention(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, *,
                          window: Optional[int] = None, softcap: Optional[float] = None,
                          tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (N, KV, G, d) packed rows, segments contiguous in ``cu_q_lens``
    order; k/v_pages: (P, page, KV, d); cu_q_lens: (S+1,) int32 row offsets;
    kv_lens: (S,) int32 keys each segment's last row attends; block_tables:
    (S, nb) int32 page ids. Returns (N, KV, G, d); rows at or after
    ``cu_q_lens[-1]`` are padding, zero on the CPU and left unwritten on the
    card. ``tiles`` is ``q_tiles(cu_q_lens, G)`` on q's device, required on
    the card (the CPU path ignores it)."""
    _check(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables)
    if not q.is_cuda:
        return mixed_attention_ref(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables,
                                   window=window, softcap=softcap)
    N, KV, G, d = q.shape
    check_kernel_shape("mixed_paged_attention", q.dtype, d, G, M_MAX)
    qt = q_tile_rows(G)
    check_tiles(tiles, q, "q_tiles(cu_q_lens, G)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k/v pages must start 16-byte aligned (the kernel copies 16 bytes "
                         "at a time)")
    out = torch.empty_like(q)
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        return out
    page, nb = k_pages.shape[1], block_tables.shape[1]
    n_split, span = key_splits(nb * page)
    sms = _sm_count(q.device)
    # the caller may drop the scratch once the launch is queued: PyTorch's
    # caching allocator hands its memory only to work queued after it
    scratch = key_split_workspace(q, n_tiles, n_split, sms).tensor
    fn, err_string = _launcher()[:2]
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), scratch.numel(), cu_q_lens.data_ptr(), kv_lens.data_ptr(),
             block_tables.data_ptr(), tiles.data_ptr(), n_tiles, KV, G, d, page, nb, qt,
             n_split, span, sms, 1.0 / d**0.5,
             0.0 if softcap is None else float(softcap),
             0 if window is None else int(window), DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mixed_paged_attention launch failed: {err_string(err).decode()}")
    mixed_paged_attention.launches += 1
    return out


mixed_paged_attention.launches = 0


def paged_attention(q, k_pages, v_pages, lengths, block_tables, *,
                    window: Optional[int] = None, softcap: Optional[float] = None,
                    tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (N, KV, G, d) one query per row; k/v_pages: (P, page, KV, d)
    contiguous pool; lengths: (N,) int32 keys each row attends;
    block_tables: (N, nb) int32 page ids in logical order. Returns
    (N, KV, G, d). ``tiles`` is ``row_tiles(block_tables, lengths, G)`` on
    q's device, required on the card (the CPU path ignores it)."""
    check_query(q, lengths, "paged_attention")
    N, KV, G, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[2:] != (KV, d):
        raise ValueError(f"want k/v pages (P, page, KV, d) matching q {tuple(q.shape)}; got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != N:
        raise ValueError(f"want block_tables as ({N}, nb) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("block_tables", block_tables)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {q.device}")
    if q.is_cuda and (k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16):
        raise ValueError("k/v pages must start 16-byte aligned (the kernel copies 16 bytes "
                         "at a time)")
    if not q.is_cuda:
        return paged_attention_ref(q, k_pages, v_pages, lengths, block_tables, window=window,
                                   softcap=softcap)
    check_tiles(tiles, q, "row_tiles(block_tables, lengths, G)")
    page, nb = k_pages.shape[1], block_tables.shape[1]
    # tiles of several rows run on the tensor cores (bf16); a call of one-row
    # tiles, or in fp32, one CTA per row
    n_tiles = tiles.shape[0] if q.dtype == torch.bfloat16 and tiles.shape[0] < N else 0
    n_split = split_count((n_tiles or N) * KV, nb * page)
    out = torch.empty_like(q)
    o_part, ml_part, _keep = workspace(q, n_split)
    _, paged, err_string = launchers()
    err = paged(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(), o_part,
                ml_part, lengths.data_ptr(), block_tables.data_ptr(), tiles.data_ptr(), n_tiles,
                N, nb, page, KV, G, d, n_split, 1.0 / d**0.5,
                0.0 if softcap is None else float(softcap), 0 if window is None else int(window),
                DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: {err_string(err).decode()}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
