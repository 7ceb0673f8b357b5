"""Plain PyTorch versions of the attention kernels.

They compute what the JAX package's ``kernels/ref.py`` oracles compute, in
fp32, and are what the kernel wrappers run on CPU tensors. Unlike the JAX
oracles they never let a dead key touch the result: keys at or after a
row's length (or below its window) are zeroed before the products, so
NaN-filled dead and scratch pages give the same answer as clean ones (the
JAX oracle relies on finite garbage: ``0 * NaN`` is NaN).

``mixed_attention_ref.cuda_calls`` counts calls on CUDA tensors, so a run
can show that its main path never fell back to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def _zero_dead(kc, vc, live):
    """Zero the keys/values outside ``live`` (broadcast over the trailing
    KV and d axes), so NaN garbage in dead slots never reaches a product."""
    live = live[..., None, None]
    return torch.where(live, kc, 0.0), torch.where(live, vc, 0.0)


def _attend(q, kc, vc, ok, softcap):
    """q (..., KV, G, d) fp32 queries over keys kc/vc (..., S, KV, d) fp32
    whose dead entries are already zeroed; ``ok`` (..., S) marks the keys
    each query row may read (its leading axes broadcast against q's)."""
    d = q.shape[-1]
    s = torch.einsum("...kgd,...skd->...kgs", q, kc) / d**0.5
    s = _softcap(s, softcap)
    s = torch.where(ok[..., None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...kgs,...skd->...kgd", p, vc)


def paged_attention_ref(q, k_pages, v_pages, lengths, block_tables, *,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """q: (N,KV,G,d); k/v_pages: (P,page,KV,d); lengths (N,);
    block_tables (N,nb) -> (N,KV,G,d).

    Row n holds one query at position ``lengths[n] - 1`` and reads its pages
    in block-table order (logical key position ``ib*page + offset``)."""
    N, KV, G, d = q.shape
    page = k_pages.shape[1]
    S = block_tables.shape[1] * page
    tabs = block_tables.long()
    kc = k_pages[tabs].reshape(N, S, KV, d).float()
    vc = v_pages[tabs].reshape(N, S, KV, d).float()
    lengths = lengths.long()[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    ok = k_pos < lengths
    if window is not None:
        ok &= k_pos > (lengths - 1) - window
    kc, vc = _zero_dead(kc, vc, ok)
    return _attend(q.float(), kc, vc, ok, softcap).to(q.dtype)


def mixed_attention_ref(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, *,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """Mixed-batch (prefill chunks + decode rows) attention, one segment at a
    time.

    q: (N,KV,G,d) flat packed rows; cu_q_lens: (S+1,) row offsets of each
    segment; kv_lens: (S,) keys the segment's *last* row attends;
    block_tables: (S,nb) per-segment page ids. Row j of segment s sits at
    position ``kv_lens[s] - q_len + j`` and attends the keys at or before it
    (and, with ``window``, above ``position - window``). Zero-width segments
    are skipped; rows at or after ``cu_q_lens[-1]`` are padding and come
    back zero.
    """
    if q.is_cuda:
        mixed_attention_ref.cuda_calls += 1
    N, KV, G, d = q.shape
    page = k_pages.shape[1]
    out = torch.zeros((N, KV, G, d), dtype=torch.float32, device=q.device)
    cu = cu_q_lens.tolist()
    kvl = kv_lens.tolist()
    for s, kv_len in enumerate(kvl):
        r0, r1 = cu[s], cu[s + 1]
        q_len = r1 - r0
        if q_len == 0:
            continue
        n_pages = -(-kv_len // page)
        tabs = block_tables[s, :n_pages].long()
        kc = k_pages[tabs].reshape(n_pages * page, KV, d).float()
        vc = v_pages[tabs].reshape(n_pages * page, KV, d).float()
        q_pos = torch.arange(kv_len - q_len, kv_len, device=q.device)[:, None]
        k_pos = torch.arange(n_pages * page, device=q.device)[None, :]
        ok = k_pos <= q_pos  # (q_len, keys); also keeps k_pos < kv_len
        live = k_pos[0] < kv_len  # keys any row of the segment may read
        if window is not None:
            ok &= k_pos > q_pos - window
            live &= k_pos[0] > kv_len - q_len - window
        kc, vc = _zero_dead(kc, vc, live)
        out[r0:r1] = _attend(q[r0:r1].float(), kc[None], vc[None], ok, softcap)
    return out.to(q.dtype)


mixed_attention_ref.cuda_calls = 0
