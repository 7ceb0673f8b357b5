"""Model-layout entry points of the port's kernels.

The counterparts of the JAX package's ``kernels/ops.py`` wrappers, with the
same signatures minus ``interpret``/``use_kernel``: each wrapper below runs
its kernel on a CUDA tensor and the kernel's plain version on a CPU tensor.
Unlike the JAX wrappers they neither transpose ``(B, S, KV, d)`` caches to
``(B, KV, S, d)`` nor pad ``S`` to a block multiple: on the card that would
copy a whole cache on every decode call. The kernels read the model layout
through its strides and mask their ragged edges themselves.

``ssd`` likewise hands the model's x, B and C slices to the chunk scan
without padding them to a chunk multiple or transposing them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import mixed_paged_attention, paged_attention
from repro_torch.kernels.ssd import ssd_chunk_scan


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Model-layout wrapper: q (B,S,H,d), k/v (B,S,KV,d) -> (B,S,H,d)."""
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def decode_attention_bhd(q, k, v, lengths, *, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Model-layout wrapper: q (B,1,H,d), cache k/v (B,S,KV,d), lengths (B,)."""
    B, T, H, d = q.shape
    if T != 1:
        raise ValueError(f"decode attention takes one query per row, got T={T}")
    KV = k.shape[2]
    o = decode_attention(q.reshape(B, KV, H // KV, d), k, v, lengths.to(torch.int32),
                         window=window, softcap=softcap)
    return o.reshape(B, 1, H, d)


def paged_attention_rows(q, k_pages, v_pages, lengths, block_tables, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Packed-row layout wrapper: q (N,H,d) + page pool (P,page,KV,d),
    per-row lengths (N,) and block tables (N,nb) -> (N,H,d)."""
    N, H, d = q.shape
    KV = k_pages.shape[2]
    o = paged_attention(q.reshape(N, KV, H // KV, d), k_pages, v_pages,
                        lengths.to(torch.int32), block_tables, window=window, softcap=softcap)
    return o.reshape(N, H, d)


def mixed_attention_rows(q, k_pages, v_pages, cu_q_lens, kv_lens, block_tables, *,
                         window: Optional[int] = None, softcap: Optional[float] = None,
                         tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed mixed-batch layout wrapper: q (N,H,d) rows laid out by segment
    (cu_q_lens (S+1,) row offsets), per-segment kv extents (S,) and block
    tables (S,nb) -> (N,H,d). ``tiles`` (``paged_attention.q_tiles``) is
    the kernel's q-tile list, required on the card; it takes the place of
    the JAX wrapper's static q-block ``qb``."""
    N, H, d = q.shape
    KV = k_pages.shape[2]
    o = mixed_paged_attention(q.reshape(N, KV, H // KV, d), k_pages, v_pages, cu_q_lens,
                              kv_lens, block_tables, window=window, softcap=softcap, tiles=tiles)
    return o.reshape(N, H, d)


def ssd(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None):
    """Model-layout wrapper, the counterpart of JAX's ops.ssd and ssd_chunked.

    x: (B,S,nh,hd), dt: (B,S,nh) fp32, A: (nh,), Bm/Cm: (B,S,G,ds), h0:
    (B,nh,hd,ds) fp32 or None. Returns (y (B,S,nh,hd), hT (B,nh,hd,ds)).
    The chunk length is the kernel's (``ref.SSD_CHUNK``); JAX's ``chunk``
    argument has no counterpart."""
    return ssd_chunk_scan(x, dt.float(), A.float(), Bm, Cm, h0)
