"""GQA attention over a dense KV cache: the serial execution path.

The PyTorch counterpart of the GQA part of the JAX package's
``models/attention.py``. One function, two entry modes:

  * ``cache=None``: full-sequence causal self-attention (one-shot forward);
  * ``cache`` given: write this call's K/V into the ``(B, max_len, KV, d)``
    cache where its ``CacheCall`` says and attend the cache up to each
    token's position. This serves prefill (``T`` prompt tokens) and decode
    (``T == 1``).

Where JAX computes the attention in XLA (``_sdpa`` under an additive
``_mask_bias``) and keeps its Pallas kernels beside it, the port computes it
in those kernels: ``_attend`` calls the one that computes the call's
function, which on CPU tensors runs its plain version:

  * no cache: causal attention of the call's tokens over themselves (B4);
  * ``T == 1``: one query per row over its cache, ``lengths = index + 1`` (B3);
  * ``T > 1`` at index 0: the prompt over itself, read in place from the
    cache's first ``T`` rows (B4);
  * ``T > 1`` at a nonzero index (chunked prefill): B1, each batch row's
    cache one page of ``max_len`` tokens, row ``j`` at ``index + j``.

Not in this module yet: MLA, cross-attention and the sequence-parallel
decode (ROADMAP.md A8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import q_tiles
from repro_torch.models.layers import dense, rms_norm, rotate

Index = Union[int, torch.Tensor]  # a uniform offset, or (B,) per-row offsets


def kv_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, dtype: torch.dtype,
                  device) -> dict:
    """Zeroed per-layer KV cache: k and v of (batch, max_len, KV, d)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_write(buf: torch.Tensor, new: torch.Tensor, index: Index) -> torch.Tensor:
    """Write ``new`` (B,T,...) into ``buf`` (B,S,...) at sequence offset(s)
    ``index``: an int (the same offset for every row) or a (B,) tensor (one
    per row). Where JAX returns an updated copy
    (``dynamic_update_slice``), the port writes ``buf`` in place, by a slice
    assignment or an ``index_put_``, and returns it."""
    new = new.to(buf.dtype)
    T = new.shape[1]
    if isinstance(index, int):
        if not 0 <= index <= buf.shape[1] - T:
            raise ValueError(f"cache write of {T} tokens at {index} overruns {buf.shape[1]}")
        buf[:, index:index + T] = new
        return buf
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = index.long()[:, None] + torch.arange(T, device=buf.device)[None, :]
    buf.index_put_((rows, cols), new)
    return buf


@dataclasses.dataclass
class CacheCall:
    """Where one serial call writes its ``T`` tokens into the dense cache
    (``index``), and the metadata its attention reads: built once per call
    (``Model._run``) and shared by every layer, as ``packed_step`` builds its
    view once per step. ``lengths`` (B,) for a decode step (B3); for a
    chunked prefill (B1) the segment offsets, keys per segment, tables and
    q-tile list, each batch row one segment whose cache is one page."""

    index: Index
    lengths: Optional[torch.Tensor] = None
    chunk: Optional[Tuple[torch.Tensor, ...]] = None


def cache_call(index: Index, B: int, T: int, G: int, device) -> CacheCall:
    """The ``CacheCall`` of ``T`` tokens per row written at ``index`` (an
    int, or (B,) offsets), with ``G`` query heads per KV head."""
    if T > 1 and isinstance(index, int) and index == 0:
        return CacheCall(index)  # the prompt over itself (B4)
    last = index + T  # keys the last token of each row attends
    if isinstance(index, int):
        last = torch.full((B,), last, dtype=torch.int32, device=device)
    last = last.to(device=device, dtype=torch.int32)
    if T == 1:
        return CacheCall(index, lengths=last)
    # row b's cache is one page (table [[b]]); its T queries one segment
    cu = np.arange(0, B * T + 1, T, dtype=np.int32)
    meta = torch.from_numpy(np.concatenate([cu, np.arange(B, dtype=np.int32),
                                            q_tiles(cu, G).ravel()])).to(device)
    d_cu, d_tab, d_tiles = torch.split(meta, [B + 1, B, meta.numel() - 2 * B - 1])
    return CacheCall(index, chunk=(d_cu, last, d_tab.view(B, 1), d_tiles.view(-1, 2)))


def _attend(q, k, v, window: Optional[int], cap: Optional[float],
            call: Optional[CacheCall]):
    """The kernel that computes this call's attention (its plain version on
    CPU tensors). q (B,T,H,d); k/v (B,S,KV,d): the call's own keys when
    ``call`` is None, else the cache."""
    B, T, H, d = q.shape
    if call is None:
        return ops.flash_attention_bshd(q, k, v, causal=True, window=window, softcap=cap)
    if T == 1:
        return ops.decode_attention_bhd(q, k, v, call.lengths, window=window, softcap=cap)
    if call.chunk is None:
        return ops.flash_attention_bshd(q, k[:, :T], v[:, :T], causal=True, window=window,
                                        softcap=cap)
    cu, kv_lens, tables, tiles = call.chunk
    o = ops.mixed_attention_rows(q.reshape(B * T, H, d), k, v, cu, kv_lens, tables,
                                 window=window, softcap=cap, tiles=tiles)
    return o.reshape(B, T, H, d)


def attn_apply(params, cfg: ModelConfig, spec: LayerSpec, x, angles, *, cache=None,
               call: Optional[CacheCall] = None):
    """x (B,T,d_model); ``angles`` the RoPE angles of the tokens' positions
    (``layers.rope_angles``, computed once for all layers); with a cache,
    ``call`` says where the tokens go. Returns (y, cache): the given cache,
    written in place, or None."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = dense(params["wq"], x).view(B, T, cfg.n_heads, hd)
    k = dense(params["wk"], x).view(B, T, cfg.n_kv_heads, hd)
    v = dense(params["wv"], x).view(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = rotate(q, angles)
    k = rotate(k, angles)
    window = cfg.local_window if spec.attn_kind == "local" else None
    cap = cfg.attn_logit_softcap
    if cache is None:
        out = _attend(q, k, v, window, cap, None)
    else:
        cache_write(cache["k"], k, call.index)
        cache_write(cache["v"], v, call.index)
        # attend the cache's copy, in the activations' dtype, as JAX does
        out = _attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), window, cap, call)
    y = dense(params["wo"], out.reshape(B, T, cfg.n_heads * hd))
    return y, cache
