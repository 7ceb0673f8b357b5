"""GQA and MLA attention over a dense cache: the serial execution path.

The PyTorch counterpart of the JAX package's ``models/attention.py``. One
function, two entry modes:

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

MLA (DeepSeek-V2's multi-head latent attention) has no kernel in either
package: ``_mla_apply`` is plain PyTorch, on JAX's branches and under JAX's
rule for choosing them:

  * no cache, ``T * T <= FLASH_THRESHOLD``: direct attention over per-head
    K/V expanded from the call's latent;
  * a cache, ``T == 1`` or ``T * S <= FLASH_THRESHOLD``: absorbed attention
    in the latent space over the cache's ``{"ckv", "krope"}`` rows
    (``latent_attention``, key-tiled with an online softmax, which the packed
    step shares);
  * otherwise (a long prompt, cached or not): expanded attention in key
    tiles (``expanded_attention``), each tile's K/V expanded from its latent,
    the counterpart of JAX's ``flash_sdpa`` with ``kv_expand``.

Full (non-causal) attention, JAX's ``_attend(..., causal=False)``, serves
whisper's encoder (no cache: B4 over the frames' keys) and its decoder's
cross-attention over the encoder's K/V (``cross_attn_apply``): B4 for a
prompt's ``T > 1`` queries, B3 for a decode step's one query per row at
``lengths`` = every encoder key. Not in this module yet: the
sequence-parallel decode
(ROADMAP.md A8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import q_tiles
from repro_torch.models.layers import dense, dense_init, rms_norm, rms_norm_init, rotate

Index = Union[int, torch.Tensor]  # a uniform offset, or (B,) per-row offsets
NEG_INF = -2.0e38
FLASH_THRESHOLD = 1 << 22  # T*S above this takes MLA's expanded, key-tiled branch
# the working set of one key tile of ``latent_attention`` (the tile's latent
# gathered for every query group, and its fp32 scores and probabilities)
MLA_TILE_BYTES = 384 * 2**20
# query and key block of ``expanded_attention``: one key block's K and V
# for all heads, (B, 512, H, nope + vh), is what the expanded branch holds
EXPANDED_BLOCK = 512


def attn_init(cfg: ModelConfig, *, generator, dtype, device) -> dict:
    """One attention layer's parameters: GQA's ``wq``/``wk``/``wv``/``wo``
    (biases, q/k norms where the config has them) or MLA's."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    if cfg.mla:
        return _mla_init(cfg, **kw)
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(cfg.n_heads * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, dtype=dtype, device=device)
        p["k_norm"] = rms_norm_init(hd, dtype=dtype, device=device)
    return p


def _mla_init(cfg: ModelConfig, *, generator, dtype, device) -> dict:
    """JAX's ``_mla_init`` leaves: the query's low-rank down and up
    projections around a norm, the latent's down projection (``kv_lora_rank``
    latent dims, then the shared RoPE key), its norm and its up projection
    to every head's no-RoPE key and value (head-interleaved columns), and
    the output projection."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, H = cfg.d_model, cfg.n_heads
    L, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, vh = cfg.qk_nope_head_dim, cfg.v_head_dim
    return {
        "q_down": dense_init(d, cfg.q_lora_rank, **kw),
        "q_norm": rms_norm_init(cfg.q_lora_rank, dtype=dtype, device=device),
        "q_up": dense_init(cfg.q_lora_rank, H * (nope + R), **kw),
        "kv_down": dense_init(d, L + R, **kw),
        "kv_norm": rms_norm_init(L, dtype=dtype, device=device),
        "kv_up": dense_init(L, H * (nope + vh), **kw),
        "wo": dense_init(H * vh, d, **kw),
    }


def kv_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, dtype: torch.dtype,
                  device) -> dict:
    """Zeroed per-layer cache: k and v of (batch, max_len, KV, d), or MLA's
    latent, ckv (batch, max_len, kv_lora_rank) and krope (batch, max_len,
    qk_rope_head_dim)."""
    if cfg.mla:
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                                     device=device)}
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


def positions_from_index(index: Index, B: int, T: int, device) -> torch.Tensor:
    """(B, T) int32 positions of T tokens written at ``index``."""
    steps = torch.arange(T, dtype=torch.int32, device=device)
    if isinstance(index, int):
        return (index + steps)[None, :].expand(B, T)
    return index.to(device=device, dtype=torch.int32)[:, None] + steps[None, :]


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
            call: Optional[CacheCall], causal: bool = True):
    """The kernel that computes this call's attention (its plain version on
    CPU tensors). q (B,T,H,d); k/v (B,S,KV,d): the call's own keys when
    ``call`` is None, else the cache. ``causal`` False: every query attends
    every key, by B4, or by B3 over ``call.lengths`` for one query a row."""
    B, T, H, d = q.shape
    if not causal:
        if T == 1 and call is not None:
            return ops.decode_attention_bhd(q, k, v, call.lengths, window=window, softcap=cap)
        return ops.flash_attention_bshd(q, k, v, causal=False, window=window, softcap=cap)
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
    if cfg.mla:
        return _mla_apply(params, cfg, x, angles, cache=cache, call=call)
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


# ---------------------------------------------------------------------------
# Cross-attention (whisper's decoder) over K/V precomputed from the encoder
# ---------------------------------------------------------------------------


def cross_attn_init(cfg: ModelConfig, *, generator, dtype, device) -> dict:
    """JAX's ``cross_attn_init`` leaves: ``wq`` and ``wv`` with biases where
    the config has them, ``wk`` without one, and ``wo``."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": dense_init(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(d, cfg.n_kv_heads * hd, **kw),
        "wv": dense_init(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(cfg.n_heads * hd, d, **kw),
    }


def cross_kv(params, cfg: ModelConfig, enc_out) -> dict:
    """K and V (B, F, KV, d) of the encoder's output (B, F, d_model)."""
    B, S, _ = enc_out.shape
    k = dense(params["wk"], enc_out).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(params["wv"], enc_out).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}


def cross_call(B: int, n_keys: int, device) -> CacheCall:
    """The ``CacheCall`` of a decode step's cross-attention: every row reads
    all ``n_keys`` encoder keys (B3's lengths), built once per call."""
    return CacheCall(None, lengths=torch.full((B,), n_keys, dtype=torch.int32, device=device))


def cross_attn_apply(params, cfg: ModelConfig, x, kv, call: Optional[CacheCall] = None):
    """x (B, T, d_model) over ``kv`` (``cross_kv``'s K and V, read in x's
    dtype as JAX does), with no mask and no positions: B4 with ``causal``
    off for T > 1, B3 for T == 1 over ``call``'s lengths (``cross_call``,
    made here when None)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = dense(params["wq"], x).view(B, T, cfg.n_heads, hd)
    k, v = kv["k"].to(x.dtype), kv["v"].to(x.dtype)
    if T == 1 and call is None:
        call = cross_call(B, k.shape[1], x.device)
    out = _attend(q, k, v, None, None, call, causal=False)
    return dense(params["wo"], out.reshape(B, T, cfg.n_heads * hd))


# ---------------------------------------------------------------------------
# MLA: direct (short, no cache), absorbed (cached), expanded (long)
# ---------------------------------------------------------------------------


def mla_qkv_rope(params, cfg: ModelConfig, x, angles):
    """JAX's ``_mla_qkv_rope`` over x (..., d_model) with ``angles`` from
    ``rope_angles`` of its positions (RoPE over ``qk_rope_head_dim``):
    q_nope (..., H, nope), q_rope (..., H, rope) rotated, the normed latent
    ckv (..., kv_lora_rank) and the rotated shared key krope (..., rope)."""
    H, L = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lead = x.shape[:-1]
    ql = rms_norm(params["q_norm"], dense(params["q_down"], x), cfg.norm_eps)
    q = dense(params["q_up"], ql).view(*lead, H, nope + rope)
    q_nope, q_rope = q[..., :nope], rotate(q[..., nope:], angles)
    c = dense(params["kv_down"], x)
    ckv = rms_norm(params["kv_norm"], c[..., :L], cfg.norm_eps)
    krope = rotate(c[..., L:].unsqueeze(-2), angles).squeeze(-2)
    return q_nope, q_rope, ckv, krope


def mla_key_tile(groups: int, queries: int, n_keys: int, width: int, itemsize: int) -> int:
    """Keys per tile of ``latent_attention``: the largest power of two
    whose working set (``groups`` copies of the tile's latent, ``width``
    elements of ``itemsize`` bytes a key, and the fp32 scores and
    probabilities of ``queries`` query heads a group) fits
    ``MLA_TILE_BYTES``, at least 16 and at most ``n_keys``. It depends
    only on shapes, never on data."""
    per_key = groups * (width * itemsize + queries * 4 * 3)
    tile = 16
    while tile * 2 * per_key <= MLA_TILE_BYTES:
        tile *= 2
    return min(tile, n_keys)


def latent_attention(q_eff, q_rope, q_pos, keys: Callable, n_keys: int, *, scale: float,
                     tile: int):
    """MLA's absorbed attention in the latent space, in key tiles with an
    online softmax. ``q_eff`` (G, M, H, L) are the queries absorbed into the
    latent (``q_nope @ w_uk``), ``q_rope`` (G, M, H, rope), ``q_pos`` (G, M)
    their positions; ``keys(k0, k1)`` gives every group's keys at positions
    k0..k1-1, (G, k1-k0, L + rope) in q's dtype: the latent ckv, then the
    RoPE key. Query (g, m) attends the keys at positions <= ``q_pos[g, m]``;
    every query attends key 0, so the first tile leaves each running max
    finite and a dead key's exp is exactly 0 after it. A score is one
    product over [q_eff | q_rope] and [ckv | krope] drawn in q's dtype and
    scaled in fp32 (JAX draws the two halves' products in q's dtype and
    adds them); probabilities enter the value product in q's dtype; the
    running max, sum and output stay fp32. Returns o_lat (G, M, H, L) in
    q's dtype. No host sync: every shape depends on (G, M, n_keys, tile)
    alone."""
    G, M, H, L = q_eff.shape
    dt, dev = q_eff.dtype, q_eff.device
    q = torch.cat([q_eff, q_rope], dim=-1).reshape(G, M * H, -1)
    limit = q_pos.reshape(G, M, 1, 1)
    m = torch.full((G, M, H), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((G, M, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((G, M * H, L), dtype=torch.float32, device=dev)
    for k0 in range(0, n_keys, tile):
        k1 = min(k0 + tile, n_keys)
        kv = keys(k0, k1)
        s = torch.bmm(q, kv.transpose(1, 2)).float().mul_(scale).view(G, M, H, k1 - k0)
        s.masked_fill_(torch.arange(k0, k1, device=dev) > limit, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s.sub_(m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc.mul_(alpha.view(G, M * H, 1))
        acc.add_(torch.bmm(p.view(G, M * H, k1 - k0).to(dt), kv[..., :L]))
        m = m_new
    return (acc / l_sum.view(G, M * H, 1)).to(dt).view(G, M, H, L)


def expanded_attention(q, ckv, krope, q_pos, w_up, nope: int, *, scale: float):
    """MLA's expanded branch, the counterpart of JAX's ``flash_sdpa`` with
    ``kv_expand``: q (B, T, H, nope + rope) over the latent keys ckv (B, S,
    L) and krope (B, S, rope) at positions 0..S-1, causal by ``q_pos`` (B,
    T). Query blocks of ``EXPANDED_BLOCK``, and within each, key blocks of
    as many keys whose per-head K and V are expanded from the latent
    (``w_up`` (L, H, nope + vh)) and dropped after use, so no K for all
    heads beyond one key block is ever held. fp32 running softmax; returns
    (B, T, H, vh) in q's dtype."""
    B, T, H, _ = q.shape
    S, rope = ckv.shape[1], krope.shape[-1]
    dev = q.device
    outs = []
    blk = EXPANDED_BLOCK
    for q0 in range(0, T, blk):
        qb = q[:, q0:q0 + blk]
        bq = qb.shape[1]
        limit = q_pos[:, None, q0:q0 + blk, None]  # (B, 1, bq, 1)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l_sum = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = None
        for k0 in range(0, S, blk):
            kv = torch.einsum("bsl,lhx->bshx", ckv[:, k0:k0 + blk], w_up)
            bk = kv.shape[1]
            k = torch.cat([kv[..., :nope],
                           krope[:, k0:k0 + bk, None, :].expand(B, bk, H, rope)], dim=-1)
            s = torch.einsum("bthd,bshd->bhts", qb, k).float() * scale
            ok = torch.arange(k0, k0 + bk, device=dev) <= limit  # (B, 1, bq, bk)
            s = s.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(~ok, 0.0)
            alpha = torch.exp(m - m_new)
            l_sum = alpha * l_sum + p.sum(dim=-1)
            pv = torch.einsum("bhts,bshv->bhtv", p.to(kv.dtype), kv[..., nope:]).float()
            acc = pv if acc is None else acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / l_sum.clamp_min(1e-37)[..., None]).to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=1)


def _direct_attention(q, k, v, scale: float):
    """JAX's ``_sdpa`` at one query head a KV head, causal over the call's
    own T keys: fp32 scores and softmax, probabilities in v's dtype."""
    T = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _mla_apply(params, cfg: ModelConfig, x, angles, *, cache=None,
               call: Optional[CacheCall] = None):
    """JAX's ``_mla_apply``: x (B, T, d_model) -> (y, cache), on the branch
    JAX takes (see the module docstring). With a cache, this call's latent
    is written at ``call.index`` first and attended from the cache's copy in
    x's dtype, as JAX does."""
    B, T, _ = x.shape
    H, L = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / ((nope + rope) ** 0.5)
    q_nope, q_rope, ckv, krope = mla_qkv_rope(params, cfg, x, angles)
    w_up = params["kv_up"]["w"].view(L, H, nope + vh).to(x.dtype)

    if cache is None:
        q = torch.cat([q_nope, q_rope], dim=-1)
        if T * T > FLASH_THRESHOLD:
            q_pos = positions_from_index(0, B, T, x.device)
            out = expanded_attention(q, ckv, krope, q_pos, w_up, nope, scale=scale)
        else:
            kv = dense(params["kv_up"], ckv).view(B, T, H, nope + vh)
            k = torch.cat([kv[..., :nope], krope[:, :, None, :].expand(B, T, H, rope)], dim=-1)
            out = _direct_attention(q, k, kv[..., nope:], scale)
        return dense(params["wo"], out.reshape(B, T, H * vh)), None

    cache_write(cache["ckv"], ckv, call.index)
    cache_write(cache["krope"], krope, call.index)
    c, kr = cache["ckv"].to(x.dtype), cache["krope"].to(x.dtype)
    S = c.shape[1]
    q_pos = positions_from_index(call.index, B, T, x.device)
    if T > 1 and T * S > FLASH_THRESHOLD:
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = expanded_attention(q, c, kr, q_pos, w_up, nope, scale=scale)
    else:
        q_eff = torch.einsum("bthn,lhn->bthl", q_nope, w_up[..., :nope])
        ckr = torch.cat([c, kr], dim=-1)
        tile = mla_key_tile(B, T * H, S, L + rope, c.element_size())
        o_lat = latent_attention(q_eff, q_rope, q_pos, lambda k0, k1: ckr[:, k0:k1], S,
                                 scale=scale, tile=tile)
        out = torch.einsum("bthl,lhv->bthv", o_lat, w_up[..., nope:])
    return dense(params["wo"], out.reshape(B, T, H * vh)), cache
