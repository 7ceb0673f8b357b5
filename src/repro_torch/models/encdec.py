"""Whisper-style encoder-decoder (the conv audio frontend is a stub).

The PyTorch counterpart of the JAX package's ``models/encdec.py``, function
for function. The encoder takes precomputed frame embeddings (B, F,
d_model) plus sinusoidal positions through bidirectional self-attention (B4
with ``causal`` off) and a biased GeLU FFN. The decoder adds learned
positions to its token embeddings and runs, per layer, causal
self-attention over its cache (``attention.attn_apply`` with a
``CacheCall``: B4 for a prompt at index 0, B1 for a later chunk, B3 for a
decode step; no RoPE), cross-attention over the encoder's K/V (B4 for
T > 1, B3 for T == 1) and the FFN. LayerNorm everywhere.

JAX stacks the layers over a scan; the port keeps them as Python lists in
layer order. A decoder layer's cache is one flat dict, ``{"k", "v"}`` of
(B, max_len, KV, d) beside ``{"cross_k", "cross_v"}`` of (B, F, KV, d),
where JAX keeps ``{"self", "cross"}`` trees: every leaf has its batch row on
axis 0, so the two-call engine slices, zeros, gathers and swaps them alike.
JAX's decoder runs in its fp32 parameters' dtype; the port's in the
model's dtype (the same in fp32).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    CacheCall,
    _attend,
    attn_apply,
    attn_init,
    cross_attn_apply,
    cross_attn_init,
    cross_call,
    cross_kv,
    kv_cache_init,
)
from repro_torch.models.layers import dense, ffn, ffn_init, layer_norm, layer_norm_init
from repro_torch.models.layers import truncated_normal


@functools.lru_cache(maxsize=8)
def _sinusoids(length: int, channels: int, device: str) -> torch.Tensor:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def sinusoids(length: int, channels: int, device="cpu") -> torch.Tensor:
    """(length, channels) fp32 positions: computed in float64 by numpy, then
    rounded to fp32, as JAX's ``sinusoids`` does; made once a device (every
    prefill segment encodes its frames)."""
    return _sinusoids(length, channels, str(torch.device(device)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _enc_layer_init(cfg: ModelConfig, **kw):
    d = cfg.d_model
    norm = dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "norm1": layer_norm_init(d, **norm),
        "attn": attn_init(cfg, **kw),
        "norm2": layer_norm_init(d, **norm),
        "ffn": ffn_init(d, cfg.d_ff, glu=cfg.glu, bias=True, **kw),
    }


def _dec_layer_init(cfg: ModelConfig, **kw):
    d = cfg.d_model
    norm = dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "norm1": layer_norm_init(d, **norm),
        "self_attn": attn_init(cfg, **kw),
        "norm_x": layer_norm_init(d, **norm),
        "cross_attn": cross_attn_init(cfg, **kw),
        "norm2": layer_norm_init(d, **norm),
        "ffn": ffn_init(d, cfg.d_ff, glu=cfg.glu, bias=True, **kw),
    }


def encdec_init(cfg: ModelConfig, *, generator, dtype, device) -> dict:
    """JAX's ``encdec_init`` tree, the layers as lists: ``enc`` and ``dec``,
    ``enc_norm``, ``dec_norm``, ``embed`` (std 0.02) and ``pos_dec``
    (max_seq_len, d_model; std 0.01)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    norm = dict(dtype=dtype, device=device)
    return {
        "enc": [_enc_layer_init(cfg, **kw) for _ in range(cfg.n_enc_layers)],
        "dec": [_dec_layer_init(cfg, **kw) for _ in range(cfg.n_layers)],
        "enc_norm": layer_norm_init(cfg.d_model, **norm),
        "dec_norm": layer_norm_init(cfg.d_model, **norm),
        "embed": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02, **kw),
        "pos_dec": truncated_normal((cfg.max_seq_len, cfg.d_model), 0.01, **kw),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings -> (B, F, d_model)."""
    B, F, _ = frames.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = frames + sinusoids(F, cfg.d_model, frames.device).to(frames.dtype)
    for p in params["enc"]:
        hn = layer_norm(p["norm1"], h, cfg.norm_eps)
        q = dense(p["attn"]["wq"], hn).view(B, F, H, hd)
        k = dense(p["attn"]["wk"], hn).view(B, F, KV, hd)
        v = dense(p["attn"]["wv"], hn).view(B, F, KV, hd)
        o = _attend(q, k, v, None, None, None, causal=False)  # bidirectional
        h = h + dense(p["attn"]["wo"], o.reshape(B, F, H * hd))
        hn = layer_norm(p["norm2"], h, cfg.norm_eps)
        h = h + ffn(p["ffn"], hn, cfg.act, cfg.glu)
    return layer_norm(params["enc_norm"], h, cfg.norm_eps)


def cross_kv_all(params, cfg: ModelConfig, enc_out) -> List[dict]:
    """Each decoder layer's cross-attention K/V, ``{"k", "v"}`` of (B, F,
    KV, d)."""
    return [cross_kv(p["cross_attn"], cfg, enc_out) for p in params["dec"]]


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def dec_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, dtype: torch.dtype,
                   device) -> List[dict]:
    """One zeroed flat dict a decoder layer: self K/V ``{"k", "v"}`` of
    (batch, max_len, KV, d) and cross K/V ``{"cross_k", "cross_v"}`` of
    (batch, frontend_len, KV, d), in ``dtype``."""
    cross = (batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim)
    return [dict(kv_cache_init(cfg, batch, max_len, dtype=dtype, device=device),
                 cross_k=torch.zeros(cross, dtype=dtype, device=device),
                 cross_v=torch.zeros(cross, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def write_cross(caches: List[dict], cross: List[dict]) -> None:
    """Copy ``cross_kv_all``'s K/V into the caches' cross leaves, in place,
    in the caches' dtype."""
    for c, kv in zip(caches, cross):
        c["cross_k"].copy_(kv["k"])
        c["cross_v"].copy_(kv["v"])


def decode_trunk(params, cfg: ModelConfig, tokens, positions, *, cross: List[dict],
                 caches: Optional[List[dict]] = None, call: Optional[CacheCall] = None):
    """The decoder stack over ``tokens`` (B, T) at ``positions`` (B, T).
    ``cross``: each layer's cross K/V. With ``caches`` (the flat per-layer
    dicts, written in place) ``call`` says where the tokens go; without,
    self-attention is causal over the call's own tokens. Returns the
    ``dec_norm``-ed hidden states (B, T, d_model)."""
    B, T = tokens.shape
    embed = params["embed"]
    x = embed[tokens.long()]
    pos = positions.clamp(0, cfg.max_seq_len - 1).long()
    h = x + params["pos_dec"][pos].to(x.dtype)
    spec = cfg.layer_specs[0]
    # a decode step's cross-attention reads every encoder key: its B3
    # lengths are built once for all layers
    x_call = cross_call(B, cross[0]["k"].shape[1], h.device) if T == 1 else None
    for i, p in enumerate(params["dec"]):
        hn = layer_norm(p["norm1"], h, cfg.norm_eps)
        self_kv = None if caches is None else {"k": caches[i]["k"], "v": caches[i]["v"]}
        y, _ = attn_apply(p["self_attn"], cfg, spec, hn, None, cache=self_kv, call=call)
        h = h + y
        hn = layer_norm(p["norm_x"], h, cfg.norm_eps)
        h = h + cross_attn_apply(p["cross_attn"], cfg, hn, cross[i], x_call)
        hn = layer_norm(p["norm2"], h, cfg.norm_eps)
        h = h + ffn(p["ffn"], hn, cfg.act, cfg.glu)
    return layer_norm(params["dec_norm"], h, cfg.norm_eps)


def cache_cross(caches: List[dict]) -> List[dict]:
    """The caches' cross leaves as ``decode_trunk``'s ``cross``."""
    return [{"k": c["cross_k"], "v": c["cross_v"]} for c in caches]
