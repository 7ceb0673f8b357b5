"""The decoder stack of the serial execution path.

The PyTorch counterpart of the JAX package's ``models/stack.py`` for
attention (GQA or MLA), Mamba2 and Mamba1 mixers, with dense FFNs, MoE FFNs
(whose auxiliary loss is dropped until training needs it) or none. JAX stacks each period
position's parameters and caches over periods and walks them with
``lax.scan``; the port keeps one entry per layer in layer order
(``Model.init``'s ``"layers"``, and the per-layer cache list below) and walks
them with a Python loop.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import CacheCall, attn_apply, kv_cache_init
from repro_torch.models.layers import ffn, rms_norm
from repro_torch.models.mamba import (
    mamba1_apply,
    mamba1_state_init,
    mamba2_apply,
    mamba2_state_init,
)
from repro_torch.models.moe import moe_apply


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, *,
                     dtype: torch.dtype, device) -> dict:
    """Attention: a dense KV cache (MLA: its latent) in ``dtype``; Mamba2
    and Mamba1: the fp32 state (as in JAX, whatever ``dtype``)."""
    if spec.mixer == "attn":
        return kv_cache_init(cfg, batch, max_len, dtype=dtype, device=device)
    if spec.mixer == "mamba2":
        return mamba2_state_init(cfg, batch, device=device)
    if spec.mixer == "mamba1":
        return mamba1_state_init(cfg, batch, device=device)
    raise ValueError(spec.mixer)


def layer_apply(p, cfg: ModelConfig, spec: LayerSpec, h, angles, *, cache=None,
                call: Optional[CacheCall] = None):
    """Returns (h, cache)."""
    hn = rms_norm(p["norm1"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        y, cache = attn_apply(p["mixer"], cfg, spec, hn, angles, cache=cache, call=call)
    elif spec.mixer == "mamba2":
        y, cache = mamba2_apply(p["mixer"], cfg, hn, state=cache)
    else:
        y, cache = mamba1_apply(p["mixer"], cfg, hn, state=cache)
    if cfg.post_norm:
        y = rms_norm(p["post_norm1"], y, cfg.norm_eps)
    h = h + y
    if spec.ffn != "none":
        hn = rms_norm(p["norm2"], h, cfg.norm_eps)
        if spec.ffn == "dense":
            y = ffn(p["ffn"], hn, cfg.act, cfg.glu)
        else:
            y, _ = moe_apply(p["ffn"], cfg, hn)
        if cfg.post_norm:
            y = rms_norm(p["post_norm2"], y, cfg.norm_eps)
        h = h + y
    # JAX shards the residual here (shard_act); without a mesh that is a
    # no-op, and the port runs on one card
    return h, cache


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, dtype: torch.dtype,
                     device) -> List[dict]:
    """One zeroed cache per layer: ``{"k", "v"}`` of (batch, max_len, KV, d)
    for GQA attention, ``{"ckv", "krope"}`` of (batch, max_len, .) for MLA,
    ``{"conv", "ssm"}`` for Mamba2 and Mamba1."""
    return [layer_cache_init(cfg, spec, batch, max_len, dtype=dtype, device=device)
            for spec in cfg.layer_specs]


def stack_apply(layers, cfg: ModelConfig, h, angles, *, caches=None,
                call: Optional[CacheCall] = None):
    """Returns (h, caches): the given per-layer caches, written in place, or
    None. ``angles`` and ``call`` are built once for all layers."""
    for i, (p, spec) in enumerate(zip(layers, cfg.layer_specs)):
        h, _ = layer_apply(p, cfg, spec, h, angles,
                           cache=None if caches is None else caches[i], call=call)
    return h, caches
