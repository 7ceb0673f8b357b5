"""Reduced (smoke-test) variants: same structure, tiny dims.

Smoke tests instantiate these on CPU and run one forward/train step. The
reduction preserves everything structural — layer-type pattern, scan period,
MLA/MoE/SSM plumbing, softcaps, biases — and shrinks only widths/counts.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def dropless(cfg: ModelConfig) -> ModelConfig:
    """Variant whose MoE dispatch never drops tokens (serving / exactness tests)."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))


def reduce_config(cfg: ModelConfig, *, periods: int = 1, vocab: int = 256) -> ModelConfig:
    n_layers = cfg.n_prefix_layers + cfg.scan_period * min(cfg.n_periods, periods)
    layer_specs = cfg.layer_specs[:n_layers]
    has_attn = any(s.mixer == "attn" for s in layer_specs)
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        layer_specs=layer_specs,
        d_model=64,
        vocab_size=vocab,
        d_ff=128 if cfg.d_ff else 0,
        frontend_len=8 if cfg.frontend else 0,
        n_enc_layers=2 if cfg.encdec else 0,
        max_seq_len=512,
        local_window=16 if cfg.local_window else None,
    )
    if has_attn:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16)
    if cfg.mla:
        kw.update(
            n_heads=4,
            n_kv_heads=4,
            head_dim=16,
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.n_experts:
        kw.update(
            n_experts=min(8, cfg.n_experts),
            top_k=min(2, cfg.top_k),
            moe_d_ff=64,
            shared_d_ff=64 if cfg.n_shared_experts else 0,
        )
    if any(s.mixer in ("mamba1", "mamba2") for s in layer_specs):
        kw.update(m_d_state=16, m_headdim=8, m_d_state_m1=8)
    return dataclasses.replace(cfg, **kw)
