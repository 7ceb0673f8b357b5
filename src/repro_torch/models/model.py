"""Decoder-only GQA model: parameters, seeded init, and the KV page pool.

The PyTorch counterpart of the JAX package's ``Model`` for the archs the
port serves so far (attention mixers, dense FFNs, no MLA/MoE/enc-dec). The
parameter tree follows ``Model.init`` / ``stack.layer_init`` /
``attention.attn_init`` key for key, except that layers are a Python list in
layer order where JAX stacks them over scan periods.

Parameters live on the model's device in the model's dtype (JAX keeps fp32
masters and casts at use; serving has no optimizer, so the port stores what
it computes with).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    dense_init,
    ffn_init,
    rms_norm_init,
    rope_freqs,
    truncated_normal,
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configs whose model path is not ported yet."""
    if cfg.encdec or any(s.mixer != "attn" for s in cfg.layer_specs):
        raise NotImplementedError(
            f"{cfg.name}: SSM / hybrid / enc-dec models run the two-call path, "
            "not ported yet (ROADMAP.md A9)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP.md, deepseek-v2 slice)")
    if any(s.ffn == "moe" for s in cfg.layer_specs):
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP.md, qwen3-moe slice)")
    if cfg.learned_pos or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: learned positions / frontends are not ported yet")


def _layer_init(cfg: ModelConfig, spec, *, generator, dtype, device):
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, hd = cfg.d_model, cfg.head_dim
    mixer = {
        "wq": dense_init(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(cfg.n_heads * hd, d, **kw),
    }
    if cfg.qk_norm:
        mixer["q_norm"] = rms_norm_init(hd, dtype=dtype, device=device)
        mixer["k_norm"] = rms_norm_init(hd, dtype=dtype, device=device)
    p = {"norm1": rms_norm_init(d, dtype=dtype, device=device), "mixer": mixer}
    if cfg.post_norm:
        p["post_norm1"] = rms_norm_init(d, dtype=dtype, device=device)
    if spec.ffn != "none":
        p["norm2"] = rms_norm_init(d, dtype=dtype, device=device)
        p["ffn"] = ffn_init(d, cfg.d_ff, glu=cfg.glu, **kw)
        if cfg.post_norm:
            p["post_norm2"] = rms_norm_init(d, dtype=dtype, device=device)
    return p


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    dtype: torch.dtype = torch.float32
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    def __post_init__(self):
        check_supported(self.cfg)
        self.device = torch.device(self.device)
        cfg = self.cfg
        self.inv_freq = rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta,
                                   device=self.device)

    def init(self, generator: torch.Generator):
        """Seeded random parameters on the model's device and dtype:
        truncated normal, std 0.02 for the embedding and LM head and
        1/sqrt(d_in) for dense layers; norm scales are ones."""
        cfg = self.cfg
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        params = {
            "embed": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02, **kw),
            "layers": [_layer_init(cfg, spec, **kw) for spec in cfg.layer_specs],
            "final_norm": rms_norm_init(cfg.d_model, dtype=self.dtype, device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = truncated_normal((cfg.d_model, cfg.vocab_size), 0.02, **kw)
        return params

    def init_page_pool(self, num_pages: int, page_size: int,
                       dtype: Optional[torch.dtype] = None):
        """Physical KV page pool: per layer, K and V pools of shape
        ``(num_pages + 1, page_size, n_kv_heads, head_dim)``. The extra page
        is the scratch page that dead block-table entries and padding rows
        point at. Zero-filled, like the reference's ``init_cache``."""
        cfg = self.cfg
        shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
        dt = dtype if dtype is not None else self.dtype
        return [
            {"k": torch.zeros(shape, dtype=dt, device=self.device),
             "v": torch.zeros(shape, dtype=dt, device=self.device)}
            for _ in cfg.layer_specs
        ]


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                device="cuda") -> Model:
    return Model(cfg=cfg, dtype=dtype, device=torch.device(device))
