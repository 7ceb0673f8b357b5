"""Decoder-only model: parameters, seeded init, the serial execution path
and the KV page pool.

The PyTorch counterpart of the JAX package's ``Model`` for the archs the
port serves so far (GQA attention and Mamba2 mixers, dense FFNs or none; no
MLA/MoE/Mamba1/enc-dec). The parameter tree follows ``Model.init`` /
``stack.layer_init`` / ``attention.attn_init`` / ``mamba.mamba2_init`` key
for key, except that layers are a Python list in layer order where JAX
stacks them over scan periods.

The serial path is JAX's: ``forward`` (one-shot causal), ``init_cache``,
``prefill`` and ``decode_step`` over per-layer caches (a dense ``(B,
max_len, KV, d)`` KV cache for attention, the conv and SSM state for
Mamba2), which they update in place and return. ``index`` is an int (one
offset for every row) or a ``(B,)`` tensor (one per row). ``loss`` waits for
training.

Parameters live on the model's device in the model's dtype (JAX keeps fp32
masters and casts at use; serving has no optimizer, so the port stores what
it computes with), except Mamba2's ``mamba.FP32_LEAVES``, which JAX uses in
fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack
from repro_torch.models.attention import Index, cache_call
from repro_torch.models.layers import (
    dense_init,
    ffn_init,
    rms_norm,
    rms_norm_init,
    rope_angles,
    rope_freqs,
    softcap,
    truncated_normal,
)
from repro_torch.models.mamba import mamba2_init


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configs whose model path is not ported yet."""
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (models/encdec.py, whisper-small) are not "
            "ported yet (ROADMAP.md A9)")
    if any(s.mixer not in ("attn", "mamba2") for s in cfg.layer_specs):
        raise NotImplementedError(
            f"{cfg.name}: Mamba1 mixers (jamba-v0.1-52b) are not ported yet (ROADMAP.md A9)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP.md, deepseek-v2 slice)")
    if any(s.ffn == "moe" for s in cfg.layer_specs):
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP.md, qwen3-moe slice)")
    if cfg.learned_pos or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: learned positions / frontends are not ported yet")


def _positions_from_index(index: Index, B: int, T: int, device) -> torch.Tensor:
    """(B, T) int32 positions of T tokens written at ``index``."""
    steps = torch.arange(T, dtype=torch.int32, device=device)
    if isinstance(index, int):
        return (index + steps)[None, :].expand(B, T)
    return index.to(torch.int32)[:, None] + steps[None, :]


def _as_index(index: Index) -> Index:
    """A 0-d tensor index becomes an int (one offset for every row)."""
    if isinstance(index, torch.Tensor) and index.dim() == 0:
        return int(index)
    return index


def _attn_init(cfg: ModelConfig, *, generator, dtype, device):
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
    return mixer


def _layer_init(cfg: ModelConfig, spec, *, generator, dtype, device):
    kw = dict(generator=generator, dtype=dtype, device=device)
    d = cfg.d_model
    init = _attn_init if spec.mixer == "attn" else mamba2_init
    p = {"norm1": rms_norm_init(d, dtype=dtype, device=device), "mixer": init(cfg, **kw)}
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
        # attention-free configs (n_heads = head_dim = 0) build no RoPE
        self.inv_freq = (rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta,
                                    device=self.device) if cfg.n_attn_layers else None)

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

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens.long()].to(self.dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=self.dtype)
        return x

    def _head(self, params, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the final-normed hidden states ``h``."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return softcap((h @ w.to(h.dtype)).float(), self.cfg.final_logit_softcap)

    # ---------------------------------------------------------------- serial
    @torch.inference_mode()
    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence causal logits (B, S, vocab), fp32, of
        ``batch["tokens"]`` (B, S). (JAX also returns the MoE auxiliary loss,
        which is 0 without MoE.)"""
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = _positions_from_index(0, B, S, self.device)
        h, _ = stack.stack_apply(params["layers"], self.cfg, self._embed(params, tokens),
                                 rope_angles(positions, self.inv_freq))
        return self._head(params, rms_norm(params["final_norm"], h, self.cfg.norm_eps))

    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None):
        """Zeroed per-layer caches: a dense KV cache ``{"k", "v"}`` of (batch,
        max_len, KV, d) in ``dtype`` (default: the model's) per attention
        layer, an fp32 ``{"conv", "ssm"}`` state per Mamba2 layer."""
        return stack.stack_cache_init(self.cfg, batch, max_len,
                                      dtype=dtype if dtype is not None else self.dtype,
                                      device=self.device)

    def _run(self, params, tokens, cache, index: Index):
        """The last position's logits (B, vocab) of ``tokens`` (B, T)
        written into ``cache`` at ``index``."""
        B, T = tokens.shape
        index = _as_index(index)
        cfg = self.cfg
        positions = _positions_from_index(index, B, T, self.device)
        # what every layer shares is built once: RoPE angles and the
        # attention's metadata (none without attention layers)
        call = (cache_call(index, B, T, cfg.n_heads // cfg.n_kv_heads, self.device)
                if cfg.n_attn_layers else None)
        h, cache = stack.stack_apply(params["layers"], cfg, self._embed(params, tokens),
                                     rope_angles(positions, self.inv_freq), caches=cache,
                                     call=call)
        h = rms_norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        return self._head(params, h)[:, 0], cache

    @torch.inference_mode()
    def prefill(self, params, batch, cache, index: Index):
        """Run a (chunked) prefill of ``batch["tokens"]`` (B, T) at
        ``index``; returns (last-position logits (B, vocab), cache)."""
        return self._run(params, batch["tokens"], cache, index)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, index: Index):
        """tokens: (B, 1) -> (logits (B, vocab), cache)."""
        return self._run(params, tokens, cache, index)

    # ------------------------------------------------------------- page pool
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
