"""The model: parameters, seeded init, the serial execution path and the
KV page pool.

The PyTorch counterpart of the JAX package's ``Model`` for every arch it
registers: GQA, MLA, Mamba2 and Mamba1 mixers, alone or interleaved as in
jamba; dense FFNs, MoE FFNs or none; learned positions and frontend
embeddings prepended to the text (internvl2's stub); and whisper's
encoder-decoder (``models/encdec.py``). The parameter tree follows
``Model.init`` / ``stack.layer_init`` / ``attention.attn_init`` /
``mamba.mamba2_init`` / ``mamba.mamba1_init`` / ``moe.moe_init`` /
``encdec.encdec_init`` key for key, except that layers are a Python list in
layer order where JAX stacks them over scan periods.

The serial path is JAX's: ``forward`` (one-shot causal), ``init_cache``,
``prefill`` and ``decode_step`` over per-layer caches (a dense ``(B,
max_len, KV, d)`` KV cache for GQA attention, MLA's ``(B, max_len, .)``
latent, the conv and SSM state for Mamba2 and Mamba1; an enc-dec decoder
layer's self and cross K/V), which they update in place and return.
``index`` is an int (one offset for every row) or a ``(B,)`` tensor (one per
row). ``batch`` is a dict: ``{"tokens": (B, T)[, "frontend_embeds": (B, F,
d)][, "frames": (B, F, d)]}``. ``loss`` waits for training.

Parameters live on the model's device in the model's dtype (JAX keeps fp32
masters and casts at use; serving has no optimizer, so the port stores what
it computes with), except the Mamba mixers' ``mamba.FP32_LEAVES``, which JAX
uses in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, stack
from repro_torch.models.attention import (
    CacheCall,
    Index,
    attn_init,
    cache_call,
    positions_from_index,
)
from repro_torch.models.layers import (
    ffn_init,
    rms_norm,
    rms_norm_init,
    rope_angles,
    rope_freqs,
    softcap,
    truncated_normal,
)
from repro_torch.models.mamba import mamba1_init, mamba2_init
from repro_torch.models.moe import moe_init


def _as_index(index: Index) -> Index:
    """A 0-d tensor index becomes an int (one offset for every row)."""
    if isinstance(index, torch.Tensor) and index.dim() == 0:
        return int(index)
    return index


def page_leaves(cfg: ModelConfig, page_size: int) -> dict:
    """Each attention layer's page-pool leaves, name -> one page's shape:
    K and V of ``(page, KV, d)``, or MLA's latent, ckv ``(page,
    kv_lora_rank)`` and krope ``(page, qk_rope_head_dim)``."""
    if cfg.mla:
        return {"ckv": (page_size, cfg.kv_lora_rank),
                "krope": (page_size, cfg.qk_rope_head_dim)}
    kv = (page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def _layer_init(cfg: ModelConfig, spec, *, generator, dtype, device):
    kw = dict(generator=generator, dtype=dtype, device=device)
    d = cfg.d_model
    init = {"attn": attn_init, "mamba2": mamba2_init, "mamba1": mamba1_init}[spec.mixer]
    p = {"norm1": rms_norm_init(d, dtype=dtype, device=device), "mixer": init(cfg, **kw)}
    if cfg.post_norm:
        p["post_norm1"] = rms_norm_init(d, dtype=dtype, device=device)
    if spec.ffn != "none":
        p["norm2"] = rms_norm_init(d, dtype=dtype, device=device)
        p["ffn"] = (moe_init(cfg, **kw) if spec.ffn == "moe" else
                    ffn_init(d, cfg.d_ff, glu=cfg.glu, **kw))
        if cfg.post_norm:
            p["post_norm2"] = rms_norm_init(d, dtype=dtype, device=device)
    return p


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    dtype: torch.dtype = torch.float32
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    def __post_init__(self):
        self.device = torch.device(self.device)
        cfg = self.cfg
        # MLA rotates only its qk_rope_head_dim dims; attention-free configs
        # (n_heads = head_dim = 0) build no RoPE
        if cfg.mla:
            self.inv_freq = rope_freqs(cfg.qk_rope_head_dim, 1.0, cfg.rope_theta,
                                       device=self.device)
        elif cfg.n_attn_layers:
            self.inv_freq = rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta,
                                       device=self.device)
        else:
            self.inv_freq = None

    def init(self, generator: torch.Generator):
        """Seeded random parameters on the model's device and dtype:
        truncated normal, std 0.02 for the embedding and LM head and
        1/sqrt(d_in) for dense layers; norm scales are ones."""
        cfg = self.cfg
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        if cfg.encdec:
            return encdec.encdec_init(cfg, **kw)
        params = {
            "embed": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02, **kw),
            "layers": [_layer_init(cfg, spec, **kw) for spec in cfg.layer_specs],
            "final_norm": rms_norm_init(cfg.d_model, dtype=self.dtype, device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = truncated_normal((cfg.d_model, cfg.vocab_size), 0.02, **kw)
        if cfg.learned_pos:
            params["pos"] = truncated_normal((cfg.max_seq_len, cfg.d_model), 0.01, **kw)
        return params

    # ------------------------------------------------------------- embeddings
    def _embed(self, params, tokens: torch.Tensor, frontend_embeds=None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, with ``frontend_embeds`` (B, F, d) prepended and,
        for ``learned_pos``, the table's rows at ``positions`` added."""
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(self.dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=self.dtype)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(device=x.device, dtype=self.dtype), x], dim=1)
        if cfg.learned_pos and positions is not None:
            pos = positions.clamp(0, cfg.max_seq_len - 1).long()
            x = x + params["pos"][pos].to(self.dtype)
        return x

    def _head(self, params, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the final-normed hidden states ``h``."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return softcap((h @ w.to(h.dtype)).float(), self.cfg.final_logit_softcap)

    # ---------------------------------------------------------------- serial
    @torch.inference_mode()
    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence causal logits (B, S, vocab), fp32, of
        ``batch["tokens"]`` (B, S): after ``frontend_embeds`` (B, F, d),
        whose F positions come first and whose logits are dropped; or, for
        an enc-dec arch, over the encoding of ``batch["frames"]``. (JAX also
        returns the MoE auxiliary loss; the port drops it until ``loss`` is
        ported with training.)"""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if cfg.encdec:
            cross = encdec.cross_kv_all(params, cfg, self._encode(params, batch))
            positions = positions_from_index(0, B, S, self.device)
            h = encdec.decode_trunk(params, cfg, tokens, positions, cross=cross)
            return self._encdec_logits(params, h)
        fe = batch.get("frontend_embeds")
        F = fe.shape[1] if fe is not None else 0
        positions = positions_from_index(0, B, F + S, self.device)
        h, _ = stack.stack_apply(params["layers"], cfg, self._embed(params, tokens, fe, positions),
                                 rope_angles(positions, self.inv_freq))
        return self._head(params, rms_norm(params["final_norm"], h[:, F:], cfg.norm_eps))

    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None):
        """Zeroed per-layer caches: a dense KV cache ``{"k", "v"}`` of (batch,
        max_len, KV, d) (MLA: the latent ``{"ckv", "krope"}`` of (batch,
        max_len, .)) in ``dtype`` (default: the model's) per attention
        layer, an fp32 ``{"conv", "ssm"}`` state per Mamba2 or Mamba1 layer;
        for an enc-dec arch ``encdec.dec_cache_init``'s dict a decoder
        layer, the cross K/V ``{"cross_k", "cross_v"}`` beside ``{"k",
        "v"}``."""
        dt = dtype if dtype is not None else self.dtype
        if self.cfg.encdec:
            return encdec.dec_cache_init(self.cfg, batch, max_len, dtype=dt, device=self.device)
        return stack.stack_cache_init(self.cfg, batch, max_len, dtype=dt, device=self.device)

    def embeds_row(self, x=None) -> torch.Tensor:
        """One request's (F, d_model) frame or frontend embeddings (numpy or
        a tensor) as a (1, F, d_model) batch row on the model's device;
        None gives zeros of ``frontend_len`` rows, as JAX's engine encodes
        a request that brought no frames."""
        if x is None:
            return torch.zeros((1, self.cfg.frontend_len, self.cfg.d_model), dtype=self.dtype,
                               device=self.device)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device)[None]

    def _encode(self, params, batch) -> torch.Tensor:
        return encdec.encode(params, self.cfg,
                             batch["frames"].to(device=self.device, dtype=self.dtype))

    @staticmethod
    def _encdec_logits(params, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the tied embedding, no softcap (JAX's enc-dec
        head)."""
        return (h @ params["embed"].T.to(h.dtype)).float()

    def _run(self, params, tokens, cache, index: Index, frontend_embeds=None):
        """The last position's logits (B, vocab) of ``tokens`` (B, T),
        after ``frontend_embeds`` (B, F, d) if given, written into ``cache``
        at ``index`` (the F embeddings first)."""
        B, T = tokens.shape
        index = _as_index(index)
        cfg = self.cfg
        T += frontend_embeds.shape[1] if frontend_embeds is not None else 0
        positions = positions_from_index(index, B, T, self.device)
        call = self._cache_call(index, B, T)
        x = self._embed(params, tokens, frontend_embeds, positions)
        h, cache = stack.stack_apply(params["layers"], cfg, x,
                                     rope_angles(positions, self.inv_freq), caches=cache,
                                     call=call)
        h = rms_norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        return self._head(params, h)[:, 0], cache

    def _cache_call(self, index: Index, B: int, T: int) -> Optional[CacheCall]:
        """What every attention layer of a call shares, built once: its
        ``CacheCall`` (none without attention layers; MLA's attention needs
        only the index)."""
        cfg = self.cfg
        if cfg.mla:
            return CacheCall(index)
        if cfg.n_attn_layers:
            return cache_call(index, B, T, cfg.n_heads // cfg.n_kv_heads, self.device)
        return None

    def _run_encdec(self, params, tokens, cache, index: Index):
        """The decoder over ``tokens`` (B, T) at ``index`` against the cross
        K/V in ``cache``; the last position's logits."""
        B, T = tokens.shape
        index = _as_index(index)
        positions = positions_from_index(index, B, T, self.device)
        h = encdec.decode_trunk(params, self.cfg, tokens, positions,
                                cross=encdec.cache_cross(cache), caches=cache,
                                call=self._cache_call(index, B, T))
        return self._encdec_logits(params, h[:, -1]), cache

    @torch.inference_mode()
    def prefill(self, params, batch, cache, index: Index):
        """Run a (chunked) prefill of ``batch["tokens"]`` (B, T) at
        ``index``; returns (last-position logits (B, vocab), cache). With
        ``batch["frontend_embeds"]`` the embeddings go first, at positions
        ``index``.. ``index + F - 1``. An enc-dec arch encodes
        ``batch["frames"]`` on every call, as JAX does, and writes each
        decoder layer's cross K/V into the cache's rows first."""
        if self.cfg.encdec:
            encdec.write_cross(cache, encdec.cross_kv_all(params, self.cfg,
                                                          self._encode(params, batch)))
            return self._run_encdec(params, batch["tokens"], cache, index)
        return self._run(params, batch["tokens"], cache, index, batch.get("frontend_embeds"))

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, index: Index):
        """tokens: (B, 1) -> (logits (B, vocab), cache)."""
        if self.cfg.encdec:
            return self._run_encdec(params, tokens, cache, index)
        return self._run(params, tokens, cache, index)

    # ------------------------------------------------------------- page pool
    def init_page_pool(self, num_pages: int, page_size: int,
                       dtype: Optional[torch.dtype] = None):
        """Physical KV page pool: per layer, K and V pools of shape
        ``(num_pages + 1, page_size, n_kv_heads, head_dim)``, or MLA's latent
        pools ckv ``(num_pages + 1, page_size, kv_lora_rank)`` and krope
        ``(num_pages + 1, page_size, qk_rope_head_dim)`` (``page_leaves``).
        The extra page is the scratch page that dead block-table entries and
        padding rows point at. Zero-filled, like the reference's
        ``init_cache``."""
        dt = dtype if dtype is not None else self.dtype
        leaves = page_leaves(self.cfg, page_size)
        return [{name: torch.zeros((num_pages + 1,) + shape, dtype=dt, device=self.device)
                 for name, shape in leaves.items()}
                for _ in self.cfg.layer_specs]


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                device="cuda") -> Model:
    return Model(cfg=cfg, dtype=dtype, device=torch.device(device))
