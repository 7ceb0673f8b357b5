"""Model configuration schema + registry for all assigned architectures.

Every architecture in the pool is expressed as a ModelConfig: a flat,
hashable description of the decoder stack (and optional encoder), rich
enough to drive model construction, KV-cache layout, sharding rules, the
analytical simulator, and the dry-run input specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence mixer + a channel mixer."""

    mixer: str = "attn"  # "attn" | "mamba1" | "mamba2"
    ffn: str = "dense"  # "dense" | "moe" | "none"
    attn_kind: str = "full"  # "full" | "local" (sliding window)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # provenance note ([arXiv:...; tier])

    # -- core dims ---------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # explicit (qwen3/gemma2 use head_dim != d_model//n_heads)
    d_ff: int = 0
    vocab_size: int = 0

    # -- attention flavor --------------------------------------------------
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # fraction of head_dim that is rotated (chatglm: 0.5)
    qk_norm: bool = False  # per-head RMSNorm on q and k (qwen3)
    qkv_bias: bool = False  # qwen2 / chatglm3
    attn_logit_softcap: Optional[float] = None  # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    local_window: Optional[int] = None  # sliding-window size for "local" layers

    # -- MLA (deepseek-v2) ---------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    # GShard capacity factor. 1.25 = standard training/dry-run setting (drops
    # over-capacity tokens, keeps compiled FLOPs ∝ top_k). Serving and the
    # decode-consistency tests use dropless_moe() -> capacity = top_k * N.
    moe_capacity_factor: float = 1.25

    # -- SSM (mamba) ---------------------------------------------------------
    m_d_state: int = 0
    m_headdim: int = 64
    m_n_groups: int = 1
    m_conv: int = 4
    m_expand: int = 2
    m_d_state_m1: int = 16  # mamba1 state size (jamba)

    # -- encoder-decoder / frontends ------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None  # None | "audio" | "vision" (stubbed)
    frontend_len: int = 0  # stub sequence length fed to encoder / prepended

    # -- misc ------------------------------------------------------------------
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU / plain)
    glu: bool = True  # gated FFN
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2: extra norms after attn/ffn
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma2: embed * sqrt(d_model)
    norm_topk: bool = True  # normalize top-k router probs (qwen3-moe); deepseek: False
    learned_pos: bool = False  # whisper decoder: learned absolute positions
    max_seq_len: int = 131072

    # -- stack structure ---------------------------------------------------
    layer_specs: Tuple[LayerSpec, ...] = ()
    n_prefix_layers: int = 0  # unrolled leading layers (deepseek-v2 dense layer 0)
    scan_period: int = 1  # scan unit size over the remaining layers

    # -- distribution switches (launchers/dry-run set these via replace) ----
    # sequence-parallel flash-decoding over the data axis for batch-1
    # long-context decode (distributed/sp_attention.py)
    sp_decode: bool = False

    def __post_init__(self):
        if not self.layer_specs:
            object.__setattr__(
                self, "layer_specs", tuple(LayerSpec() for _ in range(self.n_layers))
            )
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        self.validate()

    # -- structure ----------------------------------------------------------
    def validate(self) -> None:
        assert len(self.layer_specs) == self.n_layers, (
            f"{self.name}: {len(self.layer_specs)} specs != {self.n_layers} layers"
        )
        body = self.n_layers - self.n_prefix_layers
        assert body % self.scan_period == 0, (
            f"{self.name}: body {body} not divisible by period {self.scan_period}"
        )
        # the scanned body must actually be periodic
        period = self.layer_specs[self.n_prefix_layers : self.n_prefix_layers + self.scan_period]
        for i in range(self.n_prefix_layers, self.n_layers):
            expect = period[(i - self.n_prefix_layers) % self.scan_period]
            assert self.layer_specs[i] == expect, (
                f"{self.name}: layer {i} spec {self.layer_specs[i]} breaks period {expect}"
            )
        if any(s.mixer == "attn" for s in self.layer_specs) and not self.mla:
            assert self.n_kv_heads and self.n_heads % self.n_kv_heads == 0

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.n_prefix_layers) // self.scan_period

    @property
    def period_specs(self) -> Tuple[LayerSpec, ...]:
        return self.layer_specs[
            self.n_prefix_layers : self.n_prefix_layers + self.scan_period
        ]

    @property
    def prefix_specs(self) -> Tuple[LayerSpec, ...]:
        return self.layer_specs[: self.n_prefix_layers]

    # -- derived sizes -------------------------------------------------------
    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_bytes_per_token_layer(self) -> int:
        """bf16 KV bytes one attention layer stores per token (paper §II math)."""
        if self.mla:
            return 2 * (self.kv_lora_rank + self.qk_rope_head_dim)
        return 2 * 2 * self.n_kv_heads * self.head_dim

    @property
    def n_attn_layers(self) -> int:
        return sum(1 for s in self.layer_specs if s.mixer == "attn")

    def param_count(self) -> int:
        """Analytical parameter count (embedding + stack + head)."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for spec in self.layer_specs:
            n += self._mixer_params(spec) + self._ffn_params(spec)
            n += 2 * self.d_model  # pre-norms (approx; post-norms minor)
        n += self.d_model  # final norm
        if self.encdec:
            for _ in range(self.n_enc_layers):
                # encoder self-attn + ffn (MHA, no GQA in whisper encoder)
                n += 4 * self.d_model * self.n_heads * self.head_dim
                n += 2 * self.d_model * self.d_ff
                n += 2 * self.d_model
            # decoder cross-attention per layer
            n += self.n_layers * 4 * self.d_model * self.n_heads * self.head_dim
        return n

    def _mixer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.mixer == "attn":
            if self.mla:
                qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
                n = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_head
                n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                n += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * d
                return n
            q = d * self.n_heads * self.head_dim
            kv = 2 * d * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.head_dim * d
            return q + kv + o
        # mamba blocks
        d_in = self.m_expand * d
        if spec.mixer == "mamba2":
            ngroups_dim = 2 * self.m_n_groups * self.m_d_state
            n_heads_m = d_in // self.m_headdim
            in_proj = d * (2 * d_in + ngroups_dim + n_heads_m)
            conv = (d_in + ngroups_dim) * self.m_conv
            out = d_in * d + d_in  # out_proj + gated norm
            return in_proj + conv + out + 2 * n_heads_m  # A, D, dt_bias ~ n_heads
        if spec.mixer == "mamba1":
            st = self.m_d_state_m1
            dt_rank = math.ceil(d / 16)
            in_proj = d * 2 * d_in
            conv = d_in * self.m_conv
            xproj = d_in * (dt_rank + 2 * st)
            dtproj = dt_rank * d_in
            out = d_in * d
            return in_proj + conv + xproj + dtproj + out + d_in * st + d_in
        return 0

    def _ffn_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.ffn == "dense":
            mult = 3 if self.glu else 2
            return mult * d * self.d_ff
        if spec.ffn == "moe":
            mult = 3 if self.glu else 2
            n = self.n_experts * mult * d * self.moe_d_ff
            n += d * self.n_experts  # router
            if self.n_shared_experts:
                n += mult * d * self.shared_d_ff
            return n
        return 0

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self.layer_specs:
            n += self._mixer_params(spec) + 2 * self.d_model
            if spec.ffn == "moe":
                mult = 3 if self.glu else 2
                n += self.top_k * mult * self.d_model * self.moe_d_ff
                n += self.d_model * self.n_experts
                if self.n_shared_experts:
                    n += mult * self.d_model * self.shared_d_ff
            else:
                n += self._ffn_params(spec)
        return n


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers everything)

    _LOADED = True
