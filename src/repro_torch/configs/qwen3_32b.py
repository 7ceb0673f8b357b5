"""Qwen3-32B — dense GQA (kv=8) with per-head q/k RMSNorm, head_dim=128.

[hf Qwen/Qwen3-8B (family); hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        source="[hf:Qwen/Qwen3-8B; hf]",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,  # explicit: q dim 8192 != d_model
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        max_seq_len=131072,
    )
