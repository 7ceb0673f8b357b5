"""Qwen2-1.5B — dense GQA (kv=2) with QKV bias.

[arXiv:2407.10671; hf Qwen/Qwen2-1.5B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-1.5b")
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        source="[arXiv:2407.10671; hf]",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        max_seq_len=131072,
    )
