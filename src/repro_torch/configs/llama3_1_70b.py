"""Llama3.1-70B — the paper's TPUv7-like evaluation model (Table I).

[arXiv:2407.21783; hf meta-llama/Llama-3.1-70B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.1-70b")
def llama3_1_70b() -> ModelConfig:
    return ModelConfig(
        name="llama3.1-70b",
        family="dense",
        source="[arXiv:2407.21783; hf]",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500000.0,
        max_seq_len=131072,
    )
