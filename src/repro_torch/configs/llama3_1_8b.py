"""Llama3.1-8B — the paper's primary evaluation model (Table I).

[arXiv:2407.21783; hf meta-llama/Llama-3.1-8B]
KV bytes/token-layer = 2*2*8*128 = 4 KB -> 128K-context layer KV = 512 MB,
matching the paper's TPUv6e-like prefetch-buffer sizing exactly.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.1-8b")
def llama3_1_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3.1-8b",
        family="dense",
        source="[arXiv:2407.21783; hf]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        max_seq_len=131072,
    )
