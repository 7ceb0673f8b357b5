"""ChatGLM3-6B — dense GQA (kv=2) with 2d (half-dim) RoPE and QKV bias.

[arXiv:2406.12793; hf THUDM/chatglm3-6b]
"""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        source="[arXiv:2406.12793; hf]",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        qkv_bias=True,
        rotary_pct=0.5,  # 2d RoPE: rotate half of each head dim
        rope_theta=10000.0,
        max_seq_len=131072,
    )
