"""Qwen3-30B-A3B — MoE 128 experts top-8 (norm_topk), GQA kv=4, qk-norm.

[hf Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="[hf:Qwen/Qwen3-30B-A3B; hf]",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        norm_topk=True,
        rope_theta=1000000.0,
        layer_specs=tuple(LayerSpec(mixer="attn", ffn="moe") for _ in range(48)),
        max_seq_len=131072,
    )
