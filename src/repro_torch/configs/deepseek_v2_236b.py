"""DeepSeek-V2 (236B) — MLA (kv_lora=512) + MoE 160 routed top-6 + 2 shared.

[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2]
Layer 0 is dense (first_k_dense_replace=1); layers 1..59 are MoE.
MLA: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128.
The compressed KV cache (512+64 dims shared across all 128 heads) is the
long-context enabler — 2·(512+64) B/token-layer vs 4 KB for GQA-8.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _specs():
    return tuple(
        LayerSpec(mixer="attn", ffn="dense" if i == 0 else "moe") for i in range(60)
    )


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="[arXiv:2405.04434; hf]",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,  # MLA: full heads, cache is latent
        head_dim=128,
        d_ff=12288,  # dense layer 0
        vocab_size=102400,
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        top_k=6,
        moe_d_ff=1536,
        n_shared_experts=2,
        shared_d_ff=3072,  # 2 shared experts x 1536
        norm_topk=False,
        rope_theta=10000.0,
        layer_specs=_specs(),
        n_prefix_layers=1,
        scan_period=1,
        max_seq_len=131072,
    )
