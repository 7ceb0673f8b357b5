"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf ai21labs/Jamba-v0.1]
Structure: attn_layer_period=8 / attn_layer_offset=4 (1 attention layer per 8),
expert_layer_period=2 / expert_layer_offset=1 (MoE every other layer).
No positional embedding (rotary_pct=0 — Mamba layers carry position).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _specs():
    specs = []
    for i in range(32):
        mixer = "attn" if i % 8 == 4 else "mamba1"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(specs)


@register("jamba-v0.1-52b")
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="[arXiv:2403.19887; hf]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        n_experts=16,
        top_k=2,
        moe_d_ff=14336,
        rotary_pct=0.0,  # Jamba uses no explicit positional encoding
        m_d_state_m1=16,
        m_conv=4,
        m_expand=2,
        layer_specs=_specs(),
        scan_period=8,
        max_seq_len=262144,
    )
