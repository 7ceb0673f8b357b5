"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality) mixer.

[arXiv:2405.21060; unverified]
64 layers of pure Mamba2 blocks (no FFN), d_state=128, headdim=64,
d_inner = 2*d_model = 5120 (80 SSD heads).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("mamba2-2.7b")
def mamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        source="[arXiv:2405.21060; unverified]",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        m_d_state=128,
        m_headdim=64,
        m_n_groups=1,
        m_conv=4,
        m_expand=2,
        layer_specs=tuple(LayerSpec(mixer="mamba2", ffn="none") for _ in range(64)),
        tie_embeddings=True,
        max_seq_len=1048576,  # state-space: unbounded context
    )
