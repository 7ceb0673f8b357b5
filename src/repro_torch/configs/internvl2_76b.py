"""InternVL2-76B — InternViT-6B frontend (STUB) + Llama3-70B-class LM backbone.

[arXiv:2404.16821; unverified]
Only the transformer BACKBONE is modelled; the vision frontend is a stub whose
`input_specs()` provides precomputed patch embeddings prepended to the text.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-76b")
def internvl2_76b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        source="[arXiv:2404.16821; unverified]",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500000.0,
        frontend="vision",
        frontend_len=256,  # patch embeddings per image (stubbed)
        max_seq_len=131072,
    )
