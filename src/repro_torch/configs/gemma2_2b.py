"""Gemma2-2B — alternating local(4096-window)/global attention, logit softcaps.

[arXiv:2408.00118; hf google/gemma-2-2b]
head_dim=256 (8 heads -> q dim 2048 != d_model 2304); GeGLU; pre+post norms;
attn softcap 50, final logit softcap 30; tied + scaled embeddings.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _specs():
    # even layers sliding-window local, odd layers global (HF convention)
    return tuple(
        LayerSpec(mixer="attn", ffn="dense", attn_kind="local" if i % 2 == 0 else "full")
        for i in range(26)
    )


@register("gemma2-2b")
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        source="[arXiv:2408.00118; hf]",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        local_window=4096,
        act="gelu",
        glu=True,
        post_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        layer_specs=_specs(),
        scan_period=2,
        max_seq_len=8192,
    )
