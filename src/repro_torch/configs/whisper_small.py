"""Whisper-small — encoder-decoder; conv audio frontend STUBBED.

[arXiv:2212.04356; unverified]
12 encoder + 12 decoder layers, MHA (kv=12), GeLU FFN (no GLU), learned
positions in the decoder; `input_specs()` provides precomputed log-mel frame
embeddings (the conv1d frontend stub output) for the encoder.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        source="[arXiv:2212.04356; unverified]",
        n_layers=12,  # decoder layers
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        act="gelu",
        glu=False,
        qkv_bias=True,
        rotary_pct=0.0,
        learned_pos=True,
        encdec=True,
        n_enc_layers=12,
        frontend="audio",
        frontend_len=1500,  # whisper encoder positions (30s @ 50Hz)
        tie_embeddings=True,
        # whisper's native max target length is 448; the learned-position table
        # is sized to the assigned decode_32k shape so every cell is well-defined.
        max_seq_len=32768,
    )
