"""MusicGen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (kv=32 → MHA) d_ff=8192 vocab=2048. [arXiv:2306.05284]

Backbone only: the EnCodec modality frontend is a STUB — ``input_specs()``
supplies precomputed frame embeddings ``[B, S, d_model]`` (sum of the four
codebook embeddings after the delay pattern, as produced by the real frontend);
the backbone predicts the next frame's codes over the 2048-entry codebook.
Standard (non-gated) GELU MLP + LayerNorm + sinusoidal positions, per the paper.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(ATTN,),
    pos_emb="sinusoidal",
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    modality="audio_frames",
)
