"""Chameleon-34B [vlm] — early-fusion mixed-modal transformer, qk-norm.

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536. [arXiv:2405.09818]

Early fusion means images are VQ-tokenized into the SAME 65536-entry vocab as
text, so plain token ids are the native input — the VQ-GAN image tokenizer is
the (stubbed) modality frontend. Chameleon's QK-norm is included: it was the
paper's fix for logit drift in mixed-modal training.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    pattern=(ATTN,),
    qk_norm=True,
    rope_theta=10000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
    modality="vlm_tokens",
)
