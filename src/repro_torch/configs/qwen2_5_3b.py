"""Qwen2.5-3B [dense] — GQA (kv=2), QKV bias, RoPE theta=1e6.

36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936. [hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    pattern=(ATTN,),
    attn_bias=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,
)
