"""Mixtral-8x22B [moe] — 8 experts top-2, GQA (kv=8), sliding-window attention.

56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
[arXiv:2401.04088]

SWA window 4096 bounds the decode KV cache ⇒ long_500k is runnable.
"""
from repro_torch.configs.base import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(ATTN_MOE,),
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
)
