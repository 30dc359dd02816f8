"""Mistral-Nemo-12B [dense] — GQA (kv=8), head_dim=128 decoupled from d/H, 128k ctx.

40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,              # explicit: NOT d_model // num_heads (=160)
    d_ff=14336,
    vocab_size=131072,
    pattern=(ATTN,),
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
    max_seq=131072,
)
