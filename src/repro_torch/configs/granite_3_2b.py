"""Granite-3.0-2B [dense] — GQA (kv=8), tied embeddings.

40L d_model=2048 32H (kv=8) d_ff=8192 vocab=49155 (padded to 49280 for TP).
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    pattern=(ATTN,),
    rope_theta=10000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,
)
