"""DBRX-132B [moe] — 16 experts top-4 (fine-grained), GQA (kv=8).

40L d_model=6144 48H (kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=(ATTN_MOE,),
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    norm_type="layernorm",
    act="silu",
    gated_mlp=True,
)
