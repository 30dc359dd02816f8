"""ChatGLM3-6B [dense] — GQA (kv=2), 2d/partial RoPE (rotary on half the head dim).

28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024. [arXiv:2406.12793]
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    pattern=(ATTN,),
    rotary_pct=0.5,            # ChatGLM applies rotary to half of each head dim
    attn_bias=True,            # GLM uses bias on QKV
    rope_theta=10000.0,
    norm_type="rmsnorm",
    act="silu",
    gated_mlp=True,
)
