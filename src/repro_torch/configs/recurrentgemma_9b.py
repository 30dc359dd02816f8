"""RecurrentGemma-9B [hybrid] — Griffin: RG-LRU + local attention, 2:1 pattern.

38L d_model=4096 16H (kv=1 → MQA) d_ff=12288 vocab=256000. [arXiv:2402.19427]

Pattern: (recurrent, recurrent, local_attn) repeating; 38 = 12×3 + 2 trailing
recurrent layers. Local attention window 2048 and O(1) RG-LRU state bound the
decode state ⇒ long_500k runs.
"""
from repro_torch.configs.base import LOCAL_ATTN, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    local_window=2048,
    rglru_dim=4096,
    conv1d_width=4,
    rope_theta=10000.0,
    norm_type="rmsnorm",
    act="gelu",            # Gemma-style GeGLU
    gated_mlp=True,
    logit_softcap=30.0,
)
