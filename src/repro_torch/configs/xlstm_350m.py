"""xLSTM-350M [ssm] — sLSTM + mLSTM residual blocks, ratio 7:1 (xLSTM[7:1]).

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304. [arXiv:2405.04517]

No attention, no positional embedding (recurrence is position-aware); decode
state is O(1) per layer ⇒ long_500k runs. The mLSTM uses the chunkwise-parallel
formulation (TPU adaptation — see DESIGN.md §3); sLSTM remains a lax.scan since
its state nonlinearity is inherently sequential (per the xLSTM paper).
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                     # xLSTM blocks embed their own up/down projections
    vocab_size=50304,
    pattern=(MLSTM,) * 7 + (SLSTM,),   # 24 = 3 × (7 mLSTM + 1 sLSTM)
    pos_emb="none",
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    mlstm_proj_factor=2.0,
    mlstm_chunk=256,
    slstm_heads=4,
    tie_embeddings=True,
)
