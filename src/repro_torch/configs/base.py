"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; reduced "smoke"
variants (same family, tiny dims) are derived via ``ModelConfig.reduced()`` so
CPU tests exercise the same code paths the full configs lower through.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Block kinds understood by models/transformer.py
ATTN = "attn"                # full causal self-attention + MLP
ATTN_MOE = "attn_moe"        # attention + MoE FFN
RECURRENT = "recurrent"      # RG-LRU temporal mixing + MLP (Griffin residual block)
LOCAL_ATTN = "local_attn"    # sliding/local-window attention + MLP
MLSTM = "mlstm"              # xLSTM matrix-memory block
SLSTM = "slstm"              # xLSTM scalar-memory block

VOCAB_PAD_MULTIPLE = 16 * 8  # pad vocab so 16-way TP stays aligned to 8 sublanes


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return int(math.ceil(v / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # ---- block pattern -------------------------------------------------
    # Layer stack = `pattern` repeated; a trailing partial period is allowed
    # (e.g. recurrentgemma: 38 = 12*(R,R,A) + (R,R)).
    pattern: Tuple[str, ...] = (ATTN,)

    # ---- attention flavour ---------------------------------------------
    attn_bias: bool = False          # qwen-style QKV bias
    qk_norm: bool = False            # chameleon-style per-head RMS norm of q,k
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm "2d rope": rotary on a fraction of hd
    pos_emb: str = "rope"            # rope | sinusoidal | none
    sliding_window: Optional[int] = None   # SWA window (mixtral); None = full
    local_window: Optional[int] = None     # local-attn window (recurrentgemma)
    logit_softcap: float = 0.0

    # ---- MoE -------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2
    moe_group_size: int = 512        # tokens per dispatch group (memory control)

    # ---- recurrent / xLSTM ----------------------------------------------
    rglru_dim: int = 0               # RG-LRU recurrence width (0 → d_model)
    conv1d_width: int = 4
    mlstm_proj_factor: float = 2.0   # mLSTM up-projection factor
    mlstm_chunk: int = 256           # chunkwise-parallel chunk length
    slstm_heads: int = 4

    # ---- norms / act / embeddings -----------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (gated) | gelu (non-gated)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    mlp_bias: bool = False

    # ---- modality frontend -------------------------------------------------
    modality: str = "text"           # text | audio_frames | vlm_tokens
    # audio_frames: input_specs supplies [B, S, d_model] precomputed frame
    # embeddings (EnCodec frontend stub); vlm_tokens: early-fusion VQ tokens
    # share the text vocab so plain token ids are the native input.

    # ---- sizes ----------------------------------------------------------------
    max_seq: int = 131072
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # ---- execution flags (perf knobs; see EXPERIMENTS.md §Perf) -------------
    use_pallas: bool = False         # True on real TPU; dry-run uses the XLA path
    decode_block_w: int = 256        # decode-attention KV block (serving engine
                                     # rounds cache capacity up to this so the
                                     # kernel never re-pads the cache per step)
    remat_policy: str = "full"       # none | minimal | full  (§Perf knob)
    scan_layers: bool = True
    bf16_reduce: bool = False        # §Perf: bf16 cross-device partial sums
                                     # (halves TP/FSDP all-reduce volume at a
                                     # documented precision trade)

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0 or self.num_kv_heads == 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer block kinds, length == num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])

    @property
    def num_scan_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        """Layers past the last full pattern period (unscanned)."""
        return self.layer_kinds[self.num_scan_groups * len(self.pattern):]

    @property
    def has_attention(self) -> bool:
        return any(k in (ATTN, ATTN_MOE, LOCAL_ATTN) for k in self.layer_kinds)

    @property
    def is_subquadratic(self) -> bool:
        """True iff decode state is O(window)/O(1) — gates long_500k."""
        for k in self.layer_kinds:
            if k in (ATTN, ATTN_MOE) and self.sliding_window is None:
                return False
        return True

    @property
    def attn_window(self) -> Optional[int]:
        """KV-cache bound for attention layers (None = unbounded/full)."""
        if self.sliding_window is not None:
            return self.sliding_window
        if all(k in (RECURRENT, LOCAL_ATTN, MLSTM, SLSTM) for k in self.layer_kinds):
            return self.local_window
        return None

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs and sanity checks)."""
        d, hd, H, K = self.d_model, self.head_dim, self.num_heads, self.num_kv_heads
        n = self.padded_vocab * d                 # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d            # unembed
        for kind in self.layer_kinds:
            if kind in (ATTN, ATTN_MOE, LOCAL_ATTN):
                n += d * H * hd + 2 * d * K * hd + H * hd * d   # q, kv, o
                n += 2 * d                                       # norms
                if kind == ATTN_MOE:
                    mult = 3 if self.gated_mlp else 2
                    n += self.num_experts * (mult * d * self.d_ff)
                    n += d * self.num_experts                    # router
                else:
                    mult = 3 if self.gated_mlp else 2
                    n += mult * d * self.d_ff
            elif kind == RECURRENT:
                r = self.rglru_dim or d
                n += 2 * d * r + r * d            # in-proj(x2), out-proj
                n += r * self.conv1d_width + 2 * r  # conv + gates (diag-ish)
                mult = 3 if self.gated_mlp else 2
                n += mult * d * self.d_ff + 2 * d
            elif kind == MLSTM:
                f = int(self.mlstm_proj_factor * d)
                n += 2 * d * f + f * d            # up(x2), down
                n += 3 * f * f // 1               # qkv inside (approx, per-block)
                n += d
            elif kind == SLSTM:
                n += 4 * d * d + d * d + 2 * d    # ifzo gates + out
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.param_count()
        mult = 3 if self.gated_mlp else 2
        per_expert = mult * self.d_model * self.d_ff
        n_moe_layers = sum(1 for k in self.layer_kinds if k == ATTN_MOE)
        n -= n_moe_layers * (self.num_experts - self.experts_per_token) * per_expert
        return int(n)

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        base = dict(
            num_layers=max(2 * len(self.pattern), 2) if len(self.pattern) > 1 else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            max_seq=512,
            moe_group_size=32,
            mlstm_chunk=16,
            sliding_window=16 if self.sliding_window else None,
            local_window=16 if self.local_window else None,
            rglru_dim=64 if self.rglru_dim else 0,
            name=self.name + "-smoke",
        )
        if len(self.pattern) > 1:
            # one full period (scanned) + the arch's tail remainder (unscanned)
            base["num_layers"] = len(self.pattern) + len(self.tail_kinds)
        if self.num_experts:
            base["num_experts"] = 4
            base["experts_per_token"] = min(self.experts_per_token, 2)
            # drop-free capacity so tiny-config tests are exactly deterministic
            # regardless of token grouping (full configs keep the real factor)
            base["capacity_factor"] = 4.0
        base.update(over)
        return dataclasses.replace(self, **base)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len × global_batch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}
