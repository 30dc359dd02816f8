"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    chatglm3_6b,
    dbrx_132b,
    granite_3_2b,
    mistral_nemo_12b,
    mixtral_8x22b,
    musicgen_large,
    qwen2_5_3b,
    recurrentgemma_9b,
    xlstm_350m,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_5_3b.CONFIG,
        chatglm3_6b.CONFIG,
        granite_3_2b.CONFIG,
        mistral_nemo_12b.CONFIG,
        musicgen_large.CONFIG,
        mixtral_8x22b.CONFIG,
        dbrx_132b.CONFIG,
        xlstm_350m.CONFIG,
        chameleon_34b.CONFIG,
        recurrentgemma_9b.CONFIG,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_active(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a runnable dry-run cell, with reason if not.

    long_500k needs sub-quadratic attention / bounded decode state; pure
    full-attention archs skip it (documented in DESIGN.md §5).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full quadratic attention: unbounded 500k KV cache (see DESIGN.md §5)"
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch_cfg, shape_cfg, active, reason) for the full 40-cell grid."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            active, reason = cell_is_active(arch, shape)
            if active or include_skipped:
                yield arch, shape, active, reason
