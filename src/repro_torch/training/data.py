"""Deterministic synthetic data with a restart-safe cursor.

Counterpart of ``repro.training.data``: batches are a pure function of
(seed, step), drawn from the same numpy Philox stream, so they equal the
JAX package's bit for bit; here they come back as tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import DTYPES


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 256


class SyntheticLM:
    """Markov-ish deterministic token stream (stable across restarts).
    ``device`` is where ``batch_at`` puts its tensors (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: DataConfig, model_cfg=None, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``tokens``, ``labels`` (the next tokens) and ``positions``, int32
        [global_batch, seq_len]; ``audio_frames`` configs get ``frames``
        [global_batch, seq_len, d_model] in the config's dtype instead of
        ``tokens``."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(key=c.seed + step))
        base = rng.integers(0, c.vocab_size, size=(c.global_batch, c.seq_len + 1),
                            dtype=np.int64)
        # structure the loss can learn: positions not ≡ 0 (mod 3) repeat the
        # token 1 or 2 slots earlier
        base[:, 1::3] = base[:, 0:-1:3]
        base[:, 2::3] = base[:, 1:-1:3]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        positions = np.broadcast_to(np.arange(c.seq_len, dtype=np.int32),
                                    tokens.shape)
        host = {"tokens": tokens, "labels": labels,
                "positions": np.ascontiguousarray(positions)}
        out = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        if self.model_cfg is not None and self.model_cfg.modality == "audio_frames":
            frames = rng.standard_normal((c.global_batch, c.seq_len,
                                          self.model_cfg.d_model)).astype(np.float32)
            out["frames"] = torch.from_numpy(frames).to(
                self.device, DTYPES[self.model_cfg.dtype])
            del out["tokens"]
        return out
