"""Thin façade over the port's model: init / load / caches / entry points.

Counterpart of ``repro.models.model.Model``. The JAX handle is stateless
and takes a params pytree; this one is bound to a device and builds the
params ``nn.Module`` (``init`` from a seeded generator on the device,
``load`` from a state dict such as ``convert.params_from_jax``'s, or
``restore`` from a checkpoint directory in the JAX package's format),
which every entry point then takes as ``params``.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import transformer as tfm


class Model:
    """Model handle for one ModelConfig on one device (default: the card)."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- params ------------------------------------------------------------
    def _empty(self) -> tfm.TransformerParams:
        return tfm.TransformerParams(self.cfg, device=self.device,
                                     dtype=tfm.DTYPES[self.cfg.param_dtype])

    def init(self, seed: int = 0, *, trainable: bool = False) -> tfm.TransformerParams:
        """Random params by the JAX init rules, drawn on the device from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's bits).
        ``trainable`` turns on ``requires_grad`` for the trainer; serving
        keeps it off, so its forward and its CUDA graphs build no graph."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._empty().init_(gen).requires_grad_(trainable)

    def load(self, state_dict: Mapping[str, torch.Tensor], *,
             trainable: bool = False) -> tfm.TransformerParams:
        """Params from a state dict in the port's names (strict);
        ``trainable`` as in ``init``."""
        params = self._empty()
        params.load_state_dict(dict(state_dict), strict=True)
        return params.requires_grad_(trainable)

    def restore(self, ckpt_dir: str):
        """Params from the newest checkpoint under ``ckpt_dir`` in the JAX
        package's format (``checkpoint.save``, ``examples/train_lm.py``):
        the params tree alone or the ``(params, OptState)`` pair, whose
        params are taken. Each leaf is cast to ``cfg.param_dtype`` on the
        device. Returns (params, step)."""
        like = convert.nest((path, torch.empty(shape, device="meta"))
                            for path, shape in convert.jax_layout(self.cfg))
        tree, step = ckpt.restore_params(ckpt_dir, like)
        return self.load(convert.params_from_jax(tree, self.cfg)), step

    def param_count(self) -> int:
        return sum(p.numel() for p in tfm.TransformerParams(
            self.cfg, device="meta", dtype=torch.float32).parameters())

    # ---- caches ------------------------------------------------------------
    def cache_spec(self, batch: int, capacity: int):
        return tfm.cache_spec(self.cfg, batch, capacity)

    def init_cache(self, batch: int, capacity: int):
        return tfm.init_cache(self.cfg, batch, capacity, self.device)

    # ---- entry points ------------------------------------------------------
    def loss(self, params, batch):
        """Causal LM loss and its parts, (loss, {"nll", "aux"}); see
        transformer.train_loss."""
        return tfm.train_loss(params, batch, self.cfg)

    def prefill(self, params, batch, cache, **kw):
        return tfm.prefill(params, batch, self.cfg, cache, **kw)

    def decode_step(self, params, batch, cache, cache_len, **kw):
        return tfm.decode_step(params, batch, self.cfg, cache, cache_len, **kw)

    def extend(self, params, batch, cache, cache_len, **kw):
        """Prefill continuation against a partially filled cache (chunked
        prefill / paged suffix prefill). See transformer.extend."""
        return tfm.extend(params, batch, self.cfg, cache, cache_len, **kw)

    def verify(self, params, batch, cache, cache_lens, **kw):
        """Speculative-decode verify: score all draft positions in one
        forward, per-row cache lengths. See transformer.verify."""
        return tfm.verify(params, batch, self.cfg, cache, cache_lens, **kw)

    def verify_commit(self, staged, cache_lens, ns, lens):
        """Resolve a verify call's staged record to the committed cache at
        each row's accepted length. See transformer.verify_commit."""
        return tfm.verify_commit(self.cfg, staged, cache_lens, ns, lens)

    # ---- input construction ------------------------------------------------
    def make_batch(self, tokens_or_frames, *, labels=None, positions=None,
                   start: int = 0):
        """Token ids [B, S], or frame embeddings [B, S, d_model] under
        ``"frames"`` for ``audio_frames`` configs, at positions [start,
        start+S) unless given; ``labels`` [B, S] for ``loss``."""
        key = "frames" if self.cfg.modality == "audio_frames" else "tokens"
        arr = tokens_or_frames
        B, S = arr.shape[0], arr.shape[1]
        if positions is None:
            positions = (start + torch.arange(S, device=arr.device)
                         )[None, :].expand(B, S)
        batch = {key: arr, "positions": positions}
        if labels is not None:
            batch["labels"] = labels
        return batch
