"""Training step: loss and gradients (with microbatch accumulation), the
optional int8 gradient round trip, and the AdamW update.

Counterpart of ``repro.training.train_step``. ``train_step(params,
opt_state, batch)`` takes a params module whose leaves require grad
(``Model.init(..., trainable=True)``) and updates it, ``m`` and ``v`` in
place (``training/optimizer.py``). With ``accum_steps > 1`` the batch is
cut into that many microbatches along its first axis, and each
microbatch's gradients go into float32 buffers as ``g / n`` (the
reference's ``grads_acc``), not into the parameters' own ``.grad``, which
holds one microbatch at a time in the parameters' dtype.

The params may also be a ``sharding.Placed`` tree laid out under a
baseline table (``place_params(..., trainable=True)``, run under
``sharding.use_rules``): its leaves are ``Shards`` / ``Fsdp`` of parts, the
gradients, accumulators and AdamW moments take the same layout, and every
update runs part by part.

``state_to_jax`` and ``state_from_jax`` carry ``(params, OptState)``
to and from the JAX package's tree (the layout of its checkpoints and of
``examples/train_lm.py``'s).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import tracing
from repro_torch.checkpoint.checkpoint import OptState
from repro_torch.distributed.sharding import leaf_parts, map_parts, zip_parts
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    compress_grads: bool = False


def compress_int8(g):
    """Symmetric int8 quantization (per-tensor scale)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.to(torch.float32) * scale


def grads_roundtrip_int8(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Quantize and dequantize every gradient (a compressed all-reduce's
    rounding, on one card); a laid-out leaf's parts share its scale."""
    out = {}
    for name, g in grads.items():
        scale = torch.clamp(max(torch.max(torch.abs(t.float())) for t in leaf_parts(g)),
                            min=1e-8) / 127.0
        out[name] = map_parts(lambda t, s=scale: decompress_int8(
            torch.clamp(torch.round(t.float() / s), -127, 127).to(torch.int8),
            s).to(t.dtype), g)
    return out


def loss_and_grads(params, batch, cfg):
    """(loss, metrics, grads) of one batch: the gradients are the params'
    ``.grad`` (a parameter the loss does not reach gets zeros), taken off
    the params so that the next backward starts from none."""
    for p in params.parameters():
        p.grad = None
    loss, metrics = tfm.train_loss(params, batch, cfg)
    loss.backward()
    grads = {name: map_parts(lambda t: torch.zeros_like(t) if t.grad is None
                             else t.grad, p)
             for name, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model_cfg, train_cfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    metrics ``loss``, ``nll``, ``grad_norm`` and ``lr`` (and ``aux``
    without accumulation, as in the reference). The forward and backward
    alone are ``train_step.loss_and_grads(params, batch)``."""
    n = train_cfg.accum_steps

    def accumulated(params, batch):
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        mb = B // n
        if n == 1:
            return loss_and_grads(params, batch, model_cfg)
        acc = {name: map_parts(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                     device=t.device), p)
               for name, p in params.named_parameters()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.parameters())).device)
        # a tracer runs one microbatch, counted n times (tracing.loop)
        for i in tracing.loop(n):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(params, micro, model_cfg)
            for name in acc:
                for a, g in zip_parts(acc[name], grads.pop(name)):
                    a.add_(g.float() / n)
            loss_acc = loss_acc + loss / n
        return loss_acc, {"nll": loss_acc}, acc

    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulated(params, batch)
        if train_cfg.compress_grads:
            grads = grads_roundtrip_int8(grads)
        params, opt_state, opt_metrics = adamw_update(
            train_cfg.opt, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    train_step.loss_and_grads = accumulated
    return train_step


def state_to_jax(params, opt_state: OptState, cfg):
    """``(params, OptState)`` as the JAX package's tree: params and both
    moments in its layout (scanned layers stacked), the step as is."""
    return (convert.params_to_jax(params.state_dict(), cfg),
            OptState(step=opt_state.step,
                     m=convert.params_to_jax(opt_state.m, cfg),
                     v=convert.params_to_jax(opt_state.v, cfg)))


@torch.no_grad()
def state_from_jax(tree, params, cfg):
    """The inverse of ``state_to_jax`` into ``params`` (copied in place,
    cast to its dtype): returns (params, OptState) with float32 moments on
    the params' device and the step as a 0-d int32 tensor."""
    jparams, opt = tree
    sd = convert.params_from_jax(jparams, cfg)
    named = dict(params.named_parameters())
    for name, p in named.items():
        p.copy_(sd[name])
    dev = next(iter(named.values())).device

    def moments(t):
        return {name: x.to(dev, torch.float32).clone()
                for name, x in convert.params_from_jax(t, cfg).items()}

    step = torch.as_tensor(opt.step).to(dev, torch.int32).reshape(())
    return params, OptState(step=step, m=moments(opt.m), v=moments(opt.v))
