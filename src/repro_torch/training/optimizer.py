"""AdamW with a global-norm clip over the port's parameters.

Counterpart of ``repro.training.optimizer``, in its arithmetic order:
gradients are cast to float32 and scaled by ``min(1, clip / max(norm,
1e-9))``, the learning rate is the schedule at ``step + 1``, the moments
are bias-corrected, weight decay applies to every leaf (norms and
embeddings too), and the update is computed in float32 and cast to the
parameter's dtype.

The state is ``OptState(step, m, v)`` (the NamedTuple the port's
checkpoints write): ``step`` a 0-d int32 tensor, ``m`` and ``v`` float32
tensors keyed by the parameters' state-dict names. Where the JAX update is
a pure function, this one updates the parameters, ``m`` and ``v`` in place
and returns them: at 3 B parameters a second copy of the float32 moments
alone would be 25 GB. The clip is applied leaf by leaf inside the update,
so no float32 copy of all the gradients is made. A leaf laid out on a
mesh (``Shards`` / ``Fsdp``) has moments of the same layout and updates
part by part (``sharding.zip_parts``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping

import torch

from repro_torch.checkpoint.checkpoint import OptState
from repro_torch.distributed.sharding import leaf_parts, map_parts, zip_parts


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def named_params(params) -> Dict[str, torch.Tensor]:
    """name -> tensor of a params module (its ``named_parameters``) or of
    a mapping."""
    if isinstance(params, Mapping):
        return dict(params)
    return dict(params.named_parameters())


def init_opt_state(params) -> OptState:
    """Step 0 and zero float32 moments shaped like the params."""
    named = named_params(params)
    dev = leaf_parts(next(iter(named.values())))[0].device

    def zeros():
        return {n: map_parts(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                   device=t.device), p)
                for n, p in named.items()}

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros(), v=zeros())


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(float32 grads scaled to at most ``max_norm``, the norm before)."""
    gn = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: Mapping[str, torch.Tensor],
                 state: OptState):
    """One AdamW step with the global-norm clip, in place (see the module
    docstring). ``grads`` maps every parameter's name to its gradient (any
    float dtype). Returns (params, state, {"grad_norm", "lr"})."""
    named = named_params(params)
    gn = global_norm(t for n in named for t in leaf_parts(grads[n]))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** sf
    b2c = 1 - cfg.b2 ** sf
    for name, leaf in named.items():
        for p, g, m, v in zip_parts(leaf, grads[name], state.m[name], state.v[name]):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
            denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
            delta = (m / b1c).div_(denom)
            pf = p.float()
            delta.add_(pf, alpha=cfg.weight_decay)
            p.copy_(pf - lr * delta)
    return params, OptState(step=step, m=state.m, v=state.v), {
        "grad_norm": gn, "lr": lr}
