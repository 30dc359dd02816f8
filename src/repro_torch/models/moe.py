"""Mixture-of-Experts FFN of the port: top-k token-choice routing with a
capacity factor, one-hot dispatch and combine.

Counterpart of ``repro.models.moe``, number for number. Tokens are routed
in groups of ``cfg.moe_group_size`` (the last group zero-padded, and the
padding routes like any token); each expert takes ``capacity(cfg, G)``
tokens a group. First choices take an expert's slots in token order,
second choices only after every first choice of the group (``prev_count``),
and a token past its expert's capacity contributes nothing for that choice;
the surviving gates are renormalised by their sum. So a token's output
depends on the other tokens of its group whenever a token drops.

Dispatch and combine are the reference's one-hot products ([N, G, E, C]
masks, batched matmuls), not gathers and scatters: they are static in
shape with no index arithmetic that could sync with the host, so the decode
and verify steps capture as CUDA graphs; the dispatch sum has at most one
non-zero term per output, so it moves no number, and both products cost
little beside the expert matmuls. The reference's bf16 rounding points are
kept in every dtype: the grouped tokens, the dispatch mask and the combine
weights are bf16 even in float32 configs, and the router logits are
float32 from any input (``layers.matmul_f32``): a bf16 router would change
the top-k choices. The expert products are plain ``torch.einsum``
(batched matmuls), as they are plain einsums in the JAX package.
On a mesh the experts are cut over "model" (``wi`` / ``wg`` / ``wo`` in
``Shards`` by their expert dim): each shard runs its experts' slice of the
dispatched tokens and ``ye`` is gathered before the combine, the
reference's expert parallelism; routing, dispatch and combine run once,
so the drops and the slot order are those of one device. Under a baseline
table the expert FFNs are cut over "model" by their hidden dim
("moe_mlp": ``wi`` / ``wg`` by columns, ``wo`` by rows) and the parts'
partial products are added; with ``expert_parallel`` the experts lie over
the FSDP axis (``Fsdp`` by their expert dim) and each "data" position
runs its experts' slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import types

from repro_torch.distributed.sharding import Fsdp, Shards, gather, per_part, psum
from repro_torch.models.layers import Params, activation, matmul_f32, param


class MoE(Params):
    """Router and expert leaves (``moe.moe_defs``): router [D, E], wi / wg
    [E, D, F], wo [E, F, D], all "scaled" (the fan-in counts E, and the
    layer axis of scanned layers)."""

    AXES = {"router": ("embed", None),
            "wi": ("experts", "moe_embed", "moe_mlp"),
            "wg": ("experts", "moe_embed", "moe_mlp"),
            "wo": ("experts", "moe_mlp", "moe_embed")}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        kw = dict(device=device, dtype=dtype)
        self.router = param(D, E, **kw)
        self.wi = param(E, D, Fd, **kw)
        self.wo = param(E, Fd, D, **kw)
        if cfg.gated_mlp:
            self.wg = param(E, D, Fd, **kw)


def capacity(cfg, group: int) -> int:
    c = int(group * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference


def _one_hot(idx, n: int):
    """float32 one-hot by comparison (no scatter, no index checks)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(router_w, x, cfg):
    """x [N,G,D] -> dispatch [N,G,E,C] bf16, combine [N,G,E,C] bf16, aux
    (load-balance + z-loss, float32 scalar)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    N, G = x.shape[:2]
    C = capacity(cfg, G)
    logits = matmul_f32(x, router_w)                              # [N,G,E]
    probs = torch.softmax(logits, dim=-1)

    top1 = torch.argmax(probs, dim=-1)
    frac_routed = _one_hot(top1, E).mean(dim=(0, 1))
    frac_prob = probs.mean(dim=(0, 1))
    aux_loss = cfg.aux_loss_weight * E * torch.sum(frac_routed * frac_prob)
    z_loss = cfg.router_z_loss * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    dispatch = torch.zeros((N, G, E, C), dtype=torch.bfloat16, device=x.device)
    combine = torch.zeros((N, G, E, C), dtype=torch.float32, device=x.device)
    p_rem = probs
    prev_count = torch.zeros((N, 1, E), dtype=torch.float32, device=x.device)
    gate_sum = torch.zeros((N, G, 1), dtype=torch.float32, device=x.device)
    for _ in range(k):
        choice = torch.argmax(p_rem, dim=-1)                      # [N,G]
        oh = _one_hot(choice, E)                                  # [N,G,E]
        gate = torch.sum(p_rem * oh, dim=-1, keepdim=True)        # [N,G,1]
        pos = torch.cumsum(oh, dim=1) - oh + prev_count           # slot in expert
        keep = (pos < C).float() * oh                             # [N,G,E]
        slot = torch.sum(pos * oh, dim=-1).long()                 # [N,G]
        slot_oh = _one_hot(torch.clamp(slot, 0, C - 1), C)        # [N,G,C]
        d = keep[..., None] * slot_oh[:, :, None, :]              # [N,G,E,C]
        dispatch = dispatch + d.to(torch.bfloat16)
        combine = combine + d * gate[..., None]
        gate_sum = gate_sum + gate * torch.sum(keep, dim=-1, keepdim=True)
        prev_count = prev_count + torch.sum(oh, dim=1, keepdim=True)
        p_rem = p_rem * (1.0 - oh)
    combine = combine / torch.clamp(gate_sum[..., None], min=1e-9)
    return dispatch, combine.to(torch.bfloat16), aux_loss + z_loss


def _promote(a, b):
    """Cast ``a`` to the dtype JAX promotes ``a`` and ``b`` to (exact:
    bf16 -> float32 or no cast)."""
    return a.to(torch.promote_types(a.dtype, b.dtype))


def _experts(p, xe, cfg, xin=None):
    """The expert FFNs over their dispatched tokens xe [N,E,C,D]. Inputs
    are promoted at each use, as jnp.einsum does: the bf16 ``xe`` then gets
    one rounded cotangent per use, summed in bf16, as in JAX's gradient.
    ``xin``: the promoted inputs of ``wi`` and ``wg`` given (the parts of
    a cut weight share them, so each use still rounds one cotangent)."""
    xi, xg = xin or (_promote(xe, p.wi), _promote(xe, p.wg) if cfg.gated_mlp else None)
    h = torch.einsum("necd,edf->necf", xi, p.wi)
    if cfg.gated_mlp:
        h = activation(h, cfg.act) * torch.einsum("necd,edf->necf", xg, p.wg)
    else:
        h = activation(h, cfg.act)
    return torch.einsum("necf,efd->necd", h, p.wo)


def _inputs(p, xe, cfg):
    """``xe`` promoted for ``wi`` and ``wg`` (a part's dtypes)."""
    wi = p.wi.parts[0] if isinstance(p.wi, Fsdp) else p.wi
    wg = (p.wg.parts[0] if isinstance(p.wg, Fsdp) else p.wg) if cfg.gated_mlp else None
    return _promote(xe, wi), None if wg is None else _promote(xe, wg)


def _experts_over_data(p, xe, cfg, xin):
    """``_experts`` on the promoted inputs ``xin``; with the experts in
    ``Fsdp`` parts by their expert dim (``expert_parallel``), each part over
    its experts' slots, the outputs joined along the experts."""
    if not isinstance(p.wi, Fsdp):
        return _experts(p, xe, cfg, xin)
    outs, lo = [], 0
    for i, wi in enumerate(p.wi.parts):
        n = wi.shape[0]
        q = types.SimpleNamespace(wi=wi, wo=p.wo.parts[i],
                                  wg=p.wg.parts[i] if cfg.gated_mlp else None)
        outs.append(_experts(q, None, cfg, tuple(
            None if t is None else t[:, lo:lo + n] for t in xin)))
        lo += n
    return torch.cat(outs, 1)


def apply_moe(p, x, cfg):
    """x [B,S,D] -> ([B,S,D], aux scalar)."""
    B, S, D = x.shape
    T = B * S
    G = min(cfg.moe_group_size, T)
    Tp = -(-T // G) * G                       # pad to a group multiple
    xf = x.reshape(T, D)
    if Tp != T:
        xf = F.pad(xf, (0, 0, 0, Tp - T))
    N = Tp // G
    xg = xf.reshape(N, G, D)
    dispatch, combine, aux = route(p.router, xg, cfg)
    xe = torch.einsum("ngec,ngd->necd", dispatch, xg.to(torch.bfloat16))
    if isinstance(p.wi, Shards) and p.wi.dim == 0:
        n_e = p.wi.parts[0].shape[0]
        ye = gather(Shards([
            _experts(p.part(j), xe[:, j * n_e:(j + 1) * n_e].to(d), cfg)
            for j, d in enumerate(p.devices())], 1), x.device)
    elif isinstance(p.wi, Shards):
        devs = p.devices()
        xin = _inputs(p.part(0), xe, cfg)
        ye = psum(per_part(lambda j: _experts_over_data(
            p.part(j), xe, cfg, tuple(t if t is None else t.to(devs[j]) for t in xin)),
            len(devs)), x.device)
    else:
        ye = _experts_over_data(p, xe, cfg, _inputs(p, xe, cfg))
    y = torch.einsum("necd,ngec->ngd", ye, _promote(combine, ye))
    y = y.reshape(Tp, D)[:T]
    return y.reshape(B, S, D).to(x.dtype), aux
