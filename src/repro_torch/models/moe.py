"""Mixture-of-experts layer: top-k routing, sort-based dispatch, capacity
drop (the port of the reference's ``models/moe.py``, one token group: the
mesh-sharded grouping waits for the sharded LM).

Dispatch: every (token, choice) pair is sorted by expert (a stable sort, so
capacity keeps the earliest pairs in flat token order, as the reference
does), ranked within its expert, and written to slot ``expert * cap + rank``
of the (E * cap, d) buffer; a pair past capacity goes to the dump slot
``E * cap - 1`` with a zero value and a zero weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

from .common import dense_init


def moe_params(d_model: int, m: MoEConfig, *, generator: torch.Generator | None, device,
               dtype=torch.float32) -> dict[str, torch.Tensor]:
    def init(shape, dt=dtype):
        return dense_init(shape, generator=generator, device=device, dtype=dt)

    p = {
        "router": init((d_model, m.n_experts), torch.float32),
        "we_gate": init((m.n_experts, d_model, m.d_ff_expert)),
        "we_up": init((m.n_experts, d_model, m.d_ff_expert)),
        "we_down": init((m.n_experts, m.d_ff_expert, d_model)),
    }
    if m.d_ff_shared:
        p["ws_gate"] = init((d_model, m.d_ff_shared))
        p["ws_up"] = init((d_model, m.d_ff_shared))
        p["ws_down"] = init((m.d_ff_shared, d_model))
    return p


def moe_apply(p, x: torch.Tensor, m: MoEConfig, drop_tokens: bool = True):
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar).

    ``drop_tokens`` selects the capacity policy: True drops the pairs past
    an expert's capacity (each token's output then depends on the batch);
    False sizes capacity for the worst case, so decode reproduces prefill.
    """
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    dev, dt = x.device, x.dtype

    logits = x.float() @ p["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)  # (T, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss
    density = torch.bincount(expert_idx.reshape(-1), minlength=E).float() / (T * k)
    router_frac = probs.mean(dim=0)
    aux = E * torch.sum(density * router_frac)

    if drop_tokens:
        cap = int(T * k / E * m.capacity_factor)
        cap = max(4, -(-cap // 4) * 4)
    else:
        cap = T * k  # worst case: every assignment lands on one expert
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, E * cap - 1)
    token_of = order // k

    gathered = x[token_of] * keep[:, None].to(dt)
    buf = torch.zeros((E * cap, d), dtype=dt, device=dev).index_add_(0, dest, gathered)
    xe = buf.reshape(E, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["we_gate"].to(dt))) * torch.einsum(
        "ecd,edf->ecf", xe, p["we_up"].to(dt))
    ye = torch.einsum("ecf,efd->ecd", h, p["we_down"].to(dt)).reshape(E * cap, d)

    w = gate.reshape(-1)[order] * keep
    contrib = ye[dest] * w[:, None].to(dt)
    y = torch.zeros((T, d), dtype=dt, device=dev).index_add_(0, token_of, contrib)

    if m.d_ff_shared:
        hs = F.silu(x @ p["ws_gate"].to(dt)) * (x @ p["ws_up"].to(dt))
        y = y + hs @ p["ws_down"].to(dt)
    return y, aux
