"""Mixture-of-experts layer: top-k routing, grouped sort-based dispatch,
capacity drop (the port of the reference's ``models/moe.py``).

Dispatch: every (token, choice) pair of a token group is sorted by expert
(a stable sort, so capacity keeps the earliest pairs in flat token order,
as the reference does), ranked within its expert, and written to slot
``expert * cap + rank`` of the group's (E * cap, d) buffer; a pair past
capacity goes to the dump slot ``E * cap - 1`` with a zero value and a
zero weight.

Without a plan the tokens are one group.  With a ``MeshPlan`` they are
``G = plan.batch_size_divisor`` groups of the flat token order, each
with its own capacity (one group when ``(T // G) * k < E``): group ``g``
is row rank ``g``'s rows (over ``(pod, data)``, or ``data``), so each
rank dispatches its own tokens, and the experts are split over ``model``
when their count divides (``moe_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.shard import collectives as C
from repro_torch.shard.plans import P

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


def moe_specs(d_model: int, m: MoEConfig, plan) -> dict[str, P]:
    """The reference's MoE parameter specs for one block (its ``param_specs``
    without the leading block dim): experts over ``tp_dim(E)``, ``d`` over
    ``fsdp_dim``, the shared expert's hidden dim over ``tp_dim``."""
    fs, tp = plan.fsdp_dim, plan.tp_dim
    ex = tp(m.n_experts)
    specs = {
        "router": P(fs(d_model), None),
        "we_gate": P(ex, fs(d_model), None),
        "we_up": P(ex, fs(d_model), None),
        "we_down": P(ex, None, fs(d_model)),
    }
    if m.d_ff_shared:
        specs["ws_gate"] = P(fs(d_model), tp(m.d_ff_shared))
        specs["ws_up"] = P(fs(d_model), tp(m.d_ff_shared))
        specs["ws_down"] = P(tp(m.d_ff_shared), fs(d_model))
    return specs


def moe_apply(p, x: torch.Tensor, m: MoEConfig, drop_tokens: bool = True, plan=None):
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar).

    ``drop_tokens`` selects the capacity policy: True drops the pairs past
    an expert's capacity (each token's output then depends on its group);
    False sizes capacity for the worst case, so decode reproduces prefill.

    With a ``plan`` (a ``MeshPlan`` of a live mesh), ``p`` holds this rank's
    blocks (``moe_specs``) and ``x`` this row rank's tokens, a contiguous
    range of the flat token order, the same on every rank of its model
    group; ``y`` is theirs and ``aux`` the whole batch's, on every rank.
    """
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    dev, dt = x.device, x.dtype
    specs = None
    if plan is not None:
        specs = moe_specs(d, m, plan)
        p = {name: C.use(w, plan, specs[name], name="moe." + name) for name, w in p.items()}

    logits = x.float() @ p["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)  # (T, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss, over every token of the batch
    # (index_add_ of ones rather than bincount, which has no meta kernel:
    # the counts are integers below 2^24, exact in f32 in any order)
    routed = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, routed, torch.ones(routed.shape, dtype=torch.float32, device=dev))
    if plan is None:
        density = counts / (T * k)
        router_frac = probs.mean(dim=0)
    else:
        n_all = T * plan.row_size
        density = C.all_reduce(counts, plan, plan.row_axes, "moe.aux") / (n_all * k)
        router_frac = C.psum(probs.sum(dim=0), plan, plan.row_axes, "moe.aux") / n_all
    aux = E * torch.sum(density * router_frac)

    # the token group this rank dispatches: its own tokens, or every row
    # rank's when the batch is one group
    gathered = plan is not None and plan.row_size > 1 and T * k < E
    if gathered:
        x = C.gather(x, 0, plan, plan.row_axes, "moe.tokens")
        gate = C.gather(gate, 0, plan, plan.row_axes, "moe.gate")
        expert_idx = C.all_gather(expert_idx, 0, plan, plan.row_axes, "moe.route")
    Tg = x.shape[0]

    if drop_tokens:
        cap = int(Tg * k / E * m.capacity_factor)
        cap = max(4, -(-cap // 4) * 4)
    else:
        cap = Tg * k  # worst case: every assignment lands on one expert
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    pos_in_e = torch.arange(Tg * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, E * cap - 1)
    token_of = order // k

    gathered_x = x[token_of] * keep[:, None].to(dt)
    buf = torch.zeros((E * cap, d), dtype=dt, device=dev).index_add_(0, dest, gathered_x)
    xe = buf.reshape(E, cap, d)
    split = specs is not None and specs["we_gate"][0] is not None
    if split:  # this rank's experts, then every expert's output gathered
        per = E // plan.model_size
        xe = xe[plan.model_rank * per:(plan.model_rank + 1) * per]
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["we_gate"].to(dt))) * torch.einsum(
        "ecd,edf->ecf", xe, p["we_up"].to(dt))
    ye = torch.einsum("ecf,efd->ecd", h, p["we_down"].to(dt))
    if split:
        ye = C.gather(ye, 0, plan, "model", "moe.experts")
    ye = ye.reshape(E * cap, d)

    w = gate.reshape(-1)[order] * keep
    contrib = ye[dest] * w[:, None].to(dt)
    y = torch.zeros((Tg, d), dtype=dt, device=dev).index_add_(0, token_of, contrib)
    if gathered:
        y = y[plan.row_rank * T:(plan.row_rank + 1) * T]
        x = x[plan.row_rank * T:(plan.row_rank + 1) * T]

    if m.d_ff_shared:
        hs = F.silu(x @ p["ws_gate"].to(dt)) * (x @ p["ws_up"].to(dt))
        ys = hs @ p["ws_down"].to(dt)
        if specs is not None and specs["ws_down"][0] is not None:
            ys = C.psum(ys, plan, ("model",), "moe.shared")
        y = y + ys
    return y, aux
