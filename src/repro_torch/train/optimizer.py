"""AdamW with optional low-precision moments (8-bit-Adam style), the port of
the reference's ``train/optimizer.py``.

``moment_dtype``:

  * float32  — exact AdamW;
  * bfloat16 — 4 bytes/param of moments;
  * int8     — row-wise quantized moments (Dettmers et al., 8-bit Adam):
               1 byte/param + 4 bytes per trailing vector of scales.
               Moments are decoded, updated in f32 and encoded again each
               step.

The state is ``{"step": int32 0-d, "m": {name: moment}, "v": {name:
moment}}`` keyed by parameter name; an int8 moment is ``{"q", "scale"}``.
``apply_updates`` writes the parameters in place, under ``no_grad``, with
the reference's arithmetic in its order.  A 0-d parameter keeps its shape
(the reference's ``q8_decode`` hands it back as ``(1,)``); its int8 moment
is stored as the reference stores it, ``q`` and ``scale`` of shape (1,).

On a sharded model (``plan`` and the parameters' ``specs``) every rank
updates its own blocks: the gradient norm counts each element once (a
block held by several ranks is counted by the first of them, then one SUM
over the mesh), and an int8 row whose last dim is split takes its scale
as the MAX over the ranks that hold its pieces, as the whole row would
(``opt_state_specs`` gives the state's specs).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.shard import collectives as C
from repro_torch.shard.plans import P


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8


# ----------------------- row-wise int8 codec -------------------------- #


def _q8_zeros(p: torch.Tensor) -> dict[str, torch.Tensor]:
    shape = tuple(p.shape) if p.dim() else (1,)
    return {"q": torch.zeros(shape, dtype=torch.int8, device=p.device),
            "scale": torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=p.device)}


def q8_encode(x: torch.Tensor, sqrt_domain: bool = False, row_max=None) -> dict[str, torch.Tensor]:
    """Row-wise absmax int8: one f32 scale per trailing vector, ``q`` of
    ``x``'s shape (a 0-d ``x`` as (1,)).  ``sqrt_domain`` encodes sqrt(x)
    (x >= 0), the second moment's code: a linear one would round small
    entries of v to zero and blow up 1/sqrt(v).  ``row_max`` completes
    each row's absmax when ``x`` holds a block of the rows' last dim."""
    x = x.reshape(tuple(x.shape) if x.dim() else (1,)).float()
    if sqrt_domain:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    scale = x.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        scale = row_max(scale)
    scale = scale / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale}


def q8_decode(enc: dict[str, torch.Tensor], shape, sqrt_domain: bool = False) -> torch.Tensor:
    """The f32 values of ``enc`` in ``shape`` (a 0-d shape stays 0-d)."""
    x = (enc["q"].float() * enc["scale"]).reshape(tuple(shape))
    if sqrt_domain:
        x = x * x
    return x


def _is_q8(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


# ------------------------------ AdamW ---------------------------------- #


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _moment_zeros(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8_zeros(p)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments for ``params`` (a module, or ``{name: tensor}``), on
    their devices."""
    named = _named(params)
    dev = next(iter(named.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: _moment_zeros(p, cfg.moment_dtype) for k, p in named.items()},
        "v": {k: _moment_zeros(p, cfg.moment_dtype) for k, p in named.items()},
    }


def moment_bytes(state: dict) -> int:
    """Bytes held by the state's two moments (int8 scales included)."""
    def size(leaf):
        if _is_q8(leaf):
            return sum(size(t) for t in leaf.values())
        return leaf.numel() * leaf.element_size()

    return sum(size(leaf) for key in ("m", "v") for leaf in state[key].values())


def _read(moment, shape, sqrt_domain: bool = False) -> torch.Tensor:
    return q8_decode(moment, shape, sqrt_domain) if _is_q8(moment) else moment.float()


def _write(moment_like, value: torch.Tensor, sqrt_domain: bool = False, row_max=None):
    if _is_q8(moment_like):
        return q8_encode(value, sqrt_domain, row_max)
    return value.to(moment_like.dtype)


def _owns(spec: P, plan) -> bool:
    """Whether this rank counts its block of a leaf split by ``spec``: the
    first rank along every mesh axis the block is held alike over (the
    pods included)."""
    split = {a for a in spec if a is not None}
    return all(plan.axis_rank(a) == 0 for a in plan.axes if a not in split)


def global_norm(grads, plan=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32; of a sharded
    model's blocks (``plan`` and ``specs`` by name), every element counted
    once over the mesh, the same on every rank."""
    if plan is None:
        values = grads.values() if isinstance(grads, dict) else grads
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in values))
    dev = next(iter(grads.values())).device
    sq = sum((torch.sum(torch.square(g.float())) for k, g in grads.items() if _owns(specs[k], plan)),
             torch.zeros((), dtype=torch.float32, device=dev))
    return torch.sqrt(C.all_reduce(sq, plan, plan.axes, "grad_norm"))


def _row_max(spec: P, plan):
    """The MAX over the ranks holding the pieces of a row of a leaf whose
    last dim ``spec`` splits; None when it is whole."""
    if plan is None or not spec or spec[-1] is None:
        return None
    return lambda t: C.all_reduce(t, plan, (spec[-1],), "q8_scale", op="max")


def opt_state_specs(param_specs, cfg: OptimizerConfig, params=None, data_size: int = 16,
                    model_size: int = 16) -> dict:
    """The optimizer state's specs, mirroring ``param_specs`` (nested dicts
    of ``P``): the moments split as their parameters; an int8 moment's
    ``q`` as its parameter and its ``scale`` the same without the last dim
    (``params``, a tree of the same shape with ``.shape`` leaves, sizes
    them).  ``data_size`` and ``model_size`` are the reference's arguments,
    which it does not read either."""
    if cfg.moment_dtype != "int8":
        return {"step": P(), "m": param_specs, "v": param_specs}
    if params is None:
        raise ValueError("int8 moment specs need the params tree")

    def moment(ps, p):
        if isinstance(ps, dict):
            return {k: moment(ps[k], p[k]) for k in ps}
        shape = tuple(p.shape)
        lead = tuple(ps) + (None,) * max(0, len(shape) - len(ps))
        return {"q": ps, "scale": P(*lead[:-1], None) if shape else P(None)}

    moments = moment(param_specs, params)
    return {"step": P(), "m": moments, "v": moments}


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptimizerConfig, plan=None, specs=None) -> dict:
    """One AdamW step: ``params`` (a module, or ``{name: tensor}``) updated
    in place from ``grads`` (``{name: gradient}``; a missing one counts as
    zero), ``state`` rewritten in place.  Returns ``{"grad_norm"}``, the
    norm before clipping.  Blocks of a sharded model take ``plan`` and
    their ``specs`` by name."""
    named = _named(params)
    grads = {k: grads[k] if grads.get(k) is not None else torch.zeros_like(p) for k, p in named.items()}
    step = state["step"] + 1
    gnorm = global_norm(grads, plan, specs)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=t.device)
    c1, c2 = 1 - b1**t, 1 - b2**t
    for k, p in named.items():
        g = grads[k].float() * clip
        m = cfg.b1 * _read(state["m"][k], p.shape) + (1 - cfg.b1) * g
        v = cfg.b2 * _read(state["v"][k], p.shape, sqrt_domain=True) + (1 - cfg.b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
        row_max = _row_max(specs[k], plan) if plan is not None else None
        state["m"][k] = _write(state["m"][k], m, row_max=row_max)
        state["v"][k] = _write(state["v"][k], v, sqrt_domain=True, row_max=row_max)
    state["step"] = step
    return {"grad_norm": gnorm}
