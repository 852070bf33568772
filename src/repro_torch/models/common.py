"""Shared neural-net building blocks as torch functions (the port of the
reference's ``models/common.py``).

Parameters are drawn from an explicit ``torch.Generator``: the values differ
from the reference's JAX RNG, the distributions are the same.  Tests that
hold the port against the reference load the reference's values instead
(``models/weights.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the ``(1 + scale)`` form; returns ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def dense_init(shape, *, generator: torch.Generator | None, device, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at +-2, times
    ``scale`` or ``fan_in ** -0.5``, drawn on ``device`` from ``generator``.
    On the ``meta`` device nothing is drawn (only the shape exists)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in**-0.5
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if out.is_meta:
        return out.to(dtype)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out * std).to(dtype)


def mlp_params(sizes: tuple[int, ...], *, generator: torch.Generator | None, device,
               dtype=torch.float32) -> list[dict[str, torch.Tensor]]:
    """Plain MLP: list of {w, b} dicts."""
    return [
        {"w": dense_init((a, b), generator=generator, device=device, dtype=dtype),
         "b": torch.zeros((b,), dtype=dtype, device=device)}
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def to_numpy(node):
    """A tree of tensors (nested dicts and lists) as numpy arrays; a bf16
    tensor comes out as its f32 values, which hold it exactly, and a
    ``None`` leaf stays ``None``."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy(v) for v in node]
    t = node.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def mlp_apply(params, x: torch.Tensor, act=F.relu, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(params) or final_act:
            x = act(x)
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved).  x: (..., S, H, hd);
    positions: (..., S).  Angles in f32; the output has ``x``'s dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
