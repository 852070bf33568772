"""Decoder-only LM covering the five transformer archs of the registry (the
port of the reference's ``models/transformer.py``: its forward, training
loss and serving path).

The layer pattern comes in blocks of ``e`` layers (``_block_counts``): per
block, ``e`` attention layers, ``e - 1`` dense FFNs and a last FFN or the
MoE.  ``Transformer`` holds what the reference's ``init_params`` builds, per
block instead of stacked over blocks (``models/weights.py`` converts between
the two).  Weights are stored in f32 and cast to the activation dtype at
each use, as the reference does; they are ordinary trainable parameters
(``prefill_step`` and ``serve_step`` run under ``torch.inference_mode``
themselves, so serving builds no graph whatever the caller's grad mode).
``forward`` is a Python loop over blocks, each block recomputed in the
backward when grad is on
(the reference's per-block remat); ``loss_fn`` is the training loss;
``serve_step`` decodes one token against a KV cache of preallocated
tensors, written in place (local layers keep rolling window caches).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.matrices import resolve_device

from .attention import banded_attention, chunked_attention, decode_attention
from .common import dense_init, rms_norm, rope
from .moe import moe_apply, moe_params


def _block_counts(cfg: TransformerConfig) -> tuple[int, int]:
    """Blocks of e layers; e = lcm(MoE interleave period, local:global
    attention period), so the layer pattern inside a block is static."""
    e = cfg.moe.every if cfg.moe else 1
    if cfg.window and cfg.local_global_ratio:
        e = math.lcm(e, cfg.local_global_ratio + 1)
    if cfg.n_layers % e:
        raise ValueError(f"{cfg.n_layers} layers do not fold into blocks of {e}")
    return cfg.n_layers // e, e


def _act_dtype(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------- #
# Parameters
# ---------------------------------------------------------------------- #


def _params(params: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})


def _zeros(dev, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _attn_layer_params(cfg: TransformerConfig, gen, dev) -> nn.ParameterDict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def init(shape):
        return dense_init(shape, generator=gen, device=dev)

    p = {
        "norm": _zeros(dev, d),
        "wq": init((d, H * hd)).reshape(d, H, hd),
        "wk": init((d, KV * hd)).reshape(d, KV, hd),
        "wv": init((d, KV * hd)).reshape(d, KV, hd),
        "wo": init((H * hd, d)).reshape(H, hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = _zeros(dev, hd)
        p["k_norm"] = _zeros(dev, hd)
    return _params(p)


def _dense_ffn_params(cfg: TransformerConfig, gen, dev) -> nn.ParameterDict:
    d, f = cfg.d_model, cfg.d_ff
    return _params({
        "norm": _zeros(dev, d),
        "gate": dense_init((d, f), generator=gen, device=dev),
        "up": dense_init((d, f), generator=gen, device=dev),
        "down": dense_init((f, d), generator=gen, device=dev),
    })


class Block(nn.Module):
    """One block of ``e`` layers: ``attn[i]`` for i < e, ``dense_ffn[i]``
    for i < e - 1, then ``last_ffn`` or ``moe`` with ``moe_norm``."""

    def __init__(self, cfg: TransformerConfig, gen, dev):
        super().__init__()
        _, e = _block_counts(cfg)
        self.attn = nn.ModuleList(_attn_layer_params(cfg, gen, dev) for _ in range(e))
        self.dense_ffn = nn.ModuleList(_dense_ffn_params(cfg, gen, dev) for _ in range(e - 1))
        if cfg.moe:
            self.moe = _params(moe_params(cfg.d_model, cfg.moe, generator=gen, device=dev))
            self.moe_norm = nn.Parameter(_zeros(dev, cfg.d_model))
        else:
            self.last_ffn = _dense_ffn_params(cfg, gen, dev)


class Transformer(nn.Module):
    """The parameters of one LM, drawn from ``torch.Generator(device)``
    seeded with ``seed`` (on the ``meta`` device only the shapes exist).
    A CUDA ``device`` on a machine without a card raises.

    The module holds parameters only: ``forward``, ``prefill_step`` and
    ``serve_step`` take the config they compute with, whose ``dtype`` is the
    activation dtype (the f32 weights serve any).  ``cfg`` is kept for the
    block layout (``models/weights.py``) and for ``check_config``, which
    those functions call."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        n_blocks, _ = _block_counts(cfg)

        self.embed = nn.Parameter(dense_init((cfg.vocab, cfg.d_model), generator=gen, device=dev, scale=1.0))
        self.unembed = nn.Parameter(dense_init((cfg.d_model, cfg.vocab), generator=gen, device=dev))
        self.final_norm = nn.Parameter(_zeros(dev, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(n_blocks))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def check_config(self, cfg: TransformerConfig) -> None:
        """Raise unless ``cfg`` is the config the model was built from, up
        to the activation dtype."""
        if dataclasses.replace(self.cfg, dtype=cfg.dtype) != cfg:
            raise ValueError(f"the model was built from another config than this {cfg.arch_id} "
                             "(the dtype aside)")


# ---------------------------------------------------------------------- #
# Forward (prefill)
# ---------------------------------------------------------------------- #


def _embed(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The reference casts the whole table and scales by ``sqrt(d)`` rounded
    to the activation dtype (31.0 in bf16 for d = 960, not 30.98); gathering
    the rows before the cast gives the same values."""
    dt = _act_dtype(cfg)
    scale = torch.tensor(cfg.d_model**0.5, dtype=dt, device=tokens.device)
    return params.embed[tokens].to(dt) * scale


def _logits(params: Transformer, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """f32 logits of activation-dtype operands: the products exact in f32
    and summed there (a bf16 matmul would round its output to bf16)."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x.float() @ params.unembed.to(x.dtype).float()


def _attn_sublayer(p, x: torch.Tensor, cfg: TransformerConfig, is_local: bool,
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    dt = x.dtype
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = positions if positions is not None else torch.arange(x.shape[1], device=x.device)[None, :]
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    S = x.shape[1]
    if cfg.window and is_local and S % cfg.window == 0 and S >= 8 * cfg.window:
        # the reference's gate: at S >= 8W the band's 2*W*S score work beats
        # the masked S^2/2
        out = banded_attention(q, k, v, cfg.window)
    elif cfg.window and is_local:
        out = chunked_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)
    else:
        out = chunked_attention(q, k, v, causal=True, window=0, chunk=cfg.attn_chunk)
    return x + torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _dense_ffn(p, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    dt = x.dtype
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    act = F.silu(h @ p["gate"].to(dt)) * (h @ p["up"].to(dt))
    return x + act @ p["down"].to(dt)


def _moe_sublayer(p, norm_scale, x: torch.Tensor, cfg: TransformerConfig, drop_tokens: bool = True):
    B, S, d = x.shape
    h = rms_norm(x, norm_scale, cfg.norm_eps)
    y, aux = moe_apply(p, h.reshape(B * S, d), cfg.moe, drop_tokens)
    return x + y.reshape(B, S, d), aux


def apply_block(bp: Block, x: torch.Tensor, cfg: TransformerConfig, drop_tokens: bool = True):
    """One block of ``e`` layers: attn (+ dense FFN) x (e - 1), then attn +
    (MoE | dense) FFN.  The local/global flag is static per position."""
    _, e = _block_counts(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(e):
        x = _attn_sublayer(bp.attn[i], x, cfg, cfg.layer_is_local(i))
        if i < e - 1:
            x = _dense_ffn(bp.dense_ffn[i], x, cfg)
    if cfg.moe:
        x, aux = _moe_sublayer(bp.moe, bp.moe_norm, x, cfg, drop_tokens)
    else:
        x = _dense_ffn(bp.last_ffn, x, cfg)
    return x, aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            last_only: bool = False, drop_tokens: bool = False):
    """tokens (B, S) int -> (logits (B, S, vocab) f32, or (B, 1, vocab) with
    ``last_only``; the mean MoE aux loss).  ``drop_tokens`` False (dropless
    MoE) makes the teacher-forced logits match token-by-token decode.

    With grad enabled each block is checkpointed: only its input is kept,
    and the backward runs the block again (the reference's ``jax.checkpoint``
    with nothing saveable), so activation memory is one block deep."""
    params.check_config(cfg)
    n_blocks, _ = _block_counts(cfg)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for bp in params.blocks:
        if remat:
            x, a = checkpoint(apply_block, bp, x, cfg, drop_tokens, use_reentrant=False)
        else:
            x, a = apply_block(bp, x, cfg, drop_tokens)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg), aux / n_blocks


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL of f32 logits over the targets ``>= 0`` (the others
    are masked out; at least one counts in the denominator)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.clamp(min=0).long()[..., None])[..., 0]
    mask = (targets >= 0).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_head_loss(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + unembedding + token cross-entropy: the non-block part of
    the loss, on the hidden states ``x`` (B, S, d)."""
    return _nll(_logits(params, x, cfg), targets)


def loss_fn(params: Transformer, batch, cfg: TransformerConfig):
    """The training loss of a batch ``{"tokens", "targets"}`` (B, S): the
    forward with capacity drops, the masked mean NLL of its f32 logits plus
    ``0.01 * aux``.  Returns ``(loss, {"nll", "aux"})``."""
    logits, aux = forward(params, batch["tokens"], cfg, drop_tokens=True)
    nll = _nll(logits, batch["targets"])
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


@torch.inference_mode()
def prefill_step(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Serving prefill: full-sequence forward, last-token logits (B, vocab),
    with capacity-drop MoE dispatch as the reference's prefill keeps."""
    logits, _ = forward(params, tokens, cfg, last_only=True, drop_tokens=True)
    return logits[:, 0]


# ---------------------------------------------------------------------- #
# Serving (decode with KV cache)
# ---------------------------------------------------------------------- #


def cache_len(cfg: TransformerConfig, layer: int, max_seq: int) -> int:
    if cfg.window and cfg.layer_is_local(layer):
        return min(cfg.window, max_seq)
    return max_seq


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> list[dict[str, torch.Tensor]]:
    """Per layer ``{"k", "v"}`` of (batch, cache_len, KV, hd), zeroed."""
    dev = resolve_device(device)
    dt = dtype or _act_dtype(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    return [
        {name: torch.zeros((batch, cache_len(cfg, i, max_seq), KV, hd), dtype=dt, device=dev)
         for name in ("k", "v")}
        for i in range(cfg.n_layers)
    ]


@torch.inference_mode()
def serve_step(params: Transformer, cache, tokens: torch.Tensor, pos: int, cfg: TransformerConfig):
    """One decode step.  tokens (B, 1); ``pos`` the current position.

    Writes this position's keys and values into ``cache`` in place (slot
    ``pos % S_c``, rolling for window caches) and returns
    ``(logits (B, vocab) f32, cache)``.
    """
    params.check_config(cfg)
    _, e = _block_counts(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    for layer in range(cfg.n_layers):
        b, i = divmod(layer, e)
        bp = params.blocks[b]
        p = bp.attn[i]
        dt = x.dtype
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(dt))
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        c = cache[layer]
        slot = pos % c["k"].shape[1]
        c["k"][:, slot] = k[:, 0]
        c["v"][:, slot] = v[:, 0]
        is_local = bool(cfg.window) and cfg.layer_is_local(layer)
        out = decode_attention(q, c["k"], c["v"], pos, window=cfg.window if is_local else 0)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
        if i < e - 1:
            x = _dense_ffn(bp.dense_ffn[i], x, cfg)
        elif cfg.moe:
            # dropless: a decode step must never lose a token to capacity
            x, _ = _moe_sublayer(bp.moe, bp.moe_norm, x, cfg, drop_tokens=False)
        else:
            x = _dense_ffn(bp.last_ffn, x, cfg)
    return _logits(params, x, cfg)[:, 0], cache
