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

Sharded over a mesh (``plan=`` a ``MeshPlan`` of a live process group),
a model holds this rank's blocks of the reference's ``param_specs``
(``models/weights.py`` shards one), and ``forward``, ``loss_fn`` and
``prefill_step`` take the global batch, compute with this rank's rows of
it, and move data with ``shard/collectives.py``: FSDP dims are gathered
over ``data`` at each use; in ``head`` mode the heads split over
``model`` and the output projection is summed there; in ``hd`` mode
head_dim splits and the scores and the output projection are summed; in
``seq`` mode the hidden state splits its sequence over ``model``, K and V
are gathered, and the FFN and MoE gather the tokens of their group; the
embedding and the unembedding split the vocabulary over ``model``, and the
loss takes its log-sum-exp over the split logits.
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
from repro_torch.shard import collectives as C
from repro_torch.shard.plans import MeshPlan, P

from .attention import banded_attention, chunked_attention, decode_attention
from .common import dense_init, rms_norm, rope
from .moe import moe_apply, moe_params, moe_specs


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
        self.plan: MeshPlan | None = None  # set when sharded (models/weights.py)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def check_config(self, cfg: TransformerConfig, plan: MeshPlan | None = None) -> None:
        """Raise unless ``cfg`` is the config the model was built from, up
        to the activation dtype, and ``plan`` the plan it is sharded by."""
        if dataclasses.replace(self.cfg, dtype=cfg.dtype) != cfg:
            raise ValueError(f"the model was built from another config than this {cfg.arch_id} "
                             "(the dtype aside)")
        if plan != self.plan:
            raise ValueError(f"the model is sharded by {self.plan}, not by {plan}")


# ---------------------------------------------------------------------- #
# Sharding specs
# ---------------------------------------------------------------------- #


def _attn_specs(cfg: TransformerConfig, plan: MeshPlan, decode: bool = False) -> dict[str, P]:
    """The specs of one attention layer's parameters (the reference's
    ``param_specs`` without the two leading stack dims)."""
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    mode = plan.attn_mode(H, cfg.hd, decode)
    fs, model = plan.fsdp_dim(d), plan.model_axis

    def head_spec(nh):  # (d, nh, hd)
        if mode == "head" and nh % plan.model_size == 0:
            return P(fs, model, None)
        if mode == "hd":
            return P(fs, None, model)
        return P(fs, None, None)  # uneven heads or replicate

    if mode == "head" and H % plan.model_size == 0:
        wo = P(model, None, fs)
    elif mode == "hd":
        wo = P(None, model, fs)
    else:
        wo = P(None, None, fs)
    specs = {"norm": P(fs), "wq": head_spec(H), "wk": head_spec(KV), "wv": head_spec(KV), "wo": wo}
    if cfg.qk_norm:
        specs["q_norm"] = P(None)
        specs["k_norm"] = P(None)
    return specs


def _ffn_specs(cfg: TransformerConfig, plan: MeshPlan) -> dict[str, P]:
    fs, tp = plan.fsdp_dim(cfg.d_model), plan.tp_dim(cfg.d_ff)
    return {"norm": P(fs), "gate": P(fs, tp), "up": P(fs, tp), "down": P(tp, fs)}


def _top_specs(cfg: TransformerConfig, plan: MeshPlan) -> dict[str, P]:
    """The specs of the parameters outside the blocks: the vocabulary over
    ``model``, ``d`` over ``data``."""
    fs, tp = plan.fsdp_dim(cfg.d_model), plan.tp_dim(cfg.vocab)
    return {"embed": P(tp, fs), "unembed": P(fs, tp), "final_norm": P(fs)}


def _stacked(specs: dict[str, P], n: int) -> dict[str, P]:
    return {k: P(*(None,) * n, *v) for k, v in specs.items()}


def param_specs(cfg: TransformerConfig, plan: MeshPlan, decode: bool = False) -> dict:
    """The reference's spec tree of its stacked parameters (``init_params``'
    layout): TP over ``model``, FSDP of a non-TP dim over ``data``."""
    _, e = _block_counts(cfg)
    blocks = {"attn": _stacked(_attn_specs(cfg, plan, decode), 2)}
    if e > 1:
        blocks["dense_ffn"] = _stacked(_ffn_specs(cfg, plan), 2)
    if cfg.moe:
        blocks["moe"] = _stacked(moe_specs(cfg.d_model, cfg.moe, plan), 1)
        blocks["moe_norm"] = P(None, plan.fsdp_dim(cfg.d_model))
    else:
        blocks["last_ffn"] = _stacked(_ffn_specs(cfg, plan), 1)
    return {**_top_specs(cfg, plan), "blocks": blocks}


def _x_spec(cfg: TransformerConfig, plan: MeshPlan) -> P:
    """Hidden-state layout: batch over data; the sequence over model when
    the arch runs sequence-parallel attention."""
    if plan.attn_mode(cfg.n_heads, cfg.hd, False) == "seq":
        return P(plan.batch, plan.model_axis, None)
    return plan.p_batch(None, None)


def _seq_parallel(cfg: TransformerConfig, plan: MeshPlan | None) -> bool:
    return plan is not None and plan.attn_mode(cfg.n_heads, cfg.hd, False) == "seq"


def _rows(t: torch.Tensor, plan: MeshPlan | None) -> torch.Tensor:
    """This row rank's rows (over ``(pod, data)``, or ``data``) of a global
    batch tensor."""
    if plan is None:
        return t
    if t.shape[0] % plan.row_size:
        raise ValueError(f"batch {t.shape[0]} does not split over {plan.row_size} row ranks")
    per = t.shape[0] // plan.row_size
    return t[plan.row_rank * per:(plan.row_rank + 1) * per]


def _seq_block(t: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """This model rank's sequence block (dim 1) of ``t``."""
    S = t.shape[1]
    if S % plan.model_size:
        raise ValueError(f"sequence {S} does not split over {plan.model_size} model ranks")
    per = S // plan.model_size
    return t[:, plan.model_rank * per:(plan.model_rank + 1) * per]


def _used(p, specs: dict[str, P], plan: MeshPlan | None, prefix: str) -> dict[str, torch.Tensor]:
    """Each parameter of ``p`` as this rank computes with it: its FSDP dim
    gathered over ``data``."""
    if plan is None:
        return dict(p.items())
    return {k: C.use(v, plan, specs[k], name=f"{prefix}.{k}") for k, v in p.items()}


# ---------------------------------------------------------------------- #
# Forward (prefill)
# ---------------------------------------------------------------------- #


def _embed(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
           plan: MeshPlan | None = None) -> torch.Tensor:
    """The reference casts the whole table and scales by ``sqrt(d)`` rounded
    to the activation dtype (31.0 in bf16 for d = 960, not 30.98); gathering
    the rows before the cast gives the same values.  With the vocabulary
    split over ``model``, each rank looks up the ids in its range and the
    rows are summed over the model group (one nonzero term each: exact)."""
    dt = _act_dtype(cfg)
    scale = torch.tensor(cfg.d_model**0.5, dtype=dt, device=tokens.device)
    if plan is None:
        return params.embed[tokens].to(dt) * scale
    spec = _top_specs(cfg, plan)["embed"]
    table = C.use(params.embed, plan, spec, name="embed")
    if spec[0] is None:
        return table[tokens].to(dt) * scale
    per = table.shape[0]
    local = tokens.long() - plan.model_rank * per
    mine = (local >= 0) & (local < per)
    rows = table[local.clamp(0, per - 1)] * mine[..., None].to(table.dtype)
    return C.psum(rows, plan, ("model",), "embed.rows").to(dt) * scale


def _final_norm(params: Transformer, x: torch.Tensor, cfg: TransformerConfig, plan) -> torch.Tensor:
    scale = params.final_norm if plan is None else C.use(
        params.final_norm, plan, _top_specs(cfg, plan)["final_norm"], name="final_norm")
    return rms_norm(x, scale, cfg.norm_eps)


def _unembed(params: Transformer, cfg: TransformerConfig, plan) -> torch.Tensor:
    """The unembedding this rank computes with: (d, vocab), or (d, vocab /
    model) when the vocabulary splits over ``model``."""
    if plan is None:
        return params.unembed
    return C.use(params.unembed, plan, _top_specs(cfg, plan)["unembed"], name="unembed")


def _logits(params: Transformer, x: torch.Tensor, cfg: TransformerConfig,
            plan: MeshPlan | None = None) -> torch.Tensor:
    """f32 logits of activation-dtype operands: the products exact in f32
    and summed there (a bf16 matmul would round its output to bf16).  With
    a plan, this rank's vocabulary block."""
    x = _final_norm(params, x, cfg, plan)
    return x.float() @ _unembed(params, cfg, plan).to(x.dtype).float()


def _kv_for_heads(k, v, specs, cfg: TransformerConfig, plan: MeshPlan):
    """K and V for this rank's query heads in ``head`` mode: as computed
    when both split alike (KV heads that divide over ``model`` imply query
    heads that do); the KV heads of this rank's query heads when only the
    queries split (standard GQA TP), one per query head when the group
    does not align with the split."""
    q_split, kv_split = specs["wq"][1] is not None, specs["wk"][1] is not None
    if q_split and not kv_split:
        G = cfg.n_heads // cfg.n_kv_heads
        Hl = cfg.n_heads // plan.model_size
        h0 = plan.model_rank * Hl
        if Hl % G == 0:
            sel = slice(h0 // G, (h0 + Hl) // G)
        else:
            sel = torch.arange(h0, h0 + Hl, device=k.device) // G
        return k[:, :, sel], v[:, :, sel]
    return k, v


def _attention(q, k, v, cfg: TransformerConfig, is_local: bool, S: int, q_offset: int = 0,
               **kw) -> torch.Tensor:
    """The reference's choice of attention for a layer of a global sequence
    of ``S``: banded for a local layer at S >= 8W (decided on the global
    S; a query shard the band does not tile takes the chunked form, which
    gives the same values), else chunked, windowed on local layers."""
    W = cfg.window
    if q_offset:
        kw["q_offset"] = q_offset
    if W and is_local and S % W == 0 and S >= 8 * W and q.shape[1] % W == 0 and q_offset % W == 0:
        # at S >= 8W the band's 2*W*S score work beats the masked S^2/2
        return banded_attention(q, k, v, W, **kw)
    return chunked_attention(q, k, v, causal=True, window=W if W and is_local else 0,
                             chunk=cfg.attn_chunk, **kw)


def _attn_sublayer(p, x: torch.Tensor, cfg: TransformerConfig, is_local: bool,
                   positions: torch.Tensor | None = None, plan: MeshPlan | None = None) -> torch.Tensor:
    if plan is not None:
        return _attn_sublayer_sharded(p, x, cfg, is_local, plan)
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
    out = _attention(q, k, v, cfg, is_local, x.shape[1])
    return x + torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _attn_sublayer_sharded(p, x: torch.Tensor, cfg: TransformerConfig, is_local: bool,
                           plan: MeshPlan) -> torch.Tensor:
    """One attention layer on this rank's block of the hidden state, by the
    plan's mode (see the module's docstring)."""
    mode = plan.attn_mode(cfg.n_heads, cfg.hd, False)
    specs = _attn_specs(cfg, plan)
    w = _used(p, specs, plan, "attn")
    dt = x.dtype
    h = rms_norm(x, w["norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, w["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, w["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, w["wv"].to(dt))
    S, offset, kw = x.shape[1], 0, {}
    if mode == "hd":
        # norm and rope act on whole head vectors: gather head_dim, apply,
        # keep this rank's block; the scores are summed over the blocks
        per = cfg.hd // plan.model_size
        mine = slice(plan.model_rank * per, (plan.model_rank + 1) * per)
        q = C.gather(q, 3, plan, "model", "attn.hd")
        k = C.gather(k, 3, plan, "model", "attn.hd")
        kw = {"scale": cfg.hd**-0.5,
              "score_sum": lambda s: C.psum(s, plan, ("model",), "attn.scores")}
    elif mode == "seq":
        offset = plan.model_rank * S
        S *= plan.model_size
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    pos = (offset + torch.arange(x.shape[1], device=x.device))[None, :]
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if mode == "hd":
        q, k = q[..., mine], k[..., mine]
    elif mode == "seq":
        k = C.gather(k, 1, plan, "model", "attn.seq_kv")
        v = C.gather(v, 1, plan, "model", "attn.seq_kv")
    elif mode == "head":
        k, v = _kv_for_heads(k, v, specs, cfg, plan)
    out = _attention(q, k, v, cfg, is_local, S, offset, **kw)
    y = torch.einsum("bshk,hkd->bsd", out, w["wo"].to(dt))
    if "model" in specs["wo"]:
        y = C.psum(y, plan, ("model",), "attn.out")
    return x + y


def _dense_ffn(p, x: torch.Tensor, cfg: TransformerConfig, plan: MeshPlan | None = None) -> torch.Tensor:
    """The gated FFN; with a plan, on tokens held alike by the model group:
    the hidden dim splits over ``model`` and the output is summed there."""
    specs = None if plan is None else _ffn_specs(cfg, plan)
    w = _used(p, specs, plan, "ffn")
    dt = x.dtype
    h = rms_norm(x, w["norm"], cfg.norm_eps)
    act = F.silu(h @ w["gate"].to(dt)) * (h @ w["up"].to(dt))
    y = act @ w["down"].to(dt)
    if specs is not None and specs["down"][0] is not None:
        y = C.psum(y, plan, ("model",), "ffn.out")
    return x + y


def _moe_sublayer(p, norm_scale, x: torch.Tensor, cfg: TransformerConfig, drop_tokens: bool = True,
                  plan: MeshPlan | None = None):
    B, S, d = x.shape
    if plan is not None:
        norm_scale = C.use(norm_scale, plan, P(plan.fsdp_dim(d)), name="moe_norm")
    h = rms_norm(x, norm_scale, cfg.norm_eps)
    y, aux = moe_apply(p, h.reshape(B * S, d), cfg.moe, drop_tokens, plan)
    return x + y.reshape(B, S, d), aux


def _token_wise(fn, x: torch.Tensor, cfg: TransformerConfig, plan: MeshPlan | None):
    """``fn(x)`` for a sublayer that wants the model group's tokens alike:
    in ``seq`` mode the sequence blocks are gathered first and this rank's
    block of the output kept."""
    if not _seq_parallel(cfg, plan):
        return fn(x)
    out = fn(C.gather(x, 1, plan, "model", "seq.tokens"))
    if isinstance(out, tuple):
        return (_seq_block(out[0], plan), *out[1:])
    return _seq_block(out, plan)


def apply_block(bp: Block, x: torch.Tensor, cfg: TransformerConfig, drop_tokens: bool = True,
                plan: MeshPlan | None = None):
    """One block of ``e`` layers: attn (+ dense FFN) x (e - 1), then attn +
    (MoE | dense) FFN.  The local/global flag is static per position."""
    _, e = _block_counts(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(e):
        x = _attn_sublayer(bp.attn[i], x, cfg, cfg.layer_is_local(i), plan=plan)
        if i < e - 1:
            x = _token_wise(lambda t, i=i: _dense_ffn(bp.dense_ffn[i], t, cfg, plan), x, cfg, plan)
    if cfg.moe:
        x, aux = _token_wise(lambda t: _moe_sublayer(bp.moe, bp.moe_norm, t, cfg, drop_tokens, plan),
                             x, cfg, plan)
    else:
        x = _token_wise(lambda t: _dense_ffn(bp.last_ffn, t, cfg, plan), x, cfg, plan)
    return x, aux


def _hidden(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            plan: MeshPlan | None, drop_tokens: bool):
    """The blocks' output for this rank's rows of ``tokens`` (its sequence
    block in ``seq`` mode) and the mean MoE aux loss."""
    params.check_config(cfg, plan)
    n_blocks, _ = _block_counts(cfg)
    x = _embed(params, _rows(tokens, plan), cfg, plan)
    if _seq_parallel(cfg, plan):
        x = _seq_block(x, plan)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for bp in params.blocks:
        if remat:
            x, a = checkpoint(apply_block, bp, x, cfg, drop_tokens, plan, use_reentrant=False)
        else:
            x, a = apply_block(bp, x, cfg, drop_tokens, plan)
        aux = aux + a
    return x, aux / n_blocks


def forward(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
            plan: MeshPlan | None = None, last_only: bool = False, drop_tokens: bool = False):
    """tokens (B, S) int -> (logits (B, S, vocab) f32, or (B, 1, vocab) with
    ``last_only``; the mean MoE aux loss).  ``drop_tokens`` False (dropless
    MoE) makes the teacher-forced logits match token-by-token decode.

    With grad enabled each block is checkpointed: only its input is kept,
    and the backward runs the block again (the reference's ``jax.checkpoint``
    with nothing saveable), so activation memory is one block deep.

    With a plan, ``tokens`` is the global batch (the same on every rank)
    and every rank returns the global logits, gathered."""
    x, aux = _hidden(params, tokens, cfg, plan, drop_tokens)
    if _seq_parallel(cfg, plan):
        x = C.gather(x, 1, plan, "model", "seq.tokens")
    if last_only:
        x = x[:, -1:]
    logits = _logits(params, x, cfg, plan)
    if plan is not None:
        if plan.tp_dim(cfg.vocab) is not None:
            logits = C.gather(logits, 2, plan, "model", "logits")
        logits = C.gather(logits, 0, plan, plan.row_axes, "logits")
    return logits, aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL of f32 logits over the targets ``>= 0`` (the others
    are masked out; at least one counts in the denominator)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.clamp(min=0).long()[..., None])[..., 0]
    mask = (targets >= 0).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _global_loss(share: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A tensor whose value is the global ``value`` and whose gradient is
    that of this rank's ``share`` of it (``value + (share - share)``)."""
    return value.detach() + (share - share.detach())


def _sharded_nll(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                 cfg: TransformerConfig, plan: MeshPlan) -> torch.Tensor:
    """The masked mean NLL of the global batch from this rank's hidden
    states (see ``_global_loss``).  The log-sum-exp of vocab-split logits
    takes a MAX then a SUM over ``model``; the target's logit comes from
    the rank whose block holds it."""
    if _seq_parallel(cfg, plan):
        x = C.gather(x, 1, plan, "model", "seq.tokens")
    logits = _logits(params, x, cfg, plan)  # (b, S, vocab block)
    tgt = targets.long()
    if plan.tp_dim(cfg.vocab) is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt.clamp(min=0)[..., None])[..., 0]
    else:
        per = logits.shape[-1]
        m = C.all_reduce(logits.detach().amax(dim=-1), plan, ("model",), "loss.max", op="max")
        se = C.psum(torch.exp(logits - m[..., None]).sum(dim=-1), plan, ("model",), "loss.sumexp")
        local = tgt - plan.model_rank * per
        mine = (local >= 0) & (local < per)
        t = torch.gather(logits, -1, local.clamp(0, per - 1)[..., None])[..., 0] * mine
        nll = m + torch.log(se) - C.psum(t, plan, ("model",), "loss.target")
    mask = (targets >= 0).float()
    count = torch.clamp(C.all_reduce(mask.sum(), plan, plan.row_axes, "loss.count"), min=1.0)
    total = (nll * mask).sum()
    value = C.all_reduce(total.detach(), plan, plan.row_axes, "loss.value") / count
    # the model group holds the same tokens: each rank counts 1/model of them
    return _global_loss(total / count / plan.model_size, value)


def lm_head_loss(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                 cfg: TransformerConfig, plan: MeshPlan | None = None) -> torch.Tensor:
    """Final norm + unembedding + token cross-entropy: the non-block part of
    the loss, on the hidden states ``x`` (B, S, d).  With a plan, ``x`` is
    this rank's block (``_x_spec``) and ``targets`` the global batch's."""
    if plan is None:
        return _nll(_logits(params, x, cfg), targets)
    return _sharded_nll(params, x, _rows(targets, plan), cfg, plan)


def loss_fn(params: Transformer, batch, cfg: TransformerConfig, plan: MeshPlan | None = None):
    """The training loss of a batch ``{"tokens", "targets"}`` (B, S): the
    forward with capacity drops, the masked mean NLL of its f32 logits plus
    ``0.01 * aux``.  Returns ``(loss, {"nll", "aux"})``.

    With a plan the batch is the global one; the loss's value is the global
    loss on every rank, and its gradient this rank's share, so that
    ``backward`` leaves each rank its block of the global gradient."""
    x, aux = _hidden(params, batch["tokens"], cfg, plan, drop_tokens=True)
    if plan is None:
        nll = _nll(_logits(params, x, cfg), batch["targets"])
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}
    nll = lm_head_loss(params, x, batch["targets"], cfg, plan)
    # aux is the same on every rank of the mesh
    aux_term = _global_loss(0.01 * aux / plan.world, 0.01 * aux)
    return nll + aux_term, {"nll": nll.detach(), "aux": aux.detach()}


@torch.inference_mode()
def prefill_step(params: Transformer, tokens: torch.Tensor, cfg: TransformerConfig,
                 plan: MeshPlan | None = None) -> torch.Tensor:
    """Serving prefill: full-sequence forward, last-token logits (B, vocab),
    with capacity-drop MoE dispatch as the reference's prefill keeps.  With
    a plan, the global batch in and the global logits out on every rank."""
    logits, _ = forward(params, tokens, cfg, plan, last_only=True, drop_tokens=True)
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


def cache_specs(cfg: TransformerConfig, plan: MeshPlan, seq_shard: bool) -> list[dict[str, P]]:
    """The reference's KV cache specs: batch over data and head_dim over
    model; with ``seq_shard`` (long context, batch 1) the sequence over
    data instead of the batch."""
    if seq_shard:
        spec = P(None, plan.data_axis, None, plan.model_axis)
    else:
        spec = P(plan.batch, None, None, plan.model_axis)
    return [{"k": spec, "v": spec} for _ in range(cfg.n_layers)]


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
