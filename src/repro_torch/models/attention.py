"""Attention as torch ops: GQA, causal and sliding-window masks, the
online-softmax chunk loop, the banded local form and one-token decode (the
port of the reference's ``models/attention.py``).

Every product that the reference asks for with ``preferred_element_type=
float32`` is taken here on f32 operands: a bf16 operand is exact in f32, so
the products and their f32 sums are those of a bf16 x bf16 -> f32 dot, where
a bf16 ``einsum`` would round its output to bf16.  The numerics are the
reference's own; ``F.scaled_dot_product_attention`` would change them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd), k: (B, Sk, KV, hd) -> f32 (B, KV, G, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    q_offset: int = 0,
    scale: float | None = None,
    score_sum=None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a Python loop over chunks).

    Shapes: q (B, Sq, H, hd); k, v (B, S, KV, hd) with H % KV == 0.
    ``window > 0`` restricts to a sliding window (local layers).  The
    queries sit at positions ``q_offset`` on (a sequence-parallel rank's
    shard of the S keys' sequence; 0 and Sq == S without one).  ``scale``
    defaults to ``hd ** -0.5``; ``score_sum``, when given, completes each
    chunk's scores (a head_dim-split rank's partial sums) before the mask.

    With grad enabled each chunk's step is checkpointed, as the reference
    checkpoints its scan body: the backward recomputes the chunk's (S, chunk)
    probabilities instead of keeping them for every chunk, which would
    bring back the whole S x S score tensor.  The values are the same.
    """
    B, Sq, H, hd = q.shape
    S = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    scale = hd**-0.5 if scale is None else scale
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    dev = q.device

    q = q * scale
    q_pos = q_offset + torch.arange(Sq, device=dev)

    def body(m, l, acc, kj, vj, j: int):
        s = _gqa_scores(q, kj)  # (B, KV, G, Sq, chunk)
        if score_sum is not None:
            s = score_sum(s)
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vj.dtype).float(), vj.float())
        return m_new, l_new, acc * corr[..., None] + pv

    remat = torch.is_grad_enabled()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for j in range(S // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        if remat:
            m, l, acc = checkpoint(body, m, l, acc, kj, vj, j, use_reentrant=False)
        else:
            m, l, acc = body(m, l, acc, kj, vj, j)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, *,
                     q_offset: int = 0, scale: float | None = None, score_sum=None) -> torch.Tensor:
    """Sliding-window attention computing only the diagonal band: each
    W-sized query block attends to its own and the previous key block.

    Shapes: q (B, Sq, H, hd); k, v (B, S, KV, hd); S, Sq and ``q_offset``
    (the queries' first position) multiples of the window; ``scale`` and
    ``score_sum`` as in :func:`chunked_attention`.
    """
    B, Sq, H, hd = q.shape
    S = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    W = window
    if S % W or Sq % W or q_offset % W:
        raise ValueError(f"sequence {S}, queries {Sq} at {q_offset}: not multiples of the window {W}")
    nb, b0 = Sq // W, q_offset // W
    scale = hd**-0.5 if scale is None else scale
    dev = q.device

    qb = (q * scale).reshape(B, nb, W, H, hd)
    pad = torch.zeros((B, W, KV, hd), dtype=k.dtype, device=dev)
    kp = torch.cat([pad, k], dim=1).reshape(B, S // W + 1, W, KV, hd)[:, b0:b0 + nb + 1]
    vp = torch.cat([pad, v], dim=1).reshape(B, S // W + 1, W, KV, hd)[:, b0:b0 + nb + 1]
    kw = torch.cat([kp[:, :-1], kp[:, 1:]], dim=2)  # (B, nb, 2W, KV, hd)
    vw = torch.cat([vp[:, :-1], vp[:, 1:]], dim=2)

    qg = qb.reshape(B, nb, W, KV, G, hd)
    s = torch.einsum("bnqkgh,bnskh->bnkgqs", qg.float(), kw.float())  # (B, nb, KV, G, W, 2W)
    if score_sum is not None:
        s = score_sum(s)
    # query i (0..W-1) sits at absolute W + i; key j (0..2W-1) at j; the
    # sequence's block 0 has W keys of padding first
    qpos = W + torch.arange(W, device=dev)
    kpos = torch.arange(2 * W, device=dev)
    mask = (qpos[:, None] >= kpos[None, :]) & (qpos[:, None] - kpos[None, :] < W)
    m0 = mask & (kpos[None, :] >= W)
    full_mask = torch.stack([m0 if b0 + n == 0 else mask for n in range(nb)])
    s = torch.where(full_mask[None, :, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", p.to(vw.dtype).float(), vw.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S_c, KV, hd); pos: the current position.
    For local layers the cache is a rolling buffer of S_c == window slots;
    slot s holds absolute position  p_s = pos - ((pos - s) mod S_c)  (the
    newest write wins).  The modulo is a floor modulo: below S_c its
    operand is negative.
    """
    B, Sc, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = hd**-0.5
    s = _gqa_scores(q * scale, k_cache)  # (B, KV, G, 1, Sc)
    slots = torch.arange(Sc, device=q.device)
    abs_pos = pos - torch.remainder(pos - slots, Sc)  # absolute position held by slot
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window:
        valid &= abs_pos > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Unchunked oracle for tests."""
    s = _gqa_scores(q * q.shape[-1] ** -0.5, k)
    S, Sk = s.shape[-2], s.shape[-1]
    q_pos = torch.arange(S, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    B, Sq = out.shape[0], out.shape[1]
    return out.reshape(B, Sq, -1, q.shape[-1]).to(q.dtype)
