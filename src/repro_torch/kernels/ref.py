"""Plain torch versions of the port's kernels (the CPU path and the
oracle the CUDA kernels are held against on the card)."""
from __future__ import annotations

import torch

from repro_torch.core.matrices import pack_bits, unpack_bits


def bitmm_ref(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    """Bitpacked Boolean matmul: (B, m, k/32) x (B, k, w) -> (B, m, w) int32.

    ``C[b, i, :] = OR_{k : bit k of lhs[b, i]} rhs[b, k, :]``, computed by
    unpacking to 0/1 fp32, a matmul, ``> 0`` and repacking — exact for
    Boolean inputs, since every term is non-negative and a count of at
    least 1 stays positive.  The rhs unpacks to its full ``32·w`` columns,
    so ``w`` need not equal ``k/32``.
    """
    k, w = rhs_packed.shape[-2:]
    lhs = unpack_bits(lhs_packed, k).to(torch.float32)
    rhs = unpack_bits(rhs_packed, 32 * w).to(torch.float32)
    return pack_bits(torch.matmul(lhs, rhs) > 0)


def bitmm_or_ref(
    lhs_packed: torch.Tensor, rhs_packed: torch.Tensor, acc_packed: torch.Tensor
) -> torch.Tensor:
    """Fused closure step ``acc | (lhs x rhs)`` on int32 words: lhs
    (B, m, k/32), rhs (B, k, w), acc (B, m, w) -> (B, m, w).  Rectangular
    like :func:`bitmm_ref`; at square shapes it is the function of the
    reference's ``bitmm_or_pallas``."""
    prod = bitmm_ref(lhs_packed, rhs_packed)
    if acc_packed.shape != prod.shape:
        raise ValueError(
            f"bitmm_or_ref: acc is {tuple(acc_packed.shape)}, the product is "
            f"{tuple(prod.shape)}"
        )
    return acc_packed | prod


def tile_bitmm_ref(lhs_tiles: torch.Tensor, rhs_tiles: torch.Tensor) -> torch.Tensor:
    """Square-tile bitpacked Boolean matmul of the block-sparse backend:
    (p, B, B/32) x (p, B, B/32) -> (p, B, B/32), one independent product
    per pair — :func:`bitmm_ref` at the tile shape."""
    return bitmm_ref(lhs_tiles, rhs_tiles)


def tile_contract_ref(
    tiles: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """OR of the tile products of each output segment: ``out[s] = OR over
    pairs p with seg[p] == s of tiles[l_idx[p]] x tiles[r_idx[p]]``,
    ``(n_out, B, B/32)`` int32.  Pad pairs name segment ``n_out`` and are
    dropped.  The reference's ``_contract_chunk`` up to ``packed``: gather,
    multiply, unpack to 0/1 bytes, ``amax`` per segment (max over {0, 1}
    is the OR), repack."""
    lhs = tiles[l_idx.long()]
    rhs = tiles[r_idx.long()]
    prod = bitmm_ref(lhs, rhs)
    bits = unpack_bits(prod, 32 * prod.shape[-1]).to(torch.uint8)
    merged = torch.zeros(
        (n_out + 1, *bits.shape[1:]), dtype=torch.uint8, device=bits.device
    )
    index = seg.long().view(-1, 1, 1).expand_as(bits)
    merged.scatter_reduce_(0, index, bits, "amax")
    return pack_bits(merged[:n_out].bool())
