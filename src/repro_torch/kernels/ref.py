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
