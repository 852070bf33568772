"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain torch version (``ref.py``) only for
tensors on the CPU — because the caller asked for the CPU.  On a CUDA
tensor it launches the hand-written kernel or raises; there is no
fallback.  ``launches``, ``or_launches`` and ``tile_launches`` count the
launches of each kernel in this process, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .bitmm import bitmm_cuda, bitmm_or_cuda
from .tile_bitmm import tile_contract_cuda

#: launches of the CUDA bitmm kernel (a plain counter; callers reset it)
launches = 0
#: launches of the CUDA bitmm_or kernel (likewise)
or_launches = 0
#: launches of the CUDA tile-contraction kernel (likewise)
tile_launches = 0


def bitmm(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    """Bitpacked Boolean matmul: (B, m, k//32) x (B, k, w) -> (B, m, w).

    ``m`` may differ from ``k`` (the masked closure contracts a compacted
    block of active rows against the full packed state)."""
    global launches
    if lhs_packed.device.type == "cpu" and rhs_packed.device.type == "cpu":
        return _ref.bitmm_ref(lhs_packed, rhs_packed)
    out = bitmm_cuda(lhs_packed, rhs_packed)
    launches += 1
    return out


def bitmm_or(
    lhs_packed: torch.Tensor, rhs_packed: torch.Tensor, acc_packed: torch.Tensor
) -> torch.Tensor:
    """Fused closure step ``acc | (lhs x rhs)``: (B, m, k//32) x (B, k, w)
    OR (B, m, w) -> (B, m, w), into a new tensor (``acc`` is only read)."""
    global or_launches
    if all(t.device.type == "cpu" for t in (lhs_packed, rhs_packed, acc_packed)):
        return _ref.bitmm_or_ref(lhs_packed, rhs_packed, acc_packed)
    out = bitmm_or_cuda(lhs_packed, rhs_packed, acc_packed)
    or_launches += 1
    return out


def tile_contract(
    tiles: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """The block-sparse contraction step, in place: ``out[s] |= OR over
    pairs p with seg[p] == s of tiles[l_idx[p]] x tiles[r_idx[p]]``.
    ``tiles`` is the ``(S, B, B/32)`` slot store, the indices ``(p,)``
    int32 (a pad pair names segment ``n_out``), ``out`` the ``(n_out, B,
    B/32)`` old tiles of the output blocks.

    Returns a ``(1,)`` int32 fault flag on ``out``'s device, nonzero when a
    pair other than a pad named a segment outside ``[0, n_out]`` or a slot
    outside ``tiles``; such a pair is skipped, on either device.  The flag
    is not read here, since reading it would sync the host: the caller
    reads it at its own sync and raises."""
    global tile_launches
    if all(t.device.type == "cpu" for t in (tiles, l_idx, r_idx, seg, out)):
        n_out, S = out.shape[0], tiles.shape[0]
        bad = (seg != n_out) & (
            (seg < 0) | (seg > n_out) | (l_idx < 0) | (l_idx >= S)
            | (r_idx < 0) | (r_idx >= S)
        )
        ok = ~bad
        out |= _ref.tile_contract_ref(tiles, l_idx[ok], r_idx[ok], seg[ok], n_out)
        return bad.any().to(torch.int32).view(1)
    fault = tile_contract_cuda(tiles, l_idx, r_idx, seg, out)
    tile_launches += 1
    return fault


def tile_bitmm(lhs_tiles: torch.Tensor, rhs_tiles: torch.Tensor) -> torch.Tensor:
    """Square-tile bitpacked Boolean matmul for the block-sparse engine:
    (p, B, B//32) x (p, B, B//32) -> (p, B, B//32), one independent B×B
    product per pair.  On the card it is the tile-contraction kernel over
    one store of both batches, pair ``i`` taking lhs slot ``i`` and rhs
    slot ``p + i`` into output ``i``."""
    global tile_launches
    if lhs_tiles.device.type == "cpu" and rhs_tiles.device.type == "cpu":
        return _ref.tile_bitmm_ref(lhs_tiles, rhs_tiles)
    if lhs_tiles.shape != rhs_tiles.shape:
        raise ValueError(
            f"tile_bitmm: lhs {tuple(lhs_tiles.shape)} and rhs "
            f"{tuple(rhs_tiles.shape)} differ"
        )
    if lhs_tiles.device != rhs_tiles.device:
        raise ValueError(
            f"tile_bitmm: lhs on {lhs_tiles.device} and rhs on "
            f"{rhs_tiles.device} are not CUDA tensors of one device"
        )
    p = lhs_tiles.shape[0]
    idx = torch.arange(p, dtype=torch.int32, device=lhs_tiles.device)
    out = torch.zeros_like(lhs_tiles)
    # the indices lie in the store by construction: the fault flag stays 0
    tile_contract_cuda(torch.cat([lhs_tiles, rhs_tiles]), idx, idx + p, idx, out)
    tile_launches += 1
    return out
