"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain torch version (``ref.py``) only for
tensors on the CPU — because the caller asked for the CPU.  On a CUDA
tensor it launches the hand-written kernel or raises; there is no
fallback.  On ``meta`` tensors it returns an empty output of the right
shape and reports the kernel's cost to ``roofline/count.py`` (the dry
run's count), launching nothing.  ``launches``, ``or_launches``, ``tile_launches``,
``minplus_launches`` and ``count_mm_launches`` count the launches of each
kernel in this process, so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .bitmm import bitmm_cuda, bitmm_or_cuda
from .count_mm import count_mm_cuda
from .minplus import minplus_cuda
from .tile_bitmm import TileWork, tile_chunk_cuda

#: launches of the CUDA bitmm kernel (a plain counter; callers reset it)
launches = 0
#: launches of the CUDA bitmm_or kernel (likewise)
or_launches = 0
#: launches of the CUDA tile-contraction kernel (likewise)
tile_launches = 0
#: launches of the CUDA min-plus kernel (likewise)
minplus_launches = 0
#: launches of the CUDA saturating count kernel (likewise)
count_mm_launches = 0


def bitmm(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    """Bitpacked Boolean matmul: (B, m, k//32) x (B, k, w) -> (B, m, w).

    ``m`` may differ from ``k`` (the masked closure contracts a compacted
    block of active rows against the full packed state)."""
    global launches
    if lhs_packed.device.type == "cpu" and rhs_packed.device.type == "cpu":
        return _ref.bitmm_ref(lhs_packed, rhs_packed)
    out = bitmm_cuda(lhs_packed, rhs_packed)
    launches += out.is_cuda
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
    or_launches += out.is_cuda
    return out


def _bad_pairs(tiles, l_idx, r_idx, seg, n_out: int) -> torch.Tensor:
    """The pairs the tile kernel skips and flags in its fault word: not a pad (segment
    ``n_out``) and naming a segment outside ``[0, n_out]`` or a slot
    outside the store."""
    S = tiles.shape[0]
    return (seg != n_out) & (
        (seg < 0) | (seg > n_out) | (l_idx < 0) | (l_idx >= S)
        | (r_idx < 0) | (r_idx >= S)
    )


def tile_work(tile: int, cap: int, device: torch.device) -> TileWork | None:
    """The work buffers of one block-sparse fixpoint's chunks of at most
    ``cap`` output blocks of ``tile``-edge tiles: a :class:`TileWork` on
    the card (allocated and zeroed once) or on ``meta``, None on the CPU,
    whose plain version needs none."""
    return None if device.type == "cpu" else TileWork(tile, cap, device)


def tile_contract_chunk(
    tiles: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    out_slot: torch.Tensor,
    out_exists: torch.Tensor,
    n_out: int,
    work: TileWork | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the block-sparse fixpoint: ``new[s] = old[s] | OR over
    pairs p with seg[p] == s of tiles[l_idx[p]] x tiles[r_idx[p]]``, with
    ``old[s]`` the tile of slot ``out_slot[s]`` where ``out_exists[s]``
    and zeros elsewhere, and each output block's flags.  Returns ``(new
    (n_out, B, B/32), flags (2m + 1,) int32)``: ``flags[s]`` is set where
    ``new[s]`` differs from ``old[s]``, ``flags[m + s]`` where it has a set
    bit, and the last word is the fault flag: nonzero when a pair other
    than a pad (segment ``n_out``) named a segment outside ``[0, n_out]``
    or a slot outside ``tiles`` (such a pair is skipped, on either device),
    or on the card an existing output's slot lies outside ``tiles``; ``m``
    is ``n_out`` on the CPU and the work buffers' capacity on the card.
    On the card it is one launch into ``work`` (from :func:`tile_work`),
    whose views it returns; nothing is read back here, so the caller reads
    ``flags`` at its own sync."""
    global tile_launches
    operands = (tiles, l_idx, r_idx, seg, out_slot, out_exists)
    if all(t.device.type == "cpu" for t in operands):
        bad = _bad_pairs(tiles, l_idx, r_idx, seg, n_out)
        ok = ~bad
        new, flags = _ref.tile_contract_chunk_ref(
            tiles, l_idx[ok], r_idx[ok], seg[ok], out_slot, out_exists, n_out
        )
        flags[-1] = int(bad.any())
        return new, flags
    if work is None:
        raise ValueError("tile_contract_chunk: a chunk on the card needs its TileWork")
    out = tile_chunk_cuda(tiles, l_idx, r_idx, seg, out_slot, out_exists, n_out, work)
    tile_launches += out[0].is_cuda
    return out


def tile_bitmm(lhs_tiles: torch.Tensor, rhs_tiles: torch.Tensor) -> torch.Tensor:
    """Square-tile bitpacked Boolean matmul for the block-sparse engine:
    (p, B, B//32) x (p, B, B//32) -> (p, B, B//32), one independent B×B
    product per pair.  On the card it is one chunk of the tile kernel
    (:func:`tile_contract_chunk`) over one store of both batches, pair
    ``i`` taking lhs slot ``i`` and rhs slot ``p + i`` into output ``i``,
    which has no old tile."""
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
    p, dev = lhs_tiles.shape[0], lhs_tiles.device
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    none = torch.zeros(p, dtype=torch.int32, device=dev)
    # the indices lie in the store by construction: the fault word stays 0
    new, _ = tile_contract_chunk(
        torch.cat([lhs_tiles, rhs_tiles]), idx, idx + p, idx, none, none, p,
        tile_work(lhs_tiles.shape[1], p, dev),
    )
    return new.clone()


def minplus(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """The single-path closures' min-plus product with the rhs gathered by
    index: ``out[p, i, j] = min(acc[p, i, j], min_k lhs[p, i, k] +
    base[slab[p], row[k], j])``, (P, R, K) f32 x (S, rows, C) f32 -> a new
    (P, R, C) f32 tensor; ``slab`` (P,) and ``row`` (K,) int64 name the rhs
    rows of ``base`` (the identity where absent), ``acc`` (P, R, C) is only
    read (inf where absent).  Bit-equal on either device."""
    global minplus_launches
    operands = [t for t in (lhs, base, slab, row, acc) if t is not None]
    if all(t.device.type == "cpu" for t in operands):
        return _ref.minplus_ref(lhs, base, slab, row, acc)
    out = minplus_cuda(lhs, base, slab, row, acc)
    if out.numel() and out.is_cuda:
        minplus_launches += 1
    return out


def count_mm(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """The count closures' saturating product with the rhs gathered by
    index, on uint32 counts in int32 storage (SAT = 2^32 - 1, stored as
    -1): ``out[p, i, j] = min(SAT, acc[p, i, j] + sum_k min(SAT, lhs[p, i,
    k] * base[slab[p], row[k], j]))``, (P, R, K) x (S, rows, C) -> a new
    (P, R, C) int32 tensor; ``slab`` (P,) and ``row`` (K,) int64 name the
    rhs rows of ``base`` (the identity where absent), ``acc`` (P, R, C) is
    only read (0 where absent).  Bit-equal on either device."""
    global count_mm_launches
    operands = [t for t in (lhs, base, slab, row, acc) if t is not None]
    if all(t.device.type == "cpu" for t in operands):
        return _ref.count_mm_ref(lhs, base, slab, row, acc)
    out = count_mm_cuda(lhs, base, slab, row, acc)
    if out.numel() and out.is_cuda:
        count_mm_launches += 1
    return out
