"""Bind the block-sparse backend's tile kernel of csrc/tile_bitmm.cu: one
chunk of the block-sparse fixpoint in one launch — gather a packed
bit-tile pair per slot index, multiply, OR the product and the old tile
into the output block, and set each block's flags (see the source's
header).

Built and loaded by ``bitmm.py``'s machinery (``nvcc`` for ``sm_90a`` at
first use, into ``build/repro_torch/``); nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.roofline import count

from .bitmm import _launch, library

SOURCE = Path(__file__).resolve().parent / "csrc" / "tile_bitmm.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: SOURCE's C entry point: (argument types, result type)
ENTRIES = {"repro_tile_contract": ([_P] * 10 + [_I] * 7 + [_P], _I)}

#: tile edges the kernel has an instance for (W = B/32 words per row)
TILES = (32, 64, 128)


def _check(named: dict, dtype: torch.dtype, dim: int, device: torch.device) -> None:
    for name, t in named.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"tile_chunk_cuda: {name} is on {t.device}, not CUDA")
        if t.device != device:
            raise ValueError(
                f"tile_chunk_cuda: {name} on {t.device}, store on {device}"
            )
        if t.dtype != dtype:
            raise TypeError(f"tile_chunk_cuda: {name} is {t.dtype}, not {dtype}")
        if t.dim() != dim:
            raise ValueError(
                f"tile_chunk_cuda: {name} must be {dim}-D, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"tile_chunk_cuda: {name} is not contiguous")


def _check_pairs(store, l_idx, r_idx, seg, B: int, dev: torch.device) -> int:
    """Raise on a store or pair indices the kernel does not take; returns
    the pair count."""
    _check({"store": store}, torch.int32, 3, dev)
    _check({"l_idx": l_idx, "r_idx": r_idx, "seg": seg}, torch.int32, 1, dev)
    if B not in TILES:
        raise ValueError(
            f"tile_chunk_cuda: tiles must be (B, B/32) with B in {TILES}, "
            f"got B = {B}"
        )
    if tuple(store.shape[1:]) != (B, B // 32):
        raise ValueError(
            f"tile_chunk_cuda: store is {tuple(store.shape)}, the output "
            f"tiles are {(B, B // 32)}"
        )
    if store.data_ptr() % 16:
        raise ValueError("tile_chunk_cuda: store is not 16-byte aligned")
    p = l_idx.shape[0]
    if r_idx.shape[0] != p or seg.shape[0] != p:
        raise ValueError(
            f"tile_chunk_cuda: index lengths {p}, {r_idx.shape[0]}, "
            f"{seg.shape[0]} differ"
        )
    if p < 1:
        raise ValueError("tile_chunk_cuda: an empty bucket launches nothing")
    if max(p, store.shape[0]) > 2**31 - 1:
        raise ValueError("tile_chunk_cuda: a count exceeds int32")
    return p


class TileWork:
    """The work buffers of one block-sparse fixpoint's chunks on the card,
    allocated and zeroed once: two int32 buffers that the chunks use in
    turn, each ``[changed (cap) | nonzero (cap) | fault | pad | tiles (cap,
    B, B/32)]``.  A chunk's kernel finds its buffer zero, fills it, and
    zeroes the other one (the flags and the tiles the chunk before left
    there) for the next chunk; the fault word is never zeroed, so a fault
    stays set."""

    def __init__(self, tile: int, cap: int, device: torch.device) -> None:
        self.tile, self.cap = tile, cap
        self.head = (2 * cap + 4) // 4 * 4  # words before the tiles (16-byte aligned)
        words = self.head + cap * tile * (tile // 32)
        self.bufs = torch.zeros((2, words), dtype=torch.int32, device=device)
        self.dirty = [0, 0]  # output tiles the last chunk left in each buffer
        self.turn = 0


def tile_chunk_cuda(
    store: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    out_slot: torch.Tensor,
    out_exists: torch.Tensor,
    n_out: int,
    work: TileWork,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: one chunk of the
    block-sparse fixpoint in one launch.  ``new[s] = old[s] | OR over
    pairs p with seg[p] == s of store[l_idx[p]] x store[r_idx[p]]``, with
    ``old[s]`` the tile of slot ``out_slot[s]`` where ``out_exists[s]``
    (int32 0/1) and zeros elsewhere.  Returns ``(new (n_out, B, B/32),
    flags (2 cap + 1,))``, views of ``work``'s buffer: ``flags[s]`` the
    changed and ``flags[cap + s]`` the nonzero flag of output ``s``,
    ``flags[2 cap]`` the fault word, set to 1 when a pair other than a pad
    (segment ``n_out``) named a segment outside ``[0, n_out]`` or a slot
    outside ``store``, or an output's ``out_slot`` lies outside it (the
    kernel skips such a pair or old tile).  The views stay valid until the
    next call's launch, which zeroes their buffer.  Raises on anything the
    kernel does not take.  On ``meta`` tensors: views of ``work`` of the
    outputs' shapes, the cost reported to the counter
    (``roofline/count.py``), no launch."""
    dev = store.device
    B, cap = work.tile, work.cap
    p = _check_pairs(store, l_idx, r_idx, seg, B, dev)
    _check({"out_slot": out_slot, "out_exists": out_exists}, torch.int32, 1, dev)
    if not 1 <= n_out <= cap or out_slot.shape[0] < n_out or out_exists.shape[0] < n_out:
        raise ValueError(
            f"tile_chunk_cuda: {n_out} outputs with out_slot "
            f"{tuple(out_slot.shape)} and out_exists {tuple(out_exists.shape)}; "
            f"the work buffers hold 1 to {cap}"
        )
    if work.bufs.device != dev:
        raise ValueError(f"tile_chunk_cuda: work on {work.bufs.device}, store on {dev}")
    cur, other = work.bufs[work.turn], work.bufs[1 - work.turn]
    if store.is_meta:
        # the cost at full density (meta has no data): both tiles of every
        # pair read, each output read and written, one OR of a W-word row
        # per lhs bit
        W = B // 32
        count.kernel("tile_contract", 4 * (2 * p + 2 * n_out) * B * W, p * B * B * W, "int32")
        return cur[work.head:].view(cap, B, W)[:n_out], cur[: 2 * cap + 1]
    _launch(
        library(SOURCE, ENTRIES).repro_tile_contract,
        (store.data_ptr(), l_idx.data_ptr(), r_idx.data_ptr(), seg.data_ptr(),
         out_slot.data_ptr(), out_exists.data_ptr(),
         cur[work.head:].data_ptr(), cur.data_ptr(), cur[2 * cap:].data_ptr(),
         other.data_ptr(), work.head, work.dirty[1 - work.turn], cap,
         p, store.shape[0], n_out, B),
        dev,
    )
    work.dirty[1 - work.turn], work.dirty[work.turn] = 0, n_out
    work.turn = 1 - work.turn
    new = cur[work.head:].view(cap, B, B // 32)[:n_out]
    return new, cur[: 2 * cap + 1]
