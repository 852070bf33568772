"""Bind the block-sparse backend's tile kernel of csrc/tile_bitmm.cu: gather
a packed bit-tile pair per slot index, multiply, and OR the product into
its output block, one launch per bucket of pairs (see the source's header).

Built and loaded by ``bitmm.py``'s machinery (``nvcc`` for ``sm_90a`` at
first use, into ``build/repro_torch/``); nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .bitmm import _launch, library

SOURCE = Path(__file__).resolve().parent / "csrc" / "tile_bitmm.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: SOURCE's C entry point: (argument types, result type)
ENTRIES = {"repro_tile_contract": ([_P] * 6 + [_I] * 4 + [_P], _I)}

#: tile edges the kernel has an instance for (W = B/32 words per row)
TILES = (32, 64, 128)


def _check(named: dict, dtype: torch.dtype, dim: int, device: torch.device) -> None:
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"tile_contract_cuda: {name} is on {t.device}, not CUDA")
        if t.device != device:
            raise ValueError(
                f"tile_contract_cuda: {name} on {t.device}, out on {device}"
            )
        if t.dtype != dtype:
            raise TypeError(f"tile_contract_cuda: {name} is {t.dtype}, not {dtype}")
        if t.dim() != dim:
            raise ValueError(
                f"tile_contract_cuda: {name} must be {dim}-D, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"tile_contract_cuda: {name} is not contiguous")


def tile_contract_cuda(
    store: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Launch the kernel on the current stream: for every pair ``p`` with
    ``seg[p] < n_out``, ``out[seg[p]] |= store[l_idx[p]] x
    store[r_idx[p]]``, in place.  ``store`` is ``(S, B, B/32)`` int32 with
    B in :data:`TILES`, the indices ``(p,)`` int32 with ``p >= 1`` (a pad
    pair has ``seg == n_out``), ``out`` ``(n_out, B, B/32)`` int32.
    Returns a ``(1,)`` int32 fault flag on ``out``'s device, set to 1 when
    a pair other than a pad named a segment outside ``[0, n_out]`` or a
    slot outside ``store`` (the kernel skips such a pair).  Raises on
    anything the kernel does not take."""
    dev = out.device
    _check({"store": store, "out": out}, torch.int32, 3, dev)
    _check({"l_idx": l_idx, "r_idx": r_idx, "seg": seg}, torch.int32, 1, dev)
    B, W = out.shape[1:]
    if B not in TILES or W * 32 != B:
        raise ValueError(
            f"tile_contract_cuda: out is {tuple(out.shape)}; tiles must be "
            f"(B, B/32) with B in {TILES}"
        )
    if tuple(store.shape[1:]) != (B, W):
        raise ValueError(
            f"tile_contract_cuda: store is {tuple(store.shape)}, out's tiles "
            f"are {(B, W)}"
        )
    p = l_idx.shape[0]
    if r_idx.shape[0] != p or seg.shape[0] != p:
        raise ValueError(
            f"tile_contract_cuda: index lengths {p}, {r_idx.shape[0]}, "
            f"{seg.shape[0]} differ"
        )
    if p < 1:
        raise ValueError("tile_contract_cuda: an empty bucket launches nothing")
    if max(p, store.shape[0], out.shape[0]) > 2**31 - 1:
        raise ValueError("tile_contract_cuda: a count exceeds int32")
    fault = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch(
        library(SOURCE, ENTRIES).repro_tile_contract,
        (store.data_ptr(), l_idx.data_ptr(), r_idx.data_ptr(), seg.data_ptr(),
         out.data_ptr(), fault.data_ptr(), p, store.shape[0], out.shape[0], B),
        dev,
    )
    return fault
