"""Bind the count closures' saturating count product of csrc/count_mm.cu:
the design of the min-plus kernel on the counting semiring (each lhs row
scanned once per launch for its non-zero entries, then swept across the
output columns; the rhs rows gathered in the kernel through a slab and a
row index; see csrc/sparse_rows.cuh).

Built and loaded by ``bitmm.py``'s machinery (``nvcc`` for ``sm_90a`` at
first use, into ``build/repro_torch/``); nothing here runs at import time.
Counts are uint32 held in int32 storage, as every count state of the port.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .bitmm import _launch, library
from .minplus import _check, _check_indices, meta_cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "count_mm.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: SOURCE's C entry point: (argument types, result type)
ENTRIES = {"repro_count_mm": ([_P] * 6 + [_I] * 5 + [_P], _I)}


def count_mm_launch(lhs, base, slab, row, acc, out) -> None:
    """Enqueue the kernel into ``out`` on the current stream, without the
    index range check (the caller vouches for the indices): for timing the
    kernel back to back.  ``count_mm_cuda`` is the checked entry."""
    P, R, K = lhs.shape
    _launch(
        library(SOURCE, ENTRIES).repro_count_mm,
        (lhs.data_ptr(), base.data_ptr(),
         None if slab is None else slab.data_ptr(),
         None if row is None else row.data_ptr(),
         None if acc is None else acc.data_ptr(), out.data_ptr(),
         P, R, K, base.shape[2], base.shape[1]),
        lhs.device,
    )


def count_mm_cuda(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel: ``out[p, i, j] = min(SAT, acc[p, i, j] + sum_k
    min(SAT, lhs[p, i, k] * base[slab[p], row[k], j]))`` on uint32 counts
    in int32 storage, into a fresh (P, R, C) int32 tensor on the current
    stream (``acc`` is only read; without it the first term is 0; without
    ``slab`` or ``row`` the index is the identity).  lhs (P, R, K) and base
    (S, rows, C) int32, slab (P,) and row (K,) int64, all contiguous CUDA
    tensors of one device.  An empty product (P, R or C zero) launches
    nothing.  Raises on anything the kernel does not take, an index out of
    range included.  On ``meta`` tensors: the empty output, its cost
    reported to the counter (``minplus.meta_cost``)."""
    _check(lhs, base, slab, row, acc, "count_mm_cuda", torch.int32)
    P, R, _ = lhs.shape
    out = torch.empty((P, R, base.shape[2]), dtype=torch.int32, device=lhs.device)
    if out.is_meta:
        meta_cost("count_mm", lhs, base, acc, "int32")
        return out
    _check_indices(base, slab, row, "count_mm_cuda")
    if out.numel():
        count_mm_launch(lhs, base, slab, row, acc, out)
    return out
