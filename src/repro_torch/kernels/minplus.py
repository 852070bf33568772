"""Bind the single-path closures' min-plus kernel of csrc/minplus.cu: each
lhs row scanned once per launch for its finite entries, listed in shared
memory, then swept across the output columns, the rhs rows gathered in the
kernel through a slab and a row index (see csrc/sparse_rows.cuh).

Built and loaded by ``bitmm.py``'s machinery (``nvcc`` for ``sm_90a`` at
first use, into ``build/repro_torch/``); nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.roofline import count

from .bitmm import _launch, library

SOURCE = Path(__file__).resolve().parent / "csrc" / "minplus.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: SOURCE's C entry point: (argument types, result type)
ENTRIES = {"repro_minplus": ([_P] * 6 + [_I] * 5 + [_P], _I)}


def _check(lhs, base, slab, row, acc, kernel: str = "minplus_cuda",
           dtype: torch.dtype = torch.float32) -> None:
    """Raise on anything the indexed product kernel ``kernel`` does not take
    (its values of ``dtype``); shared by the min-plus and count kernels."""
    named = {"lhs": lhs, "base": base, "slab": slab, "row": row, "acc": acc}
    types = {"lhs": dtype, "base": dtype, "acc": dtype,
             "slab": torch.int64, "row": torch.int64}
    dims = {"lhs": 3, "base": 3, "acc": 3, "slab": 1, "row": 1}
    for name, t in named.items():
        if t is None:
            continue
        if t.device.type not in ("cuda", "meta") or t.device != lhs.device:
            raise ValueError(
                f"{kernel}: {name} is on {t.device}, lhs on {lhs.device}; "
                "all operands must be CUDA tensors of one device"
            )
        if t.dtype != types[name]:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, not {types[name]}")
        if t.dim() != dims[name]:
            raise ValueError(
                f"{kernel}: {name} must be {dims[name]}-D, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    P, R, K = lhs.shape
    S, rows, C = base.shape
    if (slab if slab is not None else lhs).shape[0] != P or (
        row is not None and row.shape[0] != K
    ):
        raise ValueError(
            f"{kernel}: lhs {tuple(lhs.shape)} needs slab ({P},) and row "
            f"({K},), got {None if slab is None else tuple(slab.shape)} and "
            f"{None if row is None else tuple(row.shape)}"
        )
    if (slab is None and S < P) or (row is None and rows != K):
        raise ValueError(
            f"{kernel}: base {tuple(base.shape)} does not contract with lhs "
            f"{tuple(lhs.shape)} (without an index: one slab per p, K rows)"
        )
    if acc is not None and tuple(acc.shape) != (P, R, C):
        raise ValueError(
            f"{kernel}: acc is {tuple(acc.shape)}, the product is {(P, R, C)}"
        )
    if P > 65535 or max(R, K, C, rows) > 2**31 - 1:
        raise ValueError(
            f"{kernel}: lhs {tuple(lhs.shape)} x base {tuple(base.shape)} is "
            "outside the launch (P <= 65535; counts within int32)"
        )


def meta_cost(kernel: str, lhs, base, acc, dtype: str) -> None:
    """Report a call of the min-plus or count kernel on ``meta`` tensors
    to the counter, at full density (meta has no data): the bound's count
    of ``chip_smoke.py`` with every lhs entry finite (or non-zero), so the
    lhs, every named rhs row, ``acc`` and the output moved once, and two
    operations per candidate (p, i, k, j)."""
    P, R, K = lhs.shape
    C = base.shape[2]
    words = P * R * K + P * K * C + P * R * C * (1 if acc is None else 2)
    count.kernel(kernel, 4 * words, 2 * P * R * K * C, dtype)


def _check_indices(base, slab, row, kernel: str = "minplus_cuda") -> None:
    """Raise if an index names a slab or row outside ``base``: the one host
    sync of a call (the kernel would read out of bounds)."""
    given = [(t, high) for t, high in ((slab, base.shape[0]), (row, base.shape[1]))
             if t is not None and t.numel()]
    if not given:
        return
    ends = torch.stack([x for t, _ in given for x in torch.aminmax(t)]).tolist()
    for (lo, hi), (_, high) in zip(zip(ends[::2], ends[1::2]), given):
        if lo < 0 or hi >= high:
            raise ValueError(
                f"{kernel}: an index in [{lo}, {hi}] falls outside [0, {high})"
            )


def minplus_launch(lhs, base, slab, row, acc, out) -> None:
    """Enqueue the kernel into ``out`` on the current stream, without the
    index range check (the caller vouches for the indices): for timing the
    kernel back to back.  ``minplus_cuda`` is the checked entry."""
    P, R, K = lhs.shape
    _launch(
        library(SOURCE, ENTRIES).repro_minplus,
        (lhs.data_ptr(), base.data_ptr(),
         None if slab is None else slab.data_ptr(),
         None if row is None else row.data_ptr(),
         None if acc is None else acc.data_ptr(), out.data_ptr(),
         P, R, K, base.shape[2], base.shape[1]),
        lhs.device,
    )


def minplus_cuda(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel: ``out[p, i, j] = min(acc[p, i, j], min_k lhs[p,
    i, k] + base[slab[p], row[k], j])`` into a fresh (P, R, C) f32 tensor
    on the current stream (``acc`` is only read; without it the first term
    is inf; without ``slab`` or ``row`` the index is the identity).
    lhs (P, R, K) and base (S, rows, C) f32, slab (P,) and row (K,) int64,
    all contiguous CUDA tensors of one device.  An empty product (P, R or
    C zero) launches nothing.  Raises on anything the kernel does not take,
    an index out of range included.  On ``meta`` tensors: the empty
    output, its cost reported to the counter (:func:`meta_cost`)."""
    _check(lhs, base, slab, row, acc)
    P, R, _ = lhs.shape
    out = torch.empty((P, R, base.shape[2]), dtype=torch.float32, device=lhs.device)
    if out.is_meta:
        meta_cost("minplus", lhs, base, acc, "float32")
        return out
    _check_indices(base, slab, row)
    if out.numel():
        minplus_launch(lhs, base, slab, row, acc, out)
    return out
