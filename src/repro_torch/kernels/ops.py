"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain torch version (``ref.py``) only for
tensors on the CPU — because the caller asked for the CPU.  On a CUDA
tensor it launches the hand-written kernel or raises; there is no
fallback.  ``launches`` and ``or_launches`` count the launches of each
kernel in this process, so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .bitmm import bitmm_cuda, bitmm_or_cuda

#: launches of the CUDA bitmm kernel (a plain counter; callers reset it)
launches = 0
#: launches of the CUDA bitmm_or kernel (likewise)
or_launches = 0


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
