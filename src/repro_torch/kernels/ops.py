"""Public wrappers of the port's kernels.

A wrapper takes its kernel's plain torch version (``ref.py``) only for
tensors on the CPU — because the caller asked for the CPU.  On a CUDA
tensor it launches the hand-written kernel or raises; there is no
fallback.  ``launches`` counts the kernel launches of this process, so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .bitmm import bitmm_cuda

#: launches of the CUDA bitmm kernel (a plain counter; callers reset it)
launches = 0


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
