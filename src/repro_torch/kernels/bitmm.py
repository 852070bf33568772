"""Build and bind the hand-written CUDA kernels of csrc/bitmm.cu: ``bitmm``
and its fused sibling ``bitmm_or`` (one kernel with a template flag).

The library is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with plain C entry points and loaded with ``ctypes``.  The build happens
at first use, from the sources in this checkout only, into
``build/repro_torch/`` at the repository root; the library's file name
carries a hash of the source and the flags, so an edit rebuilds it.
Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitmm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the loaded library, and what its build reported
_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first call (``BUILD_INFO`` then
    holds the build seconds, the library path and ptxas's report)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    path = BUILD_DIR / f"libbitmm_{digest}.so"
    t0 = time.perf_counter()
    log = ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: concurrent builds race safely
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(path))
    lib.repro_bitmm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.repro_bitmm.restype = ctypes.c_int
    lib.repro_bitmm_or.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.repro_bitmm_or.restype = ctypes.c_int
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, path=str(path), log=log.strip()
    )
    _LIB = lib
    return lib


def _check_operands(kernel: str, lhs: torch.Tensor, rhs: torch.Tensor,
                    **more: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on anything the kernel does not take; returns ``(B, m, wk, w)``."""
    named = {"lhs": lhs, "rhs": rhs, **more}
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, not int32")
        if t.dim() != 3:
            raise ValueError(f"{kernel}: {name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    for name, t in named.items():
        if t.device != lhs.device:
            raise ValueError(f"{kernel}: lhs on {lhs.device}, {name} on {t.device}")
    B, m, wk = lhs.shape
    Br, k, w = rhs.shape
    if Br != B or wk * 32 != k:
        raise ValueError(
            f"{kernel}: shapes {tuple(lhs.shape)} x {tuple(rhs.shape)} do "
            "not contract (need equal batch and lhs words · 32 == rhs rows)"
        )
    if min(B, m, wk, w) < 1 or B > 65535 or -(-m // 64) > 65535:
        raise ValueError(
            f"{kernel}: shapes {tuple(lhs.shape)} x {tuple(rhs.shape)} are "
            "outside the launch grid (need 1 <= B <= 65535, 1 <= m <= "
            "64·65535, wk >= 1, w >= 1)"
        )
    return B, m, wk, w


def _launch(entry: str, args: tuple, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def bitmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, m, k/32) x (B, k, w) int32 -> (B, m, w) int32
    on the current stream.  Raises on anything the kernel does not take."""
    B, m, wk, w = _check_operands("bitmm_cuda", lhs, rhs)
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    _launch(
        "repro_bitmm",
        (lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, m, wk, w),
        lhs.device,
    )
    return out


def bitmm_or_cuda(
    lhs: torch.Tensor, rhs: torch.Tensor, acc: torch.Tensor
) -> torch.Tensor:
    """Launch the fused kernel: ``acc | (lhs x rhs)`` with lhs (B, m, k/32),
    rhs (B, k, w) and acc (B, m, w) int32, into a fresh (B, m, w) tensor —
    never into ``acc`` — on the current stream.  Raises on anything the
    kernel does not take."""
    B, m, wk, w = _check_operands("bitmm_or_cuda", lhs, rhs, acc=acc)
    if tuple(acc.shape) != (B, m, w):
        raise ValueError(
            f"bitmm_or_cuda: acc is {tuple(acc.shape)}, the product is "
            f"{(B, m, w)}"
        )
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    _launch(
        "repro_bitmm_or",
        (lhs.data_ptr(), rhs.data_ptr(), acc.data_ptr(), out.data_ptr(),
         B, m, wk, w),
        lhs.device,
    )
    return out
