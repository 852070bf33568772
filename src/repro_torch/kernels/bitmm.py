"""Build and bind the hand-written CUDA ``bitmm`` kernel (csrc/bitmm.cu).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point and loaded with ``ctypes``.  The build happens
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
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, path=str(path), log=log.strip()
    )
    _LIB = lib
    return lib


def bitmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, m, k/32) x (B, k, w) int32 -> (B, m, w) int32
    on the current stream.  Raises on anything the kernel does not take."""
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        if t.device.type != "cuda":
            raise ValueError(f"bitmm_cuda: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.int32:
            raise TypeError(f"bitmm_cuda: {name} is {t.dtype}, not int32")
        if t.dim() != 3:
            raise ValueError(f"bitmm_cuda: {name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"bitmm_cuda: {name} is not contiguous")
    if lhs.device != rhs.device:
        raise ValueError(f"bitmm_cuda: lhs on {lhs.device}, rhs on {rhs.device}")
    B, m, wk = lhs.shape
    Br, k, w = rhs.shape
    if Br != B or wk * 32 != k:
        raise ValueError(
            f"bitmm_cuda: shapes {tuple(lhs.shape)} x {tuple(rhs.shape)} do "
            "not contract (need equal batch and lhs words · 32 == rhs rows)"
        )
    if min(B, m, wk, w) < 1 or B > 65535 or -(-m // 64) > 65535:
        raise ValueError(
            f"bitmm_cuda: shapes {tuple(lhs.shape)} x {tuple(rhs.shape)} are "
            "outside the launch grid (need 1 <= B <= 65535, 1 <= m <= "
            "64·65535, wk >= 1, w >= 1)"
        )
    lib = library()
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_bitmm(
            lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, m, wk, w, stream
        )
    if err != 0:
        raise RuntimeError(f"bitmm kernel launch failed: CUDA error {err}")
    return out
