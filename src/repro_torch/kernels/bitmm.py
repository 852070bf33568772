"""Build and bind the hand-written CUDA kernels of csrc/bitmm.cu: ``bitmm``
and its fused sibling ``bitmm_or`` (one kernel with a template flag; each
64-row tile takes a sparse row-gather path or a dense staged path by its
set-bit count, see the source's header).

Each source under ``csrc/`` (this one, ``tile_bitmm.cu``, ``minplus.cu`` and
``count_mm.cu``, the last two with their shared ``sparse_rows.cuh``) is
compiled with ``nvcc`` for ``sm_90a`` into a shared
library of its own with plain C entry points and loaded with ``ctypes``.
The build happens at first use, from the sources in this checkout only,
into ``build/repro_torch/`` at the repository root; the library's file
name carries the source's name and a hash of the source, the headers it
includes and the flags, so an edit rebuilds it, and two processes or threads may build at once.
Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.roofline import count

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitmm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the most lhs words per row a launch takes (csrc/bitmm.cu: the union and
#: the staging list, 8 bytes per word, beside the 50 KB ring in 227 KB)
MAX_LHS_WORDS = 22780

# the loaded library of each source
_LIBS: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_P, _I = ctypes.c_void_p, ctypes.c_int
#: SOURCE's C entry points: (argument types, result type)
ENTRIES = {
    "repro_bitmm": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "repro_bitmm_or": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "repro_bitmm_path": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "repro_bitmm_sparse_max_bits": ([], _I),
}


def _sources(source: Path) -> list[Path]:
    """``source`` and the local headers it includes (``#include "x.cuh"``,
    beside it), so that an edit of a header rebuilds the library too."""
    text = source.read_text()
    return [source] + [source.parent / name for name in
                       re.findall(r'^#include "([^"]+)"', text, flags=re.M)]


def load(source: Path = SOURCE, entries: dict = ENTRIES) -> tuple[ctypes.CDLL, dict]:
    """Compile ``source`` with NVCC_FLAGS into BUILD_DIR (unless a library
    of the same source and flags is there) and load it, its ``entries``
    bound (those it has: another revision of the source may have only the
    two public ones).  Returns the library and its build's seconds, path
    and ptxas report (kept beside the library, for a later process that
    finds it built)."""
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in _sources(source))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    log_path = path.with_suffix(".log")
    t0 = time.perf_counter()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log_tmp = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        log_tmp.write_text(proc.stdout + proc.stderr)
        os.replace(log_tmp, log_path)
        os.replace(tmp, path)  # atomic: concurrent builds race safely
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in entries.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    info = dict(seconds=time.perf_counter() - t0, path=str(path), log=log.strip())
    return lib, info


def library(source: Path = SOURCE, entries: dict = ENTRIES) -> ctypes.CDLL:
    """The kernel library of ``source`` in this checkout, compiled on first
    call, its ``entries`` bound."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = load(source, entries)[0]
    return lib


def _check_operands(kernel: str, lhs: torch.Tensor, rhs: torch.Tensor,
                    acc: torch.Tensor | None = None) -> tuple[int, int, int, int]:
    """Raise on anything the kernel does not take; returns ``(B, m, wk, w)``."""
    named = {"lhs": lhs, "rhs": rhs}
    if acc is not None:
        named["acc"] = acc
    for name, t in named.items():
        if t.device.type not in ("cuda", "meta"):
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
    if min(B, m, wk, w) < 1 or B > 65535 or wk > MAX_LHS_WORDS:
        raise ValueError(
            f"{kernel}: shapes {tuple(lhs.shape)} x {tuple(rhs.shape)} are "
            "outside the launch (need 1 <= B <= 65535, m >= 1, w >= 1 and "
            f"1 <= lhs words <= {MAX_LHS_WORDS}: a block's shared memory "
            "holds two words per lhs word beside the ring)"
        )
    if acc is not None and tuple(acc.shape) != (B, m, w):
        raise ValueError(
            f"{kernel}: acc is {tuple(acc.shape)}, the product is {(B, m, w)}"
        )
    return B, m, wk, w


def _launch(fn, args: tuple, device: torch.device) -> None:
    """Call the bound entry point ``fn`` with ``args`` and ``device``'s
    current stream; raise on a launch error."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")


def _meta_cost(kernel: str, B: int, m: int, wk: int, w: int, acc: bool) -> None:
    """Report a call on ``meta`` tensors to the counter, at full density
    (meta has no data): the bound's count of ``chip_smoke.py`` with every
    lhs bit set, so every rhs row read and one OR of a w-word rhs row per
    lhs bit."""
    words = B * m * wk + B * 32 * wk * w + B * m * w * (2 if acc else 1)
    count.kernel(kernel, 4 * words, B * m * 32 * wk * w, "int32")


def bitmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, m, k/32) x (B, k, w) int32 -> (B, m, w) int32
    on the current stream.  Raises on anything the kernel does not take.
    On ``meta`` tensors: the empty output, its cost reported to the
    counter (``roofline/count.py``), no launch."""
    B, m, wk, w = _check_operands("bitmm_cuda", lhs, rhs)
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    if out.is_meta:
        _meta_cost("bitmm", B, m, wk, w, acc=False)
        return out
    _launch(
        library().repro_bitmm,
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
    kernel does not take.  On ``meta`` tensors as :func:`bitmm_cuda`."""
    B, m, wk, w = _check_operands("bitmm_or_cuda", lhs, rhs, acc)
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    if out.is_meta:
        _meta_cost("bitmm_or", B, m, wk, w, acc=True)
        return out
    _launch(
        library().repro_bitmm_or,
        (lhs.data_ptr(), rhs.data_ptr(), acc.data_ptr(), out.data_ptr(),
         B, m, wk, w),
        lhs.device,
    )
    return out


def sparse_max_bits() -> int:
    """The compiled-in path threshold of ``bitmm_cuda`` and
    ``bitmm_or_cuda``: a 64-row tile with at most this many set lhs bits
    takes the sparse row gather, a denser one the staged dense path."""
    return int(library().repro_bitmm_sparse_max_bits())


def bitmm_path_cuda(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    acc: torch.Tensor | None = None,
    *,
    sparse_max_bits: int,
) -> torch.Tensor:
    """``bitmm_cuda`` (``acc`` None) or ``bitmm_or_cuda`` with the path
    threshold given: 0 sends every non-empty tile to the dense path,
    ``2**31 - 1`` every tile to the sparse one.  For timing the two paths
    and testing each; the main path calls the two kernels above, which use
    the compiled-in threshold.  Not counted as a launch of either."""
    if not 0 <= sparse_max_bits <= 2**31 - 1:
        raise ValueError(f"sparse_max_bits {sparse_max_bits} is not an int32 >= 0")
    B, m, wk, w = _check_operands("bitmm_path_cuda", lhs, rhs, acc)
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    _launch(
        library().repro_bitmm_path,
        (lhs.data_ptr(), rhs.data_ptr(),
         None if acc is None else acc.data_ptr(), out.data_ptr(),
         B, m, wk, w, sparse_max_bits),
        lhs.device,
    )
    return out
