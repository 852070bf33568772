"""The port's FLOP, byte and collective counter: the counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()`` for eager torch programs.

``Counter`` is a ``TorchDispatchMode``.  Run a step under it, on ``meta``
tensors (shapes only, no data, no card) or on real ones, and it counts,
for every aten op the step dispatches:

  * FLOPs, from ``torch.utils.flop_counter``'s formulas (products,
    convolutions, attention) and the matrix-vector ones it lacks
    (``FLOPS``), split by the dtype the product runs in;
  * transcendentals: one per output element of ``exp``, ``log``, ``tanh``,
    ``sin``, ``rsqrt`` and their kin;
  * bytes: each tensor input (at most its storage: a broadcast view is
    read once) and each output once per op, views and allocations free.
    This is what the eager program moves, op by op: no fusion is assumed,
    so the count is not XLA's fused ``bytes accessed``;
  * the peak of live bytes beyond the arguments (``temp_bytes``): every
    storage an op creates is live until the last tensor on it dies.

An upload (an op that takes host tensors only and puts its result on
another device) is not counted: it is host data made a constant, which
the step caches (``models/gnn/mace.py::_gaunt``), as XLA embeds its
constants in the program.  So a count does not depend on what the
process ran before it.

Hand-written kernels run through ``ctypes``, where no dispatch mode sees
them.  Their wrappers (``kernels/``) report their own analytic cost with
:func:`kernel` on a ``meta`` tensor: the bound's count at full density,
since meta has no data.  The collectives (``shard/``) report each call
with :func:`collective`, priced by ``roofline/hlo.py``'s ring model, so a
run under a plan without process groups counts what each rank sends.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .hlo import moved_bytes

aten = torch.ops.aten

#: ops whose every output element costs one transcendental
TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2, aten.log10,
    aten.tanh, aten.sigmoid, aten.sin, aten.cos, aten.tan, aten.asin, aten.acos,
    aten.atan, aten.atan2, aten.sinh, aten.cosh, aten.rsqrt, aten.sqrt, aten.erf,
    aten.erfc, aten.pow, aten.silu, aten.gelu, aten._softmax, aten._log_softmax,
}

#: FLOP formulas: ``torch.utils.flop_counter``'s, with the matrix-vector
#: and vector products it leaves out (two FLOPs per matrix element)
FLOPS = {
    **flop_registry,
    aten.mv: lambda mat, vec, out_val=None: 2 * mat.numel(),
    aten.addmv: lambda bias, mat, vec, *a, out_val=None, **k: 2 * mat.numel(),
    aten.dot: lambda a, b, out_val=None: 2 * a.numel(),
}

#: metadata queries, and ``lift_fresh`` (host data taken as a tensor): no
#: data is read or written, and no op is counted
_METADATA = {
    aten.is_contiguous, aten.sym_is_contiguous, aten.size, aten.sym_size, aten.stride,
    aten.sym_stride, aten.storage_offset, aten.sym_storage_offset, aten.numel,
    aten.sym_numel, aten.dim, aten.is_strides_like_format, aten.is_non_overlapping_and_dense,
    aten.lift_fresh,
}

#: ops that move no byte: allocations (the storage is live, nothing is
#: read or written) and views the schema does not mark as views
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
         aten._unsafe_view, aten._reshape_alias}

#: the counters a run is under (innermost last); kernels and collectives
#: report to all of them
_ACTIVE: list["Counter"] = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """An input's bytes: its elements, or its storage where that is smaller
    (a broadcast view reads each stored element once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _product_dtype(args) -> str:
    """The dtype a product runs in: that of its first floating operand
    with two or more dims (``addmm``'s bias is 1-D)."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.dim() >= 2:
            return str(a.dtype).removeprefix("torch.")
    for a in args:
        if isinstance(a, torch.Tensor):
            return str(a.dtype).removeprefix("torch.")
    return "unknown"


class Counter(TorchDispatchMode):
    """Counts what the ops run under it cost (see the module's docstring).

    ``flops`` maps a dtype name to its operations (``int32`` holds the
    packed kernels' word operations); ``bytes``, ``transcendentals`` and
    ``ops`` are totals; ``peak_bytes`` the peak of live bytes the run
    created; ``collectives`` ``{op: {count, out_bytes, moved_bytes}}``;
    ``kernels`` ``{name: calls}`` of the hand-written kernels reported."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: dict[str, float] = defaultdict(float)
        self.bytes = 0
        self.transcendentals = 0
        self.ops = 0
        self.live = 0
        self.peak_bytes = 0
        self.kernels: dict[str, int] = defaultdict(int)
        self.collectives: dict[str, dict] = {}
        self._refs: dict[int, list] = {}  # storage key -> [tensors alive, bytes]

    # -- entering and leaving ---------------------------------------------- #
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- live bytes -------------------------------------------------------- #
    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, out: list[torch.Tensor], inputs: set[int]) -> None:
        for t in out:
            key = t.untyped_storage()._cdata
            ref = self._refs.get(key)
            if ref is None:
                if key in inputs:
                    continue  # a view or in-place result of an argument
                ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
                self.live += ref[1]
                self.peak_bytes = max(self.peak_bytes, self.live)
            ref[0] += 1
            weakref.finalize(t, self._drop, key)

    # -- the ops ------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _METADATA or func is torch.ops.prim.device.default:
            return func(*args, **kwargs)
        if packet not in FLOPS:
            # a composite op: count the ops it is made of, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if flat_in and all(t.device.type == "cpu" for t in flat_in) and any(
                o.device.type != "cpu" for o in flat_out):
            return out  # an upload of host data, as a constant the step caches: not device work
        self.ops += 1
        if packet in FLOPS:
            self.flops[_product_dtype(args)] += FLOPS[packet](*args, **kwargs, out_val=out)
        if packet in TRANSCENDENTAL:
            self.transcendentals += sum(o.numel() for o in flat_out)
        if not func.is_view and packet not in _FREE:
            seen = set()
            for t in flat_in:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += _read_bytes(t)
            self.bytes += sum(_nbytes(o) for o in flat_out)
        self._track(flat_out, {t.untyped_storage()._cdata for t in flat_in})
        return out

    # -- reports from kernels and collectives -------------------------------- #
    def add_kernel(self, name: str, n_bytes: int, ops: float, dtype: str) -> None:
        self.kernels[name] += 1
        self.bytes += n_bytes
        self.flops[dtype] += ops

    def add_collective(self, op: str, out_bytes: int, k: int) -> None:
        if k <= 1:
            return
        rec = self.collectives.setdefault(op, {"count": 0, "out_bytes": 0, "moved_bytes": 0.0})
        rec["count"] += 1
        rec["out_bytes"] += out_bytes
        rec["moved_bytes"] += moved_bytes(op, out_bytes, k)

    # -- results ------------------------------------------------------------- #
    def collective_stats(self) -> dict:
        """The reference's schema: ``{op: {count, out_bytes, moved_bytes},
        "_total": ...}``."""
        out = {op: dict(rec) for op, rec in sorted(self.collectives.items())}
        out["_total"] = {key: sum(r[key] for r in self.collectives.values())
                         for key in ("count", "out_bytes", "moved_bytes")}
        return out

    def summary(self) -> dict:
        return {
            "flops": sum(self.flops.values()),
            "flops_by_dtype": dict(sorted(self.flops.items())),
            "bytes_accessed": self.bytes,
            "transcendentals": self.transcendentals,
            "ops": self.ops,
            "peak_bytes": self.peak_bytes,
            "kernels": dict(self.kernels),
            "collectives": self.collective_stats(),
        }


def kernel(name: str, n_bytes: int, ops: float, dtype: str) -> None:
    """A hand-written kernel's cost: ``n_bytes`` moved and ``ops``
    operations of ``dtype``, reported to every active counter."""
    for c in _ACTIVE:
        c.add_kernel(name, int(n_bytes), float(ops), dtype)


def collective(op: str, out_bytes: int, k: int) -> None:
    """One collective call: ``op`` an HLO name (``all-gather``,
    ``all-reduce``, ...), its output's bytes on this rank and the group's
    ``k`` ranks, reported to every active counter."""
    for c in _ACTIVE:
        c.add_collective(op, int(out_bytes), int(k))


def count(fn, *args, **kwargs) -> tuple[object, dict]:
    """``fn(*args, **kwargs)`` under a fresh counter: ``(result,
    summary)``."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, c.summary()
