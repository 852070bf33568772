"""The sharded LM's collectives, as functions on tensors over a
:class:`~repro_torch.shard.plans.MeshPlan`'s process groups.

The reference lets XLA insert its collectives from sharding constraints;
the port writes them out with two calls, ``all_gather`` and ``all_reduce``
(SUM or MAX): NCCL has both, and gloo takes CPU tensors and, staging them
through host memory itself, CUDA tensors too, so the CPU tests' gloo
worlds run the calls the card runs.

Gradients follow one rule: every rank ``r`` computes a local loss
``l_r`` and the global loss is ``L = sum_r l_r`` (a value held by ``c``
ranks enters each of their local losses divided by ``c``).  Then each
collective's backward is its adjoint: an all-reduce's backward is an
all-reduce of the gradients, an all-gather's an all-reduce and a slice
(a reduce-scatter).  :func:`use` puts a parameter into a computation: it
all-gathers the dims named in ``gather`` and, in the backward, sums the
gradient over every rank that computed with the same gathered tensor
(the mesh axes it is not split over), then keeps this rank's block.  So
after ``backward`` every rank holds its block of ``dL/dθ``, and every
replica of a block holds the same bits.

On a ``(pod, data, model)`` mesh the pod axis is pure data parallelism,
as in the reference: a batch's rows split over ``(pod, data)`` (the
plan's ``row_axes``), parameters split over ``data`` and ``model`` only
and are replicated across pods, so FSDP gathers stay within a pod and a
gradient is summed over the pods too.  :func:`group` resolves any set of
the plan's axes.

Each call counts, under its call-site name, the bytes this rank handed
the collective (a group of one rank sends nothing) and the call itself,
backward passes included, in ``plans.exchanged`` and
``plans.exchange_calls``, and reports itself to ``roofline/count.py``.

On ``meta`` tensors the calls are shape-only: they return outputs of the
gathered or reduced shape and make no ``torch.distributed`` call, so a
plan without process groups (``launch/mesh.py::production_plan``) runs
the sharded step at one rank's shapes, and the dry run counts it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.roofline import count

from .plans import P, _all_gather, note


def _flat(axes) -> frozenset:
    out = set()
    for a in axes:
        out |= set(a) if isinstance(a, tuple) else {a}
    return frozenset(out)


def group(plan, axes):
    """``(group, size, rank)`` of this rank over the mesh ``axes`` (names,
    or tuples of names), any set of the plan's axes: ``rank`` is this
    rank's block index there, row-major over the axes in mesh order."""
    axes = _flat(axes)
    if not axes or not axes <= set(plan.axes):
        raise ValueError(f"the axes {sorted(axes)} are not a set of the mesh's {plan.axes}")
    inner = tuple(a for a in plan.axes if a in axes)
    return plan.groups.get(axes), plan.axis_size(inner), plan.axis_rank(inner)


def all_gather(x: torch.Tensor, dim: int, plan, axes, name: str) -> torch.Tensor:
    """Every rank's ``x`` of the ``axes`` group concatenated along ``dim``
    in group-rank order (no gradient)."""
    grp, size, _ = group(plan, axes)
    with torch.no_grad():
        xm = x.movedim(dim, 0).contiguous()
        note(name, xm, size)
        out = xm.new_empty((size * xm.shape[0], *xm.shape[1:]))
        count.collective("all-gather", out.numel() * out.element_size(), size)
        if not out.is_meta:
            _all_gather(out, xm, grp)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, plan, axes, name: str, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its MAX taken) over the ``axes`` group: a new
    tensor (no gradient)."""
    grp, size, _ = group(plan, axes)
    with torch.no_grad():
        out = x.clone(memory_format=torch.contiguous_format)
        note(name, out, size)
        count.collective("all-reduce", out.numel() * out.element_size(), size)
        if not out.is_meta:
            dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=grp)
    return out


def _block(g: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    per = g.shape[dim] // size
    return g.narrow(dim, rank * per, per)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, plan, axes, name):
        ctx.args = (dim, plan, axes, name)
        return all_gather(x, dim, plan, axes, name)

    @staticmethod
    def backward(ctx, g):
        dim, plan, axes, name = ctx.args
        _, size, rank = group(plan, axes)
        g = all_reduce(g, plan, axes, name + ".grad")
        return _block(g, dim, size, rank), None, None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, axes, name):
        ctx.args = (plan, axes, name)
        return all_reduce(x, plan, axes, name)

    @staticmethod
    def backward(ctx, g):
        plan, axes, name = ctx.args
        return all_reduce(g, plan, axes, name + ".grad"), None, None, None


def gather(x: torch.Tensor, dim: int, plan, axis, name: str) -> torch.Tensor:
    """``all_gather`` along ``dim`` over ``axis`` (a name, or a tuple of
    names such as the row axes), differentiable."""
    return _Gather.apply(x, dim, plan, (axis,), name)


def psum(x: torch.Tensor, plan, axes, name: str) -> torch.Tensor:
    """``x`` summed over the ``axes`` group, differentiable."""
    return _Sum.apply(x, plan, tuple(axes), name)


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, plan, spec, gather_axes, name):
        dims = [(d, a) for d, a in enumerate(spec) if a is not None and a in gather_axes]
        split = {a for a in spec if a is not None and a not in gather_axes}
        ctx.args = (plan, dims, tuple(a for a in plan.axes if a not in split), name)
        out = p
        for d, a in dims:
            out = all_gather(out, d, plan, (a,), name)
        return out

    @staticmethod
    def backward(ctx, g):
        plan, dims, reduce_axes, name = ctx.args
        if reduce_axes:
            g = all_reduce(g, plan, reduce_axes, name + ".grad")
        for d, a in reversed(dims):
            _, size, rank = group(plan, (a,))
            g = _block(g, d, size, rank)
        return g, None, None, None, None


def use(p: torch.Tensor, plan, spec, gather=("data",), name: str = "fsdp") -> torch.Tensor:
    """The parameter block ``p`` (split as ``spec`` says) as a computation
    on this rank uses it: the dims split over an axis of ``gather``
    all-gathered.  Its gradient is summed over the ranks that share the
    gathered tensor (the other pods' included) and split back to this
    rank's block (see the module's docstring)."""
    return _Use.apply(p, plan, tuple(spec), tuple(gather), name)


def full_from_shards(local: torch.Tensor, spec: P, plan, name: str = "full_from_shards"):
    """The whole tensor, on every rank, from each rank's block under
    ``spec``: one all-gather over each split dim's axis."""
    out = local
    for dim, axis in enumerate(spec):
        if axis is not None:
            out = all_gather(out, dim, plan, (axis,), name)
    return out.contiguous()
