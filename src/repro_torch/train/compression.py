"""int8 gradient compression with error feedback for the data-parallel
all-reduce (the port of the reference's ``train/compression.py``).

Per tensor, over the ``axis`` group of a device mesh:
  1. v = grad + error_carry          (error feedback)
  2. scale = MAX-all-reduce(max|v|) / 127, at least 1e-20 (a shared
     scale, so the sum decodes exactly)
  3. q = round(v / scale), clipped to +-127, as int8 (the wire format)
  4. g_hat = SUM-all-reduce(q widened to int32) * scale / n
  5. error_carry = v - q * scale     (this rank's quantization residual)

The reference stacks every rank's gradient on a leading axis; here each
rank passes its own, and gets back the mean (the same on every rank) and
its own error carry.  The SUM moves the int32 widening (4 bytes an
element), which is what ``shard.plans.exchanged`` counts; a collective
with int8 on the wire and int32 accumulators would move a quarter of it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.shard.plans import note


def make_compressed_allreduce(mesh, axis: str = "data"):
    """``reduce(grads, err) -> (g_hat, err)`` over the ``axis`` group of
    the ``DeviceMesh`` ``mesh``; ``grads`` and ``err`` are dicts of this
    rank's tensors (``err`` starts at zeros)."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def one(g: torch.Tensor, e: torch.Tensor):
        v = g + e
        amax = v.abs().max().reshape(1)
        note("compressed.scale", amax, n)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0] / 127.0, min=1e-20)
        q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        note("compressed.q", total, n)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * scale / n, v - q.float() * scale

    def reduce(grads: dict, err: dict):
        out = {k: one(g, err[k]) for k, g in grads.items()}
        return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}

    return reduce
