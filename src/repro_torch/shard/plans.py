"""Sharding plan of the ``opt`` family: how a closure state maps onto a
``torch.distributed`` device mesh — the port of ``repro.shard.plans``.

The mesh names the axes ``data`` and ``model``, with an optional leading
``pod``.  The persistent closure state — packed int32 words ``(N, n, w)``
of a Boolean state, or the f32 lengths ``(N, n, n)`` of a single-path one —
is sharded over ``(row, model)``: its rows over the row axis (``(pod,
data)``, or ``data``) and its last axis (words, or columns) over
``model``.  Each rank holds one block, padded to an equal size on every
rank (zero words, or ``inf`` lengths, in the fill lanes), so every
collective moves equal shapes.

The reference writes the layout as PartitionSpecs (``closure_specs``) and
lets the SPMD partitioner insert the exchanges.  Here they are plain
functions on tensors, each one collective:

  ``row_copy(block)``    all-gather over the ``model`` group: rows of this
                         rank, every word (or column);
  ``col_copy(state)``    all-gather over the row group: every row, the
                         words (or columns) of this rank;
  ``gather_rows(T, idx)`` each compacted row summed in from its owner over
                         the row group (one SUM all-reduce; the other
                         ranks add zeros, so the sum is exact);
  ``scatter_rows(T, idx, new)`` this rank's share of the new compacted rows
                         all-gathered over the row group, then each row
                         written into its owner's block;
  ``any_world(flags)``   one MAX all-reduce over the mesh.

Only SUM and MAX reductions on integer or float tensors are used: NCCL
has no bitwise reductions, and the gloo worlds of the CPU tests must run
the calls the card runs.  :class:`LocalPlan` is the same layout on one
device with no collectives: the closures' ``plan=None``.

The model-family helpers of the reference's ``MeshPlan`` (``batch``,
``batch_size_divisor``, ``p_batch``, ``fsdp_dim``, ``tp_dim``,
``attn_mode``) are here too, with :class:`P`, the port's PartitionSpec,
and :func:`local_shard`, a tensor's block on this rank.  The sharded
LM's collectives, which autograd differentiates, and
``full_from_shards``, the whole tensor gathered back, are in
``shard/collectives.py``; the specs of its parameters, caches and
optimizer state in ``models/transformer.py`` and ``train/optimizer.py``.
"""
from __future__ import annotations

import hashlib
import itertools
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.roofline import count

INF = float("inf")

#: bytes each exchange sent from this rank, and its calls, by call-site
#: name: the ``opt`` family's exchanges of a MeshPlan (``any_world`` is
#: called once per closure iteration) and the sharded LM's collectives
#: (``shard/collectives.py``).  Plain counters, as ``kernels.ops.launches``;
#: callers reset them.
exchanged: dict[str, int] = {}
exchange_calls: dict[str, int] = {}


def reset_exchanges() -> None:
    exchanged.clear()
    exchange_calls.clear()


def note(name: str, sent: torch.Tensor, group_size: int | None = None) -> None:
    """Count an exchange at the call site ``name``: ``sent`` is what this
    rank puts on the wire.  A group of one rank (``group_size`` 1) sends
    nothing, though its call counts; without a size the bytes are counted
    from the shape."""
    if group_size != 1:
        exchanged[name] = exchanged.get(name, 0) + sent.numel() * sent.element_size()
    exchange_calls[name] = exchange_calls.get(name, 0) + 1


class P(tuple):
    """The port's PartitionSpec: one entry per tensor dim, ``None`` (the dim
    is whole on every rank), a mesh axis name (the dim is split into equal
    blocks over that axis) or a tuple of axis names (split over all of
    them, row-major).  A plain immutable tuple, so specs compare with the
    reference's as tuples."""

    __slots__ = ()

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _per(extent: int, parts: int) -> int:
    """The extent of one rank's shard: equal on every rank, at least 1."""
    return max(1, -(-extent // parts))


def mesh_key_of(mesh) -> tuple:
    """:attr:`repro_torch.engine.plan.PlanKey.mesh` identity of a device
    mesh: its ``(axis_name, size)`` pairs, ``()`` for ``None``."""
    if mesh is None:
        return ()
    return tuple(
        (str(a), int(s)) for a, s in zip(mesh.mesh_dim_names, mesh.shape)
    )


class _Layout:
    """The block layout over a ``row_size`` x ``model_size`` grid of ranks
    and the exchanges built on three collectives, which a subclass
    supplies (:meth:`_gather`, :meth:`_sum_rows`, :meth:`any_world`)."""

    row_size: int
    model_size: int
    row_rank: int
    model_rank: int

    # -- the collectives ------------------------------------------------ #
    def _note(self, name: str, sent: torch.Tensor) -> None:
        """Count an exchange: ``sent`` is what this rank puts on the wire."""

    def _gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``(size, *x.shape)``: ``x`` of every rank of the ``axis``
        group ("row" or "model"), in group-rank order."""
        raise NotImplementedError

    def _sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the row group, in place."""
        raise NotImplementedError

    def any_world(self, flags: torch.Tensor) -> torch.Tensor:
        """The element-wise MAX of the int32 ``flags`` over every rank of
        the mesh, in place: one all-reduce."""
        raise NotImplementedError

    # -- the layout ------------------------------------------------------ #
    def same_layout(self, other) -> bool:
        return (self.row_size, self.model_size, self.row_rank, self.model_rank) == (
            other.row_size, other.model_size, other.row_rank, other.model_rank
        )

    def rows_per(self, n: int) -> int:
        return _per(n, self.row_size)

    def cols_per(self, cols: int) -> int:
        return _per(cols, self.model_size)

    def row_range(self, n: int) -> tuple[int, int]:
        """The rows ``[r0, r1)`` of an ``n``-row state this rank owns."""
        per = self.rows_per(n)
        r0 = min(n, self.row_rank * per)
        return r0, min(n, r0 + per)

    def col_range(self, cols: int) -> tuple[int, int]:
        """The words (or columns) ``[c0, c1)`` of the last axis this rank
        owns."""
        per = self.cols_per(cols)
        c0 = min(cols, self.model_rank * per)
        return c0, min(cols, c0 + per)

    def lanes_per(self, k: int) -> int:
        """Compacted rows per row rank when ``k`` rows are compacted (the
        block is padded to ``row_size`` times this)."""
        return _per(k, self.row_size)

    def shard(self, full: torch.Tensor, fill) -> torch.Tensor:
        """This rank's block ``(N, rows_per, cols_per)`` of the full state
        ``(N, n, cols)``, padded with ``fill``; a new tensor."""
        N, n, cols = full.shape
        rp, cp = self.rows_per(n), self.cols_per(cols)
        r0, r1 = self.row_range(n)
        c0, c1 = self.col_range(cols)
        if (r1 - r0, c1 - c0) == (rp, cp):
            return full[:, r0:r1, c0:c1].clone(memory_format=torch.contiguous_format)
        out = full.new_full((N, rp, cp), fill)
        out[:, : r1 - r0, : c1 - c0] = full[:, r0:r1, c0:c1]
        return out

    def row_copy(self, block: torch.Tensor, cols: int) -> torch.Tensor:
        """``(N, r, cols)``: the rows of ``block`` (this rank's words) with
        every word, all-gathered over the ``model`` group; contiguous."""
        self._note("row_copy", block)
        g = self._gather(block, "model")  # (model, N, r, cp)
        M, N, r, cp = g.shape
        out = g.permute(1, 2, 0, 3).reshape(N, r, M * cp)[..., :cols]
        return out.contiguous()

    def col_copy(self, state: torch.Tensor, n: int) -> torch.Tensor:
        """``(N, n, cp)``: every row of the state, this rank's words (or
        columns), all-gathered over the row group; contiguous."""
        self._note("col_copy", state)
        g = self._gather(state, "row")  # (rows, N, rp, cp)
        S, N, rp, cp = g.shape
        out = g.permute(1, 0, 2, 3).reshape(N, S * rp, cp)[:, :n]
        return out.contiguous()

    def assemble(self, local: torch.Tensor, n: int, cols: int) -> torch.Tensor:
        """The full ``(N, n, cols)`` state from every rank's block, on
        every rank."""
        return self.row_copy(self.col_copy(local, n), cols)

    def gather_rows(
        self, local: torch.Tensor, idx: torch.Tensor, lanes: int, n: int
    ) -> torch.Tensor:
        """``(N, lanes, cp)``: lane ``l < len(idx)`` holds row ``idx[l]`` of
        the state (this rank's words or columns), gathered from its owner;
        lanes past ``len(idx)`` hold zeros.  ``idx`` is the same on every
        rank, its rows distinct."""
        N, _, cp = local.shape
        r0, r1 = self.row_range(n)
        out = local.new_zeros((N, lanes, cp))
        own = torch.nonzero((idx >= r0) & (idx < r1)).flatten()
        out[:, own] = local[:, idx[own] - r0]
        self._note("gather_rows", out)
        return self._sum_rows(out)

    def scatter_rows(
        self,
        local: torch.Tensor,
        idx: torch.Tensor,
        share: torch.Tensor,
        n: int,
    ) -> torch.Tensor:
        """Write the new compacted rows into their owners' blocks.

        ``share`` ``(N, lanes_per, cp)`` is this rank's lanes of the new
        compacted block (row rank ``r`` holds lanes ``r * lanes_per`` on);
        it is all-gathered over the row group, and each lane ``l <
        len(idx)`` whose row ``idx[l]`` this rank owns is written in place.
        Returns a 0-d bool tensor: whether any written row changed here."""
        self._note("scatter_rows", share)
        g = self._gather(share, "row")  # (rows, N, kp, cp)
        S, N, kp, cp = g.shape
        new = g.permute(1, 0, 2, 3).reshape(N, S * kp, cp)[:, : idx.numel()]
        r0, r1 = self.row_range(n)
        own = torch.nonzero((idx >= r0) & (idx < r1)).flatten()
        pos = idx[own] - r0
        old = local[:, pos]
        upd = new[:, own]
        local[:, pos] = upd
        return (upd != old).any()


class LocalPlan(_Layout):
    """The one-device layout: the whole state is this "rank's" block and
    every exchange is the identity.  The ``opt`` closures run it for
    ``plan=None``: the same math as on a mesh, with no collective."""

    row_size = model_size = 1
    row_rank = model_rank = 0

    def _gather(self, x, axis):
        return x[None]

    def _sum_rows(self, x):
        return x

    def any_world(self, flags):
        return flags


def _all_gather(out, inp, group) -> None:
    # torch 2.13 renamed all_gather_into_tensor (the old name warns there)
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


#: process groups made for a mesh layout, by (its shape, its ranks, its
#: axis names, the group's axes): groups must be created collectively, so
#: each is made once per process
_GROUPS: dict = {}


def _axes_of(mesh) -> tuple[str, ...]:
    """The axis names of an ``opt`` mesh; raises unless they are ``data``
    and ``model``, with at most a ``pod`` axis besides."""
    names = tuple(mesh.mesh_dim_names or ())
    if not {"data", "model"} <= set(names) or not set(names) <= {"pod", "data", "model"}:
        raise ValueError(
            "opt mesh must name 'data' and 'model' axes (and at most a "
            f"'pod' axis besides; got {names})"
        )
    return names


def _group_of(mesh, names: tuple[str, ...], axes: tuple[str, ...]):
    """The process group of this rank over the mesh axes ``axes`` (in mesh
    order): the mesh's own group for one axis; for several, a group made
    once, collectively, for every slice of the mesh along the other axes,
    its ranks row-major over ``axes``; ``None`` (the default group) for a
    mesh of the whole world."""
    import torch.distributed as dist

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    ranks = mesh.mesh
    if len(axes) == len(names) and ranks.numel() == dist.get_world_size():
        return None  # the default group spans the mesh
    key = (tuple(ranks.shape), tuple(ranks.flatten().tolist()), names, axes)
    if key not in _GROUPS:
        rest = [names.index(a) for a in names if a not in axes]
        inner = [names.index(a) for a in axes]
        slices = ranks.permute(rest + inner).reshape(-1, _prod(ranks, inner))
        mine = None
        for members in slices.tolist():
            g = dist.new_group(ranks=members)
            if dist.get_rank() in members:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def _prod(ranks: torch.Tensor, dims: list[int]) -> int:
    out = 1
    for d in dims:
        out *= ranks.shape[d]
    return out


@dataclass(frozen=True)
class MeshPlan(_Layout):
    """The reference's ``MeshPlan`` on a ``torch.distributed`` device mesh:
    the axis names and sizes, this rank's coordinates, and its process
    group over every set of the mesh's axes (``groups``), which the
    exchanges of :class:`_Layout` and ``shard/collectives.py`` use."""

    pod_axis: str | None  # None on single-pod meshes
    data_axis: str
    model_axis: str
    pod_size: int
    data_size: int
    model_size: int
    row_rank: int = 0
    model_rank: int = 0
    mesh: object = field(default=None, repr=False, compare=False)
    #: this rank's process group over each set of mesh axes (a frozenset
    #: of names); empty on a plan without process groups
    groups: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshPlan":
        """The plan of ``mesh`` (a ``DeviceMesh`` whose axes are ``data``
        and ``model``, with an optional leading ``pod``) for this rank,
        with its group over every set of the mesh's axes, each made
        collectively, in the same order on every rank."""
        import torch.distributed as dist

        names = _axes_of(mesh)
        sizes = dict(zip(names, mesh.shape))
        groups = {frozenset(axes): _group_of(mesh, names, axes)
                  for n in range(1, len(names) + 1) for axes in itertools.combinations(names, n)}
        pod = "pod" if "pod" in sizes else None
        row = frozenset(("pod", "data") if pod else ("data",))
        me = dist.get_rank()
        return cls(
            pod_axis=pod,
            data_axis="data",
            model_axis="model",
            pod_size=sizes.get("pod", 1),
            data_size=sizes["data"],
            model_size=sizes["model"],
            row_rank=dist.get_group_rank(groups[row], me),
            model_rank=dist.get_group_rank(groups[frozenset({"model"})], me),
            mesh=mesh,
            groups=groups,
        )

    @property
    def axes(self) -> tuple[str, ...]:
        """The mesh's axis names, in mesh order."""
        return (self.pod_axis, self.data_axis, self.model_axis) if self.pod_axis else (
            self.data_axis, self.model_axis)

    @property
    def row_axes(self) -> tuple[str, ...]:
        """The axes a batch's rows split over: ``(pod, data)``, or ``data``."""
        return self.axes[:-1]

    @property
    def row_group(self):
        return self.groups.get(frozenset(self.row_axes))

    @property
    def model_group(self):
        return self.groups.get(frozenset({self.model_axis}))

    @property
    def mesh_group(self):
        return self.groups.get(frozenset(self.axes))

    @property
    def batch(self):
        """Mesh axes a batch-like leading dim shards over."""
        return (self.pod_axis, self.data_axis) if self.pod_axis else self.data_axis

    @property
    def batch_size_divisor(self) -> int:
        return self.pod_size * self.data_size

    def p_batch(self, *rest) -> P:
        return P(self.batch, *rest)

    def fsdp_dim(self, size: int):
        """FSDP shards a parameter dim over ``data`` only when divisible."""
        return self.data_axis if size % self.data_size == 0 else None

    def tp_dim(self, size: int):
        return self.model_axis if size % self.model_size == 0 else None

    def attn_mode(self, n_heads: int, head_dim: int, decode: bool) -> str:
        """The reference's attention TP mode: ``head`` when the heads divide
        over ``model`` (never for decode); else ``seq`` (sequence-parallel)
        unless ``REPRO_ATTN_FALLBACK`` names another fallback, or for decode;
        else ``hd`` (head_dim split) when it divides, else ``replicate``.
        ``REPRO_ATTN_FORCE`` overrides the mode outside decode."""
        mode = os.environ.get("REPRO_ATTN_FALLBACK", "seq")
        force = os.environ.get("REPRO_ATTN_FORCE")
        if force and not decode:
            return force
        if not decode and n_heads % self.model_size == 0:
            return "head"
        if not decode and mode == "seq":
            return "seq"
        if head_dim % self.model_size == 0:
            return "hd"
        return "replicate"

    def axis_size(self, axis) -> int:
        """Ranks along a spec entry: an axis name or a tuple of them."""
        if isinstance(axis, tuple):
            out = 1
            for a in axis:
                out *= self.axis_size(a)
            return out
        return {"pod": self.pod_size, "data": self.data_size, "model": self.model_size}[axis]

    def axis_rank(self, axis) -> int:
        """This rank's coordinate along a spec entry (row-major over a
        tuple); the row rank is ``pod * data_size + data``."""
        if isinstance(axis, tuple):
            out = 0
            for a in axis:
                out = out * self.axis_size(a) + self.axis_rank(a)
            return out
        return {"pod": self.row_rank // self.data_size, "data": self.row_rank % self.data_size,
                "model": self.model_rank}[axis]

    @property
    def row_size(self) -> int:
        return self.pod_size * self.data_size

    @property
    def world(self) -> int:
        """Ranks of the mesh."""
        return self.row_size * self.model_size

    def _note(self, name, sent):
        note(name, sent)

    # On meta tensors the three are shape-only (no torch.distributed
    # call), as in shard/collectives.py: the dry run's plans have no groups.
    def _gather(self, x, axis):
        group, size = (
            (self.row_group, self.row_size) if axis == "row"
            else (self.model_group, self.model_size)
        )
        x = x.contiguous()
        # the gather concatenates along dim 0
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        count.collective("all-gather", out.numel() * out.element_size(), size)
        if not out.is_meta:
            _all_gather(out, x, group)
        return out.view(size, *x.shape)

    def _sum_rows(self, x):
        import torch.distributed as dist

        count.collective("all-reduce", x.numel() * x.element_size(), self.row_size)
        if not x.is_meta:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.row_group)
        return x

    def any_world(self, flags):
        import torch.distributed as dist

        self._note("any_world", flags)
        count.collective("all-reduce", flags.numel() * flags.element_size(), self.world)
        if not flags.is_meta:
            dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.mesh_group)
        return flags

    def check_same(self, what: str, value) -> None:
        """Raise on every rank unless ``repr(value)`` is the same on every
        rank of the mesh.  One MAX all-reduce of a digest of it beside the
        digest's negation: the ranks agree exactly when the maxima of the
        two halves cancel, so every rank reaches the same verdict."""
        import torch.distributed as dist

        h = hashlib.sha256(repr(value).encode()).digest()
        words = [int.from_bytes(h[i:i + 4], "little") for i in range(0, 16, 4)]
        both = torch.tensor(words + [-x for x in words], dtype=torch.int64,
                            device=self.mesh.device_type)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.mesh_group)
        if not torch.equal(both[:4], -both[4:]):
            raise RuntimeError(
                f"the ranks of the mesh disagree on the {what}; every rank "
                "must make the same calls with the same values"
            )


def _blocks(spec: P, shape, plan: MeshPlan):
    """``(dim, axis, size, rank)`` of each split dim of a ``shape`` tensor
    under ``spec``; raises unless every split dim divides."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the shape {tuple(shape)} has dims")
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = plan.axis_size(axis)
        if shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axis!r} ({size} ranks)")
        out.append((dim, axis, size, plan.axis_rank(axis)))
    return out


def local_shard(t, spec: P, plan: MeshPlan):
    """This rank's block of the whole tensor (or numpy array) ``t`` under
    ``spec``: a new, contiguous array of its own."""
    idx = [slice(None)] * len(t.shape)
    for dim, _, size, rank in _blocks(spec, t.shape, plan):
        per = t.shape[dim] // size
        idx[dim] = slice(rank * per, (rank + 1) * per)
    block = t[tuple(idx)]
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return np.array(block)


def check_mesh(mesh, device: str) -> None:
    """Raise unless ``mesh`` can carry states on ``device``: the axes of
    an ``opt`` mesh, a live process group, a mesh of the same device type,
    NCCL for ``cuda`` and gloo for ``cpu``."""
    import torch.distributed as dist

    _axes_of(mesh)
    kind = torch.device(device).type
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed process group")
    if mesh.device_type != kind:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} but the engine's device is "
            f"{device!r}; they must match"
        )
    want = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    backend = str(dist.get_backend(mesh.get_group("model")))
    if want is None or want not in backend:
        raise ValueError(
            f"a {kind!r} mesh needs the {want} backend, its group runs {backend!r}"
        )
    if kind == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build")


@dataclass(eq=False)
class ShardedState:
    """A closure state sharded over a mesh: this rank's block, the global
    size and the plan.  ``packed``: the block holds int32 words of a
    Boolean state (zero fill); else f32 lengths (``inf`` fill)."""

    local: torch.Tensor  # (N, rows_per, cols_per) of this rank
    n: int
    plan: MeshPlan
    packed: bool

    @property
    def cols(self) -> int:
        return -(-self.n // 32) if self.packed else self.n

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.local.shape[0], self.n, self.n)

    @property
    def device(self) -> torch.device:
        return self.local.device

    def _values(self, words: torch.Tensor) -> torch.Tensor:
        if not self.packed:
            return words
        from repro_torch.core.matrices import unpack_bits

        return unpack_bits(words, self.n)

    def full(self) -> torch.Tensor:
        """The whole state, ``(N, n, n)`` bool or f32, on every rank."""
        return self._values(self.plan.assemble(self.local, self.n, self.cols))

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (the same on every rank) of the state, ``(N, k,
        n)``, on every rank: gathered from their owners, then every word
        all-gathered."""
        if idx.numel() == 0:
            return self._values(self.local.new_zeros((self.local.shape[0], 0, self.cols)))
        blk = self.plan.gather_rows(self.local, idx, idx.numel(), self.n)
        return self._values(self.plan.row_copy(blk, self.cols))
