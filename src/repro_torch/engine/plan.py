"""Query planning: the closure cache of the port.

A closure callable is determined by ``(grammar tables, engine, padded n,
row capacity)`` — all static shape/constant information.  The reference
caches an AOT ``lower(...).compile()`` executable per plan key; torch runs
eagerly and has no such step, so this cache stores the masked-closure
function with its statics bound.  What the cache keeps is the reference's
observable contract: ``compile_misses`` counts first requests of a key,
``compile_hits`` repeats, and provenance tallies who asked.

Row capacities are bucketed (powers of two from 128 up to n) so warm
restarts after an active-set overflow reuse at most O(log n) distinct
plans per grammar instead of one per exact source count.

Invariants
----------
* **PlanKey identity.**  A cached callable is a pure function of its
  :class:`PlanKey` and of nothing else; it never depends on graph data, so
  it survives every graph edit and may be shared across engines serving
  different graphs of the same padded size.  The key keeps every field of
  the reference's ``PlanKey``.  ``mesh`` is the device-mesh identity
  (:func:`mesh_key_of`) of a sharded ``opt`` key, ``()`` otherwise; the
  concrete mesh is given at build time.  The port builds relational and
  single-path keys, masked or repair
  (``repair=True``, with ``ctx_capacity`` the contraction-context bucket
  of the dense/frontier and every single-path repair, 0 for the packed
  and block-sparse ones), and masked conjunctive and count keys (their
  ``tables`` a ``ConjunctiveTables`` or ``ProductionTables``; neither
  has a repair variant; neither, nor a repair key, carries a mesh).
  ``tile`` is the bit-tile edge of a
  block-sparse key (whose ``row_capacity`` then counts occupied blocks),
  0 for every other backend.
* **Key aliasing is semantic.**  :func:`sp_engine_name`,
  :func:`conj_engine_name` and :func:`count_engine_name` collapse keys
  exactly where the closure function is shared (bitpacked single-path
  aliases to dense; the one single-path repair keys as dense; conjunctive
  keys collapse onto dense and bitpacked, count keys onto dense), so the
  hit counters reflect real reuse.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import blocksparse as _blocksparse
from repro_torch.core import closure as _closure
from repro_torch.core import semantics as _semantics
from repro_torch.core.matrices import ProductionTables
from repro_torch.obs.trace import emit_iteration
from repro_torch.shard.plans import MeshPlan, mesh_key_of

#: masked (source-restricted) closure per backend — the serving fast path.
#: ``opt`` is the packed-exchange engine: the only backend whose plans take
#: a mesh identity (PlanKey.mesh) and shard the state over it; without a
#: mesh it runs the same math on one device.  ``blocksparse`` is the tiled
#: occupied-block engine (core/blocksparse.py): host-driven, its capacity
#: counts occupied blocks.
MASKED_ENGINES = {
    "dense": _closure.masked_closure,
    "frontier": _closure.masked_frontier_closure,
    "bitpacked": _closure.masked_bitpacked_closure,
    "opt": _closure.masked_opt_closure,
    "blocksparse": _blocksparse.masked_blocksparse_closure,
}

#: repair closure per backend — delta ingestion (frozen-row warm restart;
#: the frontier backend shares the dense repair path; the opt backend has no
#: sharded repair: :func:`repair_engine_name` keys it as bitpacked)
REPAIR_ENGINES = {
    "dense": _closure.masked_repair_closure,
    "frontier": _closure.masked_repair_closure,
    "bitpacked": _closure.masked_bitpacked_repair_closure,
    "blocksparse": _blocksparse.masked_blocksparse_repair_closure,
}


#: masked single-path (length-annotated) closure per backend.  Lengths are
#: f32 — there is no packed layout to exploit — so the bitpacked backend
#: routes through the dense min-plus path (see :func:`sp_engine_name`);
#: the opt backend shards the compacted min-plus row block over the mesh.
SP_ENGINES = {
    "dense": _semantics.masked_single_path_closure,
    "frontier": _semantics.masked_frontier_single_path_closure,
    "opt": _semantics.masked_opt_single_path_closure,
}


#: masked conjunctive closure per backend (``semantics="conjunctive"``).
#: Only two real variants exist, the dense matmul path and the packed-word
#: path: the frontier trick is unsound under AND, and the block-sparse
#: treatment has no conjunctive variant, so :func:`conj_engine_name`
#: aliases every backend onto these two.
CONJ_ENGINES = {
    "dense": _semantics.masked_conjunctive_closure,
    "bitpacked": _semantics.masked_bitpacked_conjunctive_closure,
}

#: masked counting closure (``semantics="count"``).  One real variant:
#: saturating count planes have no packed layout, no frontier trick (the
#: Jacobi recompute re-reads full rows) and no block-tiled treatment, so
#: :func:`count_engine_name` aliases every backend onto it.
COUNT_ENGINES = {
    "dense": _semantics.masked_count_closure,
}


def count_engine_name(engine: str) -> str:
    """Backend name to key counting plans under: always ``dense`` — there
    is exactly one masked counting closure (see :data:`COUNT_ENGINES`)."""
    return "dense"


def conj_engine_name(engine: str) -> str:
    """Backend name to key conjunctive plans under: packed backends
    (bitpacked, opt, blocksparse) alias to the bitpacked conjunctive
    closure, everything else (dense, frontier) to the dense one."""
    return "bitpacked" if engine in ("bitpacked", "opt", "blocksparse") \
        else "dense"


def sp_engine_name(engine: str, repair: bool = False) -> str:
    """Backend name to key single-path plans under: engines without a
    length-annotated variant (bitpacked, blocksparse) alias to dense, and
    the repair variant — one function serves every backend — always keys
    as dense."""
    if repair:
        return "dense"
    return engine if engine in SP_ENGINES else "dense"


def repair_engine_name(engine: str) -> str:
    """Backend name to key Boolean repair plans under.  The ``opt``
    backend keys as ``bitpacked`` (repair is sized by an edit's blast
    radius, so it always runs the single-device packed path, and ``mesh``
    stays out of repair keys); the other backends key as themselves."""
    return "bitpacked" if engine == "opt" else engine


def row_buckets(n: int) -> list[int]:
    """Allowed row capacities for padded size n: 128, 256, ... , n."""
    out: list[int] = []
    r = 128
    while r < n:
        out.append(r)
        r *= 2
    out.append(n)
    return out


def bucket_for(n_rows: int, n: int) -> int:
    """Smallest bucket holding ``n_rows`` active rows."""
    for r in row_buckets(n):
        if r >= n_rows:
            return r
    return n


@dataclass(frozen=True)
class PlanKey:
    """Everything that determines a closure callable (the reference's
    fields, see ``repro.engine.plan.PlanKey``).  ``instrumented`` selects
    the observability build: the callable passes the
    :func:`repro_torch.obs.trace.emit_iteration` trampoline as the
    closure's ``iter_hook``.  It IS part of the identity, so the untraced
    path never calls a hook.  ``opt`` plans are never instrumented (their
    closures take no hook: under SPMD every rank would fire it);
    engine/service.py never asks for one."""

    tables: ProductionTables  # a ConjunctiveTables for a conjunctive key
    engine: str
    n: int  # padded matrix size
    row_capacity: int
    repair: bool = False
    ctx_capacity: int = 0
    semantics: str = "relational"
    mesh: tuple = ()
    instrumented: bool = False
    tile: int = 0


@dataclass
class PlanStats:
    """Cache counters plus *provenance* tallies.

    Provenance records **who asked** for each plan — ``"planned"``
    (cost-based planner decision), ``"pinned"`` (caller named the
    backend), or any caller-supplied tag — without touching PlanKey
    identity: a planner-requested plan and a pinned one with the same key
    share one cache entry.
    """

    compile_misses: int = 0
    compile_hits: int = 0
    #: provenance tag -> requests (hits + misses) under that tag
    provenance: dict = field(default_factory=dict)

    def note_provenance(self, tag: str | None) -> None:
        if tag:
            self.provenance[tag] = self.provenance.get(tag, 0) + 1

    def as_dict(self) -> dict:
        return {
            "compile_misses": self.compile_misses,
            "compile_hits": self.compile_hits,
        }


class CompiledClosureCache:
    """Masked-closure callables keyed on PlanKey.

    ``get(key)`` returns a callable ``(T, src_mask) -> (T, mask, overflow)``
    — ``(T, src_mask, frozen_mask)`` for a repair key, ``(C, base,
    src_mask)`` for a count key; ``T`` is the f32 length state for a
    single-path key — with the grammar tables and capacities bound.  The name and counters
    are the reference's; in the port a "compile" is the binding of the
    closure's statics.
    """

    def __init__(self) -> None:
        self._exe: dict[PlanKey, object] = {}
        self.stats = PlanStats()

    def __len__(self) -> int:
        return len(self._exe)

    def get(self, key: PlanKey, mesh=None, provenance: str | None = None):
        """Callable for ``key``.  A sharded key (``key.mesh != ()``) needs
        the concrete device mesh on a miss — the key holds only its shape
        identity.  ``provenance`` tags the request origin (``"planned"`` /
        ``"pinned"``) in :class:`PlanStats` — observability only, never
        part of the key."""
        self.stats.note_provenance(provenance)
        exe = self._exe.get(key)
        if exe is None:
            self.stats.compile_misses += 1
            exe = self._exe[key] = self._build(key, mesh)
        else:
            self.stats.compile_hits += 1
        return exe

    @staticmethod
    def _plan_of(key: PlanKey, mesh):
        """The MeshPlan a sharded key binds, None for a one-device key;
        raises when the mesh given is not the one the key names."""
        if not key.mesh:
            return None
        if mesh is None or mesh_key_of(mesh) != key.mesh:
            raise ValueError(
                f"PlanKey has mesh identity {key.mesh} but got "
                f"{'no mesh' if mesh is None else mesh_key_of(mesh)}"
            )
        return MeshPlan.from_mesh(mesh)

    @classmethod
    def _build(cls, key: PlanKey, mesh=None):
        blocksparse = key.engine == "blocksparse" and key.semantics == "relational"
        masked_only = key.semantics in ("conjunctive", "count")
        opt = key.engine == "opt" and not key.repair
        if key.semantics not in ("relational", "single_path", "conjunctive", "count") \
                or (key.mesh and not opt) or (key.tile and not blocksparse) \
                or (masked_only and key.repair):
            raise ValueError(f"the port builds no plan for {key}")
        single_path = key.semantics == "single_path"
        if opt:  # no hook: the opt closures take none
            kw = {"row_capacity": key.row_capacity,
                  "plan": cls._plan_of(key, mesh)}
        else:
            kw = {
                "row_capacity": key.row_capacity,
                "iter_hook": emit_iteration if key.instrumented else None,
            }
        if key.semantics == "conjunctive":
            conj = CONJ_ENGINES[key.engine]

            def exe_conj(T, src_mask):
                return conj(T, key.tables, src_mask, **kw)

            return exe_conj
        if key.semantics == "count":
            count = COUNT_ENGINES[key.engine]

            def exe_count(C, base, src_mask):
                return count(C, base, key.tables, src_mask, **kw)

            return exe_count
        if blocksparse:  # host-driven: capacity counts occupied blocks
            kw["tile"] = key.tile or _blocksparse.DEFAULT_TILE
        if key.repair:
            fn = (
                _semantics.masked_single_path_repair_closure
                if single_path else REPAIR_ENGINES[key.engine]
            )
            if key.ctx_capacity:  # dense/frontier compact the contraction
                kw["ctx_capacity"] = key.ctx_capacity

            def exe_repair(T, src_mask, frozen_mask):
                return fn(T, key.tables, src_mask, frozen_mask, **kw)

            return exe_repair
        fn = (SP_ENGINES if single_path else MASKED_ENGINES)[key.engine]

        def exe(T, src_mask):
            return fn(T, key.tables, src_mask, **kw)

        return exe
