"""Row-level repair of materialized masked-closure states — the port of
``repro.delta.repair`` (relational and single-path states; the reference's
DELTA.md holds the design).

The engine caches, per grammar, a state ``(T, mask)`` whose rows under
``mask`` equal the all-pairs closure rows.  An edge edit at source row
``u`` can only change closure rows that can *reach* ``u`` through base
edges, so an :class:`~repro_torch.core.graph.EdgeDelta` becomes row
surgery:

insertions (monotone)
    The cached ``T`` is a sound lower bound of the new closure: the repair
    re-seeds the masked fixpoint with the inserted edges' source rows plus
    every cached row that can reach one, warm-starting from the cached
    state.  Rows outside that ancestor set are untouched.

deletions (non-monotone)
    Rows that could reach a deleted edge's source may have lost entries;
    they are *evicted*: reset to the new graph's base row and dropped from
    the mask (they recompute on next touch).

Invariants (tests/test_torch_delta.py and tests/test_torch_single_path.py
hold them bit for bit against the reference): after repair, rows under
``mask`` equal a from-scratch closure of the mutated graph; rows outside an
insertion's ancestor set are frozen — handed to the repair closure as
context and returned bit-identical (for a length state, every frozen
length annotation too, which keeps extracted witnesses valid); eviction is
conservative, never wrong.  Both sweeps run on the union of
the pre- and post-delta edge sets, one adjacency for both directions.

Block-sparse states (``engine="blocksparse"``) ride the same surgery with
mixed granularity: this module's seed/ancestor/eviction computation stays
*row*-level (strictly finer than blocks — evicting or re-seeding a row is
always sound), while the repair closure it dispatches to
(``core/blocksparse.py``) runs *block*-granular — an insertion reactivates
the bit-tiles its seed rows touch, expansion skips fully-frozen tiles, and
frozen rows inside a reactivated tile stay bit-identical because the OR of
recomputed entries (a subset of the exact closure) into an already-exact
frozen row is a no-op.  Every row the block-sparse repair may write is
under the mask it returns, so the rows-only copy below stays complete.

A state the ``opt`` engine sharded over a device mesh is gathered onto
every rank first (:func:`localize_state`): repair is sized by an edit's
blast radius, not by the graph, so it runs the one-device path, on every
rank alike, and the next sharded query shards the state again.

The port keeps the cached state on its device and a host copy beside it.
The reference re-reads the whole state after a repair; here only the rows
the repair may have written — the touched rows and the rows under the
repair closure's mask — are copied back (the frozen-row contract says no
other row changed), a rows-sized transfer instead of the full state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.shard.plans import ShardedState


def localize_state(state_dev):
    """A mesh-sharded cached state as one tensor on this rank's device.

    The ``opt`` backend caches states sharded over its mesh
    (:class:`~repro_torch.shard.plans.ShardedState`); repair and the
    one-device closures take the whole state, so a sharded state is
    all-gathered here onto every rank (the SPMD form of the reference's
    pull through the host); every rank must call this alike.  A state that
    is already a tensor passes through untouched."""
    if isinstance(state_dev, ShardedState):
        return state_dev.full()
    return state_dev


def placement_of(state_dev) -> str:
    """Placement tag of a cached closure state: ``"sharded"`` when it is
    spread over more than one rank of a mesh, ``"local"`` otherwise (a
    tensor, or a state sharded over a one-rank mesh).

    The engine records this after every closure and every repair (which
    localizes sharded states): it is a planner feature — consuming a state
    away from where it lives costs a move, which the cost model charges."""
    if isinstance(state_dev, ShardedState) and state_dev.plan.world > 1:
        return "sharded"
    return "local"


@dataclass
class DeltaStats:
    """Repair counters, surfaced through ``QueryResult.stats``.

    ``rows_repaired`` counts rows whose exactness the repair fixpoint
    (re-)established, ``rows_evicted`` cached rows dropped to base by a
    deletion, ``repair_iters`` closure-callable invocations (including
    capacity-overflow re-entries).  The conjunctive and count pairs keep
    the reference's fields; they stay 0 until those semantics are ported.
    """

    rows_repaired: int = 0
    rows_evicted: int = 0
    repair_iters: int = 0
    conj_repairs: int = 0
    conj_drops: int = 0
    count_repairs: int = 0
    count_drops: int = 0

    def merge(self, other: "DeltaStats") -> None:
        self.rows_repaired += other.rows_repaired
        self.rows_evicted += other.rows_evicted
        self.repair_iters += other.repair_iters
        self.conj_repairs += other.conj_repairs
        self.conj_drops += other.conj_drops
        self.count_repairs += other.count_repairs
        self.count_drops += other.count_drops

    def as_dict(self) -> dict:
        return {
            "rows_repaired": self.rows_repaired,
            "rows_evicted": self.rows_evicted,
            "repair_iters": self.repair_iters,
            "conj_repairs": self.conj_repairs,
            "conj_drops": self.conj_drops,
            "count_repairs": self.count_repairs,
            "count_drops": self.count_drops,
        }


@dataclass(frozen=True)
class RepairPlan:
    """Row masks (padded length n) driving the state surgery.

    ``evict``: ancestors of deleted-edge sources — lose exactness.
    ``affected``: ancestors of inserted-edge sources — need re-closure.
    ``ins_sources``: inserted-edge source rows — their base entries grew.
    """

    evict: np.ndarray
    affected: np.ndarray
    ins_sources: np.ndarray

    @property
    def touches_anything(self) -> bool:
        return bool(
            self.evict.any() or self.affected.any() or self.ins_sources.any()
        )


def _reverse_adjacency(edges) -> dict[int, list[int]]:
    radj: dict[int, list[int]] = {}
    for i, _, j in edges:
        radj.setdefault(j, []).append(i)
    return radj


def reverse_reach_rows(
    n: int, edges, seeds, pad_to: int | None = None, radj=None
) -> np.ndarray:
    """Rows that can reach a seed row (seeds included): label-blind reverse
    BFS over the edge list, O(V + E) host work.  Pass a prebuilt ``radj``
    (:func:`_reverse_adjacency`) to share the edge walk between sweeps.
    The device analog is ``core.closure.reverse_reachable_mask``."""
    size = pad_to if pad_to is not None else n
    mask = np.zeros(size, dtype=bool)
    seeds = [s for s in set(seeds) if 0 <= s < n]
    if not seeds:
        return mask
    if radj is None:
        radj = _reverse_adjacency(edges)
    stack = list(seeds)
    mask[seeds] = True
    while stack:
        v = stack.pop()
        for u in radj.get(v, ()):
            if not mask[u]:
                mask[u] = True
                stack.append(u)
    return mask


def plan_repair(graph: Graph, delta: EdgeDelta, pad_to: int) -> RepairPlan:
    """Build the row surgery plan for ``delta`` against the mutated
    ``graph`` (whose ``edges`` are already post-delta)."""
    union_edges = list(graph.edges) + list(delta.deleted)
    n = graph.n_nodes
    radj = (
        _reverse_adjacency(union_edges)
        if (delta.deleted_sources or delta.inserted_sources)
        else None
    )
    evict = reverse_reach_rows(
        n, union_edges, delta.deleted_sources, pad_to=pad_to, radj=radj
    )
    affected = reverse_reach_rows(
        n, union_edges, delta.inserted_sources, pad_to=pad_to, radj=radj
    )
    ins_sources = np.zeros(pad_to, dtype=bool)
    src = [u for u in delta.inserted_sources if u < n]
    if src:
        ins_sources[src] = True
    return RepairPlan(evict, affected, ins_sources)


def _repair_rows(
    state_host: np.ndarray,
    state_dev: torch.Tensor,
    mask: np.ndarray,
    plan: RepairPlan,
    base_rows_fn,
    run_closure,
    compose_patch,
    tracer=NULL_TRACER,
) -> tuple[np.ndarray, torch.Tensor, np.ndarray, DeltaStats]:
    """The row-surgery flow behind :func:`repair_state`; a touched row
    merges with its base row through ``compose_patch(old, base, ev)``, with
    ``ev`` the evicted-lane mask broadcastable over the patch.

    0. a sharded state is gathered into one tensor (:func:`localize_state`).
    1. base surgery on just the touched rows: grow inserted sources' base
       rows, reset evicted rows to the new base.  The patch is composed on
       the host and written into the device state in place (the engine owns
       it), a rows-sized transfer.
    2. insertion repair: warm-start the monotone fixpoint from the cached
       state, seeded with the inserted sources plus every still-cached
       ancestor row; cached rows outside the ancestor set are frozen.
    3. copy back to ``state_host`` (in place) only the rows steps 1–2 may
       have written, inside a ``delta.host_copy`` span.
    """
    stats = DeltaStats()
    mask = np.array(mask, copy=True)
    written = np.zeros(mask.shape, dtype=bool)
    state_dev = localize_state(state_dev)  # opt mesh states repair locally

    touched = plan.evict | plan.ins_sources
    if touched.any():
        idx = np.nonzero(touched)[0]
        base = np.asarray(base_rows_fn(idx))  # (|N|, k, n) bool base rows
        ev = plan.evict[idx][None, :, None]  # evicted reset; inserts grow
        patch = compose_patch(state_host[:, idx, :], base, ev)
        stats.rows_evicted = int((mask & plan.evict).sum())
        mask &= ~plan.evict
        tidx = torch.from_numpy(idx).to(state_dev.device)
        state_dev[:, tidx, :] = torch.from_numpy(patch).to(state_dev.device)
        written |= touched

    seed = (plan.affected & mask) | plan.ins_sources
    frozen = mask & ~plan.affected
    if seed.any():
        state_dev, M, calls = run_closure(state_dev, seed, frozen)
        M = np.asarray(M)
        stats.rows_repaired = int(M.sum())
        stats.repair_iters = calls
        # seed ⊆ M, so previously-exact affected rows are re-validated
        mask |= M
        written |= M
    if written.any():
        rows = np.nonzero(written)[0]
        with tracer.span("delta.host_copy", cat="engine", rows=len(rows)):
            tidx = torch.from_numpy(rows).to(state_dev.device)
            state_host[:, rows, :] = state_dev[:, tidx, :].cpu().numpy()
    return state_host, state_dev, mask, stats


def repair_state(
    T_host: np.ndarray,
    T_dev: torch.Tensor,
    mask: np.ndarray,
    plan: RepairPlan,
    base_rows_fn,
    run_closure,
    tracer=NULL_TRACER,
) -> tuple[np.ndarray, torch.Tensor, np.ndarray, DeltaStats]:
    """Apply ``plan`` to one grammar's cached Boolean state.

    ``T_host`` / ``T_dev`` are the host copy and the device state of the
    cached closure; both are updated in place, and only the rows the plan
    touches are rebuilt and transferred — never the whole matrix.
    ``base_rows_fn(idx) -> (|N|, len(idx), n)`` returns the mutated graph's
    base-matrix rows for a row subset; ``run_closure(T_dev, seed_mask,
    frozen_mask) -> (T_dev', M', n_calls)`` runs the repair fixpoint to
    completion (handling capacity overflow).  Rows under ``frozen_mask``
    are exact on the mutated graph and are contracted against but never
    recomputed.  ``tracer`` times the copy back to the host.

    Returns ``(T_host, T_dev, mask, stats)``; every returned row under
    ``mask`` equals the from-scratch closure row on the mutated graph.
    """

    def compose(old, base, ev):
        return np.where(ev, base, old | base)

    return _repair_rows(
        T_host, T_dev, mask, plan, base_rows_fn, run_closure, compose,
        tracer=tracer,
    )


def repair_single_path_state(
    L_host: np.ndarray,
    L_dev: torch.Tensor,
    mask: np.ndarray,
    plan: RepairPlan,
    base_rows_fn,
    run_closure,
    tracer=NULL_TRACER,
) -> tuple[np.ndarray, torch.Tensor, np.ndarray, DeltaStats]:
    """Single-path analog of :func:`repair_state` for cached length states.

    ``L`` is the (|N|, n, n) f32 matrix of core/semantics.py —
    ``isfinite(L)`` is the Boolean closure, finite values are witness
    lengths frozen at first discovery.  The surgery is the same row plan,
    adapted to the freeze contract: previously finite entries are NEVER
    overwritten, so

    * inserted sources only *fill* entries that were absent (new base
      edges enter at length 1; existing annotations stay), then re-enter
      the repair fixpoint as seeds;
    * evicted rows reset wholesale to base lengths — any row whose
      recorded splits pass through an evicted row is itself an ancestor of
      the deleted edge (hence evicted too), so surviving rows' annotations
      stay extraction-consistent.

    ``run_closure(L_dev, seed_mask, frozen_mask) -> (L_dev', M', n_calls)``
    runs the single-path repair fixpoint.  Returns ``(L_host, L_dev, mask,
    stats)``; like :func:`repair_state`, only the rows the repair may have
    written are copied back into ``L_host``.
    """

    def compose(old, base, ev):
        base_l = np.where(base, np.float32(1.0), np.float32(np.inf))
        keep = np.isfinite(old) & ~ev  # freeze: never overwrite finite
        return np.where(keep, old, base_l).astype(np.float32)

    return _repair_rows(
        L_host, L_dev, mask, plan, base_rows_fn, run_closure, compose,
        tracer=tracer,
    )
