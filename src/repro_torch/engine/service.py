"""Batched single-/multi-source CFPQ serving — the port of
``repro.engine.service``: relational, single-path, conjunctive and count
semantics.

``QueryEngine`` is bound to one graph and serves queries over any number of
grammars.  A batch is coalesced per (grammar, semantics): the union of all
requested source rows is computed in ONE masked-closure call (see
core/closure.py), then each request slices its rows out.  Per grammar the
engine keeps a *materialized* closure state ``(T, mask)`` on its device —
rows listed in ``mask`` are already exact — so repeated or overlapping
queries against an unchanged graph are pure row slices, and new sources
warm-start the monotone fixpoint from the cached state.

Single-path queries (``semantics="single_path"``, paper Section 5) are
served the same way from a second state per grammar: the (N, n, n) f32
length matrix of core/semantics.py (``isfinite`` of it IS the Boolean
closure), kept by the masked single-path closures on the same capacity
ladder, and a host mirror of it that the witness extractor
(``PathExtractor``) reads.  After a closure only the rows that joined the
mask are copied into the mirror: finite lengths are frozen, and rows
already under the mask were exact, so no other row changed.  Witnesses
are memoized per grammar state until the next ingested delta.

Conjunctive queries (``semantics="conjunctive"``, a
:class:`~repro_torch.core.conjunctive.ConjunctiveGrammar`) share the
relational path's Boolean state and slicing over different closures
(plan.CONJ_ENGINES).  Count queries (``semantics="count"``) keep a third
state per grammar: the (N, n, n) path-count matrix in the saturating
uint32 semiring, held in int32 storage (SAT = 2^32 - 1 reads -1), its
base tensor on the device, and a host mirror that, as for single-path,
receives only the rows a closure may have written.  ``extract_paths``
enumerates up to k paths of a pair over the relational state
(:class:`~repro_torch.core.semantics.DerivationIndex`).

Cache states reported per request:
  ``hit``   every requested row was already materialized;
  ``warm``  the masked closure ran, seeded from previous state;
  ``miss``  first closure for this (graph, grammar).

Graph edits committed through ``Graph.insert_edges`` / ``delete_edges``
(or ``QueryEngine.apply_delta``) advance the graph's version counter and
are ingested as *row-level repair* of the materialized states
(delta/repair.py) instead of dropping them; each ingested delta advances
the engine epoch (delta/txn.py).  Out-of-band edits (mutating
``graph.edges`` directly) are still caught by a per-batch edge-set
comparison — even when they coincide with logged edits — and drop every
materialized state, as does a log compacted past the engine's version.
Cached closure plans survive both paths: they depend only on the grammar
and padded size.

With ``EngineConfig(mesh=...)`` the ``opt`` closures shard their states
over a ``torch.distributed`` device mesh (core/closure.py, shard/plans.py):
a cached state is then a :class:`~repro_torch.shard.plans.ShardedState`,
each rank holding its block.  The engine runs SPMD: every rank builds it
with the same graph and grammar objects and makes the same calls in the
same order, so every rank issues the same collectives and gets the same
answer (the planner is deterministic in its features).  A sharded state
is gathered onto every rank (``localize_state``) before a one-device
closure or a repair uses it, and its host mirror receives only the rows
its closure may have written, gathered to every rank.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.blocksparse import (
    occupied_block_count,
    occupied_blocks_of_edges,
)
from repro_torch.core.conjunctive import ConjunctiveGrammar, ConjunctiveTables
from repro_torch.core.conjunctive import init_matrix as conj_init_matrix
from repro_torch.core.conjunctive import init_matrix_rows as conj_init_matrix_rows
from repro_torch.core.grammar import CNFGrammar
from repro_torch.core.graph import Graph
from repro_torch.core.matrices import (
    ProductionTables,
    init_matrix,
    init_matrix_rows,
    padded_size,
    resolve_device,
)
from repro_torch.core.semantics import (
    SAT_COUNT,
    DerivationIndex,
    PathExtractor,
    count_base,
    count_base_rows,
    count_entries,
    init_lengths,
)
from repro_torch.delta.repair import (
    DeltaStats,
    localize_state,
    placement_of,
    plan_repair,
    repair_single_path_state,
    repair_state,
)
from repro_torch.delta.txn import EpochClock, Snapshot
from repro_torch.obs.instruments import EngineMetrics
from repro_torch.obs.trace import NULL_TRACER, iteration_scope
from repro_torch.shard.plans import MeshPlan, ShardedState

from .config import EngineConfig
from .plan import (
    CompiledClosureCache,
    PlanKey,
    bucket_for,
    conj_engine_name,
    count_engine_name,
    mesh_key_of,
    repair_engine_name,
    sp_engine_name,
)
from .planner import PlanDecision, PlanFeatures, Planner
from .stats import QueryStats

def grammar_key(g: CNFGrammar | ConjunctiveGrammar):
    """Value identity of a grammar (CNFGrammar itself is mutable).

    Conjunctive grammars key under a distinct leading tag with their full
    conjunct structure, so a CNF grammar and a conjunctive one never
    collide."""
    if isinstance(g, ConjunctiveGrammar):
        return (
            "conjunctive",
            g.nonterms,
            tuple(sorted(g.term_prods)),
            g.conj_prods,
        )
    return (
        tuple(g.nonterms),
        tuple(sorted((x, tuple(v)) for x, v in g.term_prods.items())),
        tuple(g.binary_prods),
        frozenset(g.nullable),
    )


def numbering(g: CNFGrammar | ConjunctiveGrammar) -> tuple:
    """What the ranks of a mesh must agree on for ``g``: its nonterminals
    in plane order and its productions, in a form whose ``repr`` does not
    depend on the hash seed (sets and production order sorted)."""
    if isinstance(g, ConjunctiveGrammar):
        return grammar_key(g)  # tuples throughout
    return (
        tuple(g.nonterms),
        sorted((x, sorted(v)) for x, v in g.term_prods.items()),
        sorted(g.binary_prods),
        sorted(g.nullable),
    )


def _key_engine(semantics: str, engine: str, repair: bool = False) -> str:
    """The backend name a plan of ``semantics`` keys under (plan.py's
    aliasing: single-path, conjunctive and count plans collapse onto the
    closures that exist, a repair onto its repair closure)."""
    if semantics == "single_path":
        return sp_engine_name(engine, repair=repair)
    if semantics == "conjunctive":
        return conj_engine_name(engine)
    if semantics == "count":
        return count_engine_name(engine)
    return repair_engine_name(engine) if repair else engine


@dataclass(frozen=True)
class Query:
    """One CFPQ request.

    ``sources=None`` asks for the all-pairs relation; otherwise only pairs
    whose source is listed are computed/returned.  ``semantics`` is
    ``"relational"`` (pair set), ``"single_path"`` (one witness path per
    pair, paper Section 5), ``"conjunctive"`` (upper-approximate
    intersection relations, paper Section 7 — requires a
    :class:`~repro_torch.core.conjunctive.ConjunctiveGrammar`), or
    ``"count"`` (per-pair path counts in the saturating semiring,
    ``SAT_COUNT`` meaning "at least 2^32 - 1 paths" — requires a CNF
    grammar; results carry ``QueryResult.counts``).
    """

    grammar: CNFGrammar | ConjunctiveGrammar
    start: str
    sources: tuple[int, ...] | None = None
    semantics: str = "relational"


@dataclass
class QueryResult:
    query: Query
    pairs: set[tuple[int, int]]
    #: one witness path per pair (``semantics="single_path"`` only)
    paths: dict[tuple[int, int], list[tuple[int, str, int]]] | None
    stats: QueryStats
    #: per-pair path counts (``semantics="count"`` only): values are
    #: exact below ``SAT_COUNT``; the sentinel means "at least that many"
    counts: dict[tuple[int, int], int] | None = None


@dataclass
class _GrammarState:
    grammar: CNFGrammar
    tables: ProductionTables
    T: torch.Tensor | None = None  # (N, n, n) bool closure state, on device
    T_host: np.ndarray | None = None  # host copy for slicing
    mask: np.ndarray | None = None  # rows of T that are exact
    # single-path state beside the Boolean one: the (N, n, n) f32 length
    # matrix on the device, its host mirror and its own row mask
    sp_L: torch.Tensor | None = None
    sp_L_host: np.ndarray | None = None
    sp_mask: np.ndarray | None = None
    # count state beside the other two: the (N, n, n) int32-stored uint32
    # path counts on the device, its host mirror, its own row mask, and the
    # base tensor the Jacobi recompute re-adds (kept on the device)
    cnt_C: torch.Tensor | None = None
    cnt_C_host: np.ndarray | None = None
    cnt_mask: np.ndarray | None = None
    cnt_base: torch.Tensor | None = None
    extractor: PathExtractor | None = None  # edge/production index cache
    # packed all-path enumeration index over the Boolean state; dropped
    # whenever T_host changes (closure run or delta)
    deriv: DerivationIndex | None = None
    # witness memo keyed (start, i, j): valid until the next ingested delta
    # (warm closures only add entries, they never rewrite frozen ones)
    sp_paths: dict = field(default_factory=dict)
    # planner-visible state metadata: where each cached tensor lives
    # ("local" | "sharded" | "none") — kept current across queries AND
    # repairs (a repair localizes a sharded state) — and which backend last
    # served it
    placement: str = "none"
    sp_placement: str = "none"
    cnt_placement: str = "none"
    served_by: str = ""
    sp_served_by: str = ""
    cnt_served_by: str = ""


class QueryEngine:
    """Batched CFPQ query service over one graph."""

    def __init__(
        self,
        graph: Graph,
        *,
        config: EngineConfig | None = None,
        plans: CompiledClosureCache | None = None,
        tracer=None,
        metrics=None,
    ) -> None:
        config = config if config is not None else EngineConfig()
        self.graph = graph
        self.config = config
        self.device = resolve_device(config.device)
        # Device mesh of the sharded ("opt") closures, None for one device;
        # PlanKey carries its shape identity.  With a mesh each rank keeps
        # its states on its current device.
        self.mesh = config.mesh
        self._mesh_key = mesh_key_of(config.mesh)
        self._mesh_plan = None if self.mesh is None else MeshPlan.from_mesh(self.mesh)
        if self.mesh is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        #: configured engine name — ``"auto"`` means planner-routed; the
        #: backend that actually served a request is in its stats
        self.engine = config.engine
        self.plans = plans if plans is not None else CompiledClosureCache()
        self.row_capacity = config.row_capacity
        # the cost-based chooser; a pinned backend bypasses the cost model
        # (planner.decide(pin=...)) but still records decisions
        self.planner = Planner(config.resolved_profile())
        self._pin = None if config.engine == "auto" else config.engine
        self.n = padded_size(graph.n_nodes)
        self._states: dict[tuple, _GrammarState] = {}
        self._edge_set = frozenset(graph.edges)  # content served last
        self._n_nodes = graph.n_nodes
        self._version = graph.version
        self.clock = EpochClock(version=graph.version)
        self.delta_stats = DeltaStats()  # cumulative over the engine's life
        # cache and state mutation is not atomic, so query_batch/apply_delta
        # hold this across their whole body.  An RLock: apply_delta settles
        # pending edits through _check_graph while holding it.
        self._lock = threading.RLock()
        # Observability (repro_torch.obs): planner.decide / closure.execute
        # / delta.repair spans, and per-iteration events through
        # instrumented plan keys when the tracer wants them.  ``metrics`` is
        # a MetricsRegistry (the process default when None) fed
        # cache/closure/delta counters.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = EngineMetrics.on(metrics)

    def set_tracer(self, tracer) -> None:
        """Install a tracer after construction (the serving loop shares
        its tracer with the engine it drives)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def set_metrics(self, registry) -> None:
        """Re-point the engine's metric families at ``registry`` (the
        serving loop funnels engine counters into the registry its
        exposition endpoint serves)."""
        self.metrics = EngineMetrics.on(registry)

    # ------------------------------------------------------------------ #
    def query(self, q: Query, snapshot: Snapshot | None = None) -> QueryResult:
        return self.query_batch([q], snapshot=snapshot)[0]

    def query_batch(
        self,
        queries: list[Query],
        snapshot: Snapshot | None = None,
        stats_extra: dict | None = None,
    ) -> list[QueryResult]:
        """Serve a batch: one closure call per (grammar, semantics) group.

        ``snapshot`` (from :meth:`snapshot`) pins the epoch the caller
        expects to read; if a delta was committed since, the batch raises
        ``StaleSnapshotError``.  ``stats_extra`` entries are merged into
        every result's stats (the serving loop tags coalesced batches with
        it).  Results also carry ``batch_total`` (queries submitted
        together) and ``batch_groups`` (closure-call groups they were
        sliced into).
        """
        with self._lock:
            self._check_graph()
            self.clock.validate(snapshot)
            results: list[QueryResult | None] = [None] * len(queries)
            groups: dict[tuple, list[int]] = {}
            for qi, q in enumerate(queries):
                self.validate_query(q)
                groups.setdefault(
                    (grammar_key(q.grammar), q.semantics), []
                ).append(qi)
            for (gkey, semantics), qidx in groups.items():
                state = self._state_for(gkey, queries[qidx[0]].grammar)
                batch = [queries[i] for i in qidx]
                if semantics == "single_path":
                    outs = self._serve_single_path(state, batch)
                elif semantics == "count":
                    outs = self._serve_count(state, batch)
                else:  # relational and conjunctive share the bool-state path
                    outs = self._serve_relational(
                        state, batch, semantics=semantics
                    )
                for i, out in zip(qidx, outs):
                    results[i] = out
            for out in results:
                out.stats["batch_total"] = len(queries)  # type: ignore[union-attr]
                out.stats["batch_groups"] = len(groups)  # type: ignore[union-attr]
                if stats_extra:
                    out.stats.update(stats_extra)  # type: ignore[union-attr]
            return results  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    # Delta ingestion (serving layer of the delta subsystem).
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Snapshot:
        """Pin the current epoch for cross-batch read consistency."""
        with self._lock:
            return self.clock.snapshot()

    def apply_delta(
        self,
        insert: list[tuple[int, str, int]] = (),
        delete: list[tuple[int, str, int]] = (),
    ) -> DeltaStats:
        """Commit edge edits and repair materialized closures in place.

        Deletions are applied first, then insertions; both are folded into
        one repair pass.  Returns this delta's repair stats (the engine
        also accumulates them into every result's stats).
        """
        with self._lock:
            self._check_graph()  # settle pending/out-of-band edits first
            if delete:
                self.graph.delete_edges(list(delete))
            if insert:
                self.graph.insert_edges(list(insert))
            if self.graph.version == self._version:
                return DeltaStats()  # edits were all no-ops
            return self._ingest_delta()

    def _ingest_delta(self, delta=None) -> DeltaStats:
        """Fold the graph's edge log since the last-served version into
        row-level repair of every cached grammar state."""
        g = self.graph
        if delta is None:
            delta = g.delta_since(self._version)
        stats = DeltaStats()
        if delta:
            # context-managed so the repair fixpoints nest under this span
            with self.tracer.span(
                "delta.repair",
                cat="engine",
                inserted=len(delta.inserted),
                deleted=len(delta.deleted),
            ) as dsp:
                plan = plan_repair(g, delta, self.n)
                for state in self._states.values():
                    state.extractor = None  # edge indices are stale
                    state.deriv = None  # packed closure index too
                    state.sp_paths.clear()  # memoized witnesses may walk them

                    if isinstance(state.tables, ConjunctiveTables):
                        # conjunctive states have their own delta contract:
                        # insert-only = warm re-seed, any delete = full drop
                        self._repair_conjunctive(state, plan, delta, stats)
                        continue

                    def base_rows(idx, grammar=state.grammar):
                        return init_matrix_rows(g, grammar, idx, pad_to=self.n)

                    if state.T is not None and state.mask is not None:

                        def run(T_dev, seed, frozen, st=state):
                            d = self._decide(
                                st, seed, seed, "relational", "warm",
                                repair=True,
                            )
                            st.served_by = d.engine
                            return self._run_fixpoint(
                                st.tables, T_dev, seed, frozen=frozen,
                                decision=d,
                            )[:3]  # repair never falls back; drop the event

                        T_host, T_dev, mask_new, st = repair_state(
                            state.T_host, state.T, state.mask, plan,
                            base_rows, run, tracer=self.tracer,
                        )
                        state.T, state.T_host = T_dev, T_host
                        state.mask = mask_new
                        state.placement = placement_of(T_dev)
                        stats.merge(st)
                    if state.sp_L is not None and state.sp_mask is not None:
                        # insertions warm-start the min-plus row repair
                        # (frozen rows bit-identical); deletions evict the
                        # affected rows to base lengths

                        def run_sp(L_dev, seed, frozen, st=state):
                            d = self._decide(
                                st, seed, seed, "single_path", "warm",
                                repair=True,
                            )
                            st.sp_served_by = d.engine
                            return self._run_fixpoint(
                                st.tables, L_dev, seed, frozen=frozen,
                                semantics="single_path", decision=d,
                            )[:3]

                        L_host, L_dev, sp_mask, st = repair_single_path_state(
                            state.sp_L_host, state.sp_L, state.sp_mask, plan,
                            base_rows, run_sp, tracer=self.tracer,
                        )
                        state.sp_L, state.sp_L_host = L_dev, L_host
                        state.sp_mask = sp_mask
                        state.sp_placement = placement_of(L_dev)
                        stats.merge(st)
                    if state.cnt_C is not None and state.cnt_mask is not None:
                        # count states: insert-only = recount the affected
                        # rows from the new base, any delete = full drop
                        self._repair_count(state, plan, delta, stats)
                dsp.set(**stats.as_dict())
            self.metrics.observe_delta(stats)
        self._version = g.version
        self._edge_set = frozenset(g.edges)
        self.delta_stats.merge(stats)
        self.clock.advance(g.version)
        self.metrics.delta_epoch.set(self.clock.epoch)
        return stats

    def _repair_conjunctive(
        self, state: _GrammarState, plan, delta, stats: DeltaStats
    ) -> None:
        """Apply one delta to a cached conjunctive state.

        **Any deletion drops the whole state.**  Under AND a frozen row is
        no trustworthy context: removing one conjunct's support can retract
        entries in rows the reverse-reachability blast radius never touches
        through the other conjuncts, so no frozen set short of everything
        is sound.

        **Insert-only deltas repair by warm re-seed.**  Inserts only grow
        the fixpoint (AND of monotone products is monotone), so the cached
        state is a valid warm start: OR the new base edges into the
        inserted sources' rows, then re-enter the masked conjunctive
        closure seeded with the affected rows and the sources."""
        if state.T is None or state.mask is None:
            return
        if delta.deleted:
            stats.rows_evicted += int(state.mask.sum())
            stats.conj_drops += 1
            state.T = state.T_host = state.mask = None
            state.placement = "none"
            state.served_by = ""
            return
        mask = state.mask.copy()
        T_dev = localize_state(state.T)
        if plan.ins_sources.any():
            # base-row surgery on a copy: entries only grow on this path
            idx = np.nonzero(plan.ins_sources)[0]
            base = conj_init_matrix_rows(self.graph, state.grammar, idx, pad_to=self.n)
            tidx = torch.from_numpy(idx).to(self.device)
            T_dev = T_dev.clone()
            T_dev[:, tidx, :] |= torch.from_numpy(base).to(self.device)
        seed = (plan.affected & mask) | plan.ins_sources
        if seed.any():
            d = self._decide(state, seed, seed, "conjunctive", "warm")
            state.served_by = d.engine
            T_dev, M, calls, _ = self._run_fixpoint(
                state.tables, T_dev, seed, semantics="conjunctive", decision=d,
            )
            mask |= M
            stats.rows_repaired += int(M.sum())
            stats.repair_iters += calls
            stats.conj_repairs += 1
        state.T, state.T_host, state.mask = T_dev, T_dev.cpu().numpy(), mask
        state.placement = placement_of(T_dev)

    def _repair_count(
        self, state: _GrammarState, plan, delta, stats: DeltaStats
    ) -> None:
        """Apply one delta to a cached count state.

        **Any deletion drops the whole state.**  The saturating semiring
        has no subtractive inverse (a saturated entry forgets how much of
        it the deleted edge carried), so nothing sound is left to freeze.

        **Insert-only deltas recount the affected rows.**  A count row is a
        sum, not a set, so folding new base entries into accumulated counts
        would double-count.  The base tensor is rebuilt, every affected
        cached row is reset to its new base row, and the masked count
        closure re-enters seeded with those rows; unaffected mask rows
        cannot reach an inserted edge, so their counts are unchanged and
        they re-enter as exact, Jacobi-stable context.  The host mirror
        takes the rows under the closure's mask."""
        if delta.deleted:
            stats.rows_evicted += int(state.cnt_mask.sum())
            stats.count_drops += 1
            state.cnt_C = state.cnt_C_host = state.cnt_mask = None
            state.cnt_base = None
            state.cnt_placement = "none"
            state.cnt_served_by = ""
            return
        mask = state.cnt_mask.copy()
        state.cnt_base = None  # free the old base before the new one is made
        state.cnt_base = count_base(
            self.graph, state.grammar, pad_to=self.n, device=self.device
        )
        C_dev = localize_state(state.cnt_C)
        reset = (plan.affected & mask) | plan.ins_sources
        if reset.any():
            idx = np.nonzero(reset)[0]
            rows = count_base_rows(
                self.graph, state.grammar, idx, pad_to=self.n, device=self.device
            )
            C_dev = C_dev.clone()
            C_dev[:, torch.from_numpy(idx).to(self.device), :] = rows
            d = self._decide(state, reset, reset, "count", "warm")
            state.cnt_served_by = d.engine
            C_dev, M, calls, _ = self._run_fixpoint(
                state.tables, C_dev, reset, semantics="count", decision=d,
                cnt_base=state.cnt_base,
            )
            mask |= M
            state.cnt_C_host = self._mirror_rows(state, C_dev, M, "count")
            stats.rows_repaired += int(M.sum())
            stats.repair_iters += calls
            stats.count_repairs += 1
        state.cnt_C = C_dev
        state.cnt_mask = mask
        state.cnt_placement = placement_of(C_dev)

    # ------------------------------------------------------------------ #
    def _check_graph(self) -> None:
        """Reconcile with the graph: logged edits repair row-wise; any edit
        the log cannot account for (``graph.edges`` touched directly) drops
        every materialized state.  The repair path is taken only when the
        current edge set is exactly the last-served set transformed by the
        log — an out-of-band edit concurrent with logged edits therefore
        still forces full invalidation instead of being masked."""
        g = self.graph
        actual = frozenset(g.edges)
        if g.version != self._version:
            try:
                delta = g.delta_since(self._version)
            except ValueError:
                # Log compacted past our version: the edit set is unknowable.
                # If the content still equals what we served (the compacted
                # tail was a net no-op), just resync the version; otherwise
                # fall through to full invalidation below.
                delta = None
                if g.n_nodes == self._n_nodes and actual == self._edge_set:
                    self._version = g.version
                    return
            if delta is not None:
                expected = (
                    self._edge_set | set(delta.inserted)
                ) - set(delta.deleted)
                if g.n_nodes == self._n_nodes and actual == expected:
                    self._ingest_delta(delta)
                    return
        if actual != self._edge_set or g.n_nodes != self._n_nodes:
            self._states.clear()  # out-of-band edit: full invalidation
            self._edge_set = actual
            self._n_nodes = g.n_nodes
            self._version = g.version
            self.n = padded_size(g.n_nodes)
            self.clock.advance(g.version)

    def _state_for(self, gkey: tuple, g) -> _GrammarState:
        state = self._states.get(gkey)
        if state is None:
            if self._mesh_plan is not None:
                # each rank builds its own grammar, and CNF conversion can
                # number nonterminals differently under another hash seed:
                # sharded planes of different nonterminals would mix
                # silently, so the ranks must agree before any closure
                self._mesh_plan.check_same("grammar's numbering", numbering(g))
            tables = (
                ConjunctiveTables.from_grammar(g)
                if isinstance(g, ConjunctiveGrammar)
                else ProductionTables.from_grammar(g)
            )
            state = _GrammarState(g, tables)
            self._states[gkey] = state
        return state

    def validate_query(self, q: Query) -> None:
        """Raise ``ValueError`` for a malformed query.  ``query_batch``
        validates every member; the serving loop calls this per query at
        admission, so one bad request fails its own caller instead of the
        whole coalesced batch."""
        if q.semantics not in (
            "relational", "single_path", "conjunctive", "count"
        ):
            raise ValueError(f"unknown semantics {q.semantics!r}")
        conj_grammar = isinstance(q.grammar, ConjunctiveGrammar)
        if conj_grammar != (q.semantics == "conjunctive"):
            raise ValueError(
                f"semantics {q.semantics!r} does not match grammar type "
                f"{type(q.grammar).__name__} (ConjunctiveGrammar queries "
                'must use semantics="conjunctive" and vice versa)'
            )
        for m in q.sources or ():
            if not 0 <= m < self.graph.n_nodes:
                raise ValueError(f"source {m} outside graph")

    # ------------------------------------------------------------------ #
    def _need_mask(self, batch: list[Query]) -> np.ndarray | None:
        """Union of requested source rows; None means all-pairs."""
        need = np.zeros(self.n, dtype=bool)
        for q in batch:
            if q.sources is None:
                return None
            need[list(q.sources)] = True
        return need

    def _decide(
        self,
        state: _GrammarState,
        seed: np.ndarray,
        new: np.ndarray,
        semantics: str,
        cache: str,
        repair: bool = False,
    ) -> PlanDecision:
        """Build the planner features for one closure call and decide.

        Every feature is something the engine already has on hand: the
        seed mask, how many of its rows are new, graph density, grammar
        size, the cached state's temperature and placement, the base
        graph's occupied blocks, and the mesh's rank count
        (``mesh_devices``, 0 without a mesh).  As in the reference, ``opt``
        is a candidate only on a mesh of more than one rank (a query, not
        a repair); blocksparse only when the graph is large enough for
        block skipping."""
        placement = {
            "single_path": state.sp_placement, "count": state.cnt_placement,
        }.get(semantics, state.placement)
        tables = state.tables
        f = PlanFeatures(
            n=self.n,
            seed_rows=int(seed.sum()),
            new_rows=int(new.sum()),
            density=len(self.graph.edges) / max(self.graph.n_nodes, 1),
            n_prods=max(tables.n_prods, 1),
            n_nonterms=tables.n_nonterms,
            semantics=semantics,
            repair=repair,
            cache=cache,
            placement=placement,
            mesh_devices=self.mesh.size() if self.mesh is not None else 0,
            # label-blind base-graph occupancy (O(E) host count) prices the
            # blocksparse candidate; the padded n is always a multiple of
            # every legal tile, so eligibility only needs the count itself
            occupied_blocks=occupied_blocks_of_edges(
                self.n, self.graph.edges, self.config.tile
            ),
            tile=self.config.tile,
            conjuncts=getattr(tables, "n_conjuncts", 0),
        )
        return self.planner.decide(
            f, pin=self._pin, min_capacity=self.row_capacity
        )

    def _run_fixpoint(
        self,
        tables: ProductionTables,
        T: torch.Tensor,
        seed: np.ndarray,
        decision: PlanDecision,
        frozen: np.ndarray | None = None,
        semantics: str = "relational",
        cnt_base: torch.Tensor | None = None,
    ):
        """Run the masked closure to completion from ``seed`` rows, growing
        the capacity bucket on overflow (monotone warm restarts, so no work
        is lost).  With ``frozen`` (delta repair) the run uses the repair
        variant: frozen rows are contracted against but never recomputed,
        so capacity tracks the edit's blast radius, not the cache size.
        ``semantics="single_path"`` runs the length-annotated closures on
        the f32 state instead (same signatures, same bucket ladder);
        ``"conjunctive"`` the conjunctive closures on the Boolean state, and
        ``"count"`` the count closure on the count state, which also takes
        the base tensor ``cnt_base``.

        ``decision`` names the backend the planner picked; every capacity
        overflow is a fallback observation point — when
        :meth:`Planner.should_fallback` fires, the *remaining* closure is
        re-dispatched onto the decision's fallback backend at full
        capacity through the same warm restart.  At most one fallback per
        run; pinned decisions and repairs never fall back.

        With a mesh only the non-repair ``opt`` plans are sharded (they
        carry the mesh identity, and shard a whole tensor themselves);
        every other closure gets a sharded state gathered onto this rank's
        device first (:func:`repro_torch.delta.repair.localize_state`).

        Returns ``(T_device, M_host, n_calls, fallback_event)``."""
        mask = np.asarray(seed)
        repair = frozen is not None
        eng_name = _key_engine(semantics, decision.engine, repair)
        mesh_k = self._mesh_key if (not repair and eng_name == "opt") else ()
        T = T if mesh_k else localize_state(T)
        cap = bucket_for(max(decision.row_capacity, int(mask.sum())), self.n)
        n_frozen = cap_c = 0
        if repair:
            frozen_dev = torch.from_numpy(np.asarray(frozen)).to(self.device)
            n_frozen = int(np.asarray(frozen).sum())
            if semantics == "single_path" or eng_name not in (
                "bitpacked", "blocksparse"
            ):
                # dense/frontier (and every single-path) repair compacts the
                # contraction axis over active + frozen rows; the packed and
                # block-sparse repairs contract full packed words instead
                cap_c = bucket_for(max(cap, int(mask.sum()) + n_frozen), self.n)
        calls = 0
        fallback_event: dict | None = None
        tracer = self.tracer
        with tracer.span(
            "closure.execute",
            cat="engine",
            engine=eng_name,
            semantics=semantics,
            repair=repair,
            seed_rows=int(mask.sum()),
        ) as csp:
            while True:
                # the opt closures take no hook (every rank would fire it)
                instrumented = tracer.wants_iterations and eng_name != "opt"
                misses_before = self.plans.stats.compile_misses
                exe = self.plans.get(
                    PlanKey(
                        tables, eng_name, self.n, cap, repair=repair,
                        ctx_capacity=cap_c, semantics=semantics, mesh=mesh_k,
                        instrumented=instrumented,
                        tile=self.config.tile if eng_name == "blocksparse" else 0,
                    ),
                    mesh=self.mesh,
                    provenance="pinned" if decision.pinned else "planned",
                )
                self.metrics.observe_cache(
                    hit=self.plans.stats.compile_misses == misses_before
                )
                with iteration_scope(
                    tracer.iteration_sink(csp) if instrumented else None
                ):
                    src = torch.from_numpy(mask).to(self.device)
                    if repair:
                        T, M, overflow = exe(T, src, frozen_dev)
                    elif semantics == "count":  # the Jacobi re-adds the base
                        T, M, overflow = exe(T, cnt_base, src)
                    else:
                        T, M, overflow = exe(T, src)
                    calls += 1
                mask = M.cpu().numpy()
                if not overflow:
                    break
                grown = int(mask.sum())
                if fallback_event is None:
                    trigger = self.planner.should_fallback(
                        decision, grown, self.n, calls
                    )
                    if trigger is not None:
                        fb = decision.fallback_engine
                        fallback_event = {
                            "from": eng_name,
                            "to": fb,
                            "trigger": trigger,
                            "at_call": calls,
                            "active_rows": grown,
                        }
                        csp.add_event(
                            "planner.fallback", tracer.clock(), **fallback_event
                        )
                        eng_name = _key_engine(semantics, fb)
                        mesh_k = self._mesh_key if eng_name == "opt" else ()
                        T = T if mesh_k else localize_state(T)
                        cap = self.n
                        self.planner.note_fallback()
                        continue
                # overflow means the active set outgrew cap or (repair) the
                # context outgrew cap_c, so at least one bucket grows.
                # Blocksparse overflows on *occupied blocks*, which the
                # mask's row count need not exceed — double unconditionally
                # so the ladder always terminates (capacity >= n is unbounded)
                if eng_name == "blocksparse":
                    cap = bucket_for(max(2 * cap, grown), self.n)
                else:
                    cap = bucket_for(max(cap, grown), self.n)
                if cap_c:
                    cap_c = bucket_for(max(cap_c, grown + n_frozen), self.n)
                csp.add_event(
                    "warm_restart",
                    tracer.clock(),
                    capacity=cap,
                    active_rows=grown,
                    at_call=calls,
                )
            csp.set(calls=calls, active_rows=int(mask.sum()))
        self.metrics.observe_closure(eng_name, calls)
        return T, mask, calls, fallback_event

    def _ensure_rows(
        self,
        state: _GrammarState,
        batch: list[Query],
        semantics: str = "relational",
    ) -> tuple[str, PlanDecision | None, dict | None]:
        """Materialize closure rows covering the batch (the Boolean state,
        the f32 length state and its host mirror for
        ``semantics="single_path"``, or the count state and its host mirror
        for ``semantics="count"``); returns ``(cache_status, decision,
        fallback_event)`` — the latter two are None on a pure cache hit
        (no closure ran, nothing was planned)."""
        single_path = semantics == "single_path"
        count = semantics == "count"
        need = self._need_mask(batch)
        if need is None:
            need = np.ones(self.n, dtype=bool)
            need[self.graph.n_nodes :] = False  # padding rows are empty
        if single_path:
            mask, cur = state.sp_mask, state.sp_L
        elif count:
            mask, cur = state.cnt_mask, state.cnt_C
        else:
            mask, cur = state.mask, state.T
        if mask is not None and (need <= mask).all():
            return "hit", None, None
        status = "miss" if cur is None else "warm"
        if cur is None:
            make = init_matrix
            if single_path:
                make = init_lengths
            elif semantics == "conjunctive":
                make = conj_init_matrix
            elif count:
                make = count_base
            cur = make(self.graph, state.grammar, pad_to=self.n, device=self.device)
            if count:
                state.cnt_base = cur  # the closure copies it; never written
            mask = np.zeros(self.n, dtype=bool)
        with self.tracer.span(
            "planner.decide", cat="engine", semantics=semantics, cache=status
        ) as psp:
            decision = self._decide(
                state, mask | need, need & ~mask, semantics, status
            )
            psp.set(route=decision.label, pinned=decision.pinned)
        out, M, _, fb = self._run_fixpoint(
            state.tables, cur, mask | need, decision=decision,
            semantics=semantics, cnt_base=state.cnt_base if count else None,
        )
        served = fb["to"] if fb else decision.engine
        if single_path:
            state.sp_L_host = self._mirror_rows(state, out, M & ~mask)
            state.sp_L, state.sp_mask = out, M
            state.sp_placement = placement_of(out)
            state.sp_served_by = served
        elif count:
            state.cnt_C_host = self._mirror_rows(state, out, M & ~mask, "count")
            state.cnt_C, state.cnt_mask = out, M
            state.cnt_placement = placement_of(out)
            state.cnt_served_by = served
        else:
            if isinstance(out, ShardedState):  # never the whole sharded state
                state.T_host = self._mirror_rows(state, out, M & ~mask, "relational")
            else:
                state.T_host = out.cpu().numpy()
            state.T, state.mask = out, M
            state.placement = placement_of(out)
            state.served_by = served
            state.deriv = None  # the packed index is a view of the old T_host
            if served == "blocksparse":  # counted on the device state
                self.metrics.observe_blocksparse(
                    occupied_block_count(out, self.config.tile)
                )
        return status, decision, fb

    def _mirror_rows(
        self,
        state: _GrammarState,
        L: torch.Tensor,
        rows: np.ndarray,
        semantics: str = "single_path",
    ) -> np.ndarray:
        """The host mirror of the length state ``L`` (with
        ``semantics="count"`` of the count state, with ``"relational"`` of
        the Boolean state) after a closure that may have written only
        ``rows``.  A first closure starts the mirror from the base lengths,
        counts or matrix, made on the host as the device state was.  ``L``
        may be a :class:`~repro_torch.shard.plans.ShardedState`: its rows
        are gathered to every rank."""
        count, relational = semantics == "count", semantics == "relational"
        host = {"count": state.cnt_C_host, "relational": state.T_host}.get(
            semantics, state.sp_L_host
        )
        N, n, _ = L.shape
        itemsize = 1 if relational else 4
        if host is None:
            with self.tracer.span(
                "state.mirror_init", cat="engine", bytes=itemsize * N * n * n
            ):
                if count:  # zeros stay lazy: only the base entries are touched
                    host = np.zeros(tuple(L.shape), dtype=np.int32)
                    np.add.at(host, count_entries(self.graph, state.grammar), 1)
                elif relational:
                    host = init_matrix(
                        self.graph, state.grammar, pad_to=self.n, device="cpu"
                    ).numpy()
                else:
                    host = init_lengths(
                        self.graph, state.grammar, pad_to=self.n, device="cpu"
                    ).numpy()
        idx = np.nonzero(rows)[0]
        with self.tracer.span(
            "closure.host_copy", cat="engine", rows=len(idx),
            bytes=itemsize * N * len(idx) * n,
        ):
            tidx = torch.from_numpy(idx).to(L.device)
            got = L.rows(tidx) if isinstance(L, ShardedState) else L[:, tidx, :]
            host[:, idx, :] = got.cpu().numpy()
        return host

    def _serve_relational(
        self,
        state: _GrammarState,
        batch: list[Query],
        semantics: str = "relational",
    ) -> list[QueryResult]:
        """Serve a bool-state batch: materialize, then slice rows — the
        relational path, and (``semantics="conjunctive"``) the conjunctive
        one, over the conjunctive closures (plan.CONJ_ENGINES)."""
        t0 = time.perf_counter()
        status, decision, fb = self._ensure_rows(state, batch, semantics=semantics)
        latency = time.perf_counter() - t0
        nn = self.graph.n_nodes
        T = state.T_host
        stats = QueryStats(
            latency_s=latency,
            cache=status,
            # the backend that materialized the served rows — on a cache
            # hit that is whoever ran last, not whoever would run next
            engine=state.served_by or self.engine,
            semantics=semantics,
            batched_with=len(batch),
            active_rows=int(state.mask.sum()),
            epoch=self.clock.epoch,
            planner=decision.to_dict() if decision is not None else None,
            fallback=fb,
        )
        stats.update(self.plans.stats.as_dict())
        stats.update(self.delta_stats.as_dict())
        outs = []
        for q in batch:
            a0 = state.grammar.index_of(q.start)
            rows = range(nn) if q.sources is None else q.sources
            pairs: set[tuple[int, int]] = set()
            for i in rows:
                pairs.update((i, int(j)) for j in np.nonzero(T[a0, i, :nn])[0])
            if q.start in state.grammar.nullable:
                pairs |= {(m, m) for m in rows}  # empty path m pi m
            outs.append(QueryResult(q, pairs, None, stats.copy()))
        return outs

    def _serve_single_path(
        self, state: _GrammarState, batch: list[Query]
    ) -> list[QueryResult]:
        """Serve a single-path batch: materialize length rows, then slice
        pairs and extract one witness per pair from the host mirror."""
        t0 = time.perf_counter()
        status, decision, fb = self._ensure_rows(
            state, batch, semantics="single_path"
        )
        L = state.sp_L_host
        if state.extractor is None:  # invalidated on every ingested delta
            state.extractor = PathExtractor(self.graph, state.grammar)
        extractor = state.extractor
        nn = self.graph.n_nodes
        # state-scoped memo: repeated/overlapping sources — within a batch
        # or across batches — extract each witness once per delta epoch;
        # results get copies so callers can't alias it
        memo = state.sp_paths
        sliced = []
        with self.tracer.span(
            "witness.extract", cat="engine", queries=len(batch)
        ) as wsp:
            extracted = 0
            for q in batch:
                a0 = state.grammar.index_of(q.start)
                rows = range(nn) if q.sources is None else q.sources
                pairs: set[tuple[int, int]] = set()
                paths: dict[tuple[int, int], list[tuple[int, str, int]]] = {}
                for i in rows:
                    for j in np.nonzero(np.isfinite(L[a0, i, :nn]))[0]:
                        pairs.add((i, int(j)))
                        key = (q.start, i, int(j))
                        path = memo.get(key)
                        if path is None:
                            path = memo[key] = extractor.extract(
                                L, q.start, i, int(j)
                            )
                            extracted += 1
                        paths[(i, int(j))] = list(path)
                if q.start in state.grammar.nullable:
                    for m in rows:  # empty path m pi m, as in the relational path
                        if (m, m) not in pairs:
                            pairs.add((m, m))
                            paths[(m, m)] = []
                sliced.append((q, pairs, paths))
            wsp.set(extracted=extracted)
        # latency includes witness extraction — the dominant per-request
        # host cost on hot serves — not just the closure work
        latency = time.perf_counter() - t0
        stats = QueryStats(
            latency_s=latency,
            cache=status,
            engine=state.sp_served_by or self.engine,
            semantics="single_path",
            batched_with=len(batch),
            active_rows=int(state.sp_mask.sum()),
            epoch=self.clock.epoch,
            planner=decision.to_dict() if decision is not None else None,
            fallback=fb,
        )
        stats.update(self.delta_stats.as_dict())
        stats.update(self.plans.stats.as_dict())
        return [
            QueryResult(q, pairs, paths, stats.copy())
            for q, pairs, paths in sliced
        ]

    def _serve_count(
        self, state: _GrammarState, batch: list[Query]
    ) -> list[QueryResult]:
        """Serve a count batch: the same caching and slicing over the count
        state's host mirror (plan.COUNT_ENGINES underneath).  Counts are
        exact below ``SAT_COUNT``; the sentinel means "at least that many
        paths"."""
        t0 = time.perf_counter()
        status, decision, fb = self._ensure_rows(state, batch, semantics="count")
        latency = time.perf_counter() - t0
        nn = self.graph.n_nodes
        C = state.cnt_C_host.view(np.uint32)
        active = int(state.cnt_mask.sum())
        self.metrics.observe_count_state(active)
        stats = QueryStats(
            latency_s=latency,
            cache=status,
            engine=state.cnt_served_by or self.engine,
            semantics="count",
            batched_with=len(batch),
            active_rows=active,
            epoch=self.clock.epoch,
            planner=decision.to_dict() if decision is not None else None,
            fallback=fb,
        )
        stats.update(self.delta_stats.as_dict())
        stats.update(self.plans.stats.as_dict())
        sat = int(SAT_COUNT)
        outs = []
        for q in batch:
            a0 = state.grammar.index_of(q.start)
            rows = range(nn) if q.sources is None else q.sources
            pairs: set[tuple[int, int]] = set()
            counts: dict[tuple[int, int], int] = {}
            for i in rows:
                row = C[a0, i, :nn]
                for j in np.nonzero(row)[0]:
                    pairs.add((i, int(j)))
                    counts[(i, int(j))] = int(row[j])
            if q.start in state.grammar.nullable:
                for m in rows:  # the empty path m pi m is one more path
                    c = counts.get((m, m), 0)
                    counts[(m, m)] = c + 1 if c < sat else sat
                    pairs.add((m, m))
            outs.append(QueryResult(q, pairs, None, stats.copy(), counts=counts))
        return outs

    def extract_paths(
        self,
        grammar: CNFGrammar,
        start: str,
        m: int,
        n: int,
        k: int = 10,
        max_len: int = 16,
    ) -> list[list[tuple[int, str, int]]]:
        """Up to ``k`` distinct paths ``m ->* n`` derivable from ``start``,
        each of length <= ``max_len`` (bounded all-path enumeration,
        :class:`~repro_torch.core.semantics.DerivationIndex`).

        Materializes Boolean closure rows for source ``m`` through the
        relational cache, then enumerates over the packed derivation index,
        which is cached on the grammar state and rebuilt only when the
        closure state changes (new rows, or an ingested delta)."""
        with self._lock:
            self._check_graph()
            q = Query(grammar, start, sources=(m,))
            self.validate_query(q)
            if not 0 <= n < self.graph.n_nodes:
                raise ValueError(f"target {n} outside graph")
            state = self._state_for(grammar_key(grammar), grammar)
            self._ensure_rows(state, [q])
            if state.deriv is None:
                state.deriv = DerivationIndex(state.T_host, self.graph, grammar)
            return state.deriv.extract_paths(start, m, n, k, max_len)
