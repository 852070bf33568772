"""Batched single-/multi-source CFPQ serving — the port's relational slice
of ``repro.engine.service``.

``QueryEngine`` is bound to one graph and serves relational queries over
any number of grammars.  A batch is coalesced per grammar: the union of all
requested source rows is computed in ONE masked-closure call (see
core/closure.py), then each request slices its rows out.  Per grammar the
engine keeps a *materialized* closure state ``(T, mask)`` on its device —
rows listed in ``mask`` are already exact — so repeated or overlapping
queries against an unchanged graph are pure row slices, and new sources
warm-start the monotone fixpoint from the cached state.

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
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.grammar import CNFGrammar
from repro_torch.core.graph import Graph
from repro_torch.core.matrices import (
    ProductionTables,
    init_matrix,
    init_matrix_rows,
    padded_size,
    resolve_device,
)
from repro_torch.delta.repair import (
    DeltaStats,
    placement_of,
    plan_repair,
    repair_state,
)
from repro_torch.delta.txn import EpochClock, Snapshot
from repro_torch.obs.instruments import EngineMetrics
from repro_torch.obs.trace import NULL_TRACER, iteration_scope

from .config import EngineConfig
from .plan import CompiledClosureCache, PlanKey, bucket_for, repair_engine_name
from .planner import PlanDecision, PlanFeatures, Planner
from .stats import QueryStats

#: semantics of the reference engine that this port does not serve yet,
#: and the ROADMAP.md item ("Modules to port") that will port each
_NOT_PORTED = {
    "single_path": "item 6, single-path semantics",
    "conjunctive": "item 8, conjunctive",
    "count": "item 9, count and all-paths",
}


def grammar_key(g: CNFGrammar):
    """Value identity of a grammar (CNFGrammar itself is mutable)."""
    return (
        tuple(g.nonterms),
        tuple(sorted((x, tuple(v)) for x, v in g.term_prods.items())),
        tuple(g.binary_prods),
        frozenset(g.nullable),
    )


@dataclass(frozen=True)
class Query:
    """One CFPQ request.

    ``sources=None`` asks for the all-pairs relation; otherwise only pairs
    whose source is listed are computed/returned.  Only
    ``semantics="relational"`` (the pair set) is served by the port.
    """

    grammar: CNFGrammar
    start: str
    sources: tuple[int, ...] | None = None
    semantics: str = "relational"


@dataclass
class QueryResult:
    query: Query
    pairs: set[tuple[int, int]]
    stats: QueryStats


@dataclass
class _GrammarState:
    grammar: CNFGrammar
    tables: ProductionTables
    T: torch.Tensor | None = None  # (N, n, n) bool closure state, on device
    T_host: np.ndarray | None = None  # host copy for slicing
    mask: np.ndarray | None = None  # rows of T that are exact
    # planner-visible state metadata: where the cached tensor lives
    # ("local" | "none") and which backend last served it
    placement: str = "none"
    served_by: str = ""


class QueryEngine:
    """Batched relational CFPQ query service over one graph."""

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

    # ------------------------------------------------------------------ #
    def query(self, q: Query, snapshot: Snapshot | None = None) -> QueryResult:
        return self.query_batch([q], snapshot=snapshot)[0]

    def query_batch(
        self, queries: list[Query], snapshot: Snapshot | None = None
    ) -> list[QueryResult]:
        """Serve a batch: one closure call per grammar group.

        ``snapshot`` (from :meth:`snapshot`) pins the epoch the caller
        expects to read; if a delta was committed since, the batch raises
        ``StaleSnapshotError``.  Results also carry ``batch_total``
        (queries submitted together) and ``batch_groups`` (closure-call
        groups they were sliced into).
        """
        with self._lock:
            self._check_graph()
            self.clock.validate(snapshot)
            results: list[QueryResult | None] = [None] * len(queries)
            groups: dict[tuple, list[int]] = {}
            for qi, q in enumerate(queries):
                self.validate_query(q)
                groups.setdefault(grammar_key(q.grammar), []).append(qi)
            for gkey, qidx in groups.items():
                state = self._state_for(gkey, queries[qidx[0]].grammar)
                outs = self._serve_relational(state, [queries[i] for i in qidx])
                for i, out in zip(qidx, outs):
                    results[i] = out
            for out in results:
                out.stats["batch_total"] = len(queries)  # type: ignore[union-attr]
                out.stats["batch_groups"] = len(groups)  # type: ignore[union-attr]
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
                    if state.T is None or state.mask is None:
                        continue

                    def base_rows(idx, grammar=state.grammar):
                        return init_matrix_rows(g, grammar, idx, pad_to=self.n)

                    def run(T_dev, seed, frozen, st=state):
                        d = self._decide(st, seed, seed, "warm", repair=True)
                        st.served_by = d.engine
                        return self._run_fixpoint(
                            st.tables, T_dev, seed, frozen=frozen, decision=d
                        )[:3]  # repair never falls back; drop the event

                    T_host, T_dev, mask_new, st = repair_state(
                        state.T_host, state.T, state.mask, plan, base_rows,
                        run, tracer=self.tracer,
                    )
                    state.T, state.T_host, state.mask = T_dev, T_host, mask_new
                    state.placement = placement_of(T_dev)
                    stats.merge(st)
                dsp.set(**stats.as_dict())
            self.metrics.observe_delta(stats)
        self._version = g.version
        self._edge_set = frozenset(g.edges)
        self.delta_stats.merge(stats)
        self.clock.advance(g.version)
        self.metrics.delta_epoch.set(self.clock.epoch)
        return stats

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

    def _state_for(self, gkey: tuple, g: CNFGrammar) -> _GrammarState:
        state = self._states.get(gkey)
        if state is None:
            state = _GrammarState(g, ProductionTables.from_grammar(g))
            self._states[gkey] = state
        return state

    def validate_query(self, q: Query) -> None:
        """Raise ``ValueError`` for a malformed or not-yet-ported query."""
        if q.semantics in _NOT_PORTED:
            raise ValueError(
                f"semantics {q.semantics!r} is not ported to the torch engine "
                f"yet (ROADMAP.md, modules to port, {_NOT_PORTED[q.semantics]})"
            )
        if q.semantics != "relational":
            raise ValueError(f"unknown semantics {q.semantics!r}")
        if not isinstance(q.grammar, CNFGrammar):
            raise ValueError(
                f"relational queries need a CNFGrammar, got "
                f"{type(q.grammar).__name__}"
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
        cache: str,
        repair: bool = False,
    ) -> PlanDecision:
        """Build the planner features for one closure call and decide.  The
        port has no mesh and no block-sparse backend, so the candidates are
        dense, frontier and bitpacked (dense and bitpacked for a repair)."""
        tables = state.tables
        f = PlanFeatures(
            n=self.n,
            seed_rows=int(seed.sum()),
            new_rows=int(new.sum()),
            density=len(self.graph.edges) / max(self.graph.n_nodes, 1),
            n_prods=max(tables.n_prods, 1),
            n_nonterms=tables.n_nonterms,
            repair=repair,
            cache=cache,
            placement=state.placement,
            mesh_devices=0,
            occupied_blocks=0,
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
    ):
        """Run the masked closure to completion from ``seed`` rows, growing
        the capacity bucket on overflow (monotone warm restarts, so no work
        is lost).  With ``frozen`` (delta repair) the run uses the repair
        variant: frozen rows are contracted against but never recomputed,
        so capacity tracks the edit's blast radius, not the cache size.

        ``decision`` names the backend the planner picked; every capacity
        overflow is a fallback observation point — when
        :meth:`Planner.should_fallback` fires, the *remaining* closure is
        re-dispatched onto the decision's fallback backend at full
        capacity through the same warm restart.  At most one fallback per
        run; pinned decisions and repairs never fall back.

        Returns ``(T_device, M_host, n_calls, fallback_event)``."""
        mask = np.asarray(seed)
        repair = frozen is not None
        eng_name = repair_engine_name(decision.engine) if repair else decision.engine
        cap = bucket_for(max(decision.row_capacity, int(mask.sum())), self.n)
        n_frozen = cap_c = 0
        if repair:
            frozen_dev = torch.from_numpy(np.asarray(frozen)).to(self.device)
            n_frozen = int(np.asarray(frozen).sum())
            if eng_name != "bitpacked":
                # dense/frontier repair compacts the contraction axis over
                # active + frozen rows; the packed repair contracts full
                # packed words instead
                cap_c = bucket_for(max(cap, int(mask.sum()) + n_frozen), self.n)
        calls = 0
        fallback_event: dict | None = None
        tracer = self.tracer
        with tracer.span(
            "closure.execute",
            cat="engine",
            engine=eng_name,
            semantics="relational",
            repair=repair,
            seed_rows=int(mask.sum()),
        ) as csp:
            while True:
                instrumented = tracer.wants_iterations
                misses_before = self.plans.stats.compile_misses
                exe = self.plans.get(
                    PlanKey(
                        tables, eng_name, self.n, cap, repair=repair,
                        ctx_capacity=cap_c, instrumented=instrumented,
                    ),
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
                        eng_name = fb
                        cap = self.n
                        self.planner.note_fallback()
                        continue
                # overflow means the active set outgrew cap or (repair) the
                # context outgrew cap_c, so at least one bucket grows
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
        self, state: _GrammarState, batch: list[Query]
    ) -> tuple[str, PlanDecision | None, dict | None]:
        """Materialize closure rows covering the batch; returns
        ``(cache_status, decision, fallback_event)`` — the latter two are
        None on a pure cache hit (no closure ran, nothing was planned)."""
        need = self._need_mask(batch)
        if need is None:
            need = np.ones(self.n, dtype=bool)
            need[self.graph.n_nodes :] = False  # padding rows are empty
        mask, cur = state.mask, state.T
        if mask is not None and (need <= mask).all():
            return "hit", None, None
        status = "miss" if cur is None else "warm"
        if cur is None:
            cur = init_matrix(
                self.graph, state.grammar, pad_to=self.n, device=self.device
            )
            mask = np.zeros(self.n, dtype=bool)
        with self.tracer.span(
            "planner.decide", cat="engine", semantics="relational", cache=status
        ) as psp:
            decision = self._decide(state, mask | need, need & ~mask, status)
            psp.set(route=decision.label, pinned=decision.pinned)
        out, M, _, fb = self._run_fixpoint(
            state.tables, cur, mask | need, decision=decision
        )
        state.T, state.T_host, state.mask = out, out.cpu().numpy(), M
        state.placement = "local"
        state.served_by = fb["to"] if fb else decision.engine
        return status, decision, fb

    def _serve_relational(
        self, state: _GrammarState, batch: list[Query]
    ) -> list[QueryResult]:
        """Serve a batch of one grammar: materialize, then slice rows."""
        t0 = time.perf_counter()
        status, decision, fb = self._ensure_rows(state, batch)
        latency = time.perf_counter() - t0
        nn = self.graph.n_nodes
        T = state.T_host
        stats = QueryStats(
            latency_s=latency,
            cache=status,
            # the backend that materialized the served rows — on a cache
            # hit that is whoever ran last, not whoever would run next
            engine=state.served_by or self.engine,
            semantics="relational",
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
            outs.append(QueryResult(q, pairs, stats.copy()))
        return outs
