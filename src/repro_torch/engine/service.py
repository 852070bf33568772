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

Graph edits — logged through ``Graph.insert_edges`` / ``delete_edges`` or
made to ``graph.edges`` directly — drop every materialized state at the
next batch (the reference repairs logged edits row by row; that comes
with the port's delta slice).  Cached closure plans survive: they depend
only on the grammar and padded size.
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
    padded_size,
    resolve_device,
)
from repro_torch.delta.txn import EpochClock, Snapshot
from repro_torch.obs.instruments import EngineMetrics
from repro_torch.obs.trace import NULL_TRACER, iteration_scope

from .config import EngineConfig
from .plan import CompiledClosureCache, PlanKey, bucket_for
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
        # cache and state mutation is not atomic: query_batch holds this
        # across its whole body
        self._lock = threading.RLock()
        # Observability (repro_torch.obs): planner.decide / closure.execute
        # spans, and per-iteration events through instrumented plan keys
        # when the tracer wants them.  ``metrics`` is a MetricsRegistry (the
        # process default when None) fed cache/closure counters.
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
        expects to read; if the graph changed since, the batch raises
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

    def snapshot(self) -> Snapshot:
        """Pin the current epoch for cross-batch read consistency."""
        with self._lock:
            return self.clock.snapshot()

    # ------------------------------------------------------------------ #
    def _check_graph(self) -> None:
        """Reconcile with the graph: any change of its content drops every
        materialized state (the reference's out-of-band branch); a version
        bump with unchanged content only advances the epoch."""
        g = self.graph
        actual = frozenset(g.edges)
        if actual == self._edge_set and g.n_nodes == self._n_nodes:
            if g.version != self._version:
                self._version = g.version
                self.clock.advance(g.version)
            return
        self._states.clear()
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
    ) -> PlanDecision:
        """Build the planner features for one closure call and decide.  The
        port has no mesh and no block-sparse backend, so the candidates are
        dense, frontier and bitpacked."""
        tables = state.tables
        f = PlanFeatures(
            n=self.n,
            seed_rows=int(seed.sum()),
            new_rows=int(new.sum()),
            density=len(self.graph.edges) / max(self.graph.n_nodes, 1),
            n_prods=max(tables.n_prods, 1),
            n_nonterms=tables.n_nonterms,
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
    ):
        """Run the masked closure to completion from ``seed`` rows, growing
        the capacity bucket on overflow (monotone warm restarts, so no work
        is lost).

        ``decision`` names the backend the planner picked; every capacity
        overflow is a fallback observation point — when
        :meth:`Planner.should_fallback` fires, the *remaining* closure is
        re-dispatched onto the decision's fallback backend at full
        capacity through the same warm restart.  At most one fallback per
        run; pinned decisions never fall back.

        Returns ``(T_device, M_host, n_calls, fallback_event)``."""
        mask = np.asarray(seed)
        eng_name = decision.engine
        cap = bucket_for(max(decision.row_capacity, int(mask.sum())), self.n)
        calls = 0
        fallback_event: dict | None = None
        tracer = self.tracer
        with tracer.span(
            "closure.execute",
            cat="engine",
            engine=eng_name,
            semantics="relational",
            repair=False,
            seed_rows=int(mask.sum()),
        ) as csp:
            while True:
                instrumented = tracer.wants_iterations
                misses_before = self.plans.stats.compile_misses
                exe = self.plans.get(
                    PlanKey(
                        tables, eng_name, self.n, cap, instrumented=instrumented
                    ),
                    provenance="pinned" if decision.pinned else "planned",
                )
                self.metrics.observe_cache(
                    hit=self.plans.stats.compile_misses == misses_before
                )
                with iteration_scope(
                    tracer.iteration_sink(csp) if instrumented else None
                ):
                    T, M, overflow = exe(
                        T, torch.from_numpy(mask).to(self.device)
                    )
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
                # overflow means the active set outgrew cap: the bucket grows
                cap = bucket_for(max(cap, grown), self.n)
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
