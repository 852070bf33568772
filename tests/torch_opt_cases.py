"""Inputs and reference results of the ``opt`` family's port tests
(tests/test_torch_opt.py, in process, and tests/test_torch_distributed.py,
on gloo worlds).

Every input is built once with the reference's constructors and handed to
the port as its own copy (tests/torch_helpers.py); every reference result
is the reference's unsharded run (``plan=None``: its mesh tests cannot run
on this container's jax, see ROADMAP.md), computed once per process.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import closure as jclosure
from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.core import semantics as jsemantics
from repro.core.matrices import ProductionTables as JTables
from repro.core.matrices import init_matrix as jinit
from repro.core.matrices import pack_bits as jpack
from repro.engine import CompiledClosureCache as JPlans
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from helpers import masked_oracle_run, random_cnf, random_graph
from torch_helpers import port_grammar, port_graph

ANBN = "S -> a S b | a b"


def _q1():
    g = jgrammar.query1_grammar().to_cnf()
    return g, port_grammar(g)


def _anbn():
    g = jgrammar.Grammar.from_text(ANBN).to_cnf()
    return g, port_grammar(g)


@functools.cache
def opt_cases() -> dict:
    """The all-pairs case of the reference's test_roofline.py (Query 1 on
    its first ontology graph): ``name -> (jgraph, jgrammar, tgraph,
    tgrammar)``."""
    jq, tq = _q1()
    graph = jgraph.ontology_graph(30, 60, seed=3)
    return {"onto30": (graph, jq, port_graph(graph), tq)}


@functools.cache
def masked_cases() -> dict:
    """``name -> (jgraph, jgrammar, tgraph, tgrammar, sources)``: the
    reference's test_distributed_masked.py inputs — three random grammars
    and graphs, and Query 1 on an ontology graph."""
    out = {}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        g = random_cnf(rng)
        graph = random_graph(rng, n_nodes=10, n_edges=24)
        sources = tuple(sorted({int(s) for s in rng.integers(0, graph.n_nodes, 3)}))
        out[f"seed{seed}"] = (graph, g, port_graph(graph), port_grammar(g), sources)
    jq, tq = _q1()
    graph = jgraph.ontology_graph(20, 40, seed=5)
    out["ontology"] = (graph, jq, port_graph(graph), tq, (0, 7))
    return out


#: the capacity ladder starts at these capacities: from 64 on the ontology
#: graph of ``opt_cases()["onto30"]`` the active set outgrows the bucket
#: once (64, then 128 = n, whose plan the masked cases share)
LADDER_CAPS = (64,)


@functools.cache
def ladder_case():
    """``(jgraph, jgrammar, tgraph, tgrammar, sources)``."""
    graph, jg, tgraph, tg = opt_cases()["onto30"]
    return graph, jg, tgraph, tg, (0, 1)


@functools.cache
def interleaving_case():
    """The reference's delta interleaving (test_distributed_masked.py:258),
    its random draws made once: ``(jgraph, jgrammar, tgraph, tgrammar,
    steps, edges)``; ``steps`` are ``("delete" | "insert", edges)`` and
    ``("query", sources)`` in order, ``edges[k]`` the edge set of the
    ``k``-th query."""
    jg, tg = _anbn()
    n = 24
    graph = jgraph.random_labeled_graph(n, 50, ["a", "b"], seed=11)
    graph.edges[:] = sorted(set(graph.edges))
    rng = np.random.default_rng(21)
    cur = list(graph.edges)
    steps, edge_sets = [], []

    def random_edge():
        return (int(rng.integers(0, n)), ["a", "b"][int(rng.integers(0, 2))],
                int(rng.integers(0, n)))

    for _ in range(3):
        op = rng.random()
        if op < 0.35 and cur:
            victim = cur[int(rng.integers(0, len(cur)))]
            steps.append(("delete", [victim]))
            cur = [e for e in cur if e != victim]
        elif op < 0.7:
            ins = [random_edge() for _ in range(2)]
            steps.append(("insert", ins))
            cur = cur + [e for e in dict.fromkeys(ins) if e not in cur]
        steps.append(("query", tuple(sorted({int(s) for s in rng.integers(0, n, 3)}))))
        edge_sets.append(frozenset(cur))
    return graph, jg, port_graph(graph), tg, steps, edge_sets


FROZEN_INSERT = [(1, "a", 4), (8, "b", 3)]
#: the frozen case's single-path sources, two in each community (its
#: witnesses are extracted per pair, so not every row is asked for)
FROZEN_SP_SOURCES = (0, 1, 24, 25)


@functools.cache
def frozen_case():
    """The reference's frozen-row case (test_distributed_masked.py:307) on
    the interleaving's grammar and graph, so the reference engines share
    their plans: two copies of the graph as two communities, an insert
    into the first."""
    graph, jg, _, tg, _, _ = interleaving_case()
    graph = jgraph.Graph(graph.n_nodes, list(graph.edges)).repeat(2)
    assert FROZEN_SP_SOURCES[2] == graph.n_nodes // 2  # community 2 starts there
    return graph, jg, port_graph(graph), tg, FROZEN_INSERT


def _src(n, sources):
    src = np.zeros(n, bool)
    src[list(sources)] = True
    return src


@functools.cache
def ref_opt(name: str):
    """The reference's ``opt_closure`` and ``opt_step`` (uint32 words)."""
    graph, g, _, _ = opt_cases()[name]
    tables = JTables.from_grammar(g)
    T0 = jinit(graph, g)
    # jitted: one compile instead of one per eager op
    step = jax.jit(jclosure.opt_step, static_argnames=("tables", "n"))(
        jpack(T0), tables, n=T0.shape[-1])
    return np.asarray(jclosure.opt_closure(T0, tables)), np.asarray(step)


@functools.cache
def ref_masked(name: str, single_path: bool):
    """The reference's ``masked_opt_closure`` (or its single-path sibling
    on the base lengths) at capacity n, ``plan=None``: numpy ``(state, M,
    overflow)``."""
    graph, g, _, _, sources = masked_cases()[name]
    tables = JTables.from_grammar(g)
    T0 = jinit(graph, g)
    n = T0.shape[-1]
    if single_path:
        fn, state = jsemantics.masked_opt_single_path_closure, jsemantics.base_lengths(T0)
    else:
        fn, state = jclosure.masked_opt_closure, T0
    # plan=None spelled out as masked_oracle_run does: one compiled plan
    # serves both (the ladder's last call runs at n as well)
    out, M, ovf = fn(state, tables, jnp.asarray(_src(n, sources)), row_capacity=n,
                     plan=None)
    return np.asarray(out), np.asarray(M), bool(ovf)


@functools.cache
def ref_ladder(cap: int, single_path: bool):
    """The reference's restart loop (tests/helpers.py::masked_oracle_run,
    no mesh) from capacity ``cap``: its per-call snapshots."""
    graph, g, _, _, sources = ladder_case()
    tables = JTables.from_grammar(g)
    T0 = jinit(graph, g)
    state = jsemantics.base_lengths(T0) if single_path else T0
    _, _, snaps = masked_oracle_run(
        state, tables, _src(T0.shape[-1], sources), mesh_shape=None,
        row_capacity=cap, single_path=single_path,
    )
    return snaps


#: the plans of the reference's engines (the frozen case reuses the
#: interleaving's: same grammar, same padded n)
_REF_PLANS = JPlans()


def _plan_key(k) -> tuple:
    return (k.engine, k.n, k.row_capacity, k.repair, k.ctx_capacity,
            k.semantics, k.mesh, k.instrumented, k.tile)


@functools.cache
def ref_interleaving():
    """The reference's ``opt`` engine (no mesh) through the interleaving:
    per query ``(pairs, single-path pairs, engine)``, each edit's
    ``DeltaStats``, and the plan keys it built."""
    graph, g, _, _, steps, _ = interleaving_case()
    plans = _REF_PLANS
    eng = JEngine(jgraph.Graph(graph.n_nodes, list(graph.edges)), plans=plans,
                  config=JConfig(engine="opt"))
    queries, deltas = [], []
    for op, arg in steps:
        if op == "query":
            rel = eng.query(JQuery(g, "S", sources=arg))
            sp = eng.query(JQuery(g, "S", sources=arg, semantics="single_path"))
            queries.append((rel.pairs, sp.pairs, rel.stats["engine"]))
        else:
            deltas.append(eng.apply_delta(**{op: arg}).as_dict())
    return queries, deltas, sorted(map(_plan_key, plans._exe))


@functools.cache
def ref_frozen():
    """The reference's ``opt`` engine on the frozen-row case: all pairs,
    the host states and masks after the insert, its ``DeltaStats``."""
    ref_interleaving()  # first: its plan keys are read before these join
    graph, g, _, _, insert = frozen_case()
    eng = JEngine(jgraph.Graph(graph.n_nodes, list(graph.edges)),
                  plans=_REF_PLANS, config=JConfig(engine="opt"))
    pairs = eng.query(JQuery(g, "S")).pairs
    eng.query(JQuery(g, "S", sources=FROZEN_SP_SOURCES, semantics="single_path"))
    stats = eng.apply_delta(insert=insert).as_dict()
    (state,) = eng._states.values()
    after = (np.array(state.T_host), np.array(state.sp_L_host),
             np.array(state.mask), np.array(state.sp_mask))
    return pairs, after, stats, eng.query(JQuery(g, "S")).pairs
