"""Shared inputs of the port's differential tests (tests/test_torch_*.py).

Every case is built once with the reference package's constructors and once
with the port's own copies; the two must describe the same graph and
grammar, and the tests hand each package its own objects.
"""
from __future__ import annotations

import numpy as np

from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from helpers import random_cnf, random_graph

RANDOM_SEEDS = tuple(range(10))


def port_grammar(g: jgrammar.CNFGrammar) -> tgrammar.CNFGrammar:
    """The port's CNFGrammar with the same index tables as ``g``."""
    return tgrammar.CNFGrammar(
        list(g.nonterms),
        {x: list(v) for x, v in g.term_prods.items()},
        list(g.binary_prods),
        set(g.nullable),
    )


def port_graph(graph: jgraph.Graph) -> tgraph.Graph:
    return tgraph.Graph(graph.n_nodes, list(graph.edges))


def _named(name: str):
    """(reference graph, reference grammar, port graph, port grammar)."""
    if name == "paper":
        return (
            jgraph.paper_example_graph(), jgrammar.PAPER_EXAMPLE_CNF,
            tgraph.paper_example_graph(), tgrammar.PAPER_EXAMPLE_CNF,
        )
    if name == "worst6":
        text = "S -> a S b | a b"
        return (
            jgraph.worst_case_graph(6),
            jgrammar.Grammar.from_text(text).to_cnf(),
            tgraph.worst_case_graph(6),
            tgrammar.Grammar.from_text(text).to_cnf(),
        )
    onto, q = name.split(":")
    jq = {"q1": jgrammar.query1_grammar, "q2": jgrammar.query2_grammar}[q]
    tq = {"q1": tgrammar.query1_grammar, "q2": tgrammar.query2_grammar}[q]
    return (
        jgraph.paper_table_graph(onto), jq().to_cnf(),
        tgraph.paper_table_graph(onto), tq().to_cnf(),
    )


NAMED_CASES = (
    "paper",
    "skos:q1", "skos:q2", "foaf:q1", "foaf:q2",
    "people-pets:q1", "people-pets:q2",
    "worst6",
)
CASES = NAMED_CASES + tuple(f"seed{s}" for s in RANDOM_SEEDS)


def case(name: str):
    """``(jgraph, jgrammar, tgraph, tgrammar, start)`` of a named case or of
    a random one (``seedK``: the generator of
    tests/test_closure_vs_baseline.py's property test at seed K)."""
    if name.startswith("seed"):
        rng = np.random.default_rng(int(name[4:]))
        g = random_cnf(rng)
        graph = random_graph(
            rng,
            n_nodes=int(rng.integers(2, 9)),
            n_edges=int(rng.integers(1, 16)),
        )
        jg, jgr, tg, tgr = graph, g, port_graph(graph), port_grammar(g)
        start = g.nonterms[0]
    else:
        jg, jgr, tg, tgr = _named(name)
        start = "S"
    assert (tg.n_nodes, sorted(tg.edges)) == (jg.n_nodes, sorted(jg.edges))
    assert (tgr.nonterms, tgr.term_prods, tgr.binary_prods) == (
        jgr.nonterms, jgr.term_prods, jgr.binary_prods
    )
    return jg, jgr, tg, tgr, start
