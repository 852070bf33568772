"""Hellings-style worklist CFPQ — the baseline family the paper compares to.

The paper benchmarks against a GLL-based evaluator [9] and the Zhang et al.
algorithm [30]; both are worklist/parsing algorithms that derive the same
relational-semantics answer.  This is the canonical cubic worklist algorithm
(Hellings [11]): maintain a set W of discovered facts (A, i, j) and propagate
through binary productions until exhaustion.  It is the correctness oracle
for every matrix engine and the CPU perf baseline in benchmarks/bench_cfpq.py.
"""
from __future__ import annotations

from collections import defaultdict, deque

from repro_torch.core.grammar import CNFGrammar
from repro_torch.core.graph import Graph


def hellings_cfpq(graph: Graph, g: CNFGrammar) -> dict[str, set[tuple[int, int]]]:
    """Returns R_A for every nonterminal A (relational semantics)."""
    facts: set[tuple[int, int, int]] = set()  # (A, i, j)
    for i, x, j in graph.edges:
        for a in g.term_prods.get(x, ()):
            facts.add((a, i, j))

    # production indexes: by-B and by-C for incremental joins
    by_b: dict[int, list[tuple[int, int]]] = defaultdict(list)  # B -> [(A, C)]
    by_c: dict[int, list[tuple[int, int]]] = defaultdict(list)  # C -> [(A, B)]
    for a, b, c in g.binary_prods:
        by_b[b].append((a, c))
        by_c[c].append((a, b))

    # adjacency views of the fact set: out[A][i] = {j}, inc[A][j] = {i}
    out: dict[int, dict[int, set[int]]] = defaultdict(lambda: defaultdict(set))
    inc: dict[int, dict[int, set[int]]] = defaultdict(lambda: defaultdict(set))
    work: deque[tuple[int, int, int]] = deque()
    for f in facts:
        a, i, j = f
        out[a][i].add(j)
        inc[a][j].add(i)
        work.append(f)

    def add(a: int, i: int, j: int) -> None:
        if (a, i, j) not in facts:
            facts.add((a, i, j))
            out[a][i].add(j)
            inc[a][j].add(i)
            work.append((a, i, j))

    while work:
        b_or_c, i, j = work.popleft()
        # new fact as the LEFT operand:  (A -> (b_or_c) C): need C: j -> m
        for a, c in by_b.get(b_or_c, ()):
            for m in tuple(out[c][j]):
                add(a, i, m)
        # new fact as the RIGHT operand: (A -> B (b_or_c)): need B: m -> i
        for a, b in by_c.get(b_or_c, ()):
            for m in tuple(inc[b][i]):
                add(a, m, j)

    rel: dict[str, set[tuple[int, int]]] = {n: set() for n in g.nonterms}
    for a, i, j in facts:
        rel[g.nonterms[a]].add((i, j))
    return rel
