"""Query semantics on top of the closure (paper Section 4) — the port's
relational slice of ``repro.core.semantics``.

Relational semantics: R_A = {(i, j) | A in T^cf[i, j]}  (Theorem 2).
Single-path, conjunctive and count semantics are not ported yet.
"""
from __future__ import annotations

import torch

from . import closure as _closure
from .grammar import CNFGrammar
from .graph import Graph
from .matrices import (
    ProductionTables,
    init_matrix,
    relations_from_matrix,
    resolve_device,
)


def _masked_allpairs(T: torch.Tensor, tables: ProductionTables) -> torch.Tensor:
    """The masked engine with every row seeded == the all-pairs closure."""
    n = T.shape[-1]
    Tm, _, _ = _closure.masked_closure(
        T, tables, torch.ones((n,), dtype=torch.bool, device=T.device),
        row_capacity=n,
    )
    return Tm


def closure_engines() -> dict:
    """Dispatch table of all-pairs closure engines by name."""
    return {
        "dense": _closure.dense_closure,
        "frontier": _closure.frontier_closure,
        "bitpacked": _closure.bitpacked_closure,
        "masked": _masked_allpairs,
    }


def evaluate_relational(
    graph: Graph,
    g: CNFGrammar,
    start: str,
    engine: str = "dense",
    device: str | torch.device = "cuda",
) -> set[tuple[int, int]]:
    """Full relational CFPQ: returns R_start restricted to real nodes,
    including the (m, m) pairs contributed by a nullable start symbol."""
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device=resolve_device(device))
    T = closure_engines()[engine](T0, tables)
    rel = relations_from_matrix(T, g, graph.n_nodes)[start]
    if start in g.nullable:
        rel |= {(m, m) for m in range(graph.n_nodes)}
    return rel
