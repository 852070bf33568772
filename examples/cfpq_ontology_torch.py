"""CFPQ over the paper's ontology suite on the PyTorch/CUDA port (Tables 1-2 analog).

    PYTHONPATH=src python3 examples/cfpq_ontology_torch.py [graph_name]
    PYTHONPATH=src python3 examples/cfpq_ontology_torch.py skos --device cpu

Evaluates Query 1 (same generation) and Query 2 (adjacent layers) over one
of the regenerated ontology graphs with ``repro_torch``'s dense closure,
holds it against the port's Hellings worklist baseline, and prints the
relation sizes (the paper's #results column).  Exits nonzero if a relation
differs from the baseline's.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.baselines import hellings_cfpq
from repro_torch.core import closure
from repro_torch.core.grammar import query1_grammar, query2_grammar
from repro_torch.core.graph import paper_table_graph
from repro_torch.core.matrices import (
    ProductionTables,
    init_matrix,
    relations_from_matrix,
)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("graph", nargs="?", default="wine")
    ap.add_argument("--device", default="cuda",
                    help="where the closures run: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)

    graph = paper_table_graph(args.graph)
    print(f"graph {args.graph}: {graph.n_nodes} nodes, {graph.n_edges} edges")

    for qname, qgram in (("Q1", query1_grammar), ("Q2", query2_grammar)):
        g = qgram().to_cnf()
        tables = ProductionTables.from_grammar(g)

        t0 = time.perf_counter()
        base = hellings_cfpq(graph, g)["S"]
        t_base = time.perf_counter() - t0

        T0 = init_matrix(graph, g, device=device)
        closure.dense_closure(T0, tables)  # first call: library handles
        _synchronize(device)
        t0 = time.perf_counter()
        T = closure.dense_closure(T0, tables)
        _synchronize(device)
        t_mat = time.perf_counter() - t0

        rel = relations_from_matrix(T, g, graph.n_nodes)["S"]
        print(
            f"{qname}: #results={len(rel):6d}  worklist={t_base*1e3:7.1f}ms  "
            f"matrix={t_mat*1e3:7.1f}ms"
        )
        if rel != base:
            print(f"{qname}: the closure's {len(rel)} pairs differ from "
                  f"Hellings' {len(base)}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
