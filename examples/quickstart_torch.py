"""Quickstart on the PyTorch/CUDA port: one context-free path query end to end.

    PYTHONPATH=src python3 examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python3 examples/quickstart_torch.py --device cpu

Reproduces the paper's worked example (Section 4.3) with ``repro_torch``:
the same-generation query over a 3-node ontology fragment, then the same
query with single-path semantics (Section 5) to extract witness paths.
Exits nonzero if the relation is not the paper's Fig. 9.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.grammar import Grammar
from repro_torch.core.graph import Graph
from repro_torch.core.semantics import evaluate_relational, evaluate_single_path

# The same-generation query (paper Fig. 3) in the natural (non-CNF) form —
# the CNF transform is part of the frontend.
GRAMMAR = """
S -> subClassOf_r S subClassOf | type_r S type
S -> subClassOf_r subClassOf | type_r type
"""

#: the paper's Fig. 9 relation R_S on the Fig. 5 graph
FIG9 = {(0, 0), (0, 2), (1, 2)}


def fig5_graph() -> Graph:
    """The input graph (paper Fig. 5)."""
    return Graph(
        3,
        [
            (0, "subClassOf_r", 0),
            (0, "type_r", 1),
            (1, "type_r", 2),
            (2, "subClassOf", 0),
            (2, "type", 2),
        ],
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the closures run: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)

    graph = fig5_graph()
    g = Grammar.from_text(GRAMMAR).to_cnf()

    # Relational semantics: which (m, n) pairs are connected by an S-path?
    rel = evaluate_relational(graph, g, "S", device=args.device)
    print("R_S =", sorted(rel))
    if rel != FIG9:
        print(f"R_S != the paper's Fig. 9 {sorted(FIG9)}")
        return 1

    # Single-path semantics: one witness path per pair.
    paths = evaluate_single_path(graph, g, "S", device=args.device)
    for (i, j), path in sorted(paths.items()):
        labels = " ".join(x for _, x, _ in path)
        print(f"witness {i} -> {j}: {labels}")
    if set(paths) != rel:
        print("the witnessed pairs differ from R_S")
        return 1

    # Engines agree (dense matmul vs bitpacked kernel vs incremental frontier):
    for engine in ("dense", "frontier", "bitpacked"):
        if evaluate_relational(graph, g, "S", engine=engine, device=args.device) != rel:
            print(f"the {engine} closure differs from R_S")
            return 1
    print("all engines agree — OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
