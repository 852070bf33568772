"""Conjunctive-grammar CFPQ (the paper's Section 7 future work) — the port
of ``repro.core.conjunctive``.

A conjunctive production  A -> B1 C1 & B2 C2 & ...  derives w iff EVERY
conjunct derives w.  The matrix closure generalizes as the paper predicts:
per iteration

    new[A] = AND_conjuncts ( T[B_i] x T[C_i] )   (Boolean AND of products)

The path abstraction loses which *string* realizes each (i, j) pair (two
conjuncts may hold through different strings between the same nodes), so
the fixpoint is an UPPER approximation of the conjunctive relation: sound,
possibly over-approximate, and exact for ordinary CFG productions.
:class:`ConjunctiveGrammar` and :class:`ConjunctiveTables` are copies of
the reference's; the base matrix is built on the device from the edge list.
"""
from __future__ import annotations

import functools
import operator
from dataclasses import dataclass

import numpy as np
import torch

from .closure import _bool_matmul, _iter_limit
from .graph import Graph
from .matrices import padded_size, resolve_device


@dataclass(frozen=True)
class ConjunctiveGrammar:
    """CNF-like conjunctive grammar: terminal rules A -> x and binary
    conjunctive rules A -> &_k (B_k C_k) given as index tuples."""

    nonterms: tuple[str, ...]
    term_prods: tuple[tuple[str, int], ...]  # (terminal, lhs_idx)
    conj_prods: tuple[tuple[int, tuple[tuple[int, int], ...]], ...]
    # each: (lhs_idx, ((b1, c1), (b2, c2), ...)) — one or more conjuncts

    @classmethod
    def from_rules(
        cls,
        terminal_rules: dict[str, list[str]],
        conjunctive_rules: list[tuple[str, list[tuple[str, str]]]],
    ) -> "ConjunctiveGrammar":
        names: list[str] = []

        def idx(n: str) -> int:
            if n not in names:
                names.append(n)
            return names.index(n)

        for a, pairs in conjunctive_rules:
            if not pairs:
                raise ValueError(
                    f"conjunctive rule for {a!r} has no conjuncts; a "
                    "production A -> &_k (B_k C_k) needs at least one "
                    "(B, C) pair (an empty AND would derive everything)"
                )
            idx(a)
        for x, lhss in terminal_rules.items():
            for a in lhss:
                idx(a)
        term = tuple(
            (x, idx(a)) for x, lhss in terminal_rules.items() for a in lhss
        )

        def dedupe(pairs):
            # duplicate conjuncts are idempotent under AND: drop them so the
            # closure does not pay for redundant products (and the planner's
            # conjunct-count pricing reflects real work)
            seen: set[tuple[int, int]] = set()
            out = []
            for b, c in pairs:
                bc = (idx(b), idx(c))
                if bc not in seen:
                    seen.add(bc)
                    out.append(bc)
            return tuple(out)

        conj = tuple(
            (idx(a), dedupe(pairs)) for a, pairs in conjunctive_rules
        )
        return cls(tuple(names), term, conj)

    def index_of(self, name: str) -> int:
        return self.nonterms.index(name)

    @property
    def nullable(self) -> frozenset:
        """CNF-like conjunctive grammars have no epsilon rules; the empty
        set keeps the engine's result slicing uniform across grammars."""
        return frozenset()


@dataclass(frozen=True)
class ConjunctiveTables:
    """Index form of a conjunctive grammar — the analog of
    :class:`repro_torch.core.matrices.ProductionTables` for PlanKey
    identity (hashable tuples).  Conjuncts are flattened: conjunct position
    ``k`` contracts ``T[conj_b[k]] x T[conj_c[k]]`` and belongs to
    production ``prod_of[k]``, whose LHS is ``a_idx[prod_of[k]]``."""

    a_idx: tuple[int, ...]  # LHS nonterminal per production
    conj_b: tuple[int, ...]  # flattened conjunct operands
    conj_c: tuple[int, ...]
    prod_of: tuple[int, ...]  # production position per flattened conjunct
    n_nonterms: int

    @classmethod
    def from_grammar(cls, g: ConjunctiveGrammar) -> "ConjunctiveTables":
        prods = sorted(g.conj_prods)
        a_idx, conj_b, conj_c, prod_of = [], [], [], []
        for p, (a, pairs) in enumerate(prods):
            a_idx.append(a)
            for b, c in pairs:
                conj_b.append(b)
                conj_c.append(c)
                prod_of.append(p)
        return cls(
            tuple(a_idx),
            tuple(conj_b),
            tuple(conj_c),
            tuple(prod_of),
            len(g.nonterms),
        )

    @property
    def n_prods(self) -> int:
        return len(self.a_idx)

    @property
    def n_conjuncts(self) -> int:
        return len(self.conj_b)

    def conj_groups(self) -> dict[int, list[int]]:
        """Production position -> flattened conjunct positions (for the AND
        folds of the masked closures)."""
        out: dict[int, list[int]] = {}
        for k, p in enumerate(self.prod_of):
            out.setdefault(p, []).append(k)
        return out

    def lhs_groups(self) -> dict[int, list[int]]:
        """LHS nonterminal -> production positions (for the OR folds)."""
        out: dict[int, list[int]] = {}
        for p, a in enumerate(self.a_idx):
            out.setdefault(a, []).append(p)
        return out


def _base_entries(graph: Graph, g: ConjunctiveGrammar, rows=None):
    """``(a, i, j)`` of every base entry (rows restricted to ``rows`` when
    given, ``i`` then the position in ``rows``), as int64 numpy arrays."""
    by_label: dict[str, list[int]] = {}
    for x, a in g.term_prods:
        by_label.setdefault(x, []).append(a)
    pos = None if rows is None else {int(r): k for k, r in enumerate(rows)}
    out = []
    for i, x, j in graph.edges:
        k = i if pos is None else pos.get(i)
        if k is not None:
            out.extend((a, k, j) for a in by_label.get(x, ()))
    arr = np.array(out, dtype=np.int64).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def init_matrix(
    graph: Graph,
    g: ConjunctiveGrammar,
    pad_to: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The (N, n, n) bool base matrix, made on ``device`` from the edge list
    (no host tensor of the state's size is built)."""
    dev = resolve_device(device)
    n = pad_to or padded_size(graph.n_nodes)
    if n < graph.n_nodes:
        raise ValueError("pad_to smaller than the graph")
    T = torch.zeros((len(g.nonterms), n, n), dtype=torch.bool, device=dev)
    a, i, j = (torch.from_numpy(x).to(dev) for x in _base_entries(graph, g))
    T[a, i, j] = True
    return T


def init_matrix_rows(
    graph: Graph, g: ConjunctiveGrammar, rows, pad_to: int | None = None
) -> np.ndarray:
    """Base-matrix rows for a subset of source nodes, ``(N, len(rows), n)``
    bool — the engine's insert-only delta repair of conjunctive states ORs
    them into the inserted sources' rows."""
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    out = np.zeros((len(g.nonterms), len(rows), n), dtype=bool)
    a, i, j = _base_entries(graph, g, rows)
    out[a, i, j] = True
    return out


def conjunctive_closure(
    T: torch.Tensor, g: ConjunctiveGrammar, max_iters: int | None = None
) -> torch.Tensor:
    """Fixpoint of  new[A] = AND_k (T[b_k] x T[c_k])  — upper approximation
    of the conjunctive relations (exact for ordinary CFG productions).  The
    limit is the |V|^2 |N| divergence guard."""
    limit = _iter_limit(T, max_iters)
    T = T.clone()
    changed, it = True, 0
    while changed and it < limit:
        rows = list(T.unbind(0))
        for a, pairs in g.conj_prods:
            prod = functools.reduce(
                operator.and_, [_bool_matmul(T[b], T[c]) for b, c in pairs]
            )
            rows[a] = rows[a] | prod
        T_next = torch.stack(rows)
        changed = bool((T_next & ~T).any())
        T = T_next
        it += 1
    return T


def evaluate(
    graph: Graph,
    g: ConjunctiveGrammar,
    start: str,
    device: str | torch.device = "cuda",
) -> set[tuple[int, int]]:
    T = conjunctive_closure(init_matrix(graph, g, device=device), g)
    a = g.index_of(start)
    sub = T[a, : graph.n_nodes, : graph.n_nodes].cpu().numpy()
    return {(int(i), int(j)) for i, j in zip(*sub.nonzero())}
