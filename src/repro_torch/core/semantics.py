"""Query semantics on top of the closure (paper Sections 4-5) — the port's
relational and single-path slice of ``repro.core.semantics``.

Relational semantics: R_A = {(i, j) | A in T^cf[i, j]}  (Theorem 2).

Single-path semantics (Section 5): every nonterminal entry carries ONE
witness path length, frozen at first discovery — if A enters a[i, j] at
iteration p via A -> B C through node k, then l_A = l_B + l_C with the
lengths recorded for those operands, and l_A is never overwritten.  A
witness of exactly that length is rebuilt by recursive splitting
(:class:`PathExtractor`, host numpy, a copy of the reference's).

The length annotation is a min-plus product gated by novelty: candidate
lengths come from a min-plus contraction (:func:`repro_torch.kernels.ops.minplus`:
the hand-written kernel on the card, which gathers the rhs rows of ``L``
by index, so no copy of them is made) and are written only where the
Boolean closure just found a new entry.  The
invariants of the reference hold unchanged, and the tests hold every
closure here bit-equal to its reference counterpart:

* **isfinite(L) == Boolean closure** on the rows under the state's mask;
  the engine caches the one f32 tensor.
* **Freeze-on-first-discovery.**  A finite entry of ``L`` is never
  overwritten — not by later iterations, warm restarts, capacity growth or
  delta repair.  Extraction splits an entry by exact length equality.
* **Backend-relative lengths.**  Lengths may differ across backends
  (discovery order differs), but each is the length of a real witness.

The masked closures differ from the reference in shape only: the
reference contracts a fixed R-slot block whose padding lanes hold ``inf``;
torch is eager, so these contract only the valid prefix of the block (the
padding lanes' candidates are ``inf`` and never reach the ``newly`` mask),
and the work follows the active rows, not the capacity bucket.
Conjunctive and count semantics are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref

from . import closure as _closure
from .closure import _active_rows, _all_rows, _iter_limit, _masked_init
from .grammar import CNFGrammar
from .graph import Graph
from .matrices import (
    ProductionTables,
    init_matrix,
    padded_size,
    relations_from_matrix,
    resolve_device,
)

INF = float("inf")


def _minplus(
    lhs: torch.Tensor, rhs: torch.Tensor, chunk: int | None = None
) -> torch.Tensor:
    """Batched min-plus matmul: out[p,i,j] = min_k lhs[p,i,k] + rhs[p,k,j].

    :func:`repro_torch.kernels.ops.minplus` without indices: the CUDA
    kernel on the card, the plain version on the CPU.  On the CPU a
    ``chunk`` sets the plain version's contraction chunk (the result does
    not depend on it); the card takes none.  Operands may be rectangular."""
    if chunk is None:
        return _kops.minplus(lhs, rhs)
    if lhs.device.type != "cpu" or rhs.device.type != "cpu":
        raise ValueError("_minplus: a chunk is the CPU's plain version's; "
                         "the card runs the kernel")
    return _kref.minplus_ref(lhs, rhs, chunk=chunk)


def _scatter_min(cand: torch.Tensor, tables: ProductionTables) -> torch.Tensor:
    """Min per-production candidates into their LHS slot, (P, …) -> (N, …)
    (the reference's ``full(inf).at[a_idx].min(cand)``)."""
    out = cand.new_full((tables.n_nonterms, *cand.shape[1:]), INF)
    for p, a in enumerate(tables.a_idx):
        torch.minimum(out[a], cand[p], out=out[a])
    return out


def base_lengths(T: torch.Tensor) -> torch.Tensor:
    """Length annotation of a *base* matrix (``init_matrix`` output): every
    present entry is a real length-1 edge.  ``isfinite == T`` holds, but do
    NOT apply this to a derived/cached closure — its non-base entries are
    not edges, and extraction would fail on them."""
    L = torch.full(T.shape, INF, dtype=torch.float32, device=T.device)
    return L.masked_fill_(T, 1.0)


def init_lengths(
    graph: Graph,
    g: CNFGrammar,
    pad_to: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """``base_lengths(init_matrix(graph, g, pad_to))``, made on ``device``
    from the edge list: no (N, n, n) Boolean tensor is built on the host
    and copied over (the single-path state is 4x the Boolean one)."""
    dev = resolve_device(device)
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    if n < graph.n_nodes:
        raise ValueError("pad_to smaller than the graph")
    entries = [
        (a, i, j)
        for i, x, j in graph.edges
        for a in g.term_prods.get(x, ())
    ]
    L = torch.full((g.n_nonterms, n, n), INF, dtype=torch.float32, device=dev)
    if entries:
        a, i, j = torch.tensor(entries, dtype=torch.int64, device=dev).unbind(1)
        L[a, i, j] = 1.0
    return L


def single_path_closure(
    T: torch.Tensor, tables: ProductionTables, max_iters: int | None = None
):
    """Returns (T^cf bool (N,n,n), lengths f32 (N,n,n) with inf = absent)."""
    if tables.n_prods == 0:
        return T, base_lengths(T)
    b_idx, c_idx = tables.index_tensors(T.device)
    limit = _iter_limit(T, max_iters)
    L = base_lengths(T)
    T = T.clone()
    changed, it = True, 0
    while changed and it < limit:
        cand_a = _scatter_min(_kops.minplus(L[b_idx], L, c_idx), tables)
        new = torch.isfinite(cand_a) & ~T
        L = torch.where(new, cand_a, L)  # freeze-on-first-discovery
        T |= new
        changed = bool(new.any())
        it += 1
    return T, L


# ---------------------------------------------------------------------- #
# Source-restricted (masked) single-path closures — the engine workload.
#
# The state is the length matrix L alone (isfinite(L) is the Boolean
# closure at every step).  The row-mask machinery is the Boolean masked
# closures' (closure.py): the first R rows of M are active, the min-plus
# contraction runs over the active (or active + frozen) rows, and columns
# reached from active rows join M until a joint fixpoint; ``overflowed``
# when M outgrows R (or, for a repair, the context outgrows C).  Every
# call copies its state once and updates the copy in place; rows outside
# the active set are never written.
# ---------------------------------------------------------------------- #


def _step(L, vidx, rows, cand, tables):
    """Write the newly found entries of the active rows ``vidx`` (whose
    values before this step are ``rows``); returns ``(newly, reach)``: the
    new entries and the columns the rows reached before this step."""
    fin = torch.isfinite(rows)
    cand_a = _scatter_min(cand, tables)
    newly = torch.isfinite(cand_a) & ~fin
    L[:, vidx, :] = torch.where(newly, cand_a, rows)
    return newly, fin.any(dim=1).any(dim=0)


def masked_single_path_closure(
    L: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted single-path closure (dense min-plus path).

    ``L`` is the (N, n, n) f32 length state (``base_lengths`` of the base
    matrix, or a cached state for a warm restart); ``src_mask`` the (n,)
    bool row seed.  Returns ``(L, M, overflowed)``; rows of ``L`` under
    ``M`` have ``isfinite(L)`` equal to the all-pairs Boolean closure rows
    iff ``overflowed`` is False (otherwise re-enter with the returned
    state and a larger ``row_capacity``; finite entries are frozen, so no
    work is lost)."""
    if tables.n_prods == 0:
        return _all_rows(L)
    R, b_idx, c_idx, limit = _masked_init(L, tables, row_capacity, max_iters)
    L = L.clone(memory_format=torch.contiguous_format)
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        vidx = idx[:cnt]
        rows = L[:, vidx, :]  # (N, cnt, n)
        lhs = rows[:, :, vidx][b_idx]  # (P, cnt, cnt): only rows in M contribute
        cand = _kops.minplus(lhs, L, c_idx, vidx)  # rhs: rows vidx of L[c_idx]
        newly, reach = _step(L, vidx, rows, cand, tables)
        M_next = M | reach
        overflow = int(M_next.sum()) > R
        grew = bool(newly.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(newly.sum()), overflow)
        M = M_next
        it += 1
    return L, M, overflow


def masked_frontier_single_path_closure(
    L: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Masked single-path closure with the frontier (delta) trick: only
    min-plus products through entries discovered in the previous iteration
    are formed, and rows newly admitted to the mask enter the delta with
    all their entries.  A new entry's length is the min over delta-involving
    splits — possibly above the dense variant's, but both operands are
    frozen finite entries, so the recorded sum stays extraction-exact."""
    if tables.n_prods == 0:
        return _all_rows(L)
    R, b_idx, c_idx, limit = _masked_init(L, tables, row_capacity, max_iters)
    L = L.clone(memory_format=torch.contiguous_format)
    M = src_mask.clone()
    D = torch.isfinite(L) & M[None, :, None]
    overflow, it = False, 0
    while bool(D.any()) and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        vidx = idx[:cnt]
        rows = L[:, vidx, :]
        rows_d = torch.where(D[:, vidx, :], rows, INF)  # delta entries
        lhs = rows[:, :, vidx][b_idx]
        lhs_d = rows_d[:, :, vidx][b_idx]
        cand = _kops.minplus(  # min of both products, the first as acc
            lhs_d, L, c_idx, vidx, acc=_kops.minplus(lhs, rows_d, c_idx)
        )
        del rows_d, lhs_d
        newly, reach = _step(L, vidx, rows, cand, tables)
        M_next = M | reach
        fresh = torch.nonzero(M_next & ~M).flatten()  # rows activated now
        D = torch.zeros_like(D)
        D[:, vidx, :] = newly
        D[:, fresh, :] = torch.isfinite(L[:, fresh, :])  # all their entries
        overflow = int(M_next.sum()) > R
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(newly.sum()), overflow)
        M = M_next
        it += 1
    return L, M, overflow


def masked_single_path_repair_closure(
    L: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    frozen_mask: torch.Tensor,
    row_capacity: int = 128,
    ctx_capacity: int | None = None,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Repair fixpoint for cached length states (delta repair).

    Mirrors :func:`~repro_torch.core.closure.masked_repair_closure`:
    ``src_mask`` seeds the rows to rebuild, rows under ``frozen_mask`` are
    trusted exact and never recomputed but join the contraction context
    (at most ``ctx_capacity`` rows), supplying their frozen lengths.
    Served by every backend.  Returns ``(L, M, overflowed)``; frozen rows
    come back bit-identical (only active rows are written)."""
    if tables.n_prods == 0:
        return _all_rows(L)
    R, b_idx, c_idx, limit = _masked_init(L, tables, row_capacity, max_iters)
    n = L.shape[-1]
    C = min(ctx_capacity if ctx_capacity is not None else n, n)
    L = L.clone(memory_format=torch.contiguous_format)
    M = src_mask & ~frozen_mask
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        cidx, ccnt = _active_rows(M | frozen_mask, C)
        vidx, vcidx = idx[:cnt], cidx[:ccnt]
        rows = L[:, vidx, :]  # (N, cnt, n) active rows
        lhs = rows[:, :, vcidx][b_idx]  # (P, cnt, ccnt)
        # rhs: the context rows vcidx (active and frozen) of L[c_idx]
        cand = _kops.minplus(lhs, L, c_idx, vcidx)
        newly, reach = _step(L, vidx, rows, cand, tables)
        M_next = M | (reach & ~frozen_mask)
        overflow = (
            int(M_next.sum()) > R or int((M_next | frozen_mask).sum()) > C
        )
        grew = bool(newly.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(newly.sum()), overflow)
        M = M_next
        it += 1
    return L, M, overflow


# ---------------------------------------------------------------------- #
# Witness-path reconstruction ("simple search" of Theorem 5), host-side —
# a copy of the reference's.
# ---------------------------------------------------------------------- #


class _DerivationBase:
    """Shared host-side index over one (graph, grammar) pair: edge
    membership by endpoint pair, binary productions grouped by LHS,
    terminal productions grouped by LHS."""

    def __init__(self, graph: Graph, g: CNFGrammar) -> None:
        self.g = g
        self._edges: dict[tuple[int, int], list[str]] = {}
        for s, x, d in graph.edges:
            self._edges.setdefault((s, d), []).append(x)
        self._by_lhs: dict[int, list[tuple[int, int]]] = {}
        for a, b, c in g.binary_prods:
            self._by_lhs.setdefault(a, []).append((b, c))
        self._term_by_lhs: dict[int, list[str]] = {}
        for x, lhss in g.term_prods.items():
            for a in lhss:
                self._term_by_lhs.setdefault(a, []).append(x)


class PathExtractor(_DerivationBase):
    """Batched witness reconstruction over one (graph, grammar) pair.

    The graph/grammar index structures are built once, outside the
    per-pair extraction loop; extraction runs on an explicit stack (not
    Python recursion), since witness lengths grow with the graph."""

    def extract(
        self, L: np.ndarray, nonterm: str, i: int, j: int
    ) -> list[tuple[int, str, int]]:
        """Reconstruct a path i ->* j derivable from ``nonterm`` whose
        length equals the recorded annotation ``L[nonterm, i, j]``.
        Raises KeyError if (i, j) is not in R_nonterm."""
        L = np.asarray(L)
        a0 = self.g.index_of(nonterm)
        if not np.isfinite(L[a0, i, j]):
            raise KeyError(f"({nonterm}, {i}, {j}) not in the relation")
        out: list[tuple[int, str, int]] = []
        stack = [(a0, i, j, float(L[a0, i, j]))]
        while stack:
            a, s, d, length = stack.pop()
            if length == 1.0:
                for x in self._term_by_lhs.get(a, ()):  # A -> x, edge (s,x,d)
                    if x in self._edges.get((s, d), ()):
                        out.append((s, x, d))
                        break
                else:
                    raise AssertionError(
                        "length-1 witness without a matching edge"
                    )
                continue
            for b, c in self._by_lhs.get(a, ()):
                lb = L[b, s, :]
                lc = L[c, :, d]
                ks = np.nonzero(
                    np.isfinite(lb) & np.isfinite(lc) & (lb + lc == length)
                )[0]
                if ks.size:
                    k = int(ks[0])
                    # LIFO: push the C-half first so the B-half emits first
                    stack.append((c, k, d, float(lc[k])))
                    stack.append((b, s, k, float(lb[k])))
                    break
            else:
                raise AssertionError(
                    "no consistent split — annotation invariant broken"
                )
        return out


def extract_path(
    L: np.ndarray,
    graph: Graph,
    g: CNFGrammar,
    nonterm: str,
    i: int,
    j: int,
) -> list[tuple[int, str, int]]:
    """One-shot wrapper around :class:`PathExtractor` (rebuilds the index
    structures per call — batch extraction should use the class)."""
    return PathExtractor(graph, g).extract(L, nonterm, i, j)


# ---------------------------------------------------------------------- #
# Entry points.
# ---------------------------------------------------------------------- #


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


def evaluate_single_path(
    graph: Graph,
    g: CNFGrammar,
    start: str,
    device: str | torch.device = "cuda",
) -> dict[tuple[int, int], list[tuple[int, str, int]]]:
    """Single-path CFPQ: one witness path per (i, j) in R_start, including
    the empty-path witnesses of a nullable start symbol (matching the pairs
    :func:`evaluate_relational` reports)."""
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device=resolve_device(device))
    T, L = single_path_closure(T0, tables)
    L = L.cpu().numpy()
    a0 = g.index_of(start)
    n = graph.n_nodes
    ex = PathExtractor(graph, g)
    out = {}
    for i, j in zip(*np.nonzero(T[a0, :n, :n].cpu().numpy())):
        out[(int(i), int(j))] = ex.extract(L, start, int(i), int(j))
    if start in g.nullable:
        for m in range(n):
            out.setdefault((m, m), [])  # empty path m pi m
    return out
