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

Conjunctive semantics (paper Section 7): the masked closures of
``repro.core.semantics`` with an AND per production and an OR per LHS
(:func:`_conj_combine`), on the dense matmul path and on packed words
through the ``bitmm`` kernel.  Counting semantics: path counts in the
saturating uint32 semiring (``SAT_COUNT`` = 2^32 - 1), held in int32
storage with the same bits, so SAT reads as -1 and every comparison that
relies on unsigned order compares unsigned (:func:`_umax`) or tests
``!= 0``; the Jacobi products run through ``kernels.ops.count_mm`` (the
hand-written kernel on the card).  Bounded all-path enumeration
(:class:`DerivationIndex`) is host numpy, a copy of the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref

from . import closure as _closure
from .closure import (
    _active_rows,
    _all_rows,
    _bool_matmul,
    _iter_limit,
    _masked_init,
    _masked_limit,
    _scatter_or,
)
from .grammar import CNFGrammar
from .graph import Graph
from .matrices import (
    ProductionTables,
    init_matrix,
    pack_bits,
    padded_size,
    relations_from_matrix,
    resolve_device,
    unpack_bits,
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


def masked_opt_single_path_closure(
    L: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    plan=None,
):
    """Source-restricted single-path closure of the ``opt`` family:
    :func:`masked_single_path_closure` with the state sharded over the
    mesh (``repro_torch.shard.plans.MeshPlan``; rows over the row axis,
    columns over ``model``).

    Lengths are f32, so there is no packed layout to exchange; per
    iteration the compacted active block is gathered once: its rows from
    their owners (each rank keeping its columns: the column copy, R
    replicated), then every column all-gathered over ``model`` (the
    replicated ``(N, R, n)`` block).  The row copy is the rank's lanes of
    that block; the lhs gathers its columns by ``idx``.  The product is
    ``kernels.ops.minplus`` of the lhs against the column copy (slab =
    ``c_idx``), the rank's lanes x columns of the candidates, and the
    updated rows go back to their owners.  Freeze-on-first-discovery is
    kept verbatim (candidates land only where ``isfinite`` just flipped),
    so finite entries never move, on any mesh shape.  ``plan=None`` is
    the same math on one device.  Returns ``(L, M, overflowed)``, ``L`` a
    ShardedState under a plan."""
    from repro_torch.shard.plans import LocalPlan

    if tables.n_prods == 0:
        return _all_rows(L)
    R, b_idx, c_idx, limit = _masked_init(L, tables, row_capacity, max_iters)
    lay = plan if plan is not None else LocalPlan()
    n = L.shape[-1]
    Ll = _closure._shard_state(L, lay, packed=False)  # (N, rows_loc, cols_loc)
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        if cnt == 0:
            break
        vidx = idx[:cnt]
        kp = lay.lanes_per(cnt)
        lo = lay.row_rank * kp
        col_copy = lay.gather_rows(Ll, vidx, kp * lay.row_size, n)  # (N, K, c)
        col_copy[:, cnt:] = INF
        block = lay.row_copy(col_copy, n)  # (N, K, n): replicated
        # compact the contraction axis too: only rows in M can contribute
        lhs = block[:, lo:lo + kp][:, :, vidx][b_idx]  # (P, kp, cnt)
        cand = _kops.minplus(
            lhs, col_copy, c_idx, torch.arange(cnt, device=lhs.device)
        )  # (P, kp, c): this rank's lanes and columns
        cand_a = _scatter_min(cand, tables)
        old = col_copy[:, lo:lo + kp]
        newly = torch.isfinite(cand_a) & ~torch.isfinite(old)
        changed = lay.scatter_rows(Ll, vidx, torch.where(newly, cand_a, old), n)
        reach = torch.isfinite(block[:, :cnt]).any(dim=1).any(dim=0)
        M_next = M | reach
        overflow = int(M_next.sum()) > R
        grew = _closure._grew_anywhere(lay, changed) or bool((M_next & ~M).any())
        M = M_next
        it += 1
    return _closure._unshard(Ll, n, plan, packed=False), M, overflow


# ---------------------------------------------------------------------- #
# Source-restricted (masked) conjunctive closures — the engine workload for
# ``semantics="conjunctive"``.
#
# Per iteration:  new[A] = OR_prods-of-A ( AND_conjuncts ( T[b] x T[c] ) )
# over the active rows — the conjunctive generalization of
# closure.masked_closure with the same state/mask/overflow contract.  The
# frontier (delta) trick is unsound under AND (a conjunct's delta product
# misses pairs whose other conjuncts completed earlier), so there is no
# frontier variant; the engine aliases frontier to dense
# (plan.conj_engine_name).  Conjuncts that repeat a (B, C) pair across
# productions share one product.
# ---------------------------------------------------------------------- #


def _conj_combine(prod, tables):
    """Fold per-conjunct products into per-nonterminal planes: AND over
    each production's conjuncts, then OR over the productions of each LHS.

    ``prod[k]`` is the product of flattened conjunct ``k`` (a stacked
    tensor or a sequence of planes).  Works on bool planes and on packed
    int32 words alike: ``&`` and ``|`` are logical on the former and
    bitwise on the latter.  A nonterminal that heads no production gets a
    zero plane."""
    conj_groups = tables.conj_groups()
    out = prod[0].new_zeros((tables.n_nonterms, *prod[0].shape))
    for a, ps in tables.lhs_groups().items():
        for p in ps:
            ks = conj_groups[p]
            t = prod[ks[0]]
            for k in ks[1:]:
                t = t & prod[k]
            out[a] |= t
    return out


def _distinct_conjuncts(tables, device):
    """``(b, c, which)``: the distinct (B, C) pairs of the flattened
    conjuncts as int64 index tensors, and per conjunct the position of its
    pair."""
    pairs = list(dict.fromkeys(zip(tables.conj_b, tables.conj_c)))
    which = [pairs.index(bc) for bc in zip(tables.conj_b, tables.conj_c)]
    b, c = (torch.tensor(x, dtype=torch.int64, device=device) for x in zip(*pairs))
    return b, c, which


def masked_conjunctive_closure(
    T: torch.Tensor,
    tables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted conjunctive closure on the dense matmul path.

    ``T`` is the (N, n, n) bool state (``conjunctive.init_matrix`` or a
    cached state for a warm restart), ``tables`` a
    :class:`~repro_torch.core.conjunctive.ConjunctiveTables`, ``src_mask``
    the (n,) bool row seed.  Returns ``(T, M, overflowed)``; rows of ``T``
    under ``M`` equal the all-pairs ``conjunctive_closure`` rows iff
    ``overflowed`` is False.  One product per distinct (B, C) pair."""
    if tables.n_conjuncts == 0:
        return _all_rows(T)
    R, limit = min(row_capacity, T.shape[-1]), _masked_limit(T, max_iters)
    ub, uc, which = _distinct_conjuncts(tables, T.device)
    T = T.clone()
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        vidx = idx[:cnt]
        rows = T[:, vidx, :]  # (N, cnt, n) active rows
        lhs = rows[:, :, vidx]  # only rows in M contribute
        prods = [_bool_matmul(lhs[b], rows[c]) for b, c in zip(ub.tolist(), uc.tolist())]
        new_r = _conj_combine([prods[u] for u in which], tables)
        del prods, lhs
        changed = new_r & ~rows
        T[:, vidx, :] = rows | new_r
        M_next = M | rows.any(dim=1).any(dim=0)  # columns reached -> rows
        overflow = int(M_next.sum()) > R
        grew = bool(changed.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed.sum()), overflow)
        M = M_next
        it += 1
    return T, M, overflow


def masked_bitpacked_conjunctive_closure(
    T: torch.Tensor,
    tables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted conjunctive closure on packed words: the distinct
    conjunct pairs contract the gathered active rows of their B planes
    against the full packed state of their C planes in ONE ``bitmm`` launch,
    then the AND/OR fold runs bitwise on the packed products.  Contracting
    against base-only rows stays sound under AND (each product over a
    subset state is a subset of the true one), and at the joint fixpoint
    the masked rows match the dense variant bit for bit."""
    if tables.n_conjuncts == 0:
        return _all_rows(T)
    R, limit = min(row_capacity, T.shape[-1]), _masked_limit(T, max_iters)
    ub, uc, which = _distinct_conjuncts(tables, T.device)
    which = torch.tensor(which, dtype=torch.int64, device=T.device)
    n = T.shape[-1]
    Tp = pack_bits(T)  # (N, n, w)
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        vidx = idx[:cnt]
        rows = Tp[:, vidx, :]  # (N, cnt, w)
        if cnt:  # (U, cnt, w) per distinct conjunct: one launch
            prod = _kops.bitmm(rows[ub], Tp[uc])
        else:
            prod = rows.new_zeros((len(ub), 0, rows.shape[-1]))
        new_r = _conj_combine(prod[which], tables)
        del prod
        upd = rows | new_r
        changed_w = upd != rows  # changed words (packed growth unit)
        Tp[:, vidx, :] = upd
        # packed columns reached from active rows: OR over the nonterminal
        # axis, then any() over the unpacked rows
        reach = rows[0].clone()
        for a in range(1, rows.shape[0]):
            reach |= rows[a]
        M_next = M | unpack_bits(reach, n).any(dim=0)
        overflow = int(M_next.sum()) > R
        grew = bool(changed_w.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed_w.sum()), overflow)
        M = M_next
        it += 1
    return unpack_bits(Tp, n), M, overflow


# ---------------------------------------------------------------------- #
# Counting semantics: path-count matrices in a saturating semiring.
#
# C[A, i, j] counts the derivation trees of (A, i ->* j) — on an
# unambiguous grammar the number of distinct paths i ->* j whose label
# word derives from A.  Counts are uint32 with the all-ones word as a
# sticky saturation sentinel, held in int32 storage (the sentinel reads
# -1).  The fixpoint is the Jacobi iteration of C[A] = C0[A] + Σ_{A→BC}
# C[B]·C[C] from below, in three phases (see repro.core.semantics):
#   A. the Boolean fixpoint on the support;
#   B. the divergence greatest fixpoint: entries with unboundedly many
#      derivations (a derivation through a dependency cycle), stamped SAT;
#   C. the saturating Jacobi, each product one ``ops.count_mm`` launch per
#      production whose acc chains the base row and the earlier
#      productions of the same LHS (a saturating sum is min(SAT, Σ) in any
#      order, so the result equals the reference's Σ-then-add).
# ---------------------------------------------------------------------- #

#: saturation sentinel: a count of 0xFFFFFFFF means ">= 2^32 - 1 paths"
SAT_COUNT = np.uint32(_kref.SAT_COUNT)

_SAT = -1  # SAT_COUNT in int32 storage
_SIGN = -(2**31)  # xor with it maps unsigned order onto signed order


def _sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating uint32 add on int32 storage: clamps to the sentinel."""
    s = _kref.as_unsigned(a) + _kref.as_unsigned(b)
    return _kref.as_storage(s.clamp_max_(_kref.SAT_COUNT))


def _sat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating uint32 multiply on int32 storage.  a*b overflows iff
    b > 0 and a > SAT // b (the reference's test); the product of two
    values near 2^32 is never formed, so nothing overflows int64."""
    return _kref.as_storage(
        _kref.sat_mul_unsigned(_kref.as_unsigned(a), _kref.as_unsigned(b))
    )


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max of int32-stored counts (SAT, stored -1, is
    the largest): the reference's uint32 ``maximum``."""
    return torch.where((a ^ _SIGN) >= (b ^ _SIGN), a, b)


def _count_mm(
    lhs: torch.Tensor, rhs: torch.Tensor, chunk: int | None = None
) -> torch.Tensor:
    """Batched saturating count matmul on int32-stored counts:
    out[p,i,j] = sat-Σ_k sat(lhs[p,i,k] * rhs[p,k,j]).

    :func:`repro_torch.kernels.ops.count_mm` without indices: the CUDA
    kernel on the card, the plain version on the CPU, where a ``chunk``
    sets the contraction chunk (the result does not depend on it)."""
    if chunk is None:
        return _kops.count_mm(lhs, rhs)
    if lhs.device.type != "cpu" or rhs.device.type != "cpu":
        raise ValueError("_count_mm: a chunk is the CPU's plain version's; "
                         "the card runs the kernel")
    return _kref.count_mm_ref(lhs, rhs, chunk=chunk)


def _scatter_sat_add(prod: torch.Tensor, tables: ProductionTables):
    """Per-LHS saturating sum of production products, (P, …) -> (N, …)."""
    out = prod.new_zeros((tables.n_nonterms, *prod.shape[1:]))
    for p, a in enumerate(tables.a_idx):
        out[a] = _sat_add(out[a], prod[p])
    return out


def count_entries(graph: Graph, g: CNFGrammar, rows=None):
    """``(a, i, j)`` of every base path (one per edge and derived label;
    ``i`` the position in ``rows`` when given), as int64 numpy arrays."""
    pos = None if rows is None else {int(r): k for k, r in enumerate(rows)}
    out = []
    for i, x, j in graph.edges:
        k = i if pos is None else pos.get(i)
        if k is not None:
            out.extend((a, k, j) for a in g.term_prods.get(x, ()))
    arr = np.array(out, dtype=np.int64).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def _count_fill(shape, entries, device) -> torch.Tensor:
    C = torch.zeros(shape, dtype=torch.int32, device=device)
    idx = tuple(torch.from_numpy(x).to(device) for x in entries)
    C.index_put_(idx, torch.ones(len(entries[0]), dtype=torch.int32, device=device),
                 accumulate=True)
    return C


def count_base(
    graph: Graph,
    g: CNFGrammar,
    pad_to: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Base count matrix, (N, n, n) int32: C0[A,i,j] = #{edges (i,x,j) with
    A -> x}, made on ``device`` with one accumulating ``index_put_``.

    NOT ``init_matrix(...)`` as counts — two parallel edges with different
    labels that both derive from A are two distinct length-1 paths."""
    dev = resolve_device(device)
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    if n < graph.n_nodes:
        raise ValueError("pad_to smaller than the graph")
    return _count_fill((g.n_nonterms, n, n), count_entries(graph, g), dev)


def count_base_rows(
    graph: Graph,
    g: CNFGrammar,
    rows,
    pad_to: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The ``rows`` slices of :func:`count_base`, shape
    ``(|N|, len(rows), n)`` int32 on ``device`` — for delta recounts."""
    n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
    return _count_fill((g.n_nonterms, len(rows), n),
                       count_entries(graph, g, rows), resolve_device(device))


def _count_step(C, base_rows, tables, c_idx, row=None):
    """One Jacobi step's new planes: ``sat(base_rows[a] + Σ_{p: a_idx[p]
    = a} C[b_p][row][:, row] · C[c_idx[p]][row])`` per nonterminal ``a``
    (``row`` None: all rows of C), each production one ``count_mm`` launch
    whose acc is the plane so far.  The lhs is gathered per production, one
    (R, R) plane at a time; the rhs rows of C are read in place."""
    planes = list(base_rows.unbind(0))
    for p, (a, b) in enumerate(zip(tables.a_idx, tables.b_idx)):
        lhs = C[b] if row is None else C[b].index_select(0, row).index_select(1, row)
        planes[a] = _kops.count_mm(
            lhs[None], C, c_idx[p:p + 1], row, acc=planes[a][None].contiguous()
        )[0]
    return planes


def count_closure(
    C0: torch.Tensor, tables: ProductionTables, max_iters: int | None = None
) -> torch.Tensor:
    """All-pairs counting closure: the least fixpoint of
    ``C = C0 + Σ_{A→BC} C[B]·C[C]`` in the saturating semiring.

    ``C0`` is the :func:`count_base` tensor.  Runs the three phases of the
    section comment; finite entries converge at their derivation heights,
    entries with unboundedly many paths land on the SAT sentinel."""
    if tables.n_prods == 0:
        return C0
    b_idx, c_idx = tables.index_tensors(C0.device)
    limit = _iter_limit(C0, max_iters)
    T = _closure.dense_closure(C0 != 0, tables, max_iters=max_iters)  # phase A

    X, changed, it = T, True, 0
    while changed and it < limit:
        contrib = _bool_matmul(X[b_idx], T[c_idx]) | _bool_matmul(T[b_idx], X[c_idx])
        X_next = X & _scatter_or(contrib, tables)
        changed = bool((X_next != X).any())
        X, it = X_next, it + 1
    del T

    C_seed = torch.where(X, _SAT, C0)  # phase C: divergent entries pinned
    del X
    C, changed, it = C_seed, True, 0
    while changed and it < limit:
        planes = _count_step(C, C_seed, tables, c_idx)
        # monotone guard for mixed/warm inputs (a cold run never dips)
        C_next = _umax(torch.stack(planes), C)
        changed = bool((C_next != C).any())
        C, it = C_next, it + 1
    return C


def masked_count_closure(
    C: torch.Tensor,
    base: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted counting closure — the engine workload for
    ``semantics="count"`` (dense only; every backend aliases here through
    ``plan.count_engine_name``).

    ``C`` is the (N, n, n) int32-stored count state (``base`` itself when
    cold, or a cached state for a warm restart), ``base`` the current
    :func:`count_base` tensor (the Jacobi recompute re-adds it).  Returns
    ``(C, M, overflowed)`` under the standard masked contract: rows of
    ``C`` under ``M`` equal the all-pairs :func:`count_closure` rows iff
    ``overflowed`` is False.  Rows are written back with an unsigned max
    (iterates increase from below, so max never loses a count), and only
    rows under the returned ``M`` are ever written."""
    if tables.n_prods == 0:
        return _all_rows(C)
    R, b_idx, c_idx, limit = _masked_init(C, tables, row_capacity, max_iters)

    # Phase A: the Boolean support closure settles M (and overflow) before
    # any counting happens, so phases B and C run on a fixed active set.
    T_sup, M, overflow = _closure.masked_closure(
        (C != 0) | (base != 0), tables, src_mask,
        row_capacity=row_capacity, max_iters=max_iters,
    )
    idx, cnt = _active_rows(M, R)
    vidx = idx[:cnt]
    T_rows = T_sup[:, vidx, :]  # (N, cnt, n)
    del T_sup
    lhs_T = T_rows[b_idx][:, :, vidx]  # (P, cnt, cnt)

    # Phase B: divergence gfp on the active rows.  A cycle found in a
    # partial (overflowed) support is a cycle of the true support, so the
    # sentinel is never stamped prematurely.
    X_rows, changed, it = T_rows, True, 0
    while changed and it < limit:
        lhs_X = X_rows[b_idx][:, :, vidx]
        contrib = _bool_matmul(lhs_X, T_rows[c_idx]) | _bool_matmul(
            lhs_T, X_rows[c_idx]
        )
        X_next = X_rows & _scatter_or(contrib, tables)
        changed = bool((X_next != X_rows).any())
        X_rows, it = X_next, it + 1
    del T_rows, lhs_T
    C = C.clone(memory_format=torch.contiguous_format)
    C[:, vidx, :] = torch.where(X_rows, _SAT, C[:, vidx, :])  # max with SAT
    del X_rows

    # Phase C: saturating Jacobi over the settled active set.
    grew, it = not overflow, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        vidx = idx[:cnt]
        # the contraction axis is compacted too: only rows in M contribute
        planes = _count_step(C, base[:, vidx, :], tables, c_idx, vidx)
        changed, reach = 0, torch.zeros_like(M)
        for a, new in enumerate(planes):  # written after every product ran
            old = C[a, vidx, :]
            upd = _umax(old, new)
            changed += int((upd != old).sum())
            reach |= (old != 0).any(dim=0)
            C[a, vidx, :] = upd
        del planes
        M_next = M | reach
        overflow = int(M_next.sum()) > R
        grew = changed > 0 or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), changed, overflow)
        M = M_next
        it += 1
    return C, M, overflow


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


class DerivationIndex(_DerivationBase):
    """Packed derivation index: bounded all-path enumeration over one
    (closure, graph, grammar) triple (a copy of the reference's).

    The Boolean closure is held bit-packed by rows *and* by columns, so the
    split candidates of a production ``A -> B C`` at ``(i, j)`` — the nodes
    t with ``T[B,i,t]`` and ``T[C,t,j]`` — come from one AND of packed
    words.  The closure also prunes the enumeration: a (nonterm, s, d)
    branch with no closure entry derives nothing and is cut at once.

    ``T`` must be exact on every row reachable from the queried sources
    (the all-pairs closure, or a masked state whose mask covers the
    source)."""

    def __init__(self, T: np.ndarray, graph: Graph, g: CNFGrammar) -> None:
        super().__init__(graph, g)
        self._T = np.asarray(T).astype(bool)
        self.n = self._T.shape[-1]
        # bit t of _rows[A, i] is T[A, i, t]; _cols is the transpose view
        # packed the same way, so splits() ANDs two contiguous words.
        self._rows = np.packbits(self._T, axis=-1)
        self._cols = np.packbits(self._T.transpose(0, 2, 1), axis=-1)

    def splits(self, b: int, i: int, c: int, j: int) -> np.ndarray:
        """Nodes t with T[b, i, t] and T[c, t, j], via packed AND."""
        words = self._rows[b, i] & self._cols[c, j]
        return np.nonzero(np.unpackbits(words, count=self.n))[0]

    def _enum(self, a: int, s: int, d: int, budget: int):
        """Yield edge-list paths ``s ->* d`` derivable from nonterminal
        ``a`` with 1 <= length <= budget, possibly with repeats (the public
        API dedupes).  Both halves of every split get a strictly smaller
        budget, so it terminates; recursion depth is O(budget)."""
        if budget < 1 or not self._T[a, s, d]:
            return
        for x in self._term_by_lhs.get(a, ()):
            if x in self._edges.get((s, d), ()):
                yield [(s, x, d)]
        if budget < 2:
            return
        for b, c in self._by_lhs.get(a, ()):
            for t in self.splits(b, s, c, d):
                t = int(t)
                for left in self._enum(b, s, t, budget - 1):
                    for right in self._enum(c, t, d, budget - len(left)):
                        yield left + right

    def extract_paths(
        self, nonterm: str, i: int, j: int, k: int, max_len: int
    ) -> list[list[tuple[int, str, int]]]:
        """Up to ``k`` distinct paths ``i ->* j`` derivable from
        ``nonterm``, each of length <= ``max_len``.  A nullable start
        contributes the empty path at ``i == j``."""
        a0 = self.g.index_of(nonterm)
        out: list[list[tuple[int, str, int]]] = []
        seen: set[tuple] = set()
        if i == j and nonterm in self.g.nullable and k > 0:
            out.append([])
            seen.add(())
        for path in self._enum(a0, i, j, max_len):
            key = tuple(path)
            if key in seen:
                continue
            seen.add(key)
            out.append(path)
            if len(out) >= k:
                break
        return out


def extract_paths(
    T: np.ndarray,
    graph: Graph,
    g: CNFGrammar,
    nonterm: str,
    i: int,
    j: int,
    k: int = 10,
    max_len: int = 16,
) -> list[list[tuple[int, str, int]]]:
    """One-shot bounded all-path enumeration (rebuilds the packed index
    per call — batch extraction should use :class:`DerivationIndex`)."""
    return DerivationIndex(T, graph, g).extract_paths(nonterm, i, j, k, max_len)


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
        "opt": _closure.opt_closure,
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


def evaluate_count(
    graph: Graph,
    g: CNFGrammar,
    start: str,
    device: str | torch.device = "cuda",
) -> dict[tuple[int, int], int]:
    """Counting CFPQ: (i, j) -> number of derivations of ``start`` paths
    i ->* j (== distinct paths on an unambiguous grammar), saturating at
    :data:`SAT_COUNT`.  A nullable start contributes the empty path: one
    extra path per (m, m), saturating-added like any other."""
    tables = ProductionTables.from_grammar(g)
    C = count_closure(count_base(graph, g, device=device), tables)
    a0 = g.index_of(start)
    n = graph.n_nodes
    sub = C[a0, :n, :n].cpu().numpy().view(np.uint32)
    out: dict[tuple[int, int], int] = {}
    for i, j in zip(*np.nonzero(sub)):
        out[(int(i), int(j))] = int(sub[i, j])
    if start in g.nullable:
        for m in range(n):
            c = out.get((m, m), 0)
            out[(m, m)] = c + 1 if c < int(SAT_COUNT) else int(SAT_COUNT)
    return out
