"""Transitive-closure fixpoint engines (Algorithm 1 of the paper), in torch.

The port of ``repro.core.closure``.  The paper's loop is
``while T changes: T <- T ∪ (T x T)``; only the |P| products of actual
productions ``A -> B C`` can contribute, so each engine evaluates

    new[A] |= OR_{(A->BC) in P}  T[B] ·∧∨ T[C]

as ONE batched product over the production axis (gather by B/C, OR by A).

Engines
-------
  dense_closure      0/1 matmul + ``> 0`` saturation (exact).
  frontier_closure   multiplies only the delta of the previous iteration.
  bitpacked_closure  int32 AND/OR words through ``kernels.ops.bitmm`` (the
                     hand-written CUDA kernel on the card, its plain torch
                     version for CPU tensors).
  opt_closure        the packed-exchange closure of the ``opt`` family: the
                     packed state sharded over a device mesh
                     (``repro_torch.shard.plans.MeshPlan``), one row copy
                     and one column copy exchanged per iteration, the local
                     product through ``kernels.ops.bitmm``; ``plan=None`` is
                     the same math on one device.
  masked_*           source-restricted variants of the three, and of opt: a
                     row mask M seeded with the requested sources, at most R
                     active rows per iteration, ``(T, M, overflowed)``
                     returned.
  masked_*repair*    delta repair: masked variants that take a frozen-row
                     mask (rows trusted exact, contracted against but never
                     written); the packed one runs its step through
                     ``kernels.ops.bitmm_or``.
  reverse_reachable_mask  the ancestor sweep that sizes a repair.

Every engine is a Python loop that reads one "grew" flag on the host per
iteration (the reference runs ``lax.while_loop`` on the device).  Inputs
are never modified: each call copies its state once and updates the copy
in place.  The invariants of the reference hold unchanged — masked-row
exactness at the fixpoint and monotone warm restarts (see
``repro.core.closure``); the tests hold every engine bit-equal to its
reference counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.shard.plans import LocalPlan, ShardedState

from .matrices import ProductionTables, pack_bits, unpack_bits


def _mat_dtype(device: torch.device) -> torch.dtype:
    # bf16 on the card (the tensor cores' type) and on ``meta``, which
    # stands in for it in the dry run; fp32 on the CPU, where bf16 matmul
    # is slow — as the reference uses bf16 on the TPU only.
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def _bool_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched Boolean matmul by saturation: ``(A @ B) > 0``.

    Exact for 0/1 operands in bf16, and under cuBLAS's reduced-precision
    bf16 reduction too: the products are fp32-accumulated, and every term
    is non-negative, so a sum that is at least 1 can never round to 0."""
    dt = _mat_dtype(lhs.device)
    return torch.matmul(lhs.to(dt), rhs.to(dt)) > 0


def _scatter_or(prod: torch.Tensor, tables: ProductionTables) -> torch.Tensor:
    """OR per-production results into their LHS slot, (P, …) -> (N, …).

    One function for the reference's ``_scatter_or_bool`` and
    ``_scatter_or_packed``: ``|`` is the OR of bool planes and of packed
    int32 words alike (the reference's bool ``max`` would drop packed
    words with bit 31 set once they are signed)."""
    out = prod.new_zeros((tables.n_nonterms, *prod.shape[1:]))
    for p, a in enumerate(tables.a_idx):
        out[a] |= prod[p]
    return out


def _iter_limit(T: torch.Tensor, max_iters: int | None) -> int:
    # Thm. 3 bounds iterations by |V|^2 |N| = n^2 N.  The loops stop on
    # "no growth", so this limit is only a divergence guard; a tighter guess
    # can truncate before the fixpoint on deep-derivation inputs.
    n = T.shape[-1]
    return max_iters if max_iters is not None else n * n * T.shape[0]


def _masked_limit(T: torch.Tensor, max_iters: int | None) -> int:
    # the mask can grow for at most n extra iterations beyond the T bound
    return _iter_limit(T, max_iters) + T.shape[-1]


def dense_step(T: torch.Tensor, tables: ProductionTables) -> torch.Tensor:
    """One fixpoint iteration ``T | (T x T)``: the roofline unit of
    Algorithm 1 (the reference's ``dense_step``)."""
    b_idx, c_idx = tables.index_tensors(T.device)
    return T | _scatter_or(_bool_matmul(T[b_idx], T[c_idx]), tables)


def frontier_step(T: torch.Tensor, D: torch.Tensor, tables: ProductionTables):
    """One iteration of :func:`frontier_closure` from the state ``T`` and
    the entries ``D`` the previous one added: ``(T | new, new & ~T)``."""
    b_idx, c_idx = tables.index_tensors(T.device)
    left = _bool_matmul(T[b_idx], D[c_idx])
    right = _bool_matmul(D[b_idx], T[c_idx])
    new = _scatter_or(left | right, tables)
    return T | new, new & ~T


def dense_closure(
    T: torch.Tensor, tables: ProductionTables, max_iters: int | None = None
) -> torch.Tensor:
    """T^cf by the matmul path.  ``T`` is (N, n, n) bool."""
    if tables.n_prods == 0:
        return T
    b_idx, c_idx = tables.index_tensors(T.device)
    limit = _iter_limit(T, max_iters)
    T = T.clone()
    it = 0
    while it < limit:
        new = _scatter_or(_bool_matmul(T[b_idx], T[c_idx]), tables)
        grew = bool((new & ~T).any())
        T |= new
        it += 1
        if not grew:
            break
    return T


def frontier_closure(
    T: torch.Tensor, tables: ProductionTables, max_iters: int | None = None
) -> torch.Tensor:
    """Incremental closure: entering an iteration, ``D`` holds exactly the
    entries added in the previous one, so only ``T·D ∪ D·T`` can produce
    anything new.  Same fixpoint as :func:`dense_closure`."""
    if tables.n_prods == 0:
        return T
    limit = _iter_limit(T, max_iters)
    D = T.clone()
    it = 0
    while it < limit and bool(D.any()):
        T, D = frontier_step(T, D, tables)
        it += 1
    return T


def bitpacked_closure(
    T: torch.Tensor, tables: ProductionTables, max_iters: int | None = None
) -> torch.Tensor:
    """T^cf on int32-packed columns; the state never leaves the packed layout.

    For a production A -> B C the lhs T[B] needs its contraction axis (its
    columns) packed and the rhs T[C] its output axis (also its columns)
    packed — both are exactly the stored layout."""
    if tables.n_prods == 0:
        return T
    b_idx, c_idx = tables.index_tensors(T.device)
    n = T.shape[-1]
    limit = _iter_limit(T, max_iters)
    Tp = pack_bits(T)  # (N, n, w) int32
    it = 0
    while it < limit:
        prod = kops.bitmm(Tp[b_idx], Tp[c_idx])  # (P, n, w)
        Tp_next = Tp | _scatter_or(prod, tables)
        grew = bool((Tp_next != Tp).any())
        Tp = Tp_next
        it += 1
        if not grew:
            break
    return unpack_bits(Tp, n)


# ---------------------------------------------------------------------- #
# Source-restricted (masked) closure engines.
#
# Row i of T^cf depends only on rows reachable from i, so these engines
# keep a row mask M seeded with the requested sources, contract the first
# R active rows per iteration, expand M with every column an active row
# reaches, and stop with ``overflowed=True`` when M outgrows R — the caller
# re-enters with a larger capacity from the returned (T, M); the fixpoint is
# monotone, so no work is lost.  R (``row_capacity``) keeps the reference's
# fixed shapes: the active block is always R rows, padded with zero rows.
# ---------------------------------------------------------------------- #


def _active_rows(M: torch.Tensor, R: int) -> tuple[torch.Tensor, int]:
    """First R set rows of the mask: ``(idx (R,), count)``.

    Lanes ``count..R`` of ``idx`` are padding (row 0), as in the reference;
    callers zero those lanes' operands and scatter back only the valid
    prefix ``idx[:count]``, whose rows are distinct."""
    idx = torch.nonzero(M).flatten()[:R]
    count = idx.numel()
    if count < R:
        idx = torch.cat([idx, idx.new_zeros(R - count)])
    return idx, count


def _masked_init(T, tables, row_capacity, max_iters):
    n = T.shape[-1]
    b_idx, c_idx = tables.index_tensors(T.device)
    return min(row_capacity, n), b_idx, c_idx, _masked_limit(T, max_iters)


def _all_rows(T: torch.Tensor):
    """(T, M, overflowed) of a grammar without binary productions:
    T^cf == T0, so every row is already exact."""
    n = T.shape[-1]
    return T, torch.ones((n,), dtype=torch.bool, device=T.device), False


def _reach(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: the columns set in any of the packed ``rows`` (N, R, w):
    their words ORed over the nonterminals, then any() over the rows."""
    words = rows[0].clone()
    for a in range(1, rows.shape[0]):
        words |= rows[a]
    return unpack_bits(words, n).any(dim=0)


def masked_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted closure on the dense matmul path.

    ``src_mask`` is an (n,) bool row seed.  Returns ``(T, M, overflowed)``;
    rows of ``T`` where ``M`` is set equal the all-pairs closure rows iff
    ``overflowed`` is False (otherwise re-enter with the returned state and
    a larger ``row_capacity``).  ``iter_hook(it, active_rows, changed,
    overflow)`` is called after every iteration when given.
    """
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    T = T.clone()
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        rows = T[:, idx, :]  # (N, R, n) active rows
        rows[:, cnt:] = False
        # compact the contraction axis too: only rows in M can contribute
        lhs = rows[b_idx][:, :, idx]  # (P, R, R)
        lhs[:, :, cnt:] = False
        prod = _bool_matmul(lhs, rows[c_idx])  # (P, R, n)
        new_r = _scatter_or(prod, tables)[:, :cnt]
        vidx = idx[:cnt]
        old = T[:, vidx, :]
        changed = new_r & ~old
        T[:, vidx, :] = old | new_r
        M_next = M | rows.any(dim=1).any(dim=0)  # columns reached -> rows
        overflow = int(M_next.sum()) > R
        grew = bool(changed.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed.sum()), overflow)
        M = M_next
        it += 1
    return T, M, overflow


def masked_frontier_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Masked closure with the frontier (delta) trick: only products through
    entries discovered in the previous iteration are formed, and rows newly
    admitted to the mask enter the delta with their base edges."""
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    T = T.clone()
    M = src_mask.clone()
    D = T & M[None, :, None]
    overflow, it = False, 0
    while bool(D.any()) and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        rows_t = T[:, idx, :]
        rows_t[:, cnt:] = False
        rows_d = D[:, idx, :]
        rows_d[:, cnt:] = False
        lhs_t = rows_t[b_idx][:, :, idx]
        lhs_t[:, :, cnt:] = False
        lhs_d = rows_d[b_idx][:, :, idx]
        lhs_d[:, :, cnt:] = False
        prod = _bool_matmul(lhs_t, rows_d[c_idx]) | _bool_matmul(
            lhs_d, rows_t[c_idx]
        )
        new_r = _scatter_or(prod, tables)[:, :cnt]
        vidx = idx[:cnt]
        old = T[:, vidx, :]
        changed = new_r & ~old
        M_next = M | rows_t.any(dim=1).any(dim=0)
        newly = M_next & ~M  # rows activated now: their base edges are fresh
        D = T & newly[None, :, None]
        D[:, vidx, :] |= changed
        T[:, vidx, :] = old | new_r
        overflow = int(M_next.sum()) > R
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed.sum()), overflow)
        M = M_next
        it += 1
    return T, M, overflow


def masked_bitpacked_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Source-restricted closure on packed words via the rectangular bitmm
    path: lhs is the (P, R, w) gather of active rows, rhs the full (P, n, w)
    packed state (contraction against base-only rows is sound — their
    entries are a subset of the true closure — and speeds convergence)."""
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    n = T.shape[-1]
    Tp = pack_bits(T)  # (N, n, w)
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        rows = Tp[:, idx, :]  # (N, R, w)
        rows[:, cnt:] = 0
        prod = kops.bitmm(rows[b_idx], Tp[c_idx])  # (P, R, w)
        new_r = _scatter_or(prod, tables)[:, :cnt]
        vidx = idx[:cnt]
        old = Tp[:, vidx, :]
        upd = old | new_r
        changed_w = upd != old  # changed words (packed growth unit)
        Tp[:, vidx, :] = upd
        # packed columns reached from active rows
        M_next = M | _reach(rows, n)
        overflow = int(M_next.sum()) > R
        grew = bool(changed_w.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed_w.sum()), overflow)
        M = M_next
        it += 1
    return unpack_bits(Tp, n), M, overflow


# ---------------------------------------------------------------------- #
# The opt family: packed-exchange closures over a device mesh.
#
# The persistent state stays packed (int32 words, N x n x w) and is sharded
# over (rows, words) by a MeshPlan; each iteration exchanges ONE row copy
# (the rank's rows, every word: all-gathered over ``model``) and ONE column
# copy (every row, the rank's words: all-gathered over the row axis), and
# the rank's product ``bitmm(row_copy[B], col_copy[C])`` is exactly its own
# block of the state.  The reference unpacks both copies to int8 for the
# TPU's int8 MXU; here the hand-written bitmm reads the packed words the
# exchange moved.  Every rank reads one "grew" flag per iteration from a
# MAX all-reduce, so all ranks loop alike and issue the same collectives.
# With ``plan`` a MeshPlan the closures return a ShardedState (the state
# stays where it lives; ``repro_torch.delta.repair.localize_state`` gathers
# it); with ``plan=None`` they run LocalPlan, the same math on one device
# with no collective, and return tensors.
# ---------------------------------------------------------------------- #


def _shard_state(T, lay, packed: bool) -> torch.Tensor:
    """This rank's block of the persistent state: packed words of a Boolean
    ``T`` (``packed``), or f32 lengths; ``T`` a tensor, or a ShardedState of
    the same layout (its block is copied, else it is gathered first)."""
    if isinstance(T, ShardedState):
        if T.packed == packed and T.plan.same_layout(lay):
            return T.local.clone()
        T = T.full()
    return lay.shard(pack_bits(T) if packed else T, 0 if packed else float("inf"))


def _unshard(local, n, plan, packed: bool):
    if plan is None:
        return unpack_bits(local, n) if packed else local
    return ShardedState(local, n, plan, packed)


def _grew_anywhere(lay, changed: torch.Tensor) -> bool:
    return bool(lay.any_world(changed.to(torch.int32).reshape(1)).item())


def _opt_step(Tp, tables, b_idx, c_idx, n: int, lay):
    """One iteration on this rank's block: ``(Tp | new, changed here)``."""
    row_copy = lay.row_copy(Tp, -(-n // 32))  # (N, rows_loc, w)
    col_copy = lay.col_copy(Tp, n)  # (N, n, w_loc)
    new = _scatter_or(kops.bitmm(row_copy[b_idx], col_copy[c_idx]), tables)
    Tp_next = Tp | new
    return Tp_next, (Tp_next != Tp).any()


def opt_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    max_iters: int | None = None,
    plan=None,
):
    """T^cf with one packed exchange per iteration and the local product on
    ``kernels.ops.bitmm``.  ``T`` (N, n, n) bool (or a ShardedState of a
    Boolean state); returns the closure, a ShardedState under a plan."""
    if tables.n_prods == 0:
        return T
    lay = plan if plan is not None else LocalPlan()
    b_idx, c_idx = tables.index_tensors(T.device)
    n = T.shape[-1]
    limit = _iter_limit(T, max_iters)
    Tp = _shard_state(T, lay, packed=True)  # (N, rows_loc, w_loc)
    it = 0
    while it < limit:
        Tp, changed = _opt_step(Tp, tables, b_idx, c_idx, n, lay)
        it += 1
        if not _grew_anywhere(lay, changed):
            break
    return _unshard(Tp, n, plan, packed=True)


def opt_step(T_packed, tables: ProductionTables, n: int, plan=None):
    """One :func:`opt_closure` iteration on the packed state ``T_packed``
    (N, n, w) int32, or a ShardedState of packed words under ``plan``
    (the roofline unit); returns the same kind."""
    lay = plan if plan is not None else LocalPlan()
    b_idx, c_idx = tables.index_tensors(T_packed.device)
    if isinstance(T_packed, ShardedState):
        Tp = T_packed.local
    else:
        Tp = lay.shard(T_packed, 0)
    Tp, _ = _opt_step(Tp, tables, b_idx, c_idx, n, lay)
    return Tp if plan is None else ShardedState(Tp, n, plan, packed=True)


def masked_opt_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    plan=None,
):
    """Source-restricted closure on the packed-exchange path: the sharded
    sibling of :func:`masked_bitpacked_closure`.

    Per iteration the compacted active rows are gathered from their owners
    (each rank keeps its words), each row rank takes its share of them and
    all-gathers their words over ``model`` (the row copy), the column copy
    of the whole state is all-gathered over the row axis, and the rank's
    ``bitmm`` product is its lanes x words of the new rows, which go back
    to their owners (``MeshPlan.scatter_rows``).  ``M`` grows by the
    columns the gathered rows reach (their words ORed over the nonterminals
    and lanes, unpacked); reach and the grew flag travel in one MAX
    all-reduce.  Returns ``(T, M, overflowed)`` as the other masked
    closures, ``T`` a ShardedState under a plan; rows already at their
    fixpoint come back bit-identical on every mesh shape.  No
    ``iter_hook``: the reference's opt closures have none."""
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    lay = plan if plan is not None else LocalPlan()
    n = T.shape[-1]
    w = -(-n // 32)
    Tp = _shard_state(T, lay, packed=True)  # (N, rows_loc, w_loc)
    w_loc = Tp.shape[-1]
    c0 = lay.model_rank * w_loc * 32  # first column of this rank's words
    M = src_mask.clone()
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        if cnt == 0:
            break
        vidx = idx[:cnt]
        kp = lay.lanes_per(cnt)
        rows = lay.gather_rows(Tp, vidx, kp * lay.row_size, n)  # (N, K, w_loc)
        share = rows[:, lay.row_rank * kp:(lay.row_rank + 1) * kp]
        row_copy = lay.row_copy(share, w)  # (N, kp, w): rows local
        col_copy = lay.col_copy(Tp, n)  # (N, n, w_loc): words local
        new = _scatter_or(kops.bitmm(row_copy[b_idx], col_copy[c_idx]), tables)
        changed = lay.scatter_rows(Tp, vidx, share | new, n)
        # columns reached from active rows, and the grew flag: one MAX
        flags = torch.zeros(lay.model_size * w_loc * 32 + 1, dtype=torch.int32,
                            device=Tp.device)
        flags[c0:c0 + w_loc * 32] = _reach(rows, w_loc * 32)
        flags[-1] = changed
        flags = lay.any_world(flags)
        M_next = M | flags[:n].bool()
        overflow = int(M_next.sum()) > R
        grew = bool(flags[-1]) or bool((M_next & ~M).any())
        M = M_next
        it += 1
    return _unshard(Tp, n, plan, packed=True), M, overflow


# ---------------------------------------------------------------------- #
# Reverse-reachability sweep and repair closures (delta repair; the
# reference's DELTA.md and ``repro.core.closure`` explain the contract).
#
# An edge edit at row u can only change closure rows that REACH u; the
# sweep computes that ancestor set.  A repair warm-starts from a cached
# state in which most rows are already exact ("frozen"): frozen rows are
# contracted against as constants but never recomputed or written, and
# mask expansion skips them, so the row capacity is sized by the edit's
# blast radius.  At the fixpoint, rows under the returned M are exact and
# frozen rows are bit-identical to their input.
# ---------------------------------------------------------------------- #


def reverse_reachable_mask(
    adj: torch.Tensor, seeds: torch.Tensor, max_iters: int | None = None
) -> torch.Tensor:
    """Rows that can reach a seed row over ``adj`` (seeds included).

    ``adj`` is the (n, n) bool label-blind adjacency, ``seeds`` an (n,)
    bool mask.  Fixpoint of ``m <- m | adj @ m``: each step adds the direct
    predecessors of the set, so it converges within the graph's diameter."""
    n = adj.shape[-1]
    limit = max_iters if max_iters is not None else n
    dt = _mat_dtype(adj.device)
    a = adj.to(dt)
    m = seeds.clone()
    grew, it = True, 0
    while grew and it < limit:
        hit = torch.matmul(a, m.to(dt)[:, None])[:, 0] > 0
        m_next = m | hit
        grew = bool((m_next & ~m).any())
        m = m_next
        it += 1
    return m


def masked_repair_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    frozen_mask: torch.Tensor,
    row_capacity: int = 128,
    ctx_capacity: int | None = None,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Dense-path repair fixpoint (the frontier backend's too).

    ``src_mask`` seeds the rows to rebuild; rows under ``frozen_mask`` are
    trusted exact and never recomputed, but join the compacted contraction
    context (at most ``ctx_capacity`` rows, active plus frozen).  Returns
    ``(T, M, overflowed)`` with ``M`` the rebuilt rows; overflow fires when
    the active set outgrows ``row_capacity`` or the context outgrows
    ``ctx_capacity``."""
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    n = T.shape[-1]
    C = min(ctx_capacity if ctx_capacity is not None else n, n)
    T = T.clone()
    M = src_mask & ~frozen_mask
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        cidx, ccnt = _active_rows(M | frozen_mask, C)
        rows = T[:, idx, :]  # (N, R, n) active rows
        rows[:, cnt:] = False
        ctx = T[:, cidx, :]  # (N, C, n) context: active and frozen rows
        ctx[:, ccnt:] = False
        lhs = rows[b_idx][:, :, cidx]  # (P, R, C)
        lhs[:, :, ccnt:] = False
        prod = _bool_matmul(lhs, ctx[c_idx])  # (P, R, n)
        new_r = _scatter_or(prod, tables)[:, :cnt]
        vidx = idx[:cnt]  # never frozen: M excludes frozen rows
        old = T[:, vidx, :]
        changed = new_r & ~old
        T[:, vidx, :] = old | new_r
        reach = rows.any(dim=1).any(dim=0)
        M_next = M | (reach & ~frozen_mask)
        overflow = int(M_next.sum()) > R or int((M_next | frozen_mask).sum()) > C
        grew = bool(changed.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed.sum()), overflow)
        M = M_next
        it += 1
    return T, M, overflow


def masked_bitpacked_repair_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask: torch.Tensor,
    frozen_mask: torch.Tensor,
    row_capacity: int = 128,
    max_iters: int | None = None,
    iter_hook=None,
):
    """Packed-word analog of :func:`masked_repair_closure`: like
    :func:`masked_bitpacked_closure` it contracts the active rows against
    the full packed state, and mask expansion skips frozen rows.

    The step is one fused ``kops.bitmm_or``: lhs the active rows of each
    production's B, rhs the packed state of its C, acc the active rows of
    its A — so every output plane is already ``rows[A] | (B x C)``.  The
    OR over productions then writes back only the valid prefix of the
    active rows, and only the planes of nonterminals that head a
    production (a scatter-``max`` on int32 words would drop those with bit
    31 set)."""
    if tables.n_prods == 0:
        return _all_rows(T)
    R, b_idx, c_idx, limit = _masked_init(T, tables, row_capacity, max_iters)
    a_idx = torch.tensor(tables.a_idx, dtype=torch.int64, device=T.device)
    heads = torch.tensor(
        sorted(set(tables.a_idx)), dtype=torch.int64, device=T.device
    )
    n = T.shape[-1]
    Tp = pack_bits(T)  # (N, n, w)
    M = src_mask & ~frozen_mask
    grew, overflow, it = True, False, 0
    while grew and not overflow and it < limit:
        idx, cnt = _active_rows(M, R)
        rows = Tp[:, idx, :]  # (N, R, w)
        rows[:, cnt:] = 0
        out = kops.bitmm_or(rows[b_idx], Tp[c_idx], rows[a_idx])  # (P, R, w)
        upd = _scatter_or(out, tables)[heads, :cnt]  # (H, cnt, w)
        vidx = idx[:cnt]  # never frozen: M excludes frozen rows
        changed_w = upd != rows[heads, :cnt]
        Tp[heads[:, None], vidx[None, :]] = upd
        M_next = M | (_reach(rows, n) & ~frozen_mask)
        overflow = int(M_next.sum()) > R
        grew = bool(changed_w.any()) or bool((M_next & ~M).any())
        if iter_hook is not None:
            iter_hook(it + 1, int(M_next.sum()), int(changed_w.sum()), overflow)
        M = M_next
        it += 1
    return unpack_bits(Tp, n), M, overflow
