"""Tiled block-sparse bitpacked closure state (``engine="blocksparse"``).

The dense engines materialize the full (N, n, n) Boolean tensor — the
stated scale ceiling of the dense backends: real CFPQ workloads are
sparse, and at n in the 10^5–10^6 range dense padding is unpayable (at a
million nodes the Boolean state of Query 1 would take terabytes).  This
module stores the closure as a **per-nonterminal active-block list over
fixed B×B bit-tiles**, as the reference's ``repro.core.blocksparse`` does:

* A tile is the (B, B) Boolean submatrix of one nonterminal at block
  coordinates ``(rb, cb)``, bitpacked along columns into ``(B, B//32)``
  int32 words (exactly :func:`repro_torch.core.matrices.pack_bits` order:
  bit ``b`` of word ``w`` is column ``32w + b``).
* All occupied tiles of all nonterminals live slot-compacted in ONE
  device tensor ``tiles (S, B, B//32)``; a host-side index
  ``index[a][rb][cb] -> slot`` is the active-block list.  Materialized
  state is therefore O(occupied blocks), never O(n²).

The fixpoint is **host-driven**: block discovery (which (row-block,
k-block)×(k-block, col-block) pairs have occupied operands) is dynamic
sparsity, so a Python driver enumerates the occupied pairs — that
enumeration IS the block skipping — and hands each bucket of pairs to one
contraction step (:func:`_contract_chunk`): on the card one launch of the
hand-written tile kernel (:func:`repro_torch.kernels.ops.tile_contract_chunk`),
which gathers the operand tiles by slot, multiplies them, ORs each
product and the old tile into its output block and sets per-block change
flags, brought to the host once per chunk.  Newly occupied blocks and
changed blocks feed the next iteration's frontier; pairs whose operands
both went unchanged are never re-contracted.  Each chunk scatters before the next gathers
(Gauss–Seidel order), exactly as the reference does, so overflow partial
states and iteration counts match it.

Masking is block-granular: the active set is a set of row-*blocks*,
expanded along occupied blocks exactly like the row engines expand M —
the returned mask covers every row of every active block, which at
fixpoint is sound *and* exact (an inactive block's rows have no base
facts, hence empty closure rows).  Capacity is counted in **slots**
(occupied blocks): overflow returns the monotone partial state for the
engine's warm-restart ladder; a capacity of at least ``n`` is treated as
unbounded (the top of the ladder).

The wrappers speak the masked-engine contract of core/closure.py
(``(T, tables, src_mask[, frozen_mask]) -> (T, M, overflow)`` on dense
tensors) so ``engine="blocksparse"`` drops into the PlanKey/service
machinery unchanged; they compact ``T`` and expand the result on ``T``'s
device with torch ops.  :func:`blocksparse_closure_state` builds the state
straight from the edge list (:meth:`BlockSparseState.from_graph`) for the
million-node path where the dense tensor must never exist.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref

from .grammar import CNFGrammar
from .graph import Graph
from .matrices import (
    ProductionTables,
    pack_bits,
    padded_size,
    resolve_device,
    unpack_bits,
)

#: default tile edge; must be a multiple of 32 and divide the padded n
#: (the padded sizes are multiples of 128, so 32/64/128 always fit).
DEFAULT_TILE = 128

#: pairs contracted per device call — bounds the per-call index buffers
#: and the plain version's unpacked (chunk, B, B) intermediates regardless
#: of how many occupied pairs one iteration discovers.
PAIR_CHUNK = 512

#: slot-store capacities and per-call bucket sizes are padded to powers of
#: two from this floor (the reference's jit buckets; kept so slot stores,
#: pad pairs and overflow points are the reference's).
_MIN_BUCKET = 8


def _pow2_at_least(x: int, floor: int = _MIN_BUCKET) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


def _as_tensor(T) -> torch.Tensor:
    """A torch tensor as it is; an array-like (a numpy array, which may be
    read-only) copied into a CPU tensor."""
    if isinstance(T, torch.Tensor):
        return T
    return torch.from_numpy(np.array(T))


def _blocks(T: torch.Tensor, tile: int) -> torch.Tensor:
    """(N, n, n) -> the (N, g, B, g, B) view of its B×B blocks."""
    N, n = T.shape[0], T.shape[-1]
    g = n // tile
    return T.reshape(N, g, tile, g, tile)


def occupied_block_count(T, tile: int = DEFAULT_TILE) -> int:
    """Occupied B×B blocks of a dense (N, n, n) Boolean tensor (a torch
    tensor, counted on its device, or a numpy array) — the obs gauge
    behind ``blocksparse_occupied_blocks``."""
    T = _as_tensor(T)
    n = T.shape[-1]
    if n % tile:
        raise ValueError(f"matrix size {n} is not a multiple of tile {tile}")
    return int(_blocks(T, tile).any(4).any(2).sum())


def occupied_blocks_of_edges(
    n_nodes: int, edges, tile: int = DEFAULT_TILE
) -> int:
    """Distinct (i//B, j//B) block coordinates touched by an edge list —
    the label-blind base-graph occupancy estimate the planner prices
    ``engine="blocksparse"`` with (O(E), no matrix materialized)."""
    g = max(-(-n_nodes // tile), 1)
    return len({(i // tile) * g + (j // tile) for i, _, j in edges})


class BlockSparseState:
    """Slot-compacted block-sparse bitpacked closure state.

    Host-mutable (the fixpoint driver owns it single-threaded); only the
    tile payload lives on the device.  Slots are monotone: bits are only
    ever OR-ed in, and a slot, once allocated, keeps its (a, rb, cb)
    identity for the state's lifetime — which is what makes overflow
    returns safe warm-restart points.
    """

    __slots__ = ("n", "tile", "grid", "n_nonterms", "tiles", "coords", "index")

    def __init__(
        self,
        n: int,
        n_nonterms: int,
        tile: int = DEFAULT_TILE,
        device: str | torch.device = "cuda",
    ):
        if tile <= 0 or tile % 32:
            raise ValueError(f"tile must be a positive multiple of 32: {tile}")
        if n % tile:
            raise ValueError(f"matrix size {n} is not a multiple of tile {tile}")
        self.n = n
        self.tile = tile
        self.grid = n // tile
        self.n_nonterms = n_nonterms
        self.tiles = torch.zeros(
            (_MIN_BUCKET, tile, tile // 32), dtype=torch.int32,
            device=resolve_device(device),
        )
        self.coords: list[tuple[int, int, int]] = []  # slot -> (a, rb, cb)
        self.index: list[dict[int, dict[int, int]]] = [
            {} for _ in range(n_nonterms)
        ]

    # ------------------------------------------------------------------ #
    @property
    def n_slots(self) -> int:
        return len(self.coords)

    @property
    def occupied(self) -> int:
        """Occupied blocks == live slots (zero tiles are never allocated:
        the driver checks products for nonzero before slotting them)."""
        return len(self.coords)

    def nbytes(self) -> int:
        """Materialized tile payload in bytes (∝ occupied blocks)."""
        return self.n_slots * self.tile * (self.tile // 32) * 4

    def alloc_slot(self, a: int, rb: int, cb: int) -> int:
        """Reserve the next slot for block (a, rb, cb), growing the device
        store to the next power-of-two capacity when full.  The tile
        content is whatever the caller scatters in afterwards."""
        slot = len(self.coords)
        cap = self.tiles.shape[0]
        if slot >= cap:
            grown = self.tiles.new_zeros(
                (_pow2_at_least(slot + 1), self.tile, self.tile // 32)
            )
            grown[:cap] = self.tiles
            self.tiles = grown
        self.coords.append((a, rb, cb))
        self.index[a].setdefault(rb, {})[cb] = slot
        return slot

    def _set_slots(self, keys, payload: torch.Tensor) -> None:
        """Slot the blocks ``keys`` (sorted (a, rb, cb)) with their packed
        tiles ``payload``, into a power-of-two store on payload's device."""
        for slot, (a, rb, cb) in enumerate(keys):
            self.coords.append((a, rb, cb))
            self.index[a].setdefault(rb, {})[cb] = slot
        buf = payload.new_zeros(
            (_pow2_at_least(len(keys)), self.tile, self.tile // 32)
        )
        buf[: len(keys)] = payload
        self.tiles = buf

    # ------------------------------------------------------------------ #
    @classmethod
    def from_dense(cls, T, tile: int = DEFAULT_TILE) -> "BlockSparseState":
        """Compact a dense (N, n, n) Boolean tensor on its device (only
        occupied blocks are packed and slotted, in (a, rb, cb) order)."""
        T = _as_tensor(T)
        state = cls(T.shape[-1], T.shape[0], tile, device=T.device)
        blocks = _blocks(T, tile)
        nz = torch.nonzero(blocks.any(4).any(2))  # (S, 3), row-major order
        if nz.shape[0]:
            a, rb, cb = nz.unbind(1)
            payload = pack_bits(blocks[a, rb, :, cb, :])  # (S, B, B//32)
            state._set_slots(
                [tuple(k) for k in nz.cpu().tolist()], payload
            )
        return state

    @classmethod
    def from_graph(
        cls,
        graph: Graph,
        g: CNFGrammar,
        tile: int = DEFAULT_TILE,
        pad_to: int | None = None,
        device: str | torch.device = "cuda",
    ) -> "BlockSparseState":
        """Base state straight from the edge list — O(E) work and
        O(occupied blocks) memory, never materializing the dense tensor.
        Slots are in sorted (a, rb, cb) order, as the reference numbers
        them.  At n ≫ 10^4 this is the only affordable entry point."""
        n = pad_to if pad_to is not None else padded_size(graph.n_nodes)
        state = cls(n, g.n_nonterms, tile, device)
        # one (a, i, j) fact per edge (i, x, j) and production A -> x
        a_l, i_l, j_l = [], [], []
        if graph.edges:
            src, lab, dst = zip(*graph.edges)
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            labels = np.asarray(lab, dtype=object)
            for x, prods in g.term_prods.items():
                hit = labels == x
                if prods and hit.any():
                    for a in prods:
                        a_l.append(np.full(int(hit.sum()), a, dtype=np.int64))
                        i_l.append(src[hit])
                        j_l.append(dst[hit])
        if not a_l:
            return state
        a, i, j = (np.concatenate(v) for v in (a_l, i_l, j_l))
        G, W = state.grid, tile // 32
        keys, slot = np.unique(
            (a * G + i // tile) * G + j // tile, return_inverse=True
        )
        r, c = i % tile, j % tile
        words = np.zeros(len(keys) * tile * W, dtype=np.uint32)
        np.bitwise_or.at(
            words, (slot * tile + r) * W + c // 32,
            np.left_shift(np.uint32(1), (c % 32).astype(np.uint32)),
        )
        payload = torch.from_numpy(words.view(np.int32)).view(-1, tile, W)
        coords = [
            (int(k // (G * G)), int(k // G % G), int(k % G)) for k in keys
        ]
        state._set_slots(coords, payload.to(state.tiles.device))
        return state

    def to_dense(self) -> torch.Tensor:
        """Expand back to the dense (N, n, n) Boolean tensor on the store's
        device (the masked engine contract speaks dense; the scale path
        never calls this)."""
        out = torch.zeros(
            (self.n_nonterms, self.n, self.n), dtype=torch.bool,
            device=self.tiles.device,
        )
        if self.coords:
            a, rb, cb = torch.tensor(
                self.coords, dtype=torch.int64, device=out.device
            ).unbind(1)
            _blocks(out, self.tile)[a, rb, :, cb, :] = unpack_bits(
                self.tiles[: self.n_slots], self.tile
            )
        return out

    def pairs_for(
        self, a: int, i: int, nonterm_rows: bool = False
    ) -> set[tuple[int, int]]:
        """Debug/bench helper: nonzero (i, j) pairs of nonterminal ``a``
        (all rows when ``nonterm_rows``; row ``i`` otherwise) read from
        the packed tiles without densifying the whole state."""
        out: set[tuple[int, int]] = set()
        B = self.tile
        for rb, row in self.index[a].items():
            if not nonterm_rows and rb != i // B:
                continue
            slots = list(row.values())
            bits = unpack_bits(self.tiles[slots], B).cpu().numpy()
            for cb, blk in zip(row, bits):
                rows = range(B) if nonterm_rows else [i % B]
                for r in rows:
                    for c in np.nonzero(blk[r])[0]:
                        out.add((rb * B + r, cb * B + int(c)))
        return out


# ---------------------------------------------------------------------- #
# The contraction step: one bucket of occupied tile pairs.
# ---------------------------------------------------------------------- #


def _contract_chunk(
    tiles: torch.Tensor,  # (S, B, Bw) int32 slot store
    l_idx: torch.Tensor,  # (p,) int32 lhs slot per pair (pad: 0)
    r_idx: torch.Tensor,  # (p,) int32 rhs slot per pair (pad: 0)
    seg: torch.Tensor,  # (p,) int32 output segment per pair (pad: n_out)
    out_slot: torch.Tensor,  # (n_out,) int32 existing slot per output (or 0)
    out_exists: torch.Tensor,  # (n_out,) int32 or bool — out_slot valid?
    n_out: int,
    use_kernel: bool,
    work=None,
):
    """OR of per-pair tile products per output block, merged with the
    existing tile: returns ``(new (n_out, B, Bw), flags)`` on the store's
    device, ``flags`` an int32 vector ``(2m + 1,)``: the changed flag of
    output ``s`` at ``s``, its nonzero flag at ``m + s``, and a fault word
    last (see :func:`repro_torch.kernels.ops.tile_contract_chunk`).  Pad
    pairs point at segment ``n_out`` (dropped); pad outputs simply come
    back all-zero/unchanged.  ``use_kernel`` runs
    :func:`ops.tile_contract_chunk` (on the card one launch of the CUDA
    kernel into ``work``, which does the gather of the old tiles and the
    flags too), whose fault word flags a pair out of range; else the plain
    :func:`ref.tile_contract_chunk_ref`, whose fault word is 0."""
    if use_kernel:
        return _kops.tile_contract_chunk(
            tiles, l_idx, r_idx, seg, out_slot, out_exists, n_out, work
        )
    return _kref.tile_contract_chunk_ref(
        tiles, l_idx, r_idx, seg, out_slot, out_exists, n_out
    )


# ---------------------------------------------------------------------- #
# The host-driven fixpoint.
# ---------------------------------------------------------------------- #


def _activate(
    state: BlockSparseState,
    blk: int,
    active: set[int],
    to_expand: list[int],
    frontier: set[int],
) -> None:
    """Bring row-block ``blk`` into the active set: queue its occupied
    columns for reachability expansion and put its slots on the frontier —
    their lhs pairs have never been contracted under this mask, so the
    frontier filter must not skip them."""
    active.add(blk)
    to_expand.append(blk)
    for idx_a in state.index:
        row = idx_a.get(blk)
        if row:
            frontier.update(row.values())


def _chunk_operands(state: BlockSparseState, chunk, device):
    """The index operands of one chunk of ``(ls, rs, (a, rb, cb))`` pairs,
    padded to powers of two as the reference pads them, moved to the
    device in one copy.  Returns ``(out_keys, out_exists (host), out_slot
    (host), device tensors l_idx, r_idx, seg, out_slot, out_exists (int32
    0/1))``."""
    key_ids: dict[tuple[int, int, int], int] = {}
    seg = [key_ids.setdefault(k, len(key_ids)) for _, _, k in chunk]
    out_keys = list(key_ids)
    n_out = _pow2_at_least(len(out_keys))
    p_pad = _pow2_at_least(len(chunk))
    buf = np.zeros(3 * p_pad + 2 * n_out, np.int32)
    l_idx = buf[:p_pad]
    r_idx = buf[p_pad : 2 * p_pad]
    seg_arr = buf[2 * p_pad : 3 * p_pad]
    out_slot = buf[3 * p_pad : 3 * p_pad + n_out]
    out_exists = buf[3 * p_pad + n_out :]
    seg_arr[:] = n_out
    p = len(chunk)
    l_idx[:p] = [ls for ls, _, _ in chunk]
    r_idx[:p] = [rs for _, rs, _ in chunk]
    seg_arr[:p] = seg
    for oi, (a, rb, cb) in enumerate(out_keys):
        s = state.index[a].get(rb, {}).get(cb)
        if s is not None:
            out_slot[oi] = s
            out_exists[oi] = 1
    dev = torch.from_numpy(buf).to(device)
    return (
        out_keys, out_exists.astype(bool), out_slot,
        dev[:p_pad], dev[p_pad : 2 * p_pad], dev[2 * p_pad : 3 * p_pad],
        dev[3 * p_pad : 3 * p_pad + n_out], dev[3 * p_pad + n_out :],
    )


def _blocksparse_fixpoint(
    state: BlockSparseState,
    tables: ProductionTables,
    active: set[int],
    to_expand: list[int],
    block_open: np.ndarray,
    capacity: int,
    max_iters: int | None,
    use_kernel: bool,
    iter_hook,
) -> bool:
    """Run the block-sparse closure to fixpoint (or the first capacity
    overflow) in place; returns the overflow flag.

    ``active``/``to_expand`` carry the seed row-blocks (see
    :func:`_activate`); ``block_open[b]`` is False for blocks whose every
    row is frozen (delta repair) — those are contracted *against* but
    never activated, the block-granular analog of the frozen-row mask.
    ``capacity`` counts slots (occupied blocks); ``capacity >= n`` means
    unbounded (the warm-restart ladder's top).
    """
    B, N = state.tile, state.n_nonterms
    device = state.tiles.device
    unbounded = capacity >= state.n
    prods = list(zip(tables.a_idx, tables.b_idx, tables.c_idx))
    # |V|^2 |N| divergence guard plus mask-expansion slack (the reference's)
    limit = (
        max_iters
        if max_iters is not None
        else state.n * state.n * N + state.n
    )
    frontier: set[int] = set(range(state.n_slots))
    # the kernel's work buffers, allocated and zeroed once (None on the CPU)
    work = _kops.tile_work(B, PAIR_CHUNK, device) if use_kernel else None
    overflow = False
    it = 0
    while it < limit:
        it += 1
        # 1. expand the active row-block set along occupied blocks (the
        # block-level analog of the masked engines' reach expansion)
        while to_expand:
            rb = to_expand.pop()
            for idx_a in state.index:
                row = idx_a.get(rb)
                if not row:
                    continue
                for cb in row:
                    if cb not in active and block_open[cb]:
                        _activate(state, cb, active, to_expand, frontier)
        if not unbounded and state.n_slots > capacity:
            overflow = True
        changed_blocks = 0
        pairs: list[tuple[int, int, tuple[int, int, int]]] = []
        if not overflow:
            # 2. enumerate occupied (row-block, k-block)×(k-block,
            # col-block) pairs — only pairs with at least one frontier
            # operand can produce new bits
            for a, b, c in prods:
                idx_b, idx_c = state.index[b], state.index[c]
                for rb in idx_b.keys() & active:
                    for kb, ls in idx_b[rb].items():
                        row_c = idx_c.get(kb)
                        if not row_c:
                            continue
                        for cb, rs in row_c.items():
                            if ls in frontier or rs in frontier:
                                pairs.append((ls, rs, (a, rb, cb)))
        if pairs:
            # 3. contract in bounded chunks; each chunk scatters before
            # the next gathers, so later pairs see earlier products
            # (Gauss–Seidel order, as the reference)
            new_frontier: set[int] = set()
            for lo in range(0, len(pairs), PAIR_CHUNK):
                chunk = pairs[lo : lo + PAIR_CHUNK]
                (out_keys, exists, out_slot, l_d, r_d, seg_d, slot_d,
                 exists_d) = _chunk_operands(state, chunk, device)
                n_out = len(out_slot)
                new_t, flags = _contract_chunk(
                    state.tiles, l_d, r_d, seg_d, slot_d, exists_d, n_out,
                    use_kernel, work,
                )
                # the chunk's one host sync: both flag vectors and the
                # kernel's fault word in one copy
                flags = flags.cpu().numpy()
                if flags[-1]:
                    raise RuntimeError(
                        "tile_contract: a pair named a slot or segment "
                        "outside its range"
                    )
                m = (len(flags) - 1) // 2
                changed, nonzero = flags[:n_out] != 0, flags[m : m + n_out] != 0
                # 4. two-phase allocation: products were computed first,
                # so all-zero results never occupy a slot
                alloc = [
                    (oi, key)
                    for oi, key in enumerate(out_keys)
                    if not exists[oi] and nonzero[oi]
                ]
                if not unbounded and state.n_slots + len(alloc) > capacity:
                    overflow = True
                    alloc = []  # keep existing-slot progress, drop growth
                rows, slots = [], []
                for oi in range(len(out_keys)):
                    if exists[oi] and changed[oi]:
                        rows.append(oi)
                        slots.append(int(out_slot[oi]))
                for oi, (a, rb, cb) in alloc:
                    rows.append(oi)
                    slots.append(state.alloc_slot(a, rb, cb))
                    # 5. newly-occupied-block detection: a fresh block may
                    # reach blocks the mask hasn't visited yet
                    if cb not in active and block_open[cb]:
                        _activate(state, cb, active, to_expand, new_frontier)
                if rows:
                    idx = torch.tensor(rows + slots, dtype=torch.int64).to(device)
                    state.tiles[idx[len(rows):]] = new_t[idx[: len(rows)]]
                    new_frontier.update(slots)
                    changed_blocks += len(rows)
                if overflow:
                    break
            frontier = new_frontier
        if iter_hook is not None:
            iter_hook(
                it, min(len(active) * B, state.n), changed_blocks, overflow
            )
        if overflow or (not pairs) or changed_blocks == 0:
            # fixpoint: nothing changed and nothing new activated (any
            # activation enqueues frontier slots, which produce pairs)
            if not overflow and to_expand:
                continue  # a just-allocated block still needs expansion
            break
    return overflow


def _rows_of_blocks(active: set[int], tile: int, n: int) -> np.ndarray:
    M = np.zeros(n, dtype=bool)
    for rb in active:
        M[rb * tile : (rb + 1) * tile] = True
    return M


def _host_mask(mask) -> np.ndarray:
    """A row mask (torch tensor on any device, or array-like) as numpy."""
    if isinstance(mask, torch.Tensor):
        return mask.cpu().numpy().astype(bool)
    return np.asarray(mask, dtype=bool)


# ---------------------------------------------------------------------- #
# Masked-engine wrappers (the PlanKey-facing contract).
# ---------------------------------------------------------------------- #


def _check_tile(n: int, tile: int) -> None:
    """Shape validation shared by the wrappers — before any shortcut, so
    an illegal tile fails loudly even for trivial grammars."""
    if tile <= 0 or tile % 32:
        raise ValueError(f"tile must be a positive multiple of 32: {tile}")
    if n % tile:
        raise ValueError(f"matrix size {n} is not a multiple of tile {tile}")


def masked_blocksparse_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask,
    row_capacity: int = 128,
    tile: int = DEFAULT_TILE,
    max_iters: int | None = None,
    use_kernel: bool = True,
    iter_hook=None,
):
    """Source-restricted block-sparse closure with the standard masked
    contract: ``(T, M, overflow)``, rows under ``M`` exact at fixpoint,
    monotone partial state + ``overflow=True`` when the occupied-block
    count outgrows ``row_capacity`` (reinterpreted as *block* capacity —
    the service's bucket ladder grows it exactly like row capacities).

    Host-driven: ``T`` is compacted to tiles on its device, the fixpoint
    runs on the occupied-block lists, and the result densifies back there.
    ``iter_hook`` is called directly per iteration with ``(iteration,
    active_rows, changed_blocks, overflow)`` — changed units are blocks.
    """
    T = _as_tensor(T)
    n = T.shape[-1]
    _check_tile(n, tile)
    if tables.n_prods == 0:
        return T, torch.ones((n,), dtype=torch.bool, device=T.device), False
    mask_host = _host_mask(src_mask)
    state = BlockSparseState.from_dense(T, tile)
    active: set[int] = set()
    to_expand: list[int] = []
    frontier: set[int] = set()  # _activate's additions are re-added below
    block_open = np.ones(state.grid, dtype=bool)
    for rb in {int(r) // tile for r in np.nonzero(mask_host)[0]}:
        _activate(state, rb, active, to_expand, frontier)
    overflow = _blocksparse_fixpoint(
        state, tables, active, to_expand, block_open,
        row_capacity, max_iters, use_kernel, iter_hook,
    )
    M = _rows_of_blocks(active, tile, n) | mask_host
    return state.to_dense(), torch.from_numpy(M).to(T.device), overflow


def masked_blocksparse_repair_closure(
    T: torch.Tensor,
    tables: ProductionTables,
    src_mask,
    frozen_mask,
    row_capacity: int = 128,
    tile: int = DEFAULT_TILE,
    max_iters: int | None = None,
    use_kernel: bool = True,
    iter_hook=None,
):
    """Block-granular delta repair: seed blocks are reactivated from the
    non-frozen seed rows (insert = reactivate touched blocks), expansion
    skips fully-frozen blocks, and the returned mask excludes frozen rows
    (matching ``masked_repair_closure``'s ``M | (reach & ~frozen)``).

    Frozen rows stay bit-identical for free: tile products are subsets of
    the exact closure, and frozen rows already hold their exact closure
    bits, so the OR into a tile's frozen lanes adds nothing.  Delete-side
    ancestor eviction happens upstream in delta/repair.py at row
    granularity (strictly finer than blocks — sound either way).
    """
    T = _as_tensor(T)
    n = T.shape[-1]
    _check_tile(n, tile)
    if tables.n_prods == 0:
        return T, torch.ones((n,), dtype=torch.bool, device=T.device), False
    frozen_host = _host_mask(frozen_mask)
    seed = _host_mask(src_mask) & ~frozen_host
    state = BlockSparseState.from_dense(T, tile)
    block_open = ~frozen_host.reshape(state.grid, tile).all(axis=1)
    active: set[int] = set()
    to_expand: list[int] = []
    frontier: set[int] = set()
    for rb in {int(r) // tile for r in np.nonzero(seed)[0]}:
        _activate(state, rb, active, to_expand, frontier)
    overflow = _blocksparse_fixpoint(
        state, tables, active, to_expand, block_open,
        row_capacity, max_iters, use_kernel, iter_hook,
    )
    M = (_rows_of_blocks(active, tile, n) & ~frozen_host) | seed
    return state.to_dense(), torch.from_numpy(M).to(T.device), overflow


# ---------------------------------------------------------------------- #
# Standalone closure over the compacted state (the million-node path).
# ---------------------------------------------------------------------- #


def blocksparse_closure_state(
    graph: Graph,
    g: CNFGrammar,
    tile: int = DEFAULT_TILE,
    sources=None,
    use_kernel: bool = True,
    max_iters: int | None = None,
    device: str | torch.device = "cuda",
) -> BlockSparseState:
    """All-pairs (or source-restricted) closure computed *entirely* on the
    compacted state on ``device`` — the dense tensor is never built, so
    memory stays proportional to occupied blocks."""
    state = BlockSparseState.from_graph(graph, g, tile, device=device)
    active: set[int] = set()
    to_expand: list[int] = []
    frontier: set[int] = set()
    block_open = np.ones(state.grid, dtype=bool)
    if sources is None:
        seed_blocks = {rb for idx_a in state.index for rb in idx_a}
    else:
        seed_blocks = {int(s) // tile for s in sources}
    for rb in seed_blocks:
        _activate(state, rb, active, to_expand, frontier)
    _blocksparse_fixpoint(
        state, ProductionTables.from_grammar(g), active, to_expand,
        block_open, state.n, max_iters, use_kernel, None,
    )
    return state
