"""Plain torch versions of the port's kernels (the CPU path and the
oracle the CUDA kernels are held against on the card)."""
from __future__ import annotations

import torch

from repro_torch.core.matrices import pack_bits, unpack_bits


def bitmm_ref(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    """Bitpacked Boolean matmul: (B, m, k/32) x (B, k, w) -> (B, m, w) int32.

    ``C[b, i, :] = OR_{k : bit k of lhs[b, i]} rhs[b, k, :]``, computed by
    unpacking to 0/1 fp32, a matmul, ``> 0`` and repacking — exact for
    Boolean inputs, since every term is non-negative and a count of at
    least 1 stays positive.  The rhs unpacks to its full ``32·w`` columns,
    so ``w`` need not equal ``k/32``.
    """
    k, w = rhs_packed.shape[-2:]
    lhs = unpack_bits(lhs_packed, k).to(torch.float32)
    rhs = unpack_bits(rhs_packed, 32 * w).to(torch.float32)
    return pack_bits(torch.matmul(lhs, rhs) > 0)


def bitmm_or_ref(
    lhs_packed: torch.Tensor, rhs_packed: torch.Tensor, acc_packed: torch.Tensor
) -> torch.Tensor:
    """Fused closure step ``acc | (lhs x rhs)`` on int32 words: lhs
    (B, m, k/32), rhs (B, k, w), acc (B, m, w) -> (B, m, w).  Rectangular
    like :func:`bitmm_ref`; at square shapes it is the function of the
    reference's ``bitmm_or_pallas``."""
    prod = bitmm_ref(lhs_packed, rhs_packed)
    if acc_packed.shape != prod.shape:
        raise ValueError(
            f"bitmm_or_ref: acc is {tuple(acc_packed.shape)}, the product is "
            f"{tuple(prod.shape)}"
        )
    return acc_packed | prod


def tile_bitmm_ref(lhs_tiles: torch.Tensor, rhs_tiles: torch.Tensor) -> torch.Tensor:
    """Square-tile bitpacked Boolean matmul of the block-sparse backend:
    (p, B, B/32) x (p, B, B/32) -> (p, B, B/32), one independent product
    per pair — :func:`bitmm_ref` at the tile shape."""
    return bitmm_ref(lhs_tiles, rhs_tiles)


def tile_contract_ref(
    tiles: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """OR of the tile products of each output segment: ``out[s] = OR over
    pairs p with seg[p] == s of tiles[l_idx[p]] x tiles[r_idx[p]]``,
    ``(n_out, B, B/32)`` int32.  Pad pairs name segment ``n_out`` and are
    dropped.  The reference's ``_contract_chunk`` up to ``packed``: gather,
    multiply, unpack to 0/1 bytes, ``amax`` per segment (max over {0, 1}
    is the OR), repack."""
    lhs = tiles[l_idx.long()]
    rhs = tiles[r_idx.long()]
    prod = bitmm_ref(lhs, rhs)
    bits = unpack_bits(prod, 32 * prod.shape[-1]).to(torch.uint8)
    merged = torch.zeros(
        (n_out + 1, *bits.shape[1:]), dtype=torch.uint8, device=bits.device
    )
    index = seg.long().view(-1, 1, 1).expand_as(bits)
    merged.scatter_reduce_(0, index, bits, "amax")
    return pack_bits(merged[:n_out].bool())


def tile_contract_chunk_ref(
    tiles: torch.Tensor,
    l_idx: torch.Tensor,
    r_idx: torch.Tensor,
    seg: torch.Tensor,
    out_slot: torch.Tensor,
    out_exists: torch.Tensor,
    n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the block-sparse fixpoint: ``new = old |
    tile_contract_ref(...)`` with ``old[s]`` the tile of slot
    ``out_slot[s]`` where ``out_exists[s]``, zeros elsewhere.  Returns
    ``(new (n_out, B, B/32), flags (2 n_out + 1,) int32)``: ``flags[s]``
    is 1 where ``new[s]`` differs from ``old[s]``, ``flags[n_out + s]``
    where ``new[s]`` has a set bit; the last word, the fault word of the
    kernel's layout, is 0 (a pair out of range raises here)."""
    old = torch.where(
        out_exists.bool()[:, None, None], tiles[out_slot.long()], 0
    )[:n_out]
    new = old | tile_contract_ref(tiles, l_idx, r_idx, seg, n_out)
    changed = (new != old).any(2).any(1)
    nonzero = (new != 0).any(2).any(1)
    fault = torch.zeros(1, dtype=torch.bool, device=new.device)
    return new, torch.cat([changed, nonzero, fault]).to(torch.int32)


#: bytes the plain min-plus product's ``(P, chunk, rows, cols)`` f32
#: temporary may take, per device type; the chunk of the contraction axis
#: follows from it.  On the card a large temporary means few launches; on
#: the CPU one that stays in cache is several times faster.  The result
#: does not depend on the chunk (each candidate is one f32 add of two
#: lengths, and ``min`` is exact in any order).
MINPLUS_TEMP_BYTES = {"cuda": 2 << 30, "cpu": 16 << 20}


def minplus_chunk(P: int, rows: int, cols: int, K: int, device_type: str) -> int:
    """Contraction chunk of :func:`minplus_ref` under ``MINPLUS_TEMP_BYTES``."""
    per_k = 4 * max(P * rows * cols, 1)
    return max(1, min(K, MINPLUS_TEMP_BYTES[device_type] // per_k))


def minplus_ref(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
    chunk: int | None = None,
) -> torch.Tensor:
    """Batched min-plus product with the rhs gathered by index:
    ``out[p, i, j] = min(acc[p, i, j], min_k lhs[p, i, k] + base[slab[p],
    row[k], j])``, (P, R, K) x (S, rows, C) -> (P, R, C) f32, into a new
    tensor (``acc`` is only read; without it the first term is inf; without
    ``slab`` or ``row`` the index is the identity).  With both indices
    absent and no ``acc`` it is the reference's ``_minplus(lhs, base)``.

    Tiled over the contraction axis k, so the peak temporary is ``(P,
    chunk, R, C)`` f32 plus the chunk's gathered rhs rows; ``chunk=None``
    takes it from the device's ``MINPLUS_TEMP_BYTES``.  On the CPU only
    the chunk's finite lhs entries are expanded (lengths are sparse, and
    an inf lhs entry adds only inf candidates), into at most the same
    temporary.  Lengths are never negative, so no NaN can arise (``inf +
    x`` is ``inf``)."""
    P, rows, K = lhs.shape
    cols = base.shape[-1]
    if acc is not None:
        out = acc.clone(memory_format=torch.contiguous_format)
    else:
        out = torch.full((P, rows, cols), float("inf"), dtype=torch.float32,
                         device=lhs.device)
    if K == 0:
        return out
    if chunk is None:
        chunk = minplus_chunk(P, rows, cols, K, lhs.device.type)
    slabs = slab if slab is not None else torch.arange(P, device=lhs.device)
    for c0 in range(0, K, chunk):
        ks = slice(c0, c0 + chunk)
        idx = row[ks] if row is not None else torch.arange(
            c0, min(c0 + chunk, K), device=lhs.device)
        if lhs.device.type == "cpu":
            _minplus_finite(out, lhs[:, :, ks], base, slabs, idx)
            continue
        rk = base[slabs[:, None], idx[None, :]]  # (P, ch, cols)
        lk = lhs[:, :, ks].transpose(1, 2)  # (P, ch, rows)
        cand = (lk[:, :, :, None] + rk[:, :, None, :]).amin(dim=1)
        torch.minimum(out, cand, out=out)
    return out


def _minplus_finite(out, lk, base, slabs, idx) -> None:
    """``out = min(out, lk (x) base)`` over the finite entries of the lhs
    chunk ``lk`` (P, R, ch) only: one candidate row per entry, folded into
    ``out`` (P, R, C), contiguous, by an ``amin`` scatter."""
    p, i, k = torch.nonzero(lk != float("inf"), as_tuple=True)
    if len(p):
        cand = lk[p, i, k][:, None] + base[slabs[p], idx[k]]  # (entries, C)
        dst = (p * out.shape[1] + i)[:, None].expand_as(cand)
        out.view(-1, out.shape[-1]).scatter_reduce_(0, dst, cand, "amin")


#: the saturation sentinel of the count semiring, 2^32 - 1: the all-ones
#: word, which int32 storage reads as -1
SAT_COUNT = 0xFFFFFFFF

#: bytes the plain count product's ``(P, rows, chunk, cols)`` int64
#: temporaries may take, per device type (as ``MINPLUS_TEMP_BYTES``); the
#: result does not depend on the chunk (a saturating sum of non-negative
#: terms is ``min(SAT, the sum)`` in any order)
COUNT_TEMP_BYTES = {"cuda": 2 << 30, "cpu": 16 << 20}


def count_chunk(P: int, rows: int, cols: int, K: int, device_type: str) -> int:
    """Contraction chunk of :func:`count_mm_ref` under ``COUNT_TEMP_BYTES``:
    about four int64 temporaries of ``(P, rows, chunk, cols)`` are live."""
    per_k = 32 * max(P * rows * cols, 1)
    return max(1, min(K, COUNT_TEMP_BYTES[device_type] // per_k))


def as_unsigned(t: torch.Tensor) -> torch.Tensor:
    """uint32 counts held in int32 storage as int64 values in [0, 2^32)."""
    return t.to(torch.int64) & SAT_COUNT


def as_storage(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) back to int32 storage with the same bits
    (values from 2^31 up read as negative)."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def sat_mul_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``min(SAT, a * b)`` on int64 values in [0, SAT], without overflow:
    the product exceeds SAT iff ``b > 0`` and ``a > SAT // b`` (the
    reference's test), and then it is not formed."""
    over = (b > 0) & (a > SAT_COUNT // b.clamp_min(1))
    return torch.where(over, SAT_COUNT, torch.where(over, 0, a) * b)


def count_mm_ref(
    lhs: torch.Tensor,
    base: torch.Tensor,
    slab: torch.Tensor | None = None,
    row: torch.Tensor | None = None,
    acc: torch.Tensor | None = None,
    chunk: int | None = None,
) -> torch.Tensor:
    """Saturating count product with the rhs gathered by index, on uint32
    counts in int32 storage: ``out[p, i, j] = min(SAT, acc[p, i, j] +
    sum_k min(SAT, lhs[p, i, k] * base[slab[p], row[k], j]))``, (P, R, K)
    x (S, rows, C) -> a new (P, R, C) int32 tensor (``acc`` is only read;
    without it the first term is 0; without ``slab`` or ``row`` the index
    is the identity).  With both indices absent and no ``acc`` it is the
    reference's ``_count_mm(lhs, base)``.

    Computed in int64 on the operands masked to 32 bits, tiled over the
    contraction axis; ``chunk=None`` takes the chunk from the device's
    ``COUNT_TEMP_BYTES``.  Each product is clamped to SAT before the sum
    (a chunk's sum of at most 2^31 such terms fits in int64), and the
    running total is clamped after each chunk."""
    P, rows, K = lhs.shape
    cols = base.shape[-1]
    if acc is not None:
        total = as_unsigned(acc)
    else:
        total = torch.zeros((P, rows, cols), dtype=torch.int64, device=lhs.device)
    if K:
        if chunk is None:
            chunk = count_chunk(P, rows, cols, K, lhs.device.type)
        slabs = slab if slab is not None else torch.arange(P, device=lhs.device)
        for c0 in range(0, K, chunk):
            ks = slice(c0, c0 + chunk)
            idx = row[ks] if row is not None else torch.arange(
                c0, min(c0 + chunk, K), device=lhs.device)
            rk = as_unsigned(base[slabs[:, None], idx[None, :]])  # (P, ch, cols)
            lk = as_unsigned(lhs[:, :, ks])  # (P, rows, ch)
            part = sat_mul_unsigned(lk[:, :, :, None], rk[:, None, :, :]).sum(dim=2)
            total = (total + part).clamp_max_(SAT_COUNT)
    return as_storage(total)
