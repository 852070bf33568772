"""SO(3) machinery for the equivariant GNNs (Equiformer-v2, MACE), the port
of the reference's ``models/gnn/so3.py``.

Everything here is exact (no fitted approximations):

  * real spherical harmonics Y_lm up to l_max via associated-Legendre
    recurrences (torch, static loops);
  * real Wigner rotation matrices D^l(R) via the Ivanic-Ruedenberg
    recursion (J. Phys. Chem. 1996), pure real arithmetic built l by l
    from D^1 = permuted R, vectorised over the leading dims;
  * real Gaunt coefficients (the coupling tensors of MACE's product basis)
    in numpy, as the reference computes them (same sample directions, same
    seed), so the port's coupling tensors are the reference's bit for bit.

The Wigner assembly is one small expression per matrix entry, about 455
entries for l <= 6: in eager torch each is a few launches over the edge
axis.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def n_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def lm_index(l: int, m: int) -> int:
    return l * l + l + m


# ---------------------------------------------------------------------- #
# Real spherical harmonics
# ---------------------------------------------------------------------- #


def _legendre(ct, st, l_max: int, ones) -> dict:
    """Associated Legendre P_l^m(ct) without Condon-Shortley, m >= 0."""
    P = {(0, 0): ones}
    for m in range(1, l_max + 1):
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def _sph_norm(l: int, am: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - am) / math.factorial(l + am))


def real_sph_harm(dirs: torch.Tensor, l_max: int) -> torch.Tensor:
    """Y: (..., (l_max+1)^2) for unit vectors dirs (..., 3).

    Convention: Condon-Shortley-free real SH with full normalisation
    (integrates to 1 over the sphere); ordering m = -l..l per l.
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = torch.atan2(y, x)
    P = _legendre(ct, st, l_max, torch.ones_like(ct))
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = _sph_norm(l, am)
            if m == 0:
                out.append(norm * P[(l, 0)])
            elif m > 0:
                out.append(math.sqrt(2) * norm * P[(l, m)] * torch.cos(m * phi))
            else:
                out.append(math.sqrt(2) * norm * P[(l, am)] * torch.sin(am * phi))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------- #
# Wigner D for real SH: Ivanic-Ruedenberg recursion
# ---------------------------------------------------------------------- #


def _d1_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """D^1 in the real-SH (y, z, x) ordering: D1[i, j] = R[s(i), s(j)]."""
    s = [1, 2, 0]
    return R[..., s, :][..., :, s]


def wigner_stack(R: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """[D^0, D^1, ..., D^l_max], each (..., 2l+1, 2l+1), vectorised over
    the leading dims of the rotation matrices R (..., 3, 3)."""
    batch = R.shape[:-2]
    Ds = [torch.ones((*batch, 1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return Ds
    D1 = _d1_from_rotation(R)
    Ds.append(D1)

    for l in range(2, l_max + 1):
        Dp = Ds[l - 1]  # (..., 2l-1, 2l-1)

        def P(i, a, b):
            # a in [-(l-1), l-1] indexes Dp rows; b in [-l, l] output col
            ri = D1[..., i + 1, :]
            if b == l:
                return ri[..., 2] * Dp[..., a + l - 1, 2 * l - 2] - ri[..., 0] * Dp[..., a + l - 1, 0]
            if b == -l:
                return ri[..., 2] * Dp[..., a + l - 1, 0] + ri[..., 0] * Dp[..., a + l - 1, 2 * l - 2]
            return ri[..., 1] * Dp[..., a + l - 1, b + l - 1]

        rows = []
        for m in range(-l, l + 1):
            cols = []
            for n in range(-l, l + 1):
                denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
                am = abs(m)
                u = math.sqrt((l + m) * (l - m) / denom)
                v = 0.5 * math.sqrt((1 + (m == 0)) * (l + am - 1) * (l + am) / denom) * (1 - 2 * (m == 0))
                w = -0.5 * math.sqrt((l - am - 1) * (l - am) / denom) * (1 - (m == 0))
                term = 0.0
                if u != 0.0:
                    term = term + u * P(0, m, n)
                if v != 0.0:
                    if m == 0:
                        V = P(1, 1, n) + P(-1, -1, n)
                    elif m > 0:
                        V = P(1, m - 1, n) * math.sqrt(1 + (m == 1)) - P(-1, -m + 1, n) * (1 - (m == 1))
                    else:
                        V = P(1, m + 1, n) * (1 - (m == -1)) + P(-1, -m - 1, n) * math.sqrt(1 + (m == -1))
                    term = term + v * V
                if w != 0.0:
                    if m > 0:
                        W = P(1, m + 1, n) + P(-1, -m - 1, n)
                    else:  # m < 0 (w == 0 when m == 0)
                        W = P(1, m - 1, n) - P(-1, -m + 1, n)
                    term = term + w * W
                cols.append(term)
            rows.append(torch.stack(cols, dim=-1))
        Ds.append(torch.stack(rows, dim=-2))
    return Ds


def block_diag_wigner(R: torch.Tensor, l_max: int) -> torch.Tensor:
    """Full (..., K, K) block-diagonal D over all l <= l_max (K=(l_max+1)^2)."""
    Ds = wigner_stack(R, l_max)
    K = n_coeffs(l_max)
    out = R.new_zeros((*R.shape[:-2], K, K))
    for l, D in enumerate(Ds):
        i = l * l
        out[..., i : i + 2 * l + 1, i : i + 2 * l + 1] = D
    return out


def rotation_to_z(dirs: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """R (..., 3, 3) with R @ d = e_z for unit d (the eSCN edge frame); a
    zero vector gives the zero matrix."""
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=eps)
    ez = d.new_tensor([0.0, 0.0, 1.0]).expand(d.shape)
    ex = d.new_tensor([1.0, 0.0, 0.0]).expand(d.shape)
    ref = torch.where(torch.abs(d[..., 2:3]) < 0.98, ez, ex)
    b1 = torch.linalg.cross(ref, d, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=eps)
    b2 = torch.linalg.cross(d, b1, dim=-1)
    return torch.stack([b1, b2, d], dim=-2)


# ---------------------------------------------------------------------- #
# Real Gaunt coefficients (the coupling tensors of MACE's product basis)
# ---------------------------------------------------------------------- #
#
# G_{m1 m2 M} = ∫ Y_{l1 m1} Y_{l2 m2} Y_{L M} dΩ.  The product
# Y_{l1 m1}·Y_{l2 m2} lies exactly in span{Y_{L M} : L <= l1+l2}, so
# projecting sampled products onto the basis by least squares recovers G
# exactly (up to fp rounding) in this basis convention.


def _real_sph_harm_np(dirs: np.ndarray, l_max: int) -> np.ndarray:
    """numpy mirror of ``real_sph_harm`` (the reference's, for
    ``real_gaunt``)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ct = np.clip(z, -1.0, 1.0)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    phi = np.arctan2(y, x)
    P = _legendre(ct, st, l_max, np.ones_like(ct))
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = _sph_norm(l, am)
            if m == 0:
                out.append(norm * P[(l, 0)])
            elif m > 0:
                out.append(math.sqrt(2) * norm * P[(l, m)] * np.cos(m * phi))
            else:
                out.append(math.sqrt(2) * norm * P[(l, am)] * np.sin(am * phi))
    return np.stack(out, axis=-1)


@lru_cache(maxsize=None)
def real_gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    """G (2l1+1, 2l2+1, 2l3+1) in the real_sph_harm basis."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    l_big = l1 + l2
    K = n_coeffs(l_big)
    rng = np.random.default_rng(20240213)
    v = rng.normal(size=(4 * K + 16, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = _real_sph_harm_np(v, l_big).astype(np.float64)
    Y1 = Y[:, l1 * l1 : (l1 + 1) ** 2]
    Y2 = Y[:, l2 * l2 : (l2 + 1) ** 2]
    prod = Y1[:, :, None] * Y2[:, None, :]  # (S, 2l1+1, 2l2+1)
    flat = prod.reshape(prod.shape[0], -1)
    # solve against the FULL basis up to l1+l2 (the expansion is exact
    # there), then slice out the l3 rows
    coef, *_ = np.linalg.lstsq(Y, flat, rcond=None)  # (K, m1*m2)
    sl = coef[l3 * l3 : (l3 + 1) ** 2]
    G = sl.T.reshape(2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
    # true non-zero Gaunts are O(0.1), so 1e-6 separates numerical noise
    # from structure (the selection rules are exact)
    G = G.astype(np.float64)
    G[np.abs(G) < 1e-6] = 0.0
    return G
