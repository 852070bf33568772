"""MACE [arXiv:2206.07697]: higher-order equivariant message passing (ACE),
the port of the reference's ``models/gnn/mace.py``.

Per layer: (1) the atomic density  A_i,lm,c = sum_j R_lc(r_ij) Y_lm(r_ij^)
s_c(h_j)  (radial MLP x spherical harmonics x channel-mixed scalars of the
neighbour), then (2) the product basis: symmetric tensor powers of A up to
``correlation_order`` contracted back to target irreps L with real Gaunt
coupling tensors (``so3.real_gaunt``), per channel:

    B1_L = A_L
    B2_L = sum_{l1,l2}         G(l1,l2;L)       A_l1 (x) A_l2
    B3_L = sum_{l1,l2,l12,l3}  G(l1,l2;l12), G(l12,l3;L)  A^3

(3) messages are per-channel linear combinations over coupling paths, and
the scalar node states update from the invariant (L=0) component; the
readout is a per-node invariant MLP.  Intermediate couplings are truncated
at the config's l_max.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig

from ..common import dense_init, mlp_apply, mlp_params
from .common import gaussian_rbf, segment_sum
from .so3 import real_gaunt, real_sph_harm


def _order2_paths(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l1, l_max + 1):
            for L in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if np.abs(real_gaunt(l1, l2, L)).max() > 0:
                    out.append((l1, l2, L))
    return out


def _order3_paths(l_max: int):
    out = []
    for l1, l2, l12 in _order2_paths(l_max):
        for l3 in range(l_max + 1):
            for L in range(abs(l12 - l3), min(l12 + l3, l_max) + 1):
                if np.abs(real_gaunt(l12, l3, L)).max() > 0:
                    out.append((l1, l2, l12, l3, L))
    return out


@lru_cache(maxsize=None)
def _gaunt(l1: int, l2: int, l3: int, device: torch.device) -> torch.Tensor:
    """``real_gaunt`` as an f32 tensor on ``device`` (made once per device)."""
    return torch.as_tensor(real_gaunt(l1, l2, l3), dtype=torch.float32, device=device)


def mace_init(cfg: GNNConfig, d_feat: int, d_out: int = 1, *, generator, device):
    C, L = cfg.d_hidden, cfg.l_max
    n2, n3 = len(_order2_paths(L)), len(_order3_paths(L))

    def dense(shape):
        return dense_init(shape, generator=generator, device=device)

    params = {
        "embed": dense((d_feat, C)),
        "readout": mlp_params((C, C, d_out), generator=generator, device=device),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "radial": mlp_params((cfg.n_rbf, C, (L + 1) * C), generator=generator, device=device),
            "w_src": dense((C, C)),
            "w_b1": dense((L + 1, C, C)),
            "w_b2": dense((n2, C)) if n2 else None,
            "w_b3": dense((n3, C)) if n3 else None,
            "w_update": dense((C, C)),
        })
    return params


def _couple(G: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``einsum("abM,nac,nbc->nMc", G, x1, x2)`` as two contractions: the
    per-channel outer product (n, a, b, c), then G over (a, b)."""
    outer = x1[:, :, None, :] * x2[:, None, :, :]
    return torch.einsum("nabc,abM->nMc", outer, G)


def mace_forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    C, L = cfg.d_hidden, cfg.l_max
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    pos = batch["positions"]
    n = pos.shape[0]
    em = batch.get("edge_mask")
    dev = pos.device

    vec = pos.index_select(0, dst) - pos.index_select(0, src)
    r = torch.linalg.norm(vec, dim=-1)
    dirs = vec / torch.clamp(r, min=1e-9)[:, None]
    rbf = gaussian_rbf(r, cfg.n_rbf)
    Y = real_sph_harm(dirs, L)  # (E, K)
    # degenerate (zero-length / self-loop) edges have no direction: drop them
    # (Y at the zero vector is an arbitrary constant and breaks equivariance)
    Y = Y * (r > 1e-6)[:, None]

    h = batch["node_feat"] @ params["embed"]  # (N, C) scalars
    p2, p3 = _order2_paths(L), _order3_paths(L)

    for layer in params["layers"]:
        # (1) atomic density A
        Rl = mlp_apply(layer["radial"], rbf).reshape(-1, L + 1, C)  # (E, L+1, C)
        s = (h @ layer["w_src"]).index_select(0, src)  # (E, C)
        phi = []
        for l in range(L + 1):
            yl = Y[:, l * l : (l + 1) ** 2]  # (E, 2l+1)
            phi.append(yl[:, :, None] * (Rl[:, l, :] * s)[:, None, :])
        phi = torch.cat(phi, dim=1)  # (E, K, C)
        if em is not None:
            phi = phi * em[:, None, None]
        A = segment_sum(phi, dst, n)  # (N, K, C)
        Al = A.split([2 * l + 1 for l in range(L + 1)], dim=1)  # the l blocks

        # (2) product basis -> (3) message, summed per target L
        msg = [torch.einsum("nmc,cd->nmd", Al[l], layer["w_b1"][l]) for l in range(L + 1)]
        if cfg.correlation_order >= 2 and p2:
            for pi, (l1, l2, Lt) in enumerate(p2):
                b2 = _couple(_gaunt(l1, l2, Lt, dev), Al[l1], Al[l2])
                msg[Lt] = msg[Lt] + b2 * layer["w_b2"][pi][None, None, :]
        if cfg.correlation_order >= 3 and p3:
            for pi, (l1, l2, l12, l3, Lt) in enumerate(p3):
                t = _couple(_gaunt(l1, l2, l12, dev), Al[l1], Al[l2])
                b3 = _couple(_gaunt(l12, l3, Lt, dev), t, Al[l3])
                msg[Lt] = msg[Lt] + b3 * layer["w_b3"][pi][None, None, :]
        msg = torch.cat(msg, dim=1)  # (N, K, C)

        # scalar update from the invariant component
        h = h + F.silu(msg[:, 0, :] @ layer["w_update"])

    return mlp_apply(params["readout"], h)  # (N, d_out), E(3)-invariant
