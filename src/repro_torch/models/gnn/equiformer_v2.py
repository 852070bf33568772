"""Equiformer-v2 [arXiv:2306.12059]: equivariant graph attention with eSCN
SO(2) convolutions (the port of the reference's
``models/gnn/equiformer_v2.py``).

Per edge, the source node's irrep features are rotated into a frame where
the edge direction is +z.  There an SO(3)-equivariant convolution reduces
to per-|m| complex-linear mixing of the (+m, -m) coefficient pairs across
l (the eSCN trick: the O(L^6) tensor product becomes O(L^3) dense mixing).
Coefficients with |m| > m_max are truncated.  Messages are combined with
multi-head attention whose scores come from invariant (l=0) channels,
rotated back, and aggregated by destination.

As in the reference: per-edge radial networks modulate each |m| block with
a learned scalar gate (instead of generating the full SO(2) weight matrices
per edge), and a sigmoid gating of the l>0 blocks by scalar channels
stands in for the separable S^2 activation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig

from ..common import dense_init, mlp_apply, mlp_params
from .common import gaussian_rbf, segment_softmax, segment_sum
from .so3 import lm_index, n_coeffs, rotation_to_z, wigner_stack


def _m_rows(l_max: int, m: int) -> tuple[list[int], list[int]]:
    """(+m rows, -m rows) flat lm indices for l >= |m|."""
    plus = [lm_index(l, m) for l in range(abs(m), l_max + 1)]
    minus = [lm_index(l, -m) for l in range(abs(m), l_max + 1)]
    return plus, minus


def eqv2_init(cfg: GNNConfig, d_feat: int, d_out: int = 1, *, generator, device):
    C, L, M = cfg.d_hidden, cfg.l_max, cfg.m_max

    def dense(shape):
        return dense_init(shape, generator=generator, device=device)

    def mlp(sizes):
        return mlp_params(sizes, generator=generator, device=device)

    params = {"embed": dense((d_feat, C)), "readout": mlp((C, C, d_out)), "layers": []}
    n0 = L + 1
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "w_m0": dense((n0 * C, n0 * C)),
            "w_re": [dense(((L + 1 - m) * C, (L + 1 - m) * C)) for m in range(1, M + 1)],
            "w_im": [dense(((L + 1 - m) * C, (L + 1 - m) * C)) for m in range(1, M + 1)],
            "radial_gate": mlp((cfg.n_rbf, C, M + 1)),
            "attn": mlp((2 * C + cfg.n_rbf, C, cfg.n_heads)),
            "scalar_mlp": mlp((C, C, C)),
            "l_gate": dense((C, L * C)),
        })
    return params


def _rotate(Ds, X: torch.Tensor, l_max: int, transpose: bool = False) -> torch.Tensor:
    """Apply the block-diagonal Wigner to (E, K, C) irrep features (split
    into its l blocks at once, so the backward joins their gradients with
    one ``cat``)."""
    outs = []
    for D, blk in zip(Ds, X.split([2 * l + 1 for l in range(l_max + 1)], dim=1)):
        outs.append(torch.bmm(D.transpose(-1, -2) if transpose else D, blk))
    return torch.cat(outs, dim=1)


def eqv2_forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    C, L, M, H = cfg.d_hidden, cfg.l_max, cfg.m_max, cfg.n_heads
    K = n_coeffs(L)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    pos = batch["positions"]
    n = pos.shape[0]
    em = batch.get("edge_mask")

    vec = pos.index_select(0, dst) - pos.index_select(0, src)
    r = torch.linalg.norm(vec, dim=-1)
    rbf = gaussian_rbf(r, cfg.n_rbf)
    # degenerate (zero-length) edges have no frame: mask them out entirely
    deg_ok = (r > 1e-6).float()
    em = deg_ok if em is None else em * deg_ok
    R = rotation_to_z(vec)
    Ds = wigner_stack(R, L)

    # the rows the SO(2) mixing reads and writes in the edge frame: m = 0,
    # then each (+m, -m) pair; rows with |m| > m_max stay zero
    rows0, _ = _m_rows(L, 0)
    pairs = [_m_rows(L, m) for m in range(1, M + 1)]
    groups = [rows0] + [half for pair in pairs for half in pair]
    rows = torch.tensor([i for g in groups for i in g], device=pos.device)

    X = torch.cat([(batch["node_feat"] @ params["embed"])[:, None, :],
                   pos.new_zeros((n, K - 1, C))], dim=1)

    for layer in params["layers"]:
        Xs = X.index_select(0, src)  # (E, K, C)
        Xr = _rotate(Ds, Xs, L)  # edge frame
        gates = torch.sigmoid(mlp_apply(layer["radial_gate"], rbf))  # (E, M+1)

        x = Xr.index_select(1, rows).split([len(g) for g in groups], dim=1)
        # m = 0: plain linear across (l, C)
        x0 = x[0].reshape(-1, len(rows0) * C)
        mixed = [((x0 @ layer["w_m0"]) * gates[:, 0:1]).reshape(-1, len(rows0), C)]
        # 1 <= m <= m_max: complex-linear mixing of (+m, -m) pairs
        for m, (rp, _) in enumerate(pairs, start=1):
            nl = len(rp)
            xp = x[2 * m - 1].reshape(-1, nl * C)
            xn = x[2 * m].reshape(-1, nl * C)
            w1, w2 = layer["w_re"][m - 1], layer["w_im"][m - 1]
            yp = (xp @ w1 - xn @ w2) * gates[:, m : m + 1]
            yn = (xp @ w2 + xn @ w1) * gates[:, m : m + 1]
            mixed += [yp.reshape(-1, nl, C), yn.reshape(-1, nl, C)]
        Y = Xr.new_zeros(Xr.shape).index_copy(1, rows, torch.cat(mixed, dim=1))

        msg = _rotate(Ds, Y, L, transpose=True)  # back to the global frame

        score_in = torch.cat([X[:, 0, :].index_select(0, dst), msg[:, 0, :], rbf], -1)
        score = mlp_apply(layer["attn"], score_in)  # (E, H)
        score = torch.where(em[:, None] > 0, score, -1e30)
        alpha = segment_softmax(score, dst, n) * em[:, None]  # (E, H)
        msg_h = msg.reshape(*msg.shape[:-1], H, C // H) * alpha[:, None, :, None]
        X = X + segment_sum(msg_h.reshape(msg.shape), dst, n)  # (N, K, C)

        # node-wise equivariant nonlinearity
        s = X[:, 0, :]
        s_new = s + mlp_apply(layer["scalar_mlp"], F.silu(s))
        lg = torch.sigmoid(s @ layer["l_gate"]).reshape(n, L, C)
        scale = torch.repeat_interleave(
            lg, torch.tensor([2 * l + 3 for l in range(L)], device=lg.device), dim=1,
            output_size=K - 1)
        X = torch.cat([s_new[:, None, :], X[:, 1:, :] * scale], dim=1)

    return mlp_apply(params["readout"], X[:, 0, :])  # (N, d_out), invariant
