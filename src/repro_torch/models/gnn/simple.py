"""GCN [arXiv:1609.02907] and MeshGraphNet [arXiv:2010.03409] (the port of
the reference's ``models/gnn/simple.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig

from ..common import dense_init, mlp_apply, mlp_params
from .common import segment_agg, segment_sum

# ------------------------------- GCN ---------------------------------- #


def gcn_init(cfg: GNNConfig, d_feat: int, *, generator, device):
    sizes = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [dense_init((a, b), generator=generator, device=device)
                  for a, b in zip(sizes, sizes[1:])]}


def gcn_forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Symmetric-normalised GCN: h' = D^-1/2 (A+I) D^-1/2 h W.  The
    normalisation is the GCN's own aggregator: ``cfg.aggregator`` is not
    read."""
    h = batch["node_feat"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n = h.shape[0]
    em = batch.get("edge_mask")
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device) if em is None else em
    deg = segment_sum(ones, dst, n) + 1.0  # +1 self loop
    inv_sqrt = torch.rsqrt(deg)
    coef = (inv_sqrt.index_select(0, src) * inv_sqrt.index_select(0, dst)) * ones
    for i, w in enumerate(params["w"]):
        h = h @ w
        msg = h.index_select(0, src) * coef[:, None]
        h = segment_sum(msg, dst, n) + h * (1.0 / deg)[:, None]
        if i + 1 < len(params["w"]):
            h = F.relu(h)
    return h  # (N, n_classes) logits


# --------------------------- MeshGraphNet ----------------------------- #


def mgn_init(cfg: GNNConfig, d_feat: int, d_edge: int, d_out: int = 3, *, generator, device):
    d = cfg.d_hidden
    hidden = tuple([d] * cfg.mlp_layers)

    def mlp(sizes):
        return mlp_params(sizes, generator=generator, device=device)

    return {
        "enc_node": mlp((d_feat, *hidden, d)),
        "enc_edge": mlp((d_edge, *hidden, d)),
        "dec": mlp((d, *hidden, d_out)),
        "blocks": [
            {"edge_mlp": mlp((3 * d, *hidden, d)), "node_mlp": mlp((2 * d, *hidden, d))}
            for _ in range(cfg.n_layers)
        ],
    }


def mgn_forward(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Encode-process(n_layers)-decode with residual edge/node MLPs; the
    edge states are masked after each edge MLP, so padded edges change
    nothing."""
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n = batch["node_feat"].shape[0]
    h = mlp_apply(params["enc_node"], batch["node_feat"])
    e = mlp_apply(params["enc_edge"], batch["edge_feat"])
    em = batch.get("edge_mask")
    for blk in params["blocks"]:
        e_in = torch.cat([e, h.index_select(0, src), h.index_select(0, dst)], dim=-1)
        e = e + mlp_apply(blk["edge_mlp"], e_in)
        if em is not None:
            e = e * em[:, None]
        agg = segment_agg(e, dst, n, cfg.aggregator)
        h = h + mlp_apply(blk["node_mlp"], torch.cat([h, agg], -1))
    return mlp_apply(params["dec"], h)  # (N, d_out)
