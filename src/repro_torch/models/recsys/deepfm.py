"""DeepFM [arXiv:1703.04247]: an FM interaction branch and a deep MLP branch
over shared sparse embeddings (the port of the reference's
``models/recsys/deepfm.py``).

Each of the ``n_sparse`` fields does a multi-hot lookup of fixed width
``multi_hot`` with a validity mask, reduced by sum (an embedding bag).  The
FM second-order term uses the O(k) identity
  sum_{i<j} <v_i, v_j> = 0.5 * ((sum v_i)^2 - sum v_i^2).
``retrieval_scores`` scores one user against many candidate items as one
matrix-vector product.

``DeepFM`` holds the reference's leaves as parameters: ``tables`` (F, V, D),
``w1_tables`` (F, V, 1), ``w1_dense`` (n_dense, 1), ``mlp`` (a list of
``{w, b}``) and the 0-d ``bias``, drawn from a ``torch.Generator`` seeded
with ``seed`` (the values differ from the reference's JAX draws; the tests
load the reference's through ``params_from_reference``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.matrices import resolve_device

from ..common import dense_init, mlp_apply, mlp_params, to_numpy

_LEAVES = ("tables", "w1_tables", "w1_dense", "bias")


class DeepFM(nn.Module):
    """The parameters of one DeepFM; a CUDA ``device`` on a machine without
    a card raises."""

    def __init__(self, cfg: RecSysConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        d_in = F * D + cfg.n_dense
        self.tables = nn.Parameter(dense_init((F, V, D), generator=gen, device=dev, scale=0.01))
        self.w1_tables = nn.Parameter(dense_init((F, V, 1), generator=gen, device=dev, scale=0.01))
        self.w1_dense = nn.Parameter(dense_init((cfg.n_dense, 1), generator=gen, device=dev))
        self.mlp = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in layer.items()})
            for layer in mlp_params((d_in, *cfg.mlp, 1), generator=gen, device=dev))
        self.bias = nn.Parameter(torch.zeros((), dtype=torch.float32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.bias.device


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """table (V, D); ids (B, M); mask (B, M) -> (B, D) sum-bag."""
    return (table[ids.long()] * mask[..., None]).sum(dim=1)


def field_embeddings(params: DeepFM, batch, cfg: RecSysConfig) -> torch.Tensor:
    """-> (B, n_sparse, D): the bagged embedding of every field, all fields
    gathered at once."""
    return _bags(params.tables, batch)


def _bags(tables: torch.Tensor, batch) -> torch.Tensor:
    """(F, V, D) tables, ``sparse_ids`` and ``sparse_mask`` (B, F, M) ->
    (B, F, D), each field's ids looked up in its own table."""
    ids = batch["sparse_ids"].long()
    field = torch.arange(tables.shape[0], device=ids.device)[None, :, None]
    return (tables[field, ids] * batch["sparse_mask"][..., None]).sum(dim=2)


def forward(params: DeepFM, batch, cfg: RecSysConfig) -> torch.Tensor:
    """-> (B,) logits: the first-order terms, the FM term and the deep
    branch."""
    v = field_embeddings(params, batch, cfg)  # (B, F, D)
    dense = batch["dense_feat"]
    lin = params.bias + (dense @ params.w1_dense)[:, 0] + _bags(params.w1_tables, batch)[..., 0].sum(dim=1)
    s = v.sum(dim=1)
    fm = 0.5 * ((s * s).sum(dim=-1) - (v * v).sum(dim=(1, 2)))
    deep_in = torch.cat([v.reshape(v.shape[0], -1), dense], dim=-1)
    deep = mlp_apply(params.mlp, deep_in)[:, 0]
    return lin + fm + deep


def loss_fn(params: DeepFM, batch, cfg: RecSysConfig):
    """Mean binary cross-entropy of the logits against ``labels``, in the
    stable form ``max(x, 0) - x y + log1p(exp(-|x|))``.  Returns ``(loss,
    {"bce": loss})``."""
    logits = forward(params, batch, cfg)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"bce": loss}


def retrieval_scores(params: DeepFM, batch, cfg: RecSysConfig) -> torch.Tensor:
    """One query's pooled user embedding (batch of 1) against the
    ``candidate_ids`` (N,) of field 0's table (the item table) -> (N,)."""
    user = field_embeddings(params, batch, cfg).sum(dim=1)[0]  # (D,)
    return params.tables[0][batch["candidate_ids"].long()] @ user


# ---------------------------------------------------------------------- #
# The reference's tree
# ---------------------------------------------------------------------- #


def reference_tree(values) -> dict:
    """``{parameter name: leaf}`` as the reference's tree (``mlp`` a list)."""
    n_layers = sum(1 for name in values if name.startswith("mlp.") and name.endswith(".w"))
    return {**{k: values[k] for k in _LEAVES},
            "mlp": [{k: values[f"mlp.{i}.{k}"] for k in ("w", "b")} for i in range(n_layers)]}


def unstack_reference(tree) -> dict:
    """The reference's tree as ``{parameter name: leaf}``."""
    out = {k: tree[k] for k in _LEAVES}
    for i, layer in enumerate(tree["mlp"]):
        out.update({f"mlp.{i}.{k}": v for k, v in layer.items()})
    return out


def params_from_reference(tree, cfg: RecSysConfig, device="cuda") -> DeepFM:
    """A ``DeepFM`` on ``device`` holding the reference tree's values (every
    leaf must be present and no other)."""
    dev = resolve_device(device)
    model = DeepFM(cfg, device="meta")
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in unstack_reference(tree).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev)


def to_reference(model: DeepFM) -> dict:
    """The model's parameters as the reference's tree of numpy arrays."""
    return to_numpy(reference_tree(dict(model.named_parameters())))
