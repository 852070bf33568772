"""The generic train step (the port of the reference's ``train/trainer.py``):
microbatched gradient accumulation around a family's loss, the AdamW
update, metrics.

For ``n_micro > 1`` the batch's leaves carry a leading microbatch axis.
Each microbatch's backward adds its f32 gradients into the parameters'
``.grad`` (the reference's ``lax.scan`` carry: 0 + g_1 + g_2 + ...), so
activation memory is one microbatch deep (the models' per-block remat
bounds it further), and the sum is divided by ``n_micro``.

With a ``plan`` (the LM only) the model is sharded over the plan's mesh
(``models/weights.py``), every rank is handed the same global batch, and
each computes with its rows: its backward leaves it its blocks of the
global gradient, averaged over the batch axes as the reference's are, and
the update keeps every replica of a block the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig, RecSysConfig, TransformerConfig

from . import optimizer as opt


def make_loss_fn(model_cfg, plan=None):
    """``loss(model, batch) -> (loss, metrics)`` of the config's family; a
    ``plan`` shards the LM's (the other families take none)."""
    if isinstance(model_cfg, TransformerConfig):
        from repro_torch.models import transformer as tf

        return lambda model, batch: tf.loss_fn(model, batch, model_cfg, plan)
    if plan is not None:
        raise NotImplementedError(f"{type(model_cfg).__name__} has no sharded loss in the port")
    if isinstance(model_cfg, GNNConfig):
        from repro_torch.models.gnn import api

        return lambda model, batch: api.loss_fn(model, batch, model_cfg)
    if isinstance(model_cfg, RecSysConfig):
        from repro_torch.models.recsys import deepfm

        return lambda model, batch: deepfm.loss_fn(model, batch, model_cfg)
    raise TypeError(type(model_cfg))


def to_device(batch, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model_cfg, opt_cfg: opt.OptimizerConfig, n_micro: int = 1, plan=None):
    """``step(model, opt_state, batch) -> metrics``: one AdamW step of
    ``model`` (in place) and ``opt_state`` on ``batch`` (numpy arrays or
    tensors, moved to the model's device).  The metrics are 0-d tensors:
    ``loss`` and ``grad_norm`` (before clipping), plus the loss's ``nll``
    and ``aux`` (LM), ``bce`` (DeepFM), ``nll`` (GCN) or ``mse`` (the other
    GNNs) when ``n_micro == 1``; with
    microbatches the loss is the mean of theirs.  With a ``plan``, the
    model is sharded by it and ``batch`` is the global batch, the same on
    every rank; so are the metrics."""
    loss_fn = make_loss_fn(model_cfg, plan)
    sharded = {}
    if plan is not None:
        from repro_torch.models.weights import named_specs

        sharded = {"plan": plan, "specs": named_specs(model_cfg, plan)}

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batch = to_device(batch, next(iter(params.values())).device)
        for p in params.values():
            p.grad = None
        if n_micro == 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            losses = []
            for i in range(n_micro):
                mb_loss, _ = loss_fn(model, {k: v[i] for k, v in batch.items()})
                mb_loss.backward()
                losses.append(mb_loss.detach())
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(n_micro)
            loss = torch.stack(losses).mean()
            metrics = {}
        grads = {k: p.grad for k, p in params.items()}
        om = opt.apply_updates(params, grads, opt_state, opt_cfg, **sharded)
        for p in params.values():
            p.grad = None
        return dict(metrics, loss=loss.detach(), **om)

    return train_step
