"""The unified GNN interface used by the trainer (the port of the reference's
``models/gnn/api.py``).

Batch layout (flat node/edge tables, fixed shapes: batched small graphs are
flattened with graph offsets, sampled subgraphs are padded by the sampler):

    node_feat (N, d_feat) f32      positions (N, 3) f32 [equivariant archs]
    edge_src/edge_dst (E,) int32   edge_feat (E, d_edge) f32 [meshgraphnet]
    node_mask (N,) f32             edge_mask (E,) f32
    labels (N,) int32 [gcn]        targets (N, d_out) f32 [regression archs]

``GNN`` holds the reference tree's leaves as parameters under its nesting
(``w.0``, ``blocks.3.edge_mlp.1.b``, ``layers.0.w_re.1``, ...), drawn from
a ``torch.Generator`` seeded with ``seed`` (the values differ from the
reference's JAX draws; the tests load the reference's through
``params_from_reference``).  A dict of the tree is a module whose entries
read as ``node[key]``, so the forward functions index it as the reference
indexes its tree.  A ``None`` leaf (MACE's ``w_b2``/``w_b3`` when a path
list is empty) is a parameter registered as ``None``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.core.matrices import resolve_device

from ..common import to_numpy
from .dims import D_EDGE, D_OUT
from .equiformer_v2 import eqv2_forward, eqv2_init
from .mace import mace_forward, mace_init
from .simple import gcn_forward, gcn_init, mgn_forward, mgn_init

def needs_positions(cfg: GNNConfig) -> bool:
    return cfg.model in ("equiformer_v2", "mace")


def init_params(cfg: GNNConfig, d_feat: int, *, generator, device) -> dict:
    """The reference's parameter tree (nested dicts and lists of tensors)."""
    kw = {"generator": generator, "device": device}
    if cfg.model == "gcn":
        return gcn_init(cfg, d_feat, **kw)
    if cfg.model == "meshgraphnet":
        return mgn_init(cfg, d_feat, D_EDGE, D_OUT["meshgraphnet"], **kw)
    if cfg.model == "equiformer_v2":
        return eqv2_init(cfg, d_feat, D_OUT["equiformer_v2"], **kw)
    if cfg.model == "mace":
        return mace_init(cfg, d_feat, D_OUT["mace"], **kw)
    raise ValueError(cfg.model)


class _Node(nn.Module):
    """One dict of the reference's tree: tensors as parameters, a ``None``
    leaf as a parameter registered as ``None``, subtrees as modules; the
    entries keep the tree's order and read as ``node[key]``."""

    def __init__(self, tree: dict):
        super().__init__()
        self.entries = list(tree)
        for k, v in tree.items():
            if v is None or isinstance(v, torch.Tensor):
                self.register_parameter(k, None if v is None else nn.Parameter(v))
            else:
                self.add_module(k, _module(v))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _module(node) -> nn.Module:
    if isinstance(node, dict):
        return _Node(node)
    if all(isinstance(v, torch.Tensor) for v in node):
        return nn.ParameterList(nn.Parameter(v) for v in node)
    return nn.ModuleList(_module(v) for v in node)


class GNN(_Node):
    """The parameters of one GNN of ``cfg``'s model for ``d_feat`` input
    features; a CUDA ``device`` on a machine without a card raises."""

    def __init__(self, cfg: GNNConfig, d_feat: int, *, device="cuda", seed: int = 0):
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        super().__init__(init_params(cfg, d_feat, generator=gen, device=dev))
        self.cfg, self.d_feat = cfg, d_feat


def forward(params: GNN, batch, cfg: GNNConfig) -> torch.Tensor:
    fn = {
        "gcn": gcn_forward,
        "meshgraphnet": mgn_forward,
        "equiformer_v2": eqv2_forward,
        "mace": mace_forward,
    }[cfg.model]
    return fn(params, batch, cfg)


def loss_fn(params: GNN, batch, cfg: GNNConfig):
    """The masked mean NLL of the logits (gcn, ``{"nll"}``) or the masked
    MSE against ``targets`` (the rest, ``{"mse"}``): ``(loss, metrics)``."""
    out = forward(params, batch, cfg)
    mask = batch["node_mask"]
    if cfg.model == "gcn":
        logp = F.log_softmax(out, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {"nll": loss}
    err = ((out - batch["targets"]) ** 2).mean(dim=-1)
    loss = (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"mse": loss}


# ---------------------------------------------------------------------- #
# The reference's tree
# ---------------------------------------------------------------------- #


def _is_leaf(node) -> bool:
    """A tensor or array, or an int8 moment's ``{"q", "scale"}`` pair."""
    return not isinstance(node, (dict, list, tuple)) or (isinstance(node, dict) and set(node) == {"q", "scale"})


def reference_tree(model: GNN, values=None) -> dict:
    """``values[name]`` for each parameter of ``model`` (default: the
    parameters themselves) in the reference's nesting, ``None`` leaves
    kept."""
    if values is None:
        values = dict(model.named_parameters())

    def walk(mod, prefix: str):
        if isinstance(mod, _Node):
            return {k: walk(mod._modules[k], f"{prefix}{k}.") if k in mod._modules
                    else None if mod._parameters[k] is None else values[prefix + k]
                    for k in mod.entries}
        if isinstance(mod, nn.ParameterList):
            return [values[f"{prefix}{i}"] for i in range(len(mod))]
        return [walk(m, f"{prefix}{i}.") for i, m in enumerate(mod)]

    return walk(model, "")


def unstack_reference(tree) -> dict:
    """The reference's tree as ``{parameter name: leaf}``; ``None`` leaves
    are left out."""
    out = {}

    def walk(node, prefix: str):
        if node is None:
            return
        if _is_leaf(node):
            out[prefix[:-1]] = node
            return
        for k, v in (node.items() if isinstance(node, dict) else enumerate(node)):
            walk(v, f"{prefix}{k}.")

    walk(tree, "")
    return out


def _d_feat(tree, cfg: GNNConfig) -> int:
    if cfg.model == "gcn":
        first = tree["w"][0]
    elif cfg.model == "meshgraphnet":
        first = tree["enc_node"][0]["w"]
    else:
        first = tree["embed"]
    return int(first.shape[0])


def params_from_reference(tree, cfg: GNNConfig, device="cuda") -> GNN:
    """A ``GNN`` on ``device`` holding the reference tree's values (every
    leaf must be present and no other; ``d_feat`` is read off the tree)."""
    dev = resolve_device(device)
    model = GNN(cfg, _d_feat(tree, cfg), device="meta")
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in unstack_reference(tree).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev)


def to_reference(model: GNN, values=None) -> dict:
    """``reference_tree`` as nested dicts and lists of numpy arrays."""
    return to_numpy(reference_tree(model, values))
