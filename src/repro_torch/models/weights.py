"""The reference's parameter trees <-> the port's ``Transformer``.

The reference stacks block parameters over blocks: ``blocks["attn"][name]``
is ``(n_blocks, e, ...)``, ``blocks["dense_ffn"][name]`` ``(n_blocks, e - 1,
...)``, ``blocks["last_ffn"]``, ``blocks["moe"]`` and ``blocks["moe_norm"]``
``(n_blocks, ...)``.  ``params_from_reference`` loads such a tree (nested
dicts of numpy arrays) into a ``Transformer``, so both packages compute with
the same values; ``reference_tree`` and ``to_reference`` stack a model back.

The same layout serves any per-parameter mapping (gradients, AdamW moments,
int8 moments as ``{"q", "scale"}`` pairs): ``reference_tree(model, values)``
stacks ``values[name]`` for each of the model's parameter names, and
``unstack_reference(tree, model)`` takes such a tree apart into those names.
A stacked int8 moment is the reference's own encoding, because the codec's
scales run along the last axis, which stacking leaves alone.  DeepFM keeps
its own layout in ``models/recsys/deepfm.py``.

Sharded over a mesh, a model holds this rank's block of each parameter
under the reference's ``param_specs`` (``named_specs`` gives them by
parameter name): ``shard_model`` cuts a whole model down to them and
``params_from_reference(..., plan=)`` loads a tree straight into them;
``reference_tree`` stacks the blocks as they are, and ``to_reference``
of a sharded model gathers the whole tree back, on every rank (every rank
must call it).  ``training_specs`` gives the specs of a sharded model's
checkpoint tree (``train/checkpoint.py``'s ``training_tree``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.matrices import resolve_device
from repro_torch.shard.collectives import full_from_shards
from repro_torch.shard.plans import MeshPlan, P, local_shard
from repro_torch.train.optimizer import OptimizerConfig, _is_q8, opt_state_specs

from .common import to_numpy
from .transformer import Transformer, _block_counts, param_specs

_STACKED_PER_LAYER = ("attn", "dense_ffn")  # (n_blocks, e or e - 1, ...)


def _index(leaf, idx):
    """``leaf[idx]`` of an array, or of each member of a ``{"q", "scale"}``
    pair."""
    if isinstance(leaf, dict):
        return {k: _index(v, idx) for k, v in leaf.items()}
    return leaf[idx]


def _stack(leaves):
    if isinstance(leaves[0], dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    if isinstance(leaves[0], np.ndarray):
        return np.stack(leaves)
    if leaves[0].is_meta:  # the stack's shape, without torch.stack's slow meta kernel
        return leaves[0].new_empty((len(leaves), *leaves[0].shape))
    return torch.stack(leaves)


def _unstack_lm(tree, cfg: TransformerConfig) -> dict:
    n_blocks, _ = _block_counts(cfg)
    out = {name: tree[name] for name in ("embed", "unembed", "final_norm")}
    for group, leaves in tree["blocks"].items():
        if group == "moe_norm":
            leaves = {None: leaves}
        for name, arr in leaves.items():
            lead = arr["q"] if isinstance(arr, dict) else arr
            if lead.shape[0] != n_blocks:
                raise ValueError(f"blocks.{group}.{name} has {lead.shape[0]} blocks, want {n_blocks}")
            for b in range(n_blocks):
                layers = range(lead.shape[1]) if group in _STACKED_PER_LAYER else [None]
                for i in layers:
                    key = ".".join(str(s) for s in ("blocks", b, group, i, name) if s is not None)
                    out[key] = _index(arr, b if i is None else (b, i))
    return out


def unstack_reference(tree, model: Transformer) -> dict:
    """The reference-layout ``tree`` taken apart into ``{parameter name:
    leaf}`` for ``model``; the leaves keep their type (numpy arrays, tensors
    or ``{"q", "scale"}`` pairs)."""
    return _unstack_lm(tree, model.cfg)


def _state_dict(tree, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in _unstack_lm(tree, cfg).items()}


def named_specs(cfg: TransformerConfig, plan: MeshPlan) -> dict[str, P]:
    """``{parameter name: spec}`` of a ``Transformer`` under ``plan``: the
    reference's ``param_specs`` (training layout) without the stack dims."""
    tree = param_specs(cfg, plan)
    n_blocks, e = _block_counts(cfg)
    out = {name: tree[name] for name in ("embed", "unembed", "final_norm")}
    for group, leaves in tree["blocks"].items():
        if group == "moe_norm":
            leaves = {None: leaves}
        per_layer = group in _STACKED_PER_LAYER
        for name, spec in leaves.items():
            rest = P(*spec[2 if per_layer else 1:])
            for b in range(n_blocks):
                for i in range(e if group == "attn" else e - 1) if per_layer else [None]:
                    out[".".join(str(s) for s in ("blocks", b, group, i, name) if s is not None)] = rest
    return out


def shard_model(model: Transformer, plan: MeshPlan) -> Transformer:
    """``model`` (whole, unsharded) cut down in place to this rank's block
    of every parameter under ``plan``; returns it."""
    if model.plan is not None:
        raise ValueError("the model is sharded already")
    specs = named_specs(model.cfg, plan)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, nn.Parameter(local_shard(p.detach(), specs[name], plan)))
    model.plan = plan
    return model


def params_from_reference(tree, cfg: TransformerConfig, device="cuda",
                          plan: MeshPlan | None = None) -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference tree's values
    (every leaf must be present and no other), or with ``plan`` this rank's
    blocks of them.  A CUDA ``device`` on a machine without a card
    raises."""
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(_state_dict(tree, cfg), strict=True, assign=True)
    if plan is not None:
        shard_model(model, plan)
    return model.to(dev)


def _gather(value, spec: P, plan: MeshPlan):
    """The whole leaf from this rank's block; an int8 moment's scale is
    split as its ``q`` without the last dim."""
    if isinstance(value, dict):
        return {"q": full_from_shards(value["q"], spec, plan),
                "scale": full_from_shards(value["scale"], P(*spec[:-1]), plan)}
    return full_from_shards(value, spec, plan)


def reference_tree(model: Transformer, values=None) -> dict:
    """``values[name]`` for each parameter of ``model`` (default: the
    parameters themselves), stacked as the reference's tree."""
    if values is None:
        values = dict(model.named_parameters())
    cfg = model.cfg
    n_blocks, e = _block_counts(cfg)
    blocks = model.blocks

    def stack(fmt):
        return _stack([values[fmt.format(b=b)] for b in range(n_blocks)])

    def per_layer(group, count):
        names = getattr(blocks[0], group)[0].keys()
        return {n: _stack([_stack([values[f"blocks.{b}.{group}.{i}.{n}"] for i in range(count)])
                           for b in range(n_blocks)])
                for n in names}

    out = {"attn": per_layer("attn", e)}
    if e > 1:
        out["dense_ffn"] = per_layer("dense_ffn", e - 1)
    if cfg.moe:
        out["moe"] = {n: stack(f"blocks.{{b}}.moe.{n}") for n in blocks[0].moe.keys()}
        out["moe_norm"] = stack("blocks.{b}.moe_norm")
    else:
        out["last_ffn"] = {n: stack(f"blocks.{{b}}.last_ffn.{n}") for n in blocks[0].last_ffn.keys()}
    return {"embed": values["embed"], "unembed": values["unembed"],
            "final_norm": values["final_norm"], "blocks": out}


def to_reference(model: Transformer, values=None) -> dict:
    """``reference_tree`` as nested dicts of numpy arrays; of a sharded
    model, the whole tree gathered on every rank."""
    if model.plan is not None:
        specs = named_specs(model.cfg, model.plan)
        values = values if values is not None else dict(model.named_parameters())
        values = {k: _gather(v.detach() if isinstance(v, torch.Tensor) else v, specs[k], model.plan)
                  for k, v in values.items()}
    return to_numpy(reference_tree(model, values))


def training_specs(model: Transformer, opt_state: dict) -> dict:
    """The specs of a sharded LM's ``{"params", "opt"}`` training tree:
    ``param_specs`` of its plan and the optimizer state's
    (``opt_state_specs``)."""
    pspecs = param_specs(model.cfg, model.plan)
    moment = next(iter(opt_state["m"].values()))
    dtype = "int8" if _is_q8(moment) else "float32"
    shapes = reference_tree(Transformer(model.cfg, device="meta"))
    return {"params": pspecs, "opt": opt_state_specs(pspecs, OptimizerConfig(moment_dtype=dtype), shapes)}
