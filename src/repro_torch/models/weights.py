"""The reference's parameter tree <-> a ``Transformer``.

The reference stacks block parameters over blocks: ``blocks["attn"][name]``
is ``(n_blocks, e, ...)``, ``blocks["dense_ffn"][name]`` ``(n_blocks, e - 1,
...)``, ``blocks["last_ffn"]``, ``blocks["moe"]`` and ``blocks["moe_norm"]``
``(n_blocks, ...)``.  ``params_from_reference`` loads such a tree (nested
dicts of numpy arrays) into a ``Transformer``, so both packages compute with
the same values; ``reference_tree`` and ``to_reference`` stack a model back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.matrices import resolve_device

from .transformer import Transformer, _block_counts

_STACKED_PER_LAYER = ("attn", "dense_ffn")  # (n_blocks, e or e - 1, ...)


def _state_dict(tree, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    n_blocks, _ = _block_counts(cfg)
    state = {name: torch.from_numpy(np.array(tree[name], dtype=np.float32))
             for name in ("embed", "unembed", "final_norm")}
    for group, leaves in tree["blocks"].items():
        if not isinstance(leaves, dict):  # moe_norm
            leaves = {None: leaves}
        for name, arr in leaves.items():
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape[0] != n_blocks:
                raise ValueError(f"blocks.{group}.{name} has {arr.shape[0]} blocks, want {n_blocks}")
            for b in range(n_blocks):
                layers = range(arr.shape[1]) if group in _STACKED_PER_LAYER else [None]
                for i in layers:
                    key = ".".join(str(s) for s in ("blocks", b, group, i, name) if s is not None)
                    state[key] = torch.from_numpy(np.array(arr[b] if i is None else arr[b, i]))
    return state


def params_from_reference(tree, cfg: TransformerConfig, device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference tree's values
    (every leaf must be present and no other).  A CUDA ``device`` on a
    machine without a card raises."""
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(_state_dict(tree, cfg), strict=True, assign=True)
    return model.to(dev)


def reference_tree(model: Transformer) -> dict:
    """The model's tensors stacked as the reference's tree (on its device;
    on ``meta`` only the shapes)."""
    cfg = model.cfg
    _, e = _block_counts(cfg)
    blocks = model.blocks

    def stack(get):
        return torch.stack([get(bp) for bp in blocks])

    def per_layer(group, count):
        names = getattr(blocks[0], group)[0].keys()
        return {n: stack(lambda bp: torch.stack([getattr(bp, group)[i][n] for i in range(count)]))
                for n in names}

    out = {"attn": per_layer("attn", e)}
    if e > 1:
        out["dense_ffn"] = per_layer("dense_ffn", e - 1)
    if cfg.moe:
        out["moe"] = {n: stack(lambda bp: bp.moe[n]) for n in blocks[0].moe.keys()}
        out["moe_norm"] = stack(lambda bp: bp.moe_norm)
    else:
        out["last_ffn"] = {n: stack(lambda bp: bp.last_ffn[n]) for n in blocks[0].last_ffn.keys()}
    return {"embed": model.embed, "unembed": model.unembed,
            "final_norm": model.final_norm, "blocks": out}


def to_reference(model: Transformer) -> dict:
    """``reference_tree`` as nested dicts of numpy arrays."""
    def numpy(node):
        if isinstance(node, dict):
            return {k: numpy(v) for k, v in node.items()}
        return node.detach().cpu().numpy()

    return numpy(reference_tree(model))
