"""Atomic, resumable checkpoints in the reference's on-disk format (the port
of the reference's ``train/checkpoint.py``).

  * atomic publish: leaves are written to ``tmp-<step>`` and the directory
    is renamed to ``step_<08d>`` only when complete, so a crash mid-save
    never corrupts the latest checkpoint;
  * one ``.npy`` per leaf, named from the leaf's key path as the
    reference's ``_flatten`` writes it (``['params']['blocks']['attn']
    ['wq']``), and ``meta.json`` with the manifest: either package restores
    what the other saved;
  * the stateless data pipeline (``data.py``) is keyed by step, so the step
    is all the reader state there is.

numpy has no bfloat16, so a bf16 leaf is saved as its f32 values (exact)
and its dtype is recorded under ``meta["dtypes"]``; ``restore`` casts every
leaf to its template's dtype, which gives back the same bits.
``training_tree`` and ``load_training_tree`` lay a model and its optimizer
state out as the reference's ``{"params": ..., "opt": ...}`` tree, in the
model family's own layout (``models/weights.py`` for the ``Transformer``,
``models/recsys/deepfm.py`` for ``DeepFM``, ``models/gnn/api.py`` for the
``GNN``).

Mesh elasticity: arrays are stored whole.  ``save(..., plan=, specs=)``
of a sharded model's tree (``models/weights.py``'s ``training_specs``
gives an LM's specs) gathers one leaf at a time on every rank, and rank 0
of the world writes it before the next is gathered, so at most one whole
leaf is live; ``restore(..., plan=, specs=)`` gives each rank its block
under any plan, so a job restarts on another mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.models import weights
from repro_torch.models.gnn import api as gnn
from repro_torch.models.recsys import deepfm
from repro_torch.shard import collectives as C
from repro_torch.shard.plans import local_shard


def _flatten(tree, prefix: str = "") -> dict:
    """``{key path: leaf}`` with the reference's key strings: ``['name']``
    for a dict key, ``[i]`` for a list index; a ``None`` leaf is an empty
    subtree, as in JAX."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _unflatten(template, values: dict, prefix: str = ""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}[{k!r}]") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, values, f"{prefix}[{i}]") for i, v in enumerate(template)]
    return values[prefix]


def _numpy(leaf) -> tuple[np.ndarray, str | None]:
    """The array to save and, for a bf16 tensor, its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten_specs(specs, prefix: str = "") -> dict:
    """``_flatten`` of a spec tree (nested dicts of ``P``, which are tuples
    but leaves here)."""
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(_flatten_specs(specs[k], f"{prefix}[{k!r}]"))
        return out
    return {prefix: specs}


def save(path: str, step: int, tree, meta: dict | None = None, plan=None, specs=None) -> str:
    """Write ``tree`` as ``step_<08d>`` under ``path``, atomically.  With a
    ``plan``, ``tree`` holds this rank's blocks and ``specs`` their specs:
    every rank gathers one whole leaf at a time, in the same order, world
    rank 0 writes it and every rank drops it before the next; no rank
    returns before the directory is published."""
    leaves = _flatten(tree)
    if plan is None:
        return _save(path, step, leaves.items(), meta)
    import torch.distributed as dist

    leaf_specs = _flatten_specs(specs)
    whole = ((k, C.full_from_shards(t, leaf_specs[k], plan, "checkpoint")) for k, t in leaves.items())
    if dist.get_rank() == 0:
        final = _save(path, step, whole, meta)
    else:
        final = os.path.join(path, f"step_{step:08d}")
        for _ in whole:  # this rank's part in each leaf's gather
            pass
    C.all_reduce(torch.zeros(1, device=next(iter(leaves.values())).device),
                 plan, plan.axes, "checkpoint.published")
    return final


def _save(path: str, step: int, leaves, meta: dict | None = None) -> str:
    """Write the ``(key, leaf)`` pairs, one at a time, and publish."""
    tmp = os.path.join(path, f"tmp-{step}")
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest, dtypes = {}, {}
    for key, leaf in leaves:
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        arr, dtype = _numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = fname
        if dtype:
            dtypes[key] = dtype
    extra = {"dtypes": dtypes} if dtypes else {}
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"step": step, "manifest": manifest, **extra, **(meta or {})}, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def restore(ckpt_dir: str, template, device=None, plan=None, specs=None):
    """Load into the structure of ``template`` (a tree of tensors): each
    leaf in its template's dtype, on ``device`` (default: the template
    leaf's device).  With a ``plan``, each leaf is this rank's block of
    the stored array under its spec in ``specs`` (a tree like
    ``template``'s), whatever mesh saved it.  Returns ``(tree, meta)``."""
    with open(os.path.join(ckpt_dir, "meta.json")) as fh:
        meta = json.load(fh)
    leaf_specs = {} if plan is None else _flatten_specs(specs)
    loaded = {}
    for key, leaf in _flatten(template).items():
        arr = np.load(os.path.join(ckpt_dir, meta["manifest"][key]))
        if plan is not None:
            arr = local_shard(arr, leaf_specs[key], plan)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: the checkpoint holds shape {arr.shape}, the template {tuple(leaf.shape)}")
        dev = leaf.device if device is None else torch.device(device)
        loaded[key] = torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
    return _unflatten(template, loaded), meta


class CheckpointManager:
    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.path):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, meta=None) -> str:
        out = save(self.path, step, tree, meta)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{old:08d}"))
        return out

    def restore_latest(self, template, device=None):
        step = self.latest()
        if step is None:
            return None
        tree, meta = restore(os.path.join(self.path, f"step_{step:08d}"), template, device)
        return step, tree, meta


# ---------------------------------------------------------------------- #
# A model and its optimizer state as the reference's tree
# ---------------------------------------------------------------------- #


def _layout(model):
    """The model family's ``(stack, unstack)``: a ``{parameter name: leaf}``
    mapping to the reference's tree, and back."""
    if isinstance(model, deepfm.DeepFM):
        return deepfm.reference_tree, deepfm.unstack_reference
    if isinstance(model, gnn.GNN):
        return lambda values: gnn.reference_tree(model, values), gnn.unstack_reference
    return (lambda values: weights.reference_tree(model, values),
            lambda tree: weights.unstack_reference(tree, model))


def training_tree(model, opt_state: dict) -> dict:
    """``{"params": ..., "opt": {"step", "m", "v"}}``: the model's
    parameters and the state's moments stacked as the reference's tree."""
    stack, _ = _layout(model)
    return {
        "params": stack(dict(model.named_parameters())),
        "opt": {"step": opt_state["step"], "m": stack(opt_state["m"]), "v": stack(opt_state["v"])},
    }


@torch.no_grad()
def load_training_tree(tree, model, opt_state: dict) -> None:
    """Write a ``training_tree``-shaped ``tree`` into ``model`` (in place)
    and ``opt_state``."""
    _, unstack = _layout(model)
    for name, value in unstack(tree["params"]).items():
        model.get_parameter(name).copy_(value)
    opt_state["step"] = tree["opt"]["step"]
    for key in ("m", "v"):
        opt_state[key] = unstack(tree["opt"][key])
