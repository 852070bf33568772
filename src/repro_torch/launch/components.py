"""Roofline component cells of the port (the counterpart of the reference's
``launch/components.py``).

The reference composes its scanned programs from their loop bodies,
because XLA's ``cost_analysis`` counts a while/scan body once whatever
its trip count.  The port's counter sees every iteration of an eager
program, so composed and direct counts can be held equal; the components
stay the unit a card measurement times, and the composition says where
a step's work goes:

  LM train step  = n_micro * ( n_blocks * [block fwd (remat's first pass)
                                           + block fwd+bwd]
                               + head fwd+bwd )  +  optimizer update
  LM prefill     = n_blocks * block fwd + head fwd
  CFPQ           = one fixpoint iteration (``dense_step``)

Components run with ``attn_chunk == seq_len``, so the attention is one
chunk.  ``lm_components`` builds them on any device: on ``meta`` under a
plan (rank (0, 0)'s shapes) for the dry run, or on the card with whole
parameters for ``chip_smoke.py``'s roofline phase, which times them.

Writes ``artifacts/components_torch/<arch>__<shape>__<mesh>__<name>.json``
with the dry run's cost keys plus ``multiplier``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import registry
from repro_torch.roofline.count import Counter

from . import specs

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/components_torch")


@dataclass
class Component:
    name: str
    fn: Callable[[], object]  # runs the component once
    multiplier: int


def _randn(shape, dtype, dev, gen) -> torch.Tensor:
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _tokens(shape, vocab: int, dev, gen) -> torch.Tensor:
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return torch.randint(0, vocab, shape, generator=gen, device=dev, dtype=torch.int32)


def lm_components(cfg0, shape, plan=None, device="meta", mb: int | None = None,
                  act_dtype: str | None = None, n_micro: int | None = None) -> list[Component]:
    """The components of an LM train or prefill cell (a config and a
    ``ShapeSpec``), with their multipliers.  ``plan`` runs them at its rank
    (0, 0)'s shapes (its collectives shape-only on ``meta``); without one
    the parameters are whole.  ``mb`` is the microbatch the blocks see,
    global under a plan (default: the cell's, of ``n_micro`` microbatches,
    ``specs.N_MICRO`` by default); ``act_dtype`` overrides the config's
    activation dtype.  Weights and inputs are drawn from seed 0 (on
    ``meta`` only shapes)."""
    from repro_torch.core.matrices import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt

    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    n_micro = n_micro or specs.N_MICRO
    seq = shape.dim("seq_len")
    cfg = dataclasses.replace(cfg0, attn_chunk=seq, dtype=act_dtype or cfg0.dtype)
    n_blocks, e = tf._block_counts(cfg)
    if shape.kind == "train":
        mb = mb or shape.dim("global_batch") // n_micro
        train = True
    elif shape.kind == "prefill":
        mb = mb or shape.dim("global_batch")
        train = False
    else:
        raise ValueError(shape.kind)
    low_mem = cfg.arch_id in specs._LOW_MEM_ARCHS
    pdt = torch.bfloat16 if (low_mem or not train) else torch.float32
    act = tf._act_dtype(cfg)
    one = dataclasses.replace(cfg, n_layers=e)
    model = specs._lm_model(one, plan, pdt, dev)
    bp = model.blocks[0]
    x_shape = (mb, seq, cfg.d_model)
    if plan is not None:
        x_shape = specs.shard_shape(x_shape, tf._x_spec(cfg, plan), plan)
    x = _randn(x_shape, act, dev, gen)
    toks = _tokens((mb, seq), cfg.vocab, dev, gen)
    head = [model.embed, model.unembed, model.final_norm]

    def embed(tokens):
        x = tf._embed(model, tf._rows(tokens, plan), one, plan)
        return tf._seq_block(x, plan) if tf._seq_parallel(one, plan) else x

    if not train:
        def pf_block():
            with torch.inference_mode():
                return tf.apply_block(bp, x, one, plan=plan)[0]

        def head_fwd():
            with torch.inference_mode():
                h = embed(toks)[:, -1:]
                return tf._logits(model, h, one, plan)

        return [Component("block_fwd", pf_block, n_blocks), Component("head_fwd", head_fwd, 1)]

    from torch.utils.checkpoint import checkpoint

    def block_fwd():
        # the remat's first pass, as the train step runs it: a checkpointed
        # block, whose activations are not kept
        y, aux = checkpoint(tf.apply_block, bp, x, one, True, plan, use_reentrant=False)
        return y.float().sum() + aux

    def block_fwdbwd():
        # the backward's recompute of the block and its backward
        xg = x.detach().requires_grad_(True)
        y, aux = tf.apply_block(bp, xg, one, True, plan)
        return torch.autograd.grad(y.float().sum() + aux, [*bp.parameters(), xg])

    def head_fwdbwd():
        loss = tf.lm_head_loss(model, embed(toks), toks, one, plan)
        return torch.autograd.grad(loss, head)

    full = specs._lm_model(cfg, plan, pdt, dev)
    ocfg = specs._lm_opt_cfg(cfg)
    state = opt.init_opt_state(full, ocfg)
    grads = {k: _randn(p.shape, torch.float32, dev, gen) for k, p in full.named_parameters()}
    sharded = {}
    if plan is not None:
        from repro_torch.models.weights import named_specs

        sharded = {"plan": plan, "specs": named_specs(cfg, plan)}

    def opt_step():
        return opt.apply_updates(full, grads, state, ocfg, **sharded)

    return [Component("block_fwd", block_fwd, n_micro * n_blocks),
            Component("block_fwdbwd", block_fwdbwd, n_micro * n_blocks),
            Component("head_fwdbwd", head_fwdbwd, n_micro),
            Component("opt", opt_step, 1)]


def _cfpq_components(shape_name: str, plan) -> list[Component]:
    cell = specs.build_cell("cfpq", shape_name, plan, engine="dense")
    return [Component("iteration", cell.program(), 1)]


def count_component(comp: Component) -> dict:
    with Counter() as c:
        comp.fn()
    return c.summary()


def run(arch: str, shape: str, mesh_kind: str, out_dir: str) -> list[dict]:
    """Count every component of the cell on ``meta`` under the mesh's plan
    and write one JSON each."""
    from repro_torch.launch.mesh import production_plan

    plan = production_plan(multi_pod=mesh_kind == "multi")
    if arch == "cfpq":
        comps, per = _cfpq_components(shape, plan), plan.world  # global iteration over ranks
    else:
        cfg = registry.get_config(arch)
        spec = next(s for s in registry.get_shapes(arch) if s.name == shape)
        comps, per = lm_components(cfg, spec, plan), 1
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for comp in comps:
        t0 = time.perf_counter()
        cost = count_component(comp)
        coll = cost["collectives"]
        if arch == "cfpq":
            coll = specs.priced_collectives(specs.build_cell("cfpq", shape, plan, engine="dense"))
        rec = {
            "arch": arch,
            "shape": shape,
            "mesh": mesh_kind,
            "component": comp.name,
            "multiplier": comp.multiplier,
            "method": "global_over_ranks" if per > 1 else "per_rank",
            "flops": cost["flops"] / per,
            "flops_by_dtype": {k: v / per for k, v in cost["flops_by_dtype"].items()},
            "bytes_accessed": cost["bytes_accessed"] / per,
            "transcendentals": cost["transcendentals"] / per,
            "peak_bytes": cost["peak_bytes"] / per,
            "collectives": coll,
            "compile_s": round(time.perf_counter() - t0, 2),
        }
        tag = f"{arch}__{shape}__{mesh_kind}__{comp.name}"
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as fh:
            json.dump(rec, fh, indent=1)
        out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for rec in run(args.arch, args.shape, args.mesh, args.out or os.path.normpath(OUT_DIR)):
        print(f"[components] {args.arch}__{args.shape}__{args.mesh}__{rec['component']} "
              f"x{rec['multiplier']} flops={rec['flops']:.3e} "
              f"coll={rec['collectives']['_total']['moved_bytes']:.3e}B")


if __name__ == "__main__":
    main()
