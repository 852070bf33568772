"""Per-(arch x shape x mesh) dry-run cells of the port (the counterpart of
the reference's ``launch/specs.py``): the step, its arguments as ``meta``
tensors at their global shapes, in the reference's trees, and their specs.

``build_cell(arch_id, shape_name, plan)`` returns a :class:`Cell`; nothing
is allocated anywhere, so the 400B-parameter cells build on the CPU.
``count_cell(cell)`` runs the cell's step under ``roofline/count.py``'s
counter, the counterpart of the reference's ``lower_cell`` and XLA's
cost analysis.

Dtype/memory policy (the reference's):
  * dense LMs train with f32 master params + f32 moments;
  * the MoE giants (llama4 400B, qwen3 235B) train with bf16 params and
    int8 row-wise moments (train/optimizer.py): the fully-sharded state is
    the only way those fit 16G-HBM chips at 256 devices;
  * all serving is bf16.

Each count says how it was made (``Cell.method``):
  * ``per_rank``: the step ran under a plan without process groups
    (``launch/mesh.py::production_plan``), at the first rank's shapes, its
    collectives shape-only (LM train and prefill on both meshes, CFPQ
    ``opt``);
  * ``global_over_ranks``: the port's step takes no plan, so the global
    step is counted and divided by the ranks, and the collectives are
    priced from the specs (:func:`priced_collectives`).

A step whose cost repeats over blocks or microbatches is counted at two
depths of each (``Cell.depth``) and extended to its own multilinearly:
the blocks are one program, so each count is linear in them.  ``direct``
runs the whole step instead (tests hold the two equal at a reduced size).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import CFPQConfig, GNNConfig, RecSysConfig, ShapeSpec, TransformerConfig
from repro_torch.roofline.count import Counter
from repro_torch.shard.plans import MeshPlan, P
from repro_torch.train import optimizer as opt

#: archs whose optimizer state must be low-precision to fit HBM
_LOW_MEM_ARCHS = {"llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"}

N_MICRO = int(os.environ.get("REPRO_TORCH_N_MICRO", "8"))  # LM train microbatches

META = torch.device("meta")

@dataclass
class Cell:
    arch_id: str
    shape: ShapeSpec
    plan: MeshPlan
    args: tuple  # the step's arguments: trees of meta tensors, global shapes
    in_specs: tuple  # a spec tree (of ``P``) per argument
    out: Any  # the step's outputs that stay on the device, global shapes
    out_specs: Any
    program: Callable  # program(**depth) -> a zero-argument step
    method: str  # per_rank | global_over_ranks
    depth: dict = field(default_factory=dict)  # {name: full depth} of a repeated cost
    donate_argnums: tuple = ()
    note: str = ""

    @property
    def n_devices(self) -> int:
        return self.plan.world


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _cast_tree(tree, dtype):
    return _tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _same_spec(tree, spec=P()):
    return _tree_map(lambda _: spec, tree)


def _pad(n: int, mult: int = 512) -> int:
    return -(-n // mult) * mult


def leaves(tree, path=()):
    """``(path, leaf)`` of every tensor of a tree, dicts in sorted key
    order as JAX flattens them; ``None`` leaves have none."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, (*path, i))
    elif tree is not None:
        yield path, tree


def _spec_at(specs, path):
    for k in path:
        if isinstance(specs, P) or specs is None:
            return specs
        specs = specs[k]
    return specs


def shard_shape(shape, spec, plan: MeshPlan) -> tuple:
    """One rank's block of a ``shape`` tensor under ``spec`` (equal blocks:
    every split dim divides)."""
    out = list(shape)
    for dim, axis in enumerate(spec or ()):
        if axis is not None:
            size = plan.axis_size(axis)
            if out[dim] % size:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axis!r}")
            out[dim] //= size
    return tuple(out)


def per_rank_leaves(tree, specs, plan: MeshPlan) -> dict:
    """``{path: (global shape, per-rank shape, dtype)}`` of a tree under its
    spec tree."""
    return {path: (tuple(t.shape), shard_shape(t.shape, _spec_at(specs, path), plan), t.dtype)
            for path, t in leaves(tree)}


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def per_rank_bytes(tree, specs, plan: MeshPlan) -> int:
    return sum(_nbytes(local, dt) for _, local, dt in per_rank_leaves(tree, specs, plan).values())


# ---------------------------------------------------------------------- #
# LM cells
# ---------------------------------------------------------------------- #


def _lm_opt_cfg(cfg: TransformerConfig) -> opt.OptimizerConfig:
    if cfg.arch_id in _LOW_MEM_ARCHS:
        return opt.OptimizerConfig(moment_dtype="int8")
    return opt.OptimizerConfig()


def _lm_params(cfg: TransformerConfig, dtype=torch.float32):
    """The reference's stacked parameter tree, on meta."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import reference_tree

    tree = reference_tree(tf.Transformer(cfg, device="meta"))
    return tree if dtype == torch.float32 else _cast_tree(tree, dtype)


def _opt_state_tree(params, ocfg: opt.OptimizerConfig):
    """The reference's ``init_opt_state`` of a parameter tree, on meta."""
    return {"step": _meta((), torch.int32),
            "m": _tree_map(lambda p: opt._moment_zeros(p, ocfg.moment_dtype), params),
            "v": _tree_map(lambda p: opt._moment_zeros(p, ocfg.moment_dtype), params)}


def _depth_cfg(cfg: TransformerConfig, n_blocks: int | None) -> TransformerConfig:
    from repro_torch.models.transformer import _block_counts

    if n_blocks is None:
        return cfg
    _, e = _block_counts(cfg)
    return dataclasses.replace(cfg, n_layers=n_blocks * e)


def _lm_model(cfg: TransformerConfig, plan: MeshPlan | None, dtype, device="meta"):
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import shard_model

    model = tf.Transformer(cfg, device=device).to(dtype)
    return model if plan is None else shard_model(model, plan)


def _lm_train_cell(cfg: TransformerConfig, shape: ShapeSpec, plan: MeshPlan) -> Cell:
    from repro_torch.models import transformer as tf
    from repro_torch.train import trainer

    seq, gbatch = shape.dim("seq_len"), shape.dim("global_batch")
    mb = gbatch // N_MICRO
    if mb % (plan.pod_size * plan.data_size):
        raise ValueError(f"microbatch {mb} does not split over {plan}")
    pdt = torch.bfloat16 if cfg.arch_id in _LOW_MEM_ARCHS else torch.float32
    params = _lm_params(cfg, pdt)
    ocfg = _lm_opt_cfg(cfg)
    state = _opt_state_tree(params, ocfg)
    batch = {k: _meta((N_MICRO, mb, seq), torch.int32) for k in ("tokens", "targets")}
    pspecs = tf.param_specs(cfg, plan)
    ospecs = opt.opt_state_specs(pspecs, ocfg, params=params,
                                 data_size=plan.data_size, model_size=plan.model_size)
    bspec = {k: P(None, plan.batch, None) for k in batch}

    def program(n_micro=N_MICRO, n_blocks=None):
        c = _depth_cfg(cfg, n_blocks)
        model = _lm_model(c, plan, pdt)
        st = opt.init_opt_state(model, ocfg)
        b = {k: _meta((n_micro, mb, seq), torch.int32) for k in batch}
        step = trainer.make_train_step(c, ocfg, n_micro=n_micro, plan=plan)
        return lambda: step(model, st, b)

    n_blocks, _ = tf._block_counts(cfg)
    return _lm_cell(cfg, shape, plan, (params, state, batch), (pspecs, ospecs, bspec),
                    (params, state), (pspecs, ospecs), program,
                    {"n_micro": N_MICRO, "n_blocks": n_blocks}, donate=(0, 1))


def _lm_cell(cfg, shape, plan, args, in_specs, out, out_specs, program, depth, donate=(),
             method="per_rank") -> Cell:
    return Cell(cfg.arch_id, shape, plan, args, in_specs, out, out_specs, program, method,
                depth, donate)


def _lm_prefill_cell(cfg: TransformerConfig, shape: ShapeSpec, plan: MeshPlan) -> Cell:
    from repro_torch.models import transformer as tf

    seq, batch = shape.dim("seq_len"), shape.dim("global_batch")
    params = _lm_params(cfg, torch.bfloat16)
    pspecs = tf.param_specs(cfg, plan)
    tokens = _meta((batch, seq), torch.int32)

    def program(n_blocks=None):
        c = _depth_cfg(cfg, n_blocks)
        model = _lm_model(c, plan, torch.bfloat16)
        return lambda: tf.prefill_step(model, tokens, c, plan)

    n_blocks, _ = tf._block_counts(cfg)
    logits = _meta((batch, cfg.vocab))
    return _lm_cell(cfg, shape, plan, (params, tokens), (pspecs, P(plan.batch, None)), logits,
                    P(plan.batch, plan.tp_dim(cfg.vocab)), program, {"n_blocks": n_blocks})


def _lm_decode_cell(cfg: TransformerConfig, shape: ShapeSpec, plan: MeshPlan) -> Cell:
    from repro_torch.models import transformer as tf

    seq, batch = shape.dim("seq_len"), shape.dim("global_batch")
    seq_shard = batch == 1  # long-context: shard the cache over sequence
    params = _lm_params(cfg, torch.bfloat16)
    pspecs = tf.param_specs(cfg, plan, decode=True)
    cache = tf.init_cache(cfg, batch, seq, dtype=torch.bfloat16, device="meta")
    cspecs = tf.cache_specs(cfg, plan, seq_shard=seq_shard)
    if seq_shard:
        # window caches of local layers stay unsharded in seq if too small
        cspecs = [
            {k: s if cache[i][k].shape[1] % (plan.pod_size * plan.data_size) == 0
             else P(None, None, None, plan.model_axis) for k, s in spec.items()}
            for i, spec in enumerate(cspecs)
        ]
    tokens = _meta((batch, 1), torch.int32)
    pos = _meta((), torch.int32)
    tok_spec = P(plan.batch, None) if not seq_shard else P(None, None)
    logits_spec = P(plan.batch if not seq_shard else None, plan.tp_dim(cfg.vocab))

    def program():
        model = _lm_model(cfg, None, torch.bfloat16)
        c = tf.init_cache(cfg, batch, seq, dtype=torch.bfloat16, device="meta")
        return lambda: tf.serve_step(model, c, tokens, seq - 1, cfg)

    return _lm_cell(cfg, shape, plan, (params, cache, tokens, pos), (pspecs, cspecs, tok_spec, P()),
                    (_meta((batch, cfg.vocab)), cache), (logits_spec, cspecs), program, {},
                    donate=(1,), method="global_over_ranks")


# ---------------------------------------------------------------------- #
# GNN cells
# ---------------------------------------------------------------------- #


def _gnn_batch_struct(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    from repro_torch.models.gnn.common import sampled_sizes
    from repro_torch.models.gnn.dims import D_OUT

    dims = dict(shape.dims)
    if shape.kind == "graph_sampled":
        n, e = sampled_sizes(dims["batch_nodes"], (dims["fanout1"], dims["fanout2"]))
    elif shape.kind == "graph_batched":
        n, e = dims["n_nodes"] * dims["batch"], dims["n_edges"] * dims["batch"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    n, e = _pad(n), _pad(e)
    batch = {
        "node_feat": _meta((n, dims["d_feat"])),
        "edge_src": _meta((e,), torch.int32),
        "edge_dst": _meta((e,), torch.int32),
        "node_mask": _meta((n,)),
        "edge_mask": _meta((e,)),
    }
    if cfg.model == "gcn":
        batch["labels"] = _meta((n,), torch.int32)
    else:
        batch["targets"] = _meta((n, D_OUT[cfg.model]))
    if cfg.model == "meshgraphnet":
        batch["edge_feat"] = _meta((e, 4))
    if cfg.model in ("equiformer_v2", "mace"):
        batch["positions"] = _meta((n, 3))
    return batch


def _gnn_cell(cfg: GNNConfig, shape: ShapeSpec, plan: MeshPlan) -> Cell:
    from repro_torch.models.gnn import api
    from repro_torch.train import trainer

    batch = _gnn_batch_struct(cfg, shape)
    d_feat = batch["node_feat"].shape[1]
    params = api.init_params(cfg, d_feat, generator=None, device=META)
    ocfg = opt.OptimizerConfig()
    state = _opt_state_tree(params, ocfg)
    bspec = {k: P(plan.axes, *([None] * (v.dim() - 1))) for k, v in batch.items()}

    def program():
        model = api.GNN(cfg, d_feat, device="meta")
        st = opt.init_opt_state(model, ocfg)
        step = trainer.make_train_step(cfg, ocfg, n_micro=1)
        return lambda: step(model, st, batch)

    return Cell(cfg.arch_id, shape, plan, (params, state, batch),
                (_same_spec(params), _same_spec(state), bspec), (params, state),
                (_same_spec(params), _same_spec(state)), program, "global_over_ranks",
                donate_argnums=(0, 1))


# ---------------------------------------------------------------------- #
# RecSys cells
# ---------------------------------------------------------------------- #


def _recsys_batch_struct(cfg: RecSysConfig, batch: int) -> dict:
    return {
        "sparse_ids": _meta((batch, cfg.n_sparse, cfg.multi_hot), torch.int32),
        "sparse_mask": _meta((batch, cfg.n_sparse, cfg.multi_hot)),
        "dense_feat": _meta((batch, cfg.n_dense)),
        "labels": _meta((batch,), torch.int32),
    }


def _recsys_param_specs(params, cfg: RecSysConfig, plan: MeshPlan) -> dict:
    specs = _same_spec(params)
    specs["tables"] = P(None, plan.model_axis, None)
    specs["w1_tables"] = P(None, plan.model_axis, None)
    return specs


def _recsys_cell(cfg: RecSysConfig, shape: ShapeSpec, plan: MeshPlan) -> Cell:
    from repro_torch.models.recsys import deepfm
    from repro_torch.train import trainer

    model0 = deepfm.DeepFM(cfg, device="meta")
    params = deepfm.reference_tree(dict(model0.named_parameters()))
    params = _tree_map(lambda t: t.detach(), params)
    pspecs = _recsys_param_specs(params, cfg, plan)

    def cell(args, in_specs, out, out_specs, make, donate=()):
        # make(model) -> the zero-argument step, its state built outside it
        def program():
            return make(deepfm.DeepFM(cfg, device="meta"))

        return Cell(cfg.arch_id, shape, plan, args, in_specs, out, out_specs, program,
                    "global_over_ranks", donate_argnums=donate)

    if shape.kind == "retrieval":
        n_cand = shape.dim("n_candidates")
        batch = _recsys_batch_struct(cfg, 1)
        batch["candidate_ids"] = _meta((_pad(n_cand),), torch.int32)
        bspec = {k: P() for k in batch}
        bspec["candidate_ids"] = P(plan.axes)
        return cell((params, batch), (pspecs, bspec), _meta((_pad(n_cand),)), P(plan.axes),
                    lambda m: partial(deepfm.retrieval_scores, m, batch, cfg))

    b = shape.dim("batch")
    batch = _recsys_batch_struct(cfg, b)
    bspec = {k: P(plan.batch, *([None] * (v.dim() - 1))) for k, v in batch.items()}
    if shape.kind == "train":
        ocfg = opt.OptimizerConfig()
        state = _opt_state_tree(params, ocfg)
        ospecs = opt.opt_state_specs(pspecs, ocfg, params=params,
                                     data_size=plan.data_size, model_size=plan.model_size)
        step = trainer.make_train_step(cfg, ocfg, n_micro=1)
        return cell((params, state, batch), (pspecs, ospecs, bspec), (params, state),
                    (pspecs, ospecs), lambda m: partial(step, m, opt.init_opt_state(m, ocfg), batch),
                    donate=(0, 1))
    return cell((params, batch), (pspecs, bspec), _meta((b,)), P(plan.batch),
                lambda m: partial(deepfm.forward, m, batch, cfg))


# ---------------------------------------------------------------------- #
# CFPQ cells (the paper's workload at datacenter scale)
# ---------------------------------------------------------------------- #


def cfpq_grammar_tables():
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.matrices import ProductionTables

    g = query1_grammar().to_cnf()
    return g, ProductionTables.from_grammar(g)


def _cfpq_cell(cfg: CFPQConfig, shape: ShapeSpec, plan: MeshPlan, engine=None) -> Cell:
    from repro_torch.core import closure
    from repro_torch.shard.plans import ShardedState

    g, tables = cfpq_grammar_tables()
    n = shape.dim("n_nodes")
    tspec = P(None, plan.batch, plan.model_axis)
    eng = engine or cfg.engine
    if eng == "opt":
        # packed-state engine (beyond-paper): per-iteration step on packed
        # words, one-sided packed exchange, the bitmm kernel per rank
        Tp = _meta((g.n_nonterms, n, n // 32), torch.int32)

        def program():
            local = _meta(shard_shape(Tp.shape, tspec, plan), torch.int32)
            return lambda: closure.opt_step(ShardedState(local, n, plan, packed=True), tables, n, plan)

        return Cell(cfg.arch_id, shape, plan, (Tp,), (tspec,), Tp, tspec, program, "per_rank",
                    donate_argnums=(0,), note="engine=opt (per-iteration step on packed state)")
    T = _meta((g.n_nonterms, n, n), torch.bool)
    if eng == "dense":
        def program():
            return lambda: closure.dense_step(T, tables)
    elif eng == "frontier":
        def program():
            return lambda: closure.frontier_step(T, T, tables)
    else:
        raise ValueError(f"no dry-run cell for the {eng!r} engine")
    return Cell(cfg.arch_id, shape, plan, (T,), (tspec,), T, tspec, program, "global_over_ranks",
                donate_argnums=(0,), note=f"engine={eng} (per-iteration step)")


# ---------------------------------------------------------------------- #


def build_cell(arch_id: str, shape_name: str, plan: MeshPlan, **kw) -> Cell:
    cfg = registry.get_config(arch_id)
    shape = next(s for s in registry.get_shapes(arch_id) if s.name == shape_name)
    if isinstance(cfg, TransformerConfig):
        if shape.kind == "train":
            return _lm_train_cell(cfg, shape, plan)
        if shape.kind == "prefill":
            return _lm_prefill_cell(cfg, shape, plan)
        if shape.kind == "decode":
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                raise ValueError("long_500k inapplicable: pure full-attention arch")
            return _lm_decode_cell(cfg, shape, plan)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(cfg, shape, plan)
    if isinstance(cfg, RecSysConfig):
        return _recsys_cell(cfg, shape, plan)
    if isinstance(cfg, CFPQConfig):
        return _cfpq_cell(cfg, shape, plan, **kw)
    raise KeyError((arch_id, shape_name))


# ---------------------------------------------------------------------- #
# Counting
# ---------------------------------------------------------------------- #

#: the depths a repeated cost is counted at: two microbatches and three
#: (one has no gradient accumulation), one block and two
_DEPTHS = {"n_micro": (2, 3), "n_blocks": (1, 2)}


def _run(cell: Cell, **depth) -> dict:
    step = cell.program(**depth)
    with Counter() as c:
        step()
    return c.summary()


def _numbers(summary: dict, prefix=()) -> dict:
    """Every number of a summary, by its key path."""
    out = {}
    for k, v in summary.items():
        if isinstance(v, dict):
            out.update(_numbers(v, (*prefix, k)))
        elif isinstance(v, (int, float)):
            out[(*prefix, k)] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _extend(cell: Cell, runs: dict) -> dict:
    """Each number of the runs at the corners of ``_DEPTHS`` extended
    multilinearly to the cell's own depth."""
    names = list(cell.depth)
    keys = set()
    for s in runs.values():
        keys |= set(_numbers(s))
    out = {}
    for key in keys:
        total = 0.0
        for corner, s in runs.items():
            weight = 1.0
            for name, pick in zip(names, corner):
                lo, hi = _DEPTHS[name]
                t = (cell.depth[name] - lo) / (hi - lo)
                weight *= t if pick else 1 - t
            total += weight * _numbers(s).get(key, 0)
        out[key] = round(total)
    summary = _nest(out)
    for key in ("flops_by_dtype", "kernels"):  # kept when empty
        summary.setdefault(key, {})
    return summary


def count_cell(cell: Cell, direct: bool = False) -> dict:
    """The cell's counts (``roofline/count.py``'s summary, per rank).
    ``per_rank`` cells count rank (0, 0)'s step; ``global_over_ranks``
    cells the global step divided by the ranks, with the collectives
    priced from the specs.  A cell with a ``depth`` is counted at the
    corners of ``_DEPTHS`` and extended, unless ``direct``."""
    t0 = time.perf_counter()
    if cell.depth and not direct:
        corners = list(itertools.product((0, 1), repeat=len(cell.depth)))
        runs = {c: _run(cell, **{name: _DEPTHS[name][pick] for name, pick in zip(cell.depth, c)})
                for c in corners}
        summary = _extend(cell, runs)
        summary["depth"] = {"counted": {n: list(_DEPTHS[n]) for n in cell.depth},
                            "extended_to": dict(cell.depth)}
    else:
        summary = _run(cell)
    if cell.method == "global_over_ranks":
        k = cell.n_devices
        summary = {**_tree_map_numbers(summary, lambda v: v / k),
                   "collectives": priced_collectives(cell)}
    summary["count_s"] = time.perf_counter() - t0
    return summary


def _tree_map_numbers(tree: dict, fn) -> dict:
    return {k: _tree_map_numbers(v, fn) if isinstance(v, dict)
            else fn(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else v
            for k, v in tree.items()}


def priced_collectives(cell: Cell) -> dict:
    """The collectives of a ``global_over_ranks`` cell, per rank, priced
    from its specs as the port's sharded code moves the data:

      * a CFPQ state, sharded ``(None, row, model)``, sends its row copy
        (all-gather over ``model``) and its column copy (all-gather over
        the row axis) per operand of the iteration, as ``MeshPlan.row_copy``
        and ``col_copy`` do: one state for ``dense``, two (T and D) for
        ``frontier``;
      * DeepFM's tables, split over ``model`` along their rows, are looked
        up where they live and each rank's bags summed over ``model``, as
        the LM's vocabulary-split embedding is (one all-reduce of the bags
        forward, one of their gradient backward); the retrieval's
        candidates, spread over every rank, fetch their rows from the
        ``model`` rank holding them (one all-to-all);
      * any other parameter (the first argument's leaves) split over
        ``data`` is all-gathered over it at its use, as
        ``shard/collectives.py::use`` does;
      * in a train cell every parameter's gradient is all-reduced over the
        ranks holding the same block.

    The other activations' collectives are not priced."""
    from repro_torch.roofline.count import Counter as _C

    plan, rec = cell.plan, _C()
    cfg = registry.get_config(cell.arch_id)
    f32 = torch.float32
    if isinstance(cfg, CFPQConfig):
        (T,), (spec,) = cell.args, cell.in_specs
        b = _nbytes(shard_shape(T.shape, spec, plan), T.dtype)
        for _ in range(2 if "frontier" in cell.note else 1):
            rec.add_collective("all-gather", b * plan.model_size, plan.model_size)
            rec.add_collective("all-gather", b * plan.row_size, plan.row_size)
        return rec.collective_stats()
    train = cell.donate_argnums == (0, 1)
    if isinstance(cfg, RecSysConfig):
        shape = cell.shape
        rows = 1 if shape.kind == "retrieval" else shape.dim("batch") // plan.row_size
        for width in (cfg.embed_dim, 1):  # tables, w1_tables
            bags = _nbytes((rows, cfg.n_sparse, width), f32)
            for _ in range(2 if train else 1):
                rec.add_collective("all-reduce", bags, plan.model_size)
        if shape.kind == "retrieval":
            cands = cell.args[1]["candidate_ids"].shape[0] // plan.world
            rec.add_collective("all-to-all", _nbytes((cands, cfg.embed_dim), f32), plan.model_size)
    for path, (glob, local, dt) in per_rank_leaves(cell.args[0], cell.in_specs[0], plan).items():
        spec = _spec_at(cell.in_specs[0], path) or ()
        blocks = 1
        for g, l in zip(glob, local):
            blocks *= g // l
        data = plan.data_size if plan.data_axis in spec else 1
        if data > 1:
            rec.add_collective("all-gather", _nbytes(local, dt) * data, data)
        if train:
            rec.add_collective("all-reduce", _nbytes(local, f32), plan.world // blocks)
    return rec.collective_stats()
