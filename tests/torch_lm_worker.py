"""One rank of a gloo world for tests/test_torch_sharded_lm.py.

Imports only torch, numpy and the port (``repro_torch``): the parent test
builds the inputs, runs the reference, and compares.  :func:`run` joins
the world through a ``FileStore``, builds its ``(data, model)`` device
mesh and the ``(pod, data, model)`` meshes its input file names over the
same ranks, runs every case of the file on the mesh the case names
(sharded train steps, the grouped MoE dispatch, ``prefill_step``, the
compressed all-reduce, the elastic checkpoint) and saves this rank's
results, or the traceback that stopped it, for the parent.
"""
from __future__ import annotations

import os
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.moe import moe_apply, moe_specs
from repro_torch.models.weights import named_specs, params_from_reference, to_reference, training_specs
from repro_torch.shard import collectives as C
from repro_torch.shard.plans import MeshPlan, exchange_calls, exchanged, local_shard, reset_exchanges
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import make_compressed_allreduce
from repro_torch.train.trainer import make_train_step

#: seconds any collective may wait before the world fails
COLLECTIVE_TIMEOUT_S = 60


def _mesh(shape):
    """A ``(data, model)`` mesh, or a ``(pod, data, model)`` one."""
    if len(shape) == 3:
        return init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))
    return make_test_mesh(*shape, device="cpu")


class _Plans(dict):
    """The plan of each mesh shape, its mesh built at the first use: every
    rank asks for the same shapes in the same order, so the groups are
    made collectively."""

    def __missing__(self, shape):
        mesh = _mesh(shape)
        self[shape] = MeshPlan.from_mesh(mesh)
        return self[shape]


def _train(case: dict, plan: MeshPlan) -> tuple[dict, object, dict]:
    """One sharded train step of the case: the metrics, this rank's blocks
    of the parameters and moments (the parent puts them together) and,
    with int8 moments, the gathered parameters and moments."""
    if case["force"]:
        os.environ["REPRO_ATTN_FORCE"] = case["force"]
    try:
        cfg = case["cfg"]
        ocfg = opt.OptimizerConfig(moment_dtype=case["moment"], grad_clip=case["clip"])
        model = params_from_reference(case["tree"], cfg, device="cpu", plan=plan)
        state = opt.init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg, case["n_micro"], plan)
        reset_exchanges()
        metrics = step(model, state, case["batch"])
        sent = {"exchanged": dict(exchanged), "exchange_calls": dict(exchange_calls)}
        out = {
            **sent,
            "coords": (plan.row_rank, plan.model_rank),
            "pos": {a: plan.axis_rank(a) for a in plan.axes},
            "mode": plan.attn_mode(cfg.n_heads, cfg.hd, False),
            "specs": named_specs(cfg, plan),
            **{k: float(v) for k, v in metrics.items()},
            "local": {k: p.detach().clone() for k, p in model.named_parameters()},
            "local_m": state["m"],
            "local_v": state["v"],
        }
        if case["moment"] == "int8":
            out.update(params=to_reference(model), m=to_reference(model, state["m"]),
                       v=to_reference(model, state["v"]))
        return out, model, state
    finally:
        os.environ.pop("REPRO_ATTN_FORCE", None)


def _moe(case: dict, plan: MeshPlan) -> dict:
    """``moe_apply`` with the plan on this row rank's tokens; ``y``
    gathered over the row ranks."""
    m = case["m"]
    x = torch.from_numpy(case["x"])
    specs = moe_specs(x.shape[1], m, plan)
    p = {k: local_shard(torch.from_numpy(v), specs[k], plan) for k, v in case["p"].items()}
    per = x.shape[0] // plan.row_size
    with torch.no_grad():
        y, aux = moe_apply(p, x[plan.row_rank * per:(plan.row_rank + 1) * per], m, True, plan)
    return {"y": C.all_gather(y, 0, plan, plan.row_axes, "test"), "aux": aux}


def _prefill(case: dict, plan: MeshPlan) -> dict:
    cfg, tokens = case["cfg"], torch.from_numpy(case["tokens"])
    sharded = params_from_reference(case["tree"], cfg, device="cpu", plan=plan)
    whole = params_from_reference(case["tree"], cfg, device="cpu")
    return {"logits": tf.prefill_step(sharded, tokens, cfg, plan),
            "plain": tf.prefill_step(whole, tokens, cfg)}


def _compress(case: dict, mesh) -> list:
    """``rounds`` reductions over the case's ``axis`` of this rank's
    gradient (its world rank's) with error feedback: per round the mean
    and this rank's carry."""
    reduce = make_compressed_allreduce(mesh, case["axis"])
    g = {"w": torch.from_numpy(case["grads"][dist.get_rank()])}
    err = {"w": torch.zeros_like(g["w"])}
    out = []
    for _ in range(case["rounds"]):
        g_hat, err = reduce(g, err)
        out.append((g_hat["w"], err["w"]))
    return out


def _elastic(case: dict, root: str, plans: _Plans, model, state) -> dict:
    """Save the trained model under its plan, then restore it, and the
    reference's checkpoint, onto each other mesh of the same ranks: this
    rank's restored blocks, their specs and its coordinates there."""
    saved_on = "x".join(map(str, case["source"][0]))
    path = ckpt.save(os.path.join(root, f"port_ckpt_{saved_on}"), 1, ckpt.training_tree(model, state),
                     plan=model.plan, specs=training_specs(model, state))
    out = {"path": path}
    for shape in case["shapes"]:
        plan = plans[shape]
        for name, src in (("port", path), ("reference", case["ref_dir"])):
            fresh = params_from_reference(case["tree"], case["cfg"], device="cpu", plan=plan)
            fstate = opt.init_opt_state(fresh, opt.OptimizerConfig(moment_dtype=case["moment"]))
            specs = training_specs(fresh, fstate)
            tree, _ = ckpt.restore(src, ckpt.training_tree(fresh, fstate), plan=plan, specs=specs)
            ckpt.load_training_tree(tree, fresh, fstate)
            out[name, shape] = {"tree": ckpt.training_tree(fresh, fstate), "specs": specs,
                                "coords": (plan.row_rank, plan.model_rank)}
    return out


def run(rank: int, world: int, shape: tuple, store: str, cases_path: str, out_path: str) -> None:
    """Join the world, run every case of the input file on the ``shape``
    mesh, save the results (or the traceback) to ``out_path % rank``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        plans = _Plans()
        plan = plans[tuple(shape)]
        cases = torch.load(cases_path, weights_only=False)
        results = {"coords": (plan.row_rank, plan.model_rank), "train": {}, "moe": {}, "prefill": {},
                   "compress": {}, "elastic": {}}
        trained = {}
        for case in cases["train"]:
            res, model, state = _train(case, plans[case["key"][0]])
            results["train"][case["key"]] = res
            trained[case["key"]] = (model, state)
        for case in cases["moe"]:
            results["moe"][case["key"]] = _moe(case, plans[case["key"][0]])
        for case in cases["prefill"]:
            results["prefill"][case["key"]] = _prefill(case, plans[case["shape"]])
        for case in cases["compress"]:
            results["compress"][case["shape"]] = _compress(case, plans[case["shape"]].mesh)
        for case in cases["elastic"]:
            results["elastic"][case["source"]] = _elastic(
                case, os.path.dirname(cases_path), plans, *trained[case["source"]])
        torch.save(results, out_path % rank)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out_path % rank)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
