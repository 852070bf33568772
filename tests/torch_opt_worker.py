"""One rank of a gloo world for tests/test_torch_distributed.py.

Imports only torch, numpy and the port (``repro_torch``): the parent test
builds the inputs, runs the reference, and compares.  :func:`run` joins
the world through a ``FileStore``, builds the ``(data, model)`` device
mesh, runs every case of the input file on it and saves this rank's
results (or the traceback that stopped it) for the parent.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import repro_torch
from repro_torch.core import closure, semantics
from repro_torch.core.graph import Graph
from repro_torch.core.matrices import ProductionTables, init_matrix, pack_bits
from repro_torch.delta.repair import plan_repair
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.shard.plans import MeshPlan

#: seconds any collective may wait before the world fails
COLLECTIVE_TIMEOUT_S = 60


def ladder(fn, state, tables, src, cap, n, plan=None, max_restarts=20):
    """The restart loop of tests/helpers.py::masked_oracle_run on the port:
    per call the whole state (gathered under a plan) and the mask."""
    mask, snaps = src, []
    for _ in range(max_restarts):
        state, mask, overflow = fn(state, tables, mask, row_capacity=cap, plan=plan)
        snaps.append((state if plan is None else state.full(), mask.clone()))
        if not overflow:
            return snaps
        needed = max(int(mask.sum()), 2 * cap, 2)
        cap = min(n, 1 << int(np.ceil(np.log2(needed))))
    raise AssertionError(f"no fixpoint within {max_restarts} restarts")


def _closures(cases: dict, plan, single_path: bool = True) -> dict:
    """Every closure case of ``cases`` on ``plan``; without
    ``single_path``, only the relational masked closures."""
    out = {}
    for name, (graph, g) in cases["opt"].items():
        tables = ProductionTables.from_grammar(g)
        T0 = init_matrix(graph, g, device="cpu")
        n = T0.shape[-1]
        out["opt", name] = closure.opt_closure(T0, tables, plan=plan).full()
        out["opt_step", name] = pack_bits(
            closure.opt_step(pack_bits(T0), tables, n, plan=plan).full())
    for name, (graph, g, sources) in cases["masked"].items():
        tables = ProductionTables.from_grammar(g)
        T0 = init_matrix(graph, g, device="cpu")
        n = T0.shape[-1]
        src = torch.zeros(n, dtype=torch.bool)
        src[list(sources)] = True
        T, M, ovf = closure.masked_opt_closure(T0, tables, src, row_capacity=n, plan=plan)
        out["masked", name] = (T.full(), M, ovf)
        if not single_path:
            continue
        L, M, ovf = semantics.masked_opt_single_path_closure(
            semantics.base_lengths(T0), tables, src, row_capacity=n, plan=plan)
        out["masked_sp", name] = (L.full(), M, ovf)
    if "ladder" not in cases:
        return out
    graph, g, sources, caps = cases["ladder"]
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device="cpu")
    n = T0.shape[-1]
    src = torch.zeros(n, dtype=torch.bool)
    src[list(sources)] = True
    for cap in caps:
        out["ladder", cap] = ladder(closure.masked_opt_closure, T0, tables, src, cap, n, plan)
        out["ladder_sp", cap] = ladder(
            semantics.masked_opt_single_path_closure, semantics.base_lengths(T0),
            tables, src, cap, n, plan)
    return out


def _copy(graph):
    return Graph(graph.n_nodes, list(graph.edges))


def _served(r) -> dict:
    return {"pairs": r.pairs, "paths": r.paths, "engine": r.stats["engine"],
            "cache": r.stats["cache"],
            "route": None if r.stats.planner is None else r.stats.planner["label"]}


def _engines(cases: dict, mesh) -> dict:
    out = {}
    graph, g, steps = cases["interleaving"]
    eng = QueryEngine(_copy(graph),
                      config=EngineConfig(engine="opt", device="cpu", mesh=mesh))
    rows = []
    for op, arg in steps:
        if op != "query":
            eng.apply_delta(**{op: arg})
            continue
        rel = eng.query(Query(g, "S", sources=arg))
        sp = eng.query(Query(g, "S", sources=arg, semantics="single_path"))
        (state,) = eng._states.values()
        rows.append((_served(rel), _served(sp), state.placement, state.sp_placement))
    out["interleaving"] = rows
    graph, g, insert, sp_sources = cases["frozen"]
    eng = QueryEngine(_copy(graph), config=EngineConfig(engine="opt", device="cpu", mesh=mesh))
    all_pairs = eng.query(Query(g, "S"))
    eng.query(Query(g, "S", sources=sp_sources, semantics="single_path"))
    (state,) = eng._states.values()

    def snapshot():
        return {"T": state.T_host.copy(), "L": state.sp_L_host.copy(),
                "mask": state.mask.copy(), "sp_mask": state.sp_mask.copy(),
                "placement": (state.placement, state.sp_placement),
                "kind": type(state.T).__name__}

    before = snapshot()
    stats = eng.apply_delta(insert=insert)
    repair_plan = plan_repair(eng.graph, eng.graph.delta_since(0), eng.n)
    after = snapshot()
    requery = eng.query(Query(g, "S"))
    out["frozen"] = {
        "pairs": all_pairs.pairs, "before": before, "after": after,
        "affected": repair_plan.affected, "stats": stats.as_dict(),
        "requery": requery.pairs,
    }
    return out


#: builds Query 1 in CNF and writes it, pickled, to stdout
_BUILD_GRAMMAR = (
    "import pickle, sys\n"
    "from repro_torch.core.grammar import query1_grammar\n"
    "sys.stdout.buffer.write(pickle.dumps(query1_grammar().to_cnf()))\n"
)


def own_grammar(hash_seed: int):
    """Query 1 in CNF as an interpreter started with ``PYTHONHASHSEED =
    hash_seed`` builds it: CNF conversion walks sets, so the nonterminal
    numbering depends on the hash seed."""
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONHASHSEED": str(hash_seed),
           "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, "-c", _BUILD_GRAMMAR], env=env,
                          capture_output=True, check=True, timeout=60)
    return pickle.loads(done.stdout)


def _grammar_check(cases: dict, mesh, rank: int) -> dict:
    """Each rank builds its own grammar under its own hash seed (its rank)
    and queries a mesh-backed engine with it: the engine must refuse."""
    g = own_grammar(rank)
    graph = cases["masked"]["ontology"][0]
    eng = QueryEngine(_copy(graph), config=EngineConfig(engine="opt", device="cpu", mesh=mesh))
    try:
        eng.query(Query(g, "S"))
        error = None
    except RuntimeError as e:
        error = str(e)
    return {"nonterms": list(g.nonterms), "error": error}


def run(rank: int, world: int, shape: tuple, store: str, cases_path: str,
        out_path: str, engines: bool = True, grammar_check: bool = False) -> None:
    """Join the world, run every case on the mesh (the engine cases only
    with ``engines``; with ``grammar_check`` also :func:`_grammar_check`),
    save the results (or the traceback) to ``out_path % rank``."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cases = torch.load(cases_path, weights_only=False)
        plan = MeshPlan.from_mesh(mesh)
        results = {"coords": (plan.row_rank, plan.model_rank)}
        results.update(_closures(cases, plan))
        if engines:
            results.update(_engines(cases, mesh))
        if grammar_check:
            results["grammar_check"] = _grammar_check(cases, mesh, rank)
        if world == 4:  # the row axis over (pod, data): a 2 x 1 x 2 mesh
            pod = init_device_mesh("cpu", (2, 1, 2),
                                   mesh_dim_names=("pod", "data", "model"))
            pod_plan = MeshPlan.from_mesh(pod)
            results["pod_coords"] = (pod_plan.row_rank, pod_plan.model_rank)
            one = {"opt": {}, "masked": {"ontology": cases["masked"]["ontology"]}}
            results.update({("pod",) + k: v for k, v in _closures(
                one, pod_plan, single_path=False).items()})
        torch.save(results, out_path % rank)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out_path % rank)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
