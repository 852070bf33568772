"""The port's ``opt`` family on one device (``plan=None``) against the
reference: ``opt_closure`` and ``opt_step`` (tests/test_roofline.py),
``masked_opt_closure`` and ``masked_opt_single_path_closure`` word for word
and length for length, the capacity ladder of tests/helpers.py's restart
loop, the pinned ``opt`` engine through the delta interleaving, the
``opt`` server smoke test of tests/test_serving.py, ``localize_state`` and
``placement_of``, the mesh checks of ``EngineConfig``, and the planner's
decisions with a mesh.  The sharded runs are tests/test_torch_distributed.py.
"""
from __future__ import annotations

import asyncio
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.baselines import hellings_cfpq
from repro.engine import PlanFeatures as JFeatures
from repro.engine import Planner as JPlanner
from repro.engine import PlannerProfile as JProfile
from repro_torch.core import closure, semantics
from repro_torch.core.graph import Graph, ontology_graph
from repro_torch.core.grammar import query1_grammar
from repro_torch.core.matrices import (
    ProductionTables,
    init_matrix,
    pack_bits,
    to_reference,
)
from repro_torch.delta.repair import localize_state, placement_of
from repro_torch.engine import (
    CompiledClosureCache,
    EngineConfig,
    PlanFeatures,
    Planner,
    PlannerProfile,
    Query,
    QueryEngine,
)
from repro_torch.serve import CFPQServer, ServeConfig
from helpers import assert_path_witness
from torch_opt_worker import ladder
from torch_opt_cases import (
    LADDER_CAPS,
    _plan_key,
    interleaving_case,
    ladder_case,
    masked_cases,
    opt_cases,
    ref_interleaving,
    ref_ladder,
    ref_masked,
    ref_opt,
)

BOUND_S = 30.0  # the server's event loop; a hang fails the test


def _src(n, sources):
    src = torch.zeros(n, dtype=torch.bool)
    src[list(sources)] = True
    return src


@pytest.mark.parametrize("name", sorted(opt_cases()))
def test_opt_closure_and_step_match_reference(name):
    """``opt_closure`` equals the reference's (and the dense closure);
    ``opt_step`` equals the reference's words and only adds bits."""
    _, _, graph, g = opt_cases()[name]
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device="cpu")
    want, want_step = ref_opt(name)
    got = closure.opt_closure(T0, tables)
    np.testing.assert_array_equal(to_reference(got), want)
    assert torch.equal(got, closure.dense_closure(T0, tables))
    Tp = pack_bits(T0)
    step = closure.opt_step(Tp, tables, n=T0.shape[-1])
    np.testing.assert_array_equal(to_reference(step), want_step)
    assert torch.equal(step & Tp, Tp)  # monotone: every old bit survives


@pytest.mark.parametrize("single_path", [False, True], ids=["relational", "single_path"])
@pytest.mark.parametrize("name", sorted(masked_cases()))
def test_masked_opt_closures_match_reference(name, single_path):
    """Word for word (relational) and ``torch.equal`` on the lengths
    (single-path), with the same mask and overflow flag, and equal to the
    port's one-device masked closure of the same family."""
    _, _, graph, g, sources = masked_cases()[name]
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device="cpu")
    n = T0.shape[-1]
    want, want_M, want_ovf = ref_masked(name, single_path)
    if single_path:
        L0 = semantics.base_lengths(T0)
        got, M, ovf = semantics.masked_opt_single_path_closure(
            L0, tables, _src(n, sources), row_capacity=n)
        assert torch.equal(got, torch.from_numpy(want.copy()))
        same = semantics.masked_single_path_closure(
            L0, tables, _src(n, sources), row_capacity=n)[0]
    else:
        got, M, ovf = closure.masked_opt_closure(
            T0, tables, _src(n, sources), row_capacity=n)
        np.testing.assert_array_equal(to_reference(got), want)
        same = closure.masked_bitpacked_closure(
            T0, tables, _src(n, sources), row_capacity=n)[0]
    np.testing.assert_array_equal(M.numpy(), want_M)
    assert ovf == want_ovf
    assert torch.equal(got, same)


@pytest.mark.parametrize("single_path", [False, True], ids=["relational", "single_path"])
@pytest.mark.parametrize("cap", LADDER_CAPS)
def test_capacity_ladder_matches_reference(cap, single_path):
    """Every call of the warm-restart ladder equals the reference's call
    (state and mask); entries never retract, finite lengths never move."""
    _, _, graph, g, sources = ladder_case()
    tables = ProductionTables.from_grammar(g)
    T0 = init_matrix(graph, g, device="cpu")
    n = T0.shape[-1]
    if single_path:
        fn, state = semantics.masked_opt_single_path_closure, semantics.base_lengths(T0)
    else:
        fn, state = closure.masked_opt_closure, T0
    got = ladder(fn, state, tables, _src(n, sources), cap, n)
    want = ref_ladder(cap, single_path)
    assert len(got) == len(want) > 1
    for (t, m), (jt, jm) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), jt)
        np.testing.assert_array_equal(m.numpy(), jm)
    for (a, _), (b, _) in zip(got, got[1:]):
        if single_path:
            was = torch.isfinite(a)
            assert torch.equal(b[was], a[was])
        else:
            assert not (a & ~b).any()


def test_pinned_opt_engine_matches_reference():
    """The engine pinned to ``opt`` (no mesh) through the reference's delta
    interleaving: pairs of both semantics, ``stats["engine"]``, every
    edit's ``DeltaStats`` and the plan keys equal the reference engine's;
    every witness is a walk the grammar derives."""
    _, _, tgraph, tg, steps, edge_sets = interleaving_case()
    want_queries, want_deltas, want_keys = ref_interleaving()
    plans = CompiledClosureCache()
    eng = QueryEngine(Graph(tgraph.n_nodes, list(tgraph.edges)),
                      plans=plans, config=EngineConfig(engine="opt", device="cpu"))
    queries, deltas = [], []
    for op, arg in steps:
        if op != "query":
            deltas.append(eng.apply_delta(**{op: arg}).as_dict())
            continue
        rel = eng.query(Query(tg, "S", sources=arg))
        sp = eng.query(Query(tg, "S", sources=arg, semantics="single_path"))
        queries.append((rel.pairs, sp.pairs, rel.stats["engine"]))
        edges = edge_sets[len(queries) - 1]
        step_graph = SimpleNamespace(edge_set=lambda e=edges: e)
        for (i, j), path in sp.paths.items():
            assert_path_witness(step_graph, tg, "S", i, j, path)
    assert queries == want_queries
    assert deltas == want_deltas
    assert sorted(map(_plan_key, plans._exe)) == want_keys
    assert {k.engine for k in plans._exe if not k.repair} == {"opt"}
    assert {k.engine for k in plans._exe if k.repair} <= {"bitpacked", "dense"}


def test_opt_backend_serving_smoke():
    """tests/test_serving.py::test_opt_backend_serving_smoke through the
    port's server: coalesced reads on both semantics and a fenced write,
    served by the ``opt`` closures, against Hellings."""
    from repro.core import graph as jgraph
    from repro.core.grammar import query1_grammar as jq1

    jg = jq1().to_cnf()
    g = query1_grammar().to_cnf()
    graph = ontology_graph(20, 40, seed=0)

    def oracle(edges):
        return hellings_cfpq(jgraph.Graph(graph.n_nodes, list(edges)), jg)["S"]

    async def main():
        eng = QueryEngine(graph, config=EngineConfig(engine="opt", device="cpu"))
        ref = oracle(graph.edges)
        cfg = ServeConfig(max_batch=4, batch_window_s=0.005)
        async with CFPQServer(eng, cfg) as srv:
            rs = await asyncio.gather(
                *[srv.submit(Query(g, "S", sources=(m,))) for m in range(3)],
                srv.submit(Query(g, "S", sources=(1,), semantics="single_path")),
            )
            await srv.apply_delta(insert=[(0, "type", 3)])  # fenced write
            r2 = await srv.submit(Query(g, "S", sources=(0,)))
        assert all(r.stats["engine"] == "opt" for r in rs)
        for r in rs[:3]:
            (m,) = r.query.sources
            assert r.pairs == {(i, j) for (i, j) in ref if i == m}
        assert rs[3].paths is not None and rs[3].pairs == rs[1].pairs
        for (i, j), path in rs[3].paths.items():
            assert_path_witness(graph, g, "S", i, j, path)
        ref2 = oracle(graph.edges)  # post-delta oracle
        assert r2.pairs == {(i, j) for (i, j) in ref2 if i == 0}
        assert r2.stats["epoch"] == 1

    asyncio.run(asyncio.wait_for(main(), timeout=BOUND_S))


def test_localize_and_placement_of_one_device_states():
    """A tensor passes ``localize_state`` untouched and is ``"local"``."""
    t = torch.zeros(2, 3, 3, dtype=torch.bool)
    assert localize_state(t) is t
    assert placement_of(t) == "local"


def _fake_mesh(names=("data", "model"), device_type="cpu"):
    return SimpleNamespace(mesh_dim_names=names, device_type=device_type,
                           shape=(1, 1))


@pytest.mark.parametrize("engine", ["dense", "frontier", "bitpacked", "blocksparse"])
def test_mesh_only_with_opt_or_auto(engine):
    with pytest.raises(ValueError, match="only supported by the 'opt' engine"):
        EngineConfig(engine=engine, device="cpu", mesh=_fake_mesh())


def test_mesh_needs_data_and_model_axes():
    with pytest.raises(ValueError, match="'data' and 'model'"):
        EngineConfig(engine="opt", device="cpu", mesh=_fake_mesh(("x", "y")))


@pytest.mark.parametrize("engine", ["opt", "auto"])
def test_mesh_without_a_process_group_raises(engine):
    """No fallback: a mesh with no live process group refuses the config
    (this process never initializes one)."""
    with pytest.raises(RuntimeError, match="process group"):
        EngineConfig(engine=engine, device="cpu", mesh=_fake_mesh())


def test_opt_accepted_without_a_mesh():
    assert EngineConfig(engine="opt", device="cpu").mesh is None


def _features(pkg, n, seed, semantics_, repair, cache, placement, devices):
    return pkg(
        n=n, seed_rows=seed, new_rows=max(seed // 2, 1), density=2.5,
        n_prods=6, n_nonterms=7, semantics=semantics_, repair=repair,
        cache=cache, placement=placement, mesh_devices=devices,
        occupied_blocks=12, tile=128,
    )


@pytest.mark.parametrize("devices", [0, 2, 4])
def test_planner_decides_mesh_features_like_reference(devices):
    """``decide()`` on features with ``mesh_devices`` set equals the
    reference planner's on the same features (no JAX mesh needed): ``opt``
    is a candidate exactly when the mesh has more than one rank."""
    port, ref = Planner(PlannerProfile.default()), JPlanner(JProfile.default())
    offered = set()
    for n, seed, sem, repair, cache, placement in itertools.product(
        (128, 1024, 16384), (1, 64, 1000), ("relational", "single_path"),
        (False, True), ("miss", "warm"), ("none", "local", "sharded"),
    ):
        f = _features(PlanFeatures, n, min(seed, n), sem, repair, cache, placement, devices)
        jf = _features(JFeatures, n, min(seed, n), sem, repair, cache, placement, devices)
        for pin in (None, "opt"):
            got = port.decide(f, pin=pin, min_capacity=128).to_dict()
            assert got == ref.decide(jf, pin=pin, min_capacity=128).to_dict()
            if pin is None:
                offered |= {label.split(":")[0] for label in got["candidates"]}
            else:
                assert got["engine"] == "opt"
    assert ("opt" in offered) == (devices > 1)
