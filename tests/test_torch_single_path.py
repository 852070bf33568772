"""The port's single-path semantics against the reference, bit for bit.

* ``_minplus`` against the reference's on square and rectangular operands,
  and across chunk sizes (the result must not depend on the chunk);
* ``single_path_closure``, ``masked_single_path_closure``,
  ``masked_frontier_single_path_closure`` and
  ``masked_single_path_repair_closure`` against their JAX counterparts on
  every named case and random seed of tests/torch_helpers.py: ``L``,
  ``M`` and ``overflowed``;
* ``PathExtractor.extract`` returning the reference's paths from the same
  lengths;
* the engine's ``single_path`` batches against the JAX engine's (pairs,
  paths, cache statuses, ``active_rows``), and ``apply_delta`` over a
  cached length state (``sp_L``, ``sp_mask``, ``DeltaStats``);
* the Section 5 golden case (lengths 6 / 4 / 2), and the engine's host
  mirror of the length state against the whole device tensor after warm
  restarts, capacity overflows and repairs.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance is exact everywhere (``np.array_equal``, set and dict
equality).  Each reference result is computed once per module.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.core import matrices as jm
from repro.core import semantics as js
from repro.engine import CompiledClosureCache as JPlans
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch.baselines.hellings import hellings_cfpq
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.core import matrices as tm
from repro_torch.core import semantics as ts
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.kernels import ref as kref
from helpers import assert_path_witness
from torch_helpers import CASES, NAMED_CASES, case

BACKENDS = ("dense", "frontier", "bitpacked", "auto")
SMALL_CAP = 4  # masked closures overflow on most cases at this capacity

# ---------------------------------------------------------------------- #
# _minplus
# ---------------------------------------------------------------------- #


def _lengths(rng, shape, inf_frac=0.5):
    a = rng.integers(1, 20, size=shape).astype(np.float32)
    a[rng.random(shape) < inf_frac] = np.inf
    return a


@pytest.mark.parametrize("chunk", [1, 2, 5, 64, None])
@pytest.mark.parametrize(
    "shape", [(3, 40, 40, 40), (2, 7, 13, 29), (1, 5, 1, 9)],
    ids=["square", "rectangular", "k=1"],
)
def test_minplus_matches_reference_at_every_chunk(shape, chunk):
    P, rows, K, cols = shape
    rng = np.random.default_rng(P * 1000 + rows * 10 + K)
    lhs, rhs = _lengths(rng, (P, rows, K)), _lengths(rng, (P, K, cols))
    want = np.asarray(js._minplus(jnp.asarray(lhs), jnp.asarray(rhs)))
    got = ts._minplus(torch.from_numpy(lhs), torch.from_numpy(rhs), chunk=chunk)
    assert not bool(torch.isnan(got).any())
    np.testing.assert_array_equal(got.numpy(), want)


def test_minplus_chunk_follows_the_memory_budget():
    # the plain product's chunk (kernels/ref.py, which ts._minplus runs)
    per_k = 4 * 6 * 1024 * 15872
    for dev, budget in kref.MINPLUS_TEMP_BYTES.items():
        assert kref.minplus_chunk(6, 1024, 15872, 1024, dev) == max(1, budget // per_k)
        assert kref.minplus_chunk(1, 2, 3, 7, dev) == 7  # small operands: one chunk
        assert kref.minplus_chunk(6, 15872, 15872, 15872, dev) == 1  # never below 1
    assert kref.minplus_chunk(6, 1024, 15872, 1024, "cuda") == 5


def test_init_lengths_equals_base_lengths_of_the_base_matrix():
    jg, jgr, tg, tgr, _ = case("skos:q1")
    want = np.asarray(js.base_lengths(jm.init_matrix(jg, jgr)))
    got = ts.init_lengths(tg, tgr, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ts.base_lengths(tm.init_matrix(tg, tgr, device="cpu")).numpy(), want
    )


# ---------------------------------------------------------------------- #
# closures, per case
# ---------------------------------------------------------------------- #


def _sources(n_nodes: int, n: int) -> np.ndarray:
    src = np.zeros(n, dtype=bool)
    src[[0, n_nodes // 2]] = True
    return src


_REF: dict = {}


def _pad(name: str) -> int | None:
    """The random cases (at most 8 nodes) are padded to 32, not 128."""
    return 32 if name.startswith("seed") else None


def _reference(name: str) -> dict:
    """The reference's results on case ``name`` (computed once).  The
    random cases run the reference eagerly: each has its own grammar, so
    jit would compile four closures per case, which costs more than
    running them op by op at n = 32."""
    if name not in _REF:
        eager = jax.disable_jit() if _pad(name) else contextlib.nullcontext()
        with eager:
            _REF[name] = _reference_run(name)
    return _REF[name]


def _reference_run(name: str) -> dict:
    jg, jgr, _, _, _ = case(name)
    tables = jm.ProductionTables.from_grammar(jgr)
    T0 = jm.init_matrix(jg, jgr, pad_to=_pad(name))
    n = T0.shape[-1]
    L0 = js.base_lengths(T0)
    src = _sources(jg.n_nodes, n)
    out = {"src": src}
    T, L = js.single_path_closure(T0, tables)
    out["allpairs"] = (np.asarray(T), np.asarray(L))
    for fn in ("masked_single_path_closure", "masked_frontier_single_path_closure"):
        L1, M1, ovf = getattr(js, fn)(
            L0, tables, jnp.asarray(src), row_capacity=SMALL_CAP
        )
        out[fn] = (np.asarray(L1), np.asarray(M1), bool(ovf))
    # repair input: the all-pairs lengths with the source rows evicted to
    # base, the other rows frozen
    Lr = np.array(out["allpairs"][1], copy=True)
    Lr[:, src, :] = np.asarray(L0)[:, src, :]
    frozen = ~src
    frozen[jg.n_nodes:] = False
    L2, M2, ovf = js.masked_single_path_repair_closure(
        jnp.asarray(Lr), tables, jnp.asarray(src), jnp.asarray(frozen),
        row_capacity=SMALL_CAP, ctx_capacity=2 * SMALL_CAP,
    )
    out["repair_input"] = (Lr, frozen)
    out["masked_single_path_repair_closure"] = (
        np.asarray(L2), np.asarray(M2), bool(ovf)
    )
    return out


def _port_tables(name):
    _, _, tg, tgr, _ = case(name)
    return tg, tgr, tm.ProductionTables.from_grammar(tgr)


@pytest.mark.parametrize("name", CASES)
def test_single_path_closure_matches_reference(name):
    want_T, want_L = _reference(name)["allpairs"]
    tg, tgr, tables = _port_tables(name)
    T0 = tm.init_matrix(tg, tgr, pad_to=_pad(name), device="cpu")
    T, L = ts.single_path_closure(T0, tables)
    np.testing.assert_array_equal(T.numpy(), want_T)
    np.testing.assert_array_equal(L.numpy(), want_L)


@pytest.mark.parametrize(
    "fn", ["masked_single_path_closure", "masked_frontier_single_path_closure"]
)
@pytest.mark.parametrize("name", CASES)
def test_masked_single_path_closure_matches_reference(name, fn):
    ref = _reference(name)
    tg, tgr, tables = _port_tables(name)
    L0 = ts.init_lengths(tg, tgr, pad_to=_pad(name), device="cpu")
    L, M, ovf = getattr(ts, fn)(
        L0, tables, torch.from_numpy(ref["src"]), row_capacity=SMALL_CAP
    )
    want_L, want_M, want_ovf = ref[fn]
    np.testing.assert_array_equal(L.numpy(), want_L)
    np.testing.assert_array_equal(M.numpy(), want_M)
    assert ovf == want_ovf
    np.testing.assert_array_equal(
        L0.numpy(), ts.init_lengths(tg, tgr, pad_to=_pad(name), device="cpu").numpy()
    )  # the input state is not modified


@pytest.mark.parametrize("name", CASES)
def test_single_path_repair_closure_matches_reference(name):
    ref = _reference(name)
    _, _, tables = _port_tables(name)
    Lr, frozen = ref["repair_input"]
    L, M, ovf = ts.masked_single_path_repair_closure(
        torch.from_numpy(Lr.copy()), tables,
        torch.from_numpy(ref["src"]), torch.from_numpy(frozen),
        row_capacity=SMALL_CAP, ctx_capacity=2 * SMALL_CAP,
    )
    want_L, want_M, want_ovf = ref["masked_single_path_repair_closure"]
    np.testing.assert_array_equal(L.numpy(), want_L)
    np.testing.assert_array_equal(M.numpy(), want_M)
    assert ovf == want_ovf
    np.testing.assert_array_equal(L.numpy()[:, frozen], Lr[:, frozen])


@pytest.mark.parametrize("name", NAMED_CASES)
def test_path_extractor_matches_reference(name):
    jg, jgr, tg, tgr, start = case(name)
    _, L = _reference(name)["allpairs"]
    jex, tex = js.PathExtractor(jg, jgr), ts.PathExtractor(tg, tgr)
    a0 = tgr.index_of(start)
    pairs = list(zip(*np.nonzero(np.isfinite(L[a0, :tg.n_nodes, :tg.n_nodes]))))
    for i, j in pairs:
        got = tex.extract(L, start, int(i), int(j))
        assert got == jex.extract(L, start, int(i), int(j))
        assert_path_witness(jg, jgr, start, int(i), int(j), got,
                            length=int(L[a0, i, j]))
    with pytest.raises(KeyError):
        tex.extract(L, start, tg.n_nodes, 0)  # a padding row has no pairs


def test_evaluate_single_path_matches_reference_and_hellings():
    jg, jgr, tg, tgr, start = case("skos:q1")
    got = ts.evaluate_single_path(tg, tgr, start, device="cpu")
    assert got == js.evaluate_single_path(jg, jgr, start)
    assert set(got) == hellings_cfpq(tg, tgr)[start]


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #

#: two disjoint generated ontologies of 70 nodes: n = 256, buckets 128/256
#: (a source reaches its whole copy, so two copies overflow 128)
COPIES = 2
#: (label, [(grammar, sources, semantics)]) — one batch per step
STEPS = (
    ("cold", [("q1", (0, 2, 7), "single_path")]),
    ("same copy", [("q1", (11,), "single_path")]),
    ("other copy", [("q1", (72, 80), "single_path")]),  # overflows 128
    ("repeat", [("q1", (2, 72), "single_path")]),
)
#: a delete in the first copy and two inserts joining it to the second;
#: then single-path queries again
EDIT = {"delete": [(1, "subClassOf_r", 0)],
        "insert": [(3, "type_r", 100), (100, "type", 5)]}
EDIT_QUERIES = [("q1", (0, 3), "single_path"), ("q1", (72,), "single_path")]


def _graphs():
    return (
        jgraph.ontology_graph(20, 50, seed=0).repeat(COPIES),
        tgraph.ontology_graph(20, 50, seed=0).repeat(COPIES),
    )


J_GRAMMARS = {"q1": jgrammar.query1_grammar().to_cnf()}
T_GRAMMARS = {"q1": tgrammar.query1_grammar().to_cnf()}
JPLANS = JPlans()  # one compile per plan key across the module's engines


def _run(engine, query_cls, grammars, steps):
    """Per step: per query ``(pairs, paths, cache, active_rows, engine)``."""
    out = []
    for _, batch in steps:
        res = engine.query_batch(
            [query_cls(grammars[k], "S", sources=s, semantics=sem)
             for k, s, sem in batch]
        )
        out.append([
            (r.pairs, r.paths, r.stats["cache"], r.stats["active_rows"],
             r.stats["engine"])
            for r in res
        ])
    return out


def _sp_states(engine):
    return {
        k: (np.array(s.sp_L_host, copy=True), np.array(s.sp_mask, copy=True))
        for k, s in engine._states.items() if s.sp_L is not None
    }


@pytest.fixture(scope="module", params=BACKENDS)
def reference(request):
    backend = request.param
    jg, _ = _graphs()
    engine = JEngine(jg, config=JConfig(engine=backend), plans=JPLANS)
    steps = _run(engine, JQuery, J_GRAMMARS, STEPS)
    before = _sp_states(engine)
    stats = engine.apply_delta(**EDIT)
    after = _run(engine, JQuery, J_GRAMMARS, [("edit", EDIT_QUERIES)])[0]
    return {"backend": backend, "steps": steps, "before": before,
            "delta": stats.as_dict(), "after_states": _sp_states(engine),
            "after": after}


@pytest.fixture(scope="module")
def port(reference):
    _, tg = _graphs()
    engine = QueryEngine(
        tg, config=EngineConfig(engine=reference["backend"], device="cpu")
    )
    steps = _run(engine, Query, T_GRAMMARS, STEPS)
    before = _sp_states(engine)
    stats = engine.apply_delta(**EDIT)
    mid = _sp_states(engine)
    after = _run(engine, Query, T_GRAMMARS, [("edit", EDIT_QUERIES)])[0]
    return {"engine": engine, "steps": steps, "before": before,
            "delta": stats.as_dict(), "after_states": mid, "after": after}


def test_single_path_pairs_and_paths_match_reference(reference, port):
    for (label, _), want, got in zip(STEPS, reference["steps"], port["steps"]):
        assert [g[:2] for g in got] == [w[:2] for w in want], label


def test_single_path_cache_and_active_rows_match_reference(reference, port):
    want = [[w[2:] for w in s] for s in reference["steps"]]
    got = [[g[2:] for g in s] for s in port["steps"]]
    assert got == want
    statuses = {g[2] for s in port["steps"] for g in s}
    assert statuses == {"miss", "warm", "hit"}
    assert max(g[3] for s in port["steps"] for g in s) > 128  # overflowed


def test_single_path_states_match_reference(reference, port):
    assert port["before"].keys() == reference["before"].keys()
    for k, (L, M) in reference["before"].items():
        np.testing.assert_array_equal(port["before"][k][0], L)
        np.testing.assert_array_equal(port["before"][k][1], M)


def test_single_path_apply_delta_matches_reference(reference, port):
    assert port["delta"] == reference["delta"]
    assert port["delta"]["rows_repaired"] > 0 and port["delta"]["rows_evicted"] > 0
    for k, (L, M) in reference["after_states"].items():
        np.testing.assert_array_equal(port["after_states"][k][0], L)
        np.testing.assert_array_equal(port["after_states"][k][1], M)
    assert [g[:3] for g in port["after"]] == [w[:3] for w in reference["after"]]


def test_single_path_witnesses_are_valid_paths(port):
    engine = port["engine"]
    jg, _ = _graphs()
    jg.delete_edges(EDIT["delete"])
    jg.insert_edges(EDIT["insert"])
    for pairs, paths, *_ in port["after"]:
        assert set(paths) == pairs
        for (i, j), path in paths.items():
            assert_path_witness(jg, J_GRAMMARS["q1"], "S", i, j, path)
    assert engine.snapshot().epoch == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_section5_golden_lengths(backend):
    """The paper's running example: (1, 2) freezes at length 2, (0, 2) at
    4 and (0, 0) at 6, on every backend."""
    graph = tgraph.paper_example_graph()
    g = tgrammar.query1_grammar().to_cnf()
    eng = QueryEngine(graph, config=EngineConfig(engine=backend, device="cpu"))
    r = eng.query(Query(g, "S", semantics="single_path"))
    lengths = {(0, 0): 6, (0, 2): 4, (1, 2): 2}
    assert r.pairs == set(lengths) == set(r.paths)
    for (i, j), path in r.paths.items():
        assert_path_witness(jgraph.paper_example_graph(),
                            jgrammar.query1_grammar().to_cnf(), "S", i, j,
                            path, length=lengths[(i, j)])
    assert r.paths[(1, 2)] == [(1, "type_r", 2), (2, "type", 2)]


def test_nullable_start_yields_empty_path_witnesses():
    g = tgrammar.Grammar.from_text("S -> a S | a | eps").to_cnf()
    graph = tgraph.Graph(3, [(0, "a", 1)])
    eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
    r = eng.query(Query(g, "S", sources=(0, 2), semantics="single_path"))
    assert r.pairs == {(0, 0), (0, 1), (2, 2)}
    assert r.paths == {(0, 0): [], (2, 2): [], (0, 1): [(0, "a", 1)]}
    assert r.pairs == eng.query(Query(g, "S", sources=(0, 2))).pairs


def test_host_mirror_equals_device_state():
    """After a cold closure, a warm restart past a capacity overflow, a
    repair and a hit, the host mirror equals the whole device tensor —
    although only rows that joined the mask (or that a repair wrote) were
    copied back."""
    _, tg = _graphs()
    g = T_GRAMMARS["q1"]
    eng = QueryEngine(tg, config=EngineConfig(engine="dense", device="cpu"))

    def mirrored():
        (st,) = eng._states.values()
        assert st.sp_L_host is not st.sp_L.numpy()
        np.testing.assert_array_equal(st.sp_L_host, st.sp_L.numpy())
        return st

    eng.query(Query(g, "S", sources=(0,), semantics="single_path"))
    rows = int(mirrored().sp_mask.sum())
    r = eng.query(Query(g, "S", sources=(72,), semantics="single_path"))
    assert r.stats["cache"] == "warm" and r.stats["active_rows"] > 128
    assert int(mirrored().sp_mask.sum()) > rows
    assert eng.apply_delta(**EDIT).rows_evicted > 0
    mirrored()
    eng.query(Query(g, "S", sources=(0, 1, 73), semantics="single_path"))
    mirrored()


def test_single_path_result_has_paths_relational_has_none():
    _, tg = _graphs()
    g = T_GRAMMARS["q1"]
    eng = QueryEngine(tg, config=EngineConfig(device="cpu"))
    rel, sp = eng.query_batch([
        Query(g, "S", sources=(0,)),
        Query(g, "S", sources=(0,), semantics="single_path"),
    ])
    assert rel.paths is None and sp.paths is not None
    assert rel.pairs == sp.pairs == set(sp.paths)
    assert rel.stats["batch_groups"] == 2
