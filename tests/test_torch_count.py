"""The port's count and all-paths semantics against the reference, bit for
bit.

* the saturating arithmetic (``_sat_add``, ``_sat_mul``, ``_count_mm`` at
  every chunk, ``_scatter_sat_add``) on values near 2^16 (their products
  pass 2^32) and on the SAT sentinel, an empty contraction, and the base
  tensors;
* ``count_closure`` and ``masked_count_closure`` against their JAX
  counterparts on the golden cases (diamond, parallel stages, the
  saturating cycle, sticky saturation downstream, finite counts beside
  divergent ones) and random DAGs: the uint32 words, ``M`` and
  ``overflowed``, SAT entries carried through a warm restart;
* ``evaluate_count`` against the reference and a string-level brute-force
  path count; ``extract_paths`` returning the reference's paths;
* the engine's count batches, ``apply_delta`` (a recount that lets
  saturation in, then a drop) and ``extract_paths`` against the JAX
  engine's (counts, cache statuses, ``DeltaStats``, plan keys), the host
  mirror against the device state, the server round trip, and the
  iteration-cap regressions.

Inputs are built with numpy from fixed seeds and handed to both packages.
Tolerance is exact everywhere (``np.array_equal`` on uint32 views, dict
equality).  Each reference result is computed once per module.
"""
import asyncio

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
from repro_torch.core import closure as tc
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.core import matrices as tm
from repro_torch.core import semantics as ts
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.engine.plan import CompiledClosureCache, count_engine_name
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from helpers import assert_path_witness, cyk_recognize

BACKENDS = ("dense", "frontier", "bitpacked", "blocksparse", "auto")
SAT = 0xFFFFFFFF


def _grammars(text):
    return (jgrammar.Grammar.from_text(text).to_cnf(),
            tgrammar.Grammar.from_text(text).to_cnf())


#: S derives a^+, unambiguously: derivation counts are path counts
J_LIN, T_LIN = _grammars("S -> a S | a")
J_NUL, T_NUL = _grammars("S -> a S | ")
J_PAR, T_PAR = _grammars("S -> a | b")
J_BAL, T_BAL = _grammars("S -> a S b | a b")

J_PLANS = JPlans()  # one reference compile cache for the module


def _pair(edges, n=None):
    if n is None:
        n = 1 + max(max(i, j) for i, _, j in edges)
    return jgraph.Graph(n, list(edges)), tgraph.Graph(n, list(edges))


def _dag(seed: int):
    rng = np.random.default_rng(10 + seed)
    edges = []
    for _ in range(10):
        i = int(rng.integers(0, 5))
        edges.append((i, "a", int(rng.integers(i + 1, 6))))
    return _pair(edges)


def _stages(n_par: int):
    edges = []
    for s in range(2):  # two stages: s*2 -> s*2+2 via n_par midpoints
        for p in range(n_par):
            mid = 10 + s * n_par + p
            edges += [(s * 2, "a", mid), (mid, "a", (s + 1) * 2)]
    return _pair(edges)


#: name -> ((reference graph, port graph), (reference, port grammar))
CASES = {
    "diamond": (_pair([(0, "a", 1), (0, "a", 2), (1, "a", 3), (2, "a", 3)]),
                (J_LIN, T_LIN)),
    "stages3": (_stages(3), (J_LIN, T_LIN)),
    "loop": (_pair([(0, "a", 0)]), (J_LIN, T_LIN)),
    "cycle": (_pair([(0, "a", 1), (1, "a", 0)]), (J_LIN, T_LIN)),
    "sticky": (_pair([(0, "a", 0), (0, "a", 1), (1, "a", 2)]), (J_LIN, T_LIN)),
    "beside": (_pair([(0, "a", 1), (1, "a", 1), (2, "a", 3), (3, "a", 4),
                      (2, "a", 4)]), (J_LIN, T_LIN)),
    "dag0": (_dag(0), (J_LIN, T_LIN)),
    "dag1": (_dag(1), (J_LIN, T_LIN)),
    "chain": (_pair([(i, "a", i + 1) for i in range(5)]), (J_LIN, T_LIN)),
    "parallel_labels": (_pair([(0, "a", 1), (0, "b", 1)]), (J_PAR, T_PAR)),
    "nullable": (_pair([(0, "a", 1)]), (J_NUL, T_NUL)),
}
DAGS = ("diamond", "stages3", "dag0", "dag1", "chain")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def brute_count(graph, g, start: str) -> dict:
    """Every distinct edge path i ->* j (length <= n) whose label word
    CYK-derives from ``start``; exact on DAGs with an unambiguous grammar."""
    adj: dict[int, list] = {}
    for i, x, j in graph.edges:
        adj.setdefault(i, []).append((x, j))
    counts: dict = {}
    for s in range(graph.n_nodes):
        stack = [(s, [])]
        while stack:
            node, word = stack.pop()
            if word and cyk_recognize(g, start, word):
                counts[(s, node)] = counts.get((s, node), 0) + 1
            if len(word) < graph.n_nodes:
                stack.extend((j, word + [x]) for x, j in adj.get(node, ()))
    if start in g.nullable:
        for m in range(graph.n_nodes):
            counts[(m, m)] = counts.get((m, m), 0) + 1
    return counts


# ---------------------------------------------------------------------- #
# saturating arithmetic
# ---------------------------------------------------------------------- #


def _operands(seed: int, shape):
    """uint32 values: small, near 2^16 (products pass 2^32), near 2^32 and
    SAT itself, and zeros."""
    rng = np.random.default_rng(seed)
    pools = [rng.integers(0, 50, shape), rng.integers(2**16 - 40, 2**16 + 40, shape),
             rng.integers(2**32 - 2**20, 2**32, shape), np.full(shape, SAT)]
    pick = rng.integers(0, 4, shape)
    a = np.choose(pick, pools).astype(np.uint64)
    a[rng.random(shape) < 0.3] = 0
    return a.astype(np.uint32)


def test_sat_add_and_mul_equal_the_reference():
    a, b = _operands(1, (40, 40)), _operands(2, (40, 40))
    for jfn, tfn in ((js._sat_add, ts._sat_add), (js._sat_mul, ts._sat_mul)):
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(_u32(tfn(_t(a), _t(b))), want)
    assert (np.asarray(js._sat_mul(jnp.asarray(a), jnp.asarray(b))) == SAT).any()
    got = ts._umax(_t(a), _t(b))  # the unsigned max the closures write with
    np.testing.assert_array_equal(_u32(got), np.maximum(a, b))


@pytest.mark.parametrize("chunk", [1, 3, 64, None])
@pytest.mark.parametrize("shape", [(3, 7, 13, 9), (2, 5, 1, 4), (1, 9, 70, 11),
                                   (1, 3, 7, 1)],
                         ids=["rectangular", "k=1", "k>chunk", "one column"])
def test_count_mm_matches_the_reference_at_every_chunk(shape, chunk):
    P, rows, K, cols = shape
    lhs, rhs = _operands(P + K, (P, rows, K)), _operands(rows + cols, (P, K, cols))
    want = np.asarray(js._count_mm(jnp.asarray(lhs), jnp.asarray(rhs)))
    got = ts._count_mm(_t(lhs), _t(rhs), chunk=chunk)
    np.testing.assert_array_equal(_u32(got), want)


def test_count_mm_ref_index_and_acc_forms():
    """The indexed, accumulating form equals gathering the rhs and adding
    ``acc`` with the reference's saturating add."""
    rng = np.random.default_rng(3)
    lhs, base = _operands(4, (2, 6, 5)), _operands(5, (4, 9, 7))
    slab, row = np.array([3, 1]), rng.integers(0, 9, 5)
    acc = _operands(6, (2, 6, 7))
    prod = js._count_mm(jnp.asarray(lhs), jnp.asarray(base[slab][:, row]))
    want = np.asarray(js._sat_add(jnp.asarray(acc), prod))
    got = kref.count_mm_ref(_t(lhs), _t(base), torch.from_numpy(slab),
                            torch.from_numpy(row), _t(acc))
    np.testing.assert_array_equal(_u32(got), want)
    per_k = 32 * 128 * 15872  # four int64 temporaries of (1, 128, chunk, 15872)
    for dev, budget in kref.COUNT_TEMP_BYTES.items():
        assert kref.count_chunk(1, 128, 15872, 15872, dev) == max(1, budget // per_k)
    assert kref.count_chunk(6, 15872, 15872, 15872, "cuda") == 1  # never below 1
    assert kref.count_chunk(1, 2, 3, 7, "cpu") == 7  # small operands: one chunk


def test_count_mm_with_an_empty_contraction_is_acc_or_zero():
    """K = 0 (the reference's ``_count_mm`` takes no empty contraction):
    the product is 0, and with acc it is acc."""
    lhs = torch.zeros((2, 3, 0), dtype=torch.int32)
    rhs = torch.zeros((2, 0, 5), dtype=torch.int32)
    acc = _t(_operands(8, (2, 3, 5)))
    assert not ops.count_mm(lhs, rhs).any()
    assert torch.equal(ops.count_mm(lhs, rhs, acc=acc), acc)
    base = torch.zeros((3, 4, 5), dtype=torch.int32)
    assert torch.equal(ops.count_mm(lhs, base, torch.tensor([2, 0]),
                                    torch.zeros(0, dtype=torch.int64), acc), acc)


def test_scatter_sat_add_equals_the_reference():
    tables_j = jm.ProductionTables.from_grammar(J_BAL)
    tables_t = tm.ProductionTables.from_grammar(T_BAL)
    prod = _operands(7, (tables_j.n_prods, 5, 6))
    want = np.asarray(js._scatter_sat_add(jnp.asarray(prod), tables_j))
    np.testing.assert_array_equal(_u32(ts._scatter_sat_add(_t(prod), tables_t)), want)


@pytest.mark.parametrize("name", ["parallel_labels", "stages3"])
def test_count_base_equals_the_reference(name):
    (jg, tg), (jgr, tgr) = CASES[name]
    want = np.asarray(js.count_base(jg, jgr))
    np.testing.assert_array_equal(_u32(ts.count_base(tg, tgr, device="cpu")), want)
    rows = [2, 0, 5]
    np.testing.assert_array_equal(
        _u32(ts.count_base_rows(tg, tgr, rows, pad_to=128, device="cpu")),
        js.count_base_rows(jg, jgr, rows, pad_to=128))


# ---------------------------------------------------------------------- #
# closures against the reference's
# ---------------------------------------------------------------------- #

_REF: dict = {}


def _src(n: int) -> np.ndarray:
    src = np.zeros(n, dtype=bool)
    src[0] = True
    return src


def _reference(name: str) -> dict:
    """The reference's count closures on case ``name`` (computed once)."""
    if name not in _REF:
        (jg, _), (jgr, _) = CASES[name]
        tables = jm.ProductionTables.from_grammar(jgr)
        C0 = js.count_base(jg, jgr)
        out = {"all": np.asarray(js.count_closure(C0, tables))}
        for cap in (1, C0.shape[-1]):
            C, M, ov = js.masked_count_closure(
                C0, C0, tables, jnp.asarray(_src(C0.shape[-1])), row_capacity=cap)
            out[cap] = (np.asarray(C), np.asarray(M), bool(ov))
        out["evaluate"] = js.evaluate_count(jg, jgr, "S")
        _REF[name] = out
    return _REF[name]


@pytest.mark.parametrize("name", list(CASES))
def test_count_closures_equal_the_reference(name):
    """count_closure's words, and masked_count_closure's (C, M, overflowed)
    at capacity 1 (overflows) and at full capacity; then a warm restart
    from the overflowed state, which carries its SAT stamps, reaches the
    full result on the mask rows."""
    (_, tg), (_, tgr) = CASES[name]
    tables = tm.ProductionTables.from_grammar(tgr)
    C0 = ts.count_base(tg, tgr, device="cpu")
    want = _reference(name)
    np.testing.assert_array_equal(_u32(ts.count_closure(C0, tables)), want["all"])
    n = C0.shape[-1]
    src = torch.from_numpy(_src(n))
    for cap in (1, n):
        C, M, ov = ts.masked_count_closure(C0, C0, tables, src, row_capacity=cap)
        wC, wM, wov = want[cap]
        np.testing.assert_array_equal(_u32(C), wC)
        np.testing.assert_array_equal(M.numpy(), wM)
        assert ov == wov
    assert torch.equal(C0, ts.count_base(tg, tgr, device="cpu"))  # input kept
    C, M, _ = ts.masked_count_closure(C0, C0, tables, src, row_capacity=1)
    C, M, ov = ts.masked_count_closure(C, C0, tables, M, row_capacity=n)
    wC, wM, _ = want[n]
    assert not ov
    np.testing.assert_array_equal(_u32(C)[:, wM], wC[:, wM])


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_count_equals_the_reference_and_brute_force(name):
    (_, tg), (_, tgr) = CASES[name]
    got = ts.evaluate_count(tg, tgr, "S", device="cpu")
    assert got == _reference(name)["evaluate"]
    if name in DAGS or name in ("parallel_labels", "nullable"):
        assert got == brute_count(tg, tgr, "S")


def test_saturation_goldens():
    """A cycle admits unboundedly many paths: every connected pair is the
    SAT sentinel, stamped by the divergence phase, and sticky downstream;
    pairs off the cycle stay exact."""
    ev = {k: ts.evaluate_count(CASES[k][0][1], T_LIN, "S", device="cpu")
          for k in ("loop", "cycle", "sticky", "beside")}
    assert ev["loop"] == {(0, 0): SAT}
    assert ev["cycle"] == {(i, j): SAT for i in (0, 1) for j in (0, 1)}
    assert ev["sticky"][(0, 2)] == SAT and ev["sticky"][(1, 2)] == 1
    assert ev["beside"][(0, 1)] == SAT and ev["beside"][(2, 4)] == 2


@pytest.mark.parametrize("name", ["diamond", "dag0", "loop", "nullable"])
def test_extract_paths_equals_the_reference(name):
    (jg, tg), (jgr, tgr) = CASES[name]
    T0 = tm.init_matrix(tg, tgr, device="cpu")
    T = tc.dense_closure(T0, tm.ProductionTables.from_grammar(tgr)).numpy()
    counts = ts.evaluate_count(tg, tgr, "S", device="cpu")
    for (i, j), c in counts.items():
        k = min(c, 6) + 2
        got = ts.extract_paths(T, tg, tgr, "S", i, j, k=k, max_len=6)
        assert got == js.extract_paths(T, jg, jgr, "S", i, j, k=k, max_len=6)
        assert len({tuple(p) for p in got}) == len(got)
        if name != "loop":  # on a DAG the enumeration finds every path
            assert len(got) == c
        for p in got:
            assert_path_witness(jg, jgr, "S", i, j, p)


# ---------------------------------------------------------------------- #
# the engine against the reference engine
# ---------------------------------------------------------------------- #

STEPS = ([(0,)], [(1,)], [None], [(0,), (1,)])


def _serve(engine, query_cls, grammar, steps):
    out = []
    for step in steps:
        res = engine.query_batch([
            query_cls(grammar, "S", sources=src, semantics="count") for src in step])
        out.append([(r.counts, r.pairs, r.stats["cache"], r.stats["active_rows"])
                    for r in res])
    return out


ENGINE_CASES = ("diamond", "sticky", "nullable", "dag1")


@pytest.fixture(scope="module")
def reference_engines():
    out = {}
    for backend in BACKENDS:
        for name in ENGINE_CASES:
            (jg, _), (jgr, _) = CASES[name]
            eng = JEngine(jg, plans=J_PLANS, config=JConfig(engine=backend))
            out[backend, name] = _serve(eng, JQuery, jgr, STEPS)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_the_reference_engine(backend, reference_engines):
    plans = CompiledClosureCache()
    for name in ENGINE_CASES:
        (_, tg), (_, tgr) = CASES[name]
        eng = QueryEngine(tg, plans=plans,
                          config=EngineConfig(engine=backend, device="cpu"))
        got = _serve(eng, Query, tgr, STEPS)
        assert got == reference_engines[backend, name], name
        (st,) = eng._states.values()
        assert np.array_equal(st.cnt_C_host, st.cnt_C.numpy())  # mirror == device
    # every backend keys its count plans under the one dense closure
    assert {(k.engine, k.semantics) for k in plans._exe} == {("dense", "count")}


def test_plan_keys_and_routes_equal_the_reference():
    from repro.engine.plan import count_engine_name as jname

    for engine in ("dense", "frontier", "bitpacked", "blocksparse", "opt"):
        assert count_engine_name(engine) == jname(engine) == "dense"
    (jg, tg), (jgr, tgr) = CASES["diamond"]
    jplans, tplans = JPlans(), CompiledClosureCache()
    for backend in ("dense", "frontier", "bitpacked", "blocksparse"):
        j = JEngine(jg, plans=jplans, config=JConfig(engine=backend)).query(
            JQuery(jgr, "S", semantics="count"))
        t = QueryEngine(tg, plans=tplans, config=EngineConfig(
            engine=backend, device="cpu")).query(Query(tgr, "S", semantics="count"))
        assert t.counts == j.counts
    assert tplans.stats.as_dict() == jplans.stats.as_dict()
    assert tplans.stats.compile_misses == 1
    j = JEngine(jg, plans=J_PLANS).query(JQuery(jgr, "S", semantics="count"))
    t = QueryEngine(tg, config=EngineConfig(device="cpu")).query(
        Query(tgr, "S", semantics="count"))
    assert t.stats.planner["label"] == j.stats.planner["label"] == "dense:masked+count"


def test_mixed_relational_count_batch_and_validation():
    from repro_torch.core.conjunctive import ConjunctiveGrammar

    (_, tg), (_, tgr) = CASES["diamond"]
    eng = QueryEngine(tg, config=EngineConfig(device="cpu"))
    r_cnt, r_rel = eng.query_batch([Query(tgr, "S", semantics="count"),
                                    Query(tgr, "S", semantics="relational")])
    assert r_cnt.counts == brute_count(tg, tgr, "S")
    assert r_rel.pairs == set(r_cnt.counts) and r_rel.counts is None
    assert r_cnt.stats.batch_groups == 2
    assert eng.metrics.count_active_rows.value == r_cnt.stats.active_rows


def test_count_requires_cnf_grammar():
    from repro_torch.core.conjunctive import ConjunctiveGrammar

    conj = ConjunctiveGrammar.from_rules({"a": ["A"]}, [("S", [("A", "A")])])
    eng = QueryEngine(CASES["diamond"][0][1], config=EngineConfig(device="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        eng.query(Query(conj, "S", semantics="count"))


# ---------------------------------------------------------------------- #
# the delta contract: insert = recount affected rows, delete = full drop
# ---------------------------------------------------------------------- #

#: (insert, delete) per epoch on 0 -a-> 1 over 4 nodes: a second path,
#: a self-loop (saturation enters through the recount), then a delete and
#: a mixed delta
EPOCHS = (([(1, "a", 2)], []), ([(0, "a", 2)], []), ([(2, "a", 2)], []),
          ([(2, "a", 3)], []), ([], [(1, "a", 2)]), ([(1, "a", 2)], [(0, "a", 1)]))


def _delta_run(engine_cls, query_cls, graph_cls, plans, config, grammar, check=None):
    eng = engine_cls(graph_cls(4, [(0, "a", 1)]), plans=plans, config=config)
    q = query_cls(grammar, "S", semantics="count")
    r = eng.query(q)
    out = [(r.counts, r.stats["cache"])]
    for ins, dele in EPOCHS:
        st = eng.apply_delta(insert=ins, delete=dele)
        if check is not None:
            check(eng)
        r = eng.query(q)
        out.append((st.as_dict(), r.counts, r.stats["cache"]))
        if check is not None:
            check(eng)
    return out


@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_delta_interleaving_matches_the_reference(backend):
    def mirror_is_device(eng):
        (st,) = eng._states.values()
        if st.cnt_C is not None:
            assert np.array_equal(st.cnt_C_host, st.cnt_C.numpy())

    want = _delta_run(JEngine, JQuery, jgraph.Graph, J_PLANS,
                      JConfig(engine=backend), J_LIN)
    got = _delta_run(QueryEngine, Query, tgraph.Graph, CompiledClosureCache(),
                     EngineConfig(engine=backend, device="cpu"), T_LIN,
                     mirror_is_device)
    assert got == want
    stats = [s for s, _, _ in got[1:]]
    assert [(s["count_repairs"], s["count_drops"]) for s in stats] == [
        (1, 0)] * 4 + [(0, 1)] * 2
    assert [c for _, _, c in got[1:]] == ["hit"] * 4 + ["miss"] * 2
    assert got[3][1][(0, 2)] == SAT  # saturation entered through a recount


def test_host_mirror_equals_the_device_after_a_warm_restart():
    """Single-source batches grow the mask from 2 rows to 3 to all 140,
    past the first capacity bucket (128 of n = 256): every warm restart and
    the recount after an insert leave the host mirror equal to the whole
    device state, SAT included."""
    edges = [(0, "a", i) for i in range(1, 71)] + [
        (i, "a", 70 + i) for i in range(1, 70)] + [(5, "a", 5)]
    graph = tgraph.Graph(140, edges)
    eng = QueryEngine(graph, config=EngineConfig(engine="dense", device="cpu"))
    for sources in ((75,), (3,), (0,)):
        r = eng.query(Query(T_LIN, "S", sources=sources, semantics="count"))
        (st,) = eng._states.values()
        assert np.array_equal(st.cnt_C_host, st.cnt_C.numpy())
    assert r.stats.active_rows == 140 and r.stats.cache == "warm"
    assert r.counts[(0, 5)] == SAT and r.counts[(0, 75)] == SAT
    assert r.counts[(0, 73)] == 1
    eng.apply_delta(insert=[(3, "a", 74)])
    (st,) = eng._states.values()
    assert np.array_equal(st.cnt_C_host, st.cnt_C.numpy())
    assert eng.query(Query(T_LIN, "S", sources=(0,), semantics="count")).counts == {
        k: v for k, v in ts.evaluate_count(graph, T_LIN, "S", device="cpu").items()
        if k[0] == 0}


def test_engine_extract_paths_and_invalidation():
    _, graph = _pair([(0, "a", 1), (1, "a", 3)])
    eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
    assert len(eng.extract_paths(T_LIN, "S", 0, 3, k=10, max_len=8)) == 1
    eng.apply_delta(insert=[(0, "a", 2), (2, "a", 3)])
    paths = eng.extract_paths(T_LIN, "S", 0, 3, k=10, max_len=8)
    assert len(paths) == 2
    for p in paths:
        assert_path_witness(jgraph.Graph(4, list(graph.edges)), J_LIN, "S", 0, 3, p)
    with pytest.raises(ValueError, match="outside graph"):
        eng.extract_paths(T_LIN, "S", 0, 9)


# ---------------------------------------------------------------------- #
# the serving loop and the iteration-cap regressions
# ---------------------------------------------------------------------- #


def test_count_through_both_servers():
    from repro.serve import CFPQServer as JServer
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import CFPQServer, ServeConfig

    (jg, tg), (jgr, tgr) = CASES["diamond"]

    async def main(server, cfg, engine, query_cls, grammar):
        async with server(engine, cfg(max_batch=8, batch_window_s=0.005)) as srv:
            outs = await asyncio.wait_for(asyncio.gather(*[
                srv.submit(query_cls(grammar, "S", sources=(i,), semantics="count"))
                for i in range(3)]), 30)
            return [r.counts for r in outs], srv.stats.planner_routes

    want, jroutes = asyncio.run(main(
        JServer, JServeConfig, JEngine(jg, plans=J_PLANS), JQuery, jgr))
    got, routes = asyncio.run(main(
        CFPQServer, ServeConfig, QueryEngine(tg, config=EngineConfig(device="cpu")),
        Query, tgr))
    assert got == want
    assert any(k.endswith("+count") for k in routes), routes


@pytest.fixture(scope="module")
def worst17():
    return tgraph.worst_case_graph(17)


def test_iteration_cap_reaches_deep_fixpoints(worst17):
    """n * N iterations truncate worst_case_graph(17) before the fixpoint
    (the pair (0, 0) needs a derivation far deeper); the |V|^2 |N| guard
    reaches it."""
    n = tm.padded_size(worst17.n_nodes)
    tables = tm.ProductionTables.from_grammar(T_BAL)
    T0 = tm.init_matrix(worst17, T_BAL, pad_to=n, device="cpu")
    a0 = T_BAL.index_of("S")
    T_old = tc.dense_closure(T0, tables, max_iters=n * T_BAL.n_nonterms)
    T_new = tc.dense_closure(T0, tables)
    assert not T_old[a0, 0, 0] and T_new[a0, 0, 0]
    assert not (T_old & ~T_new).any()


@pytest.mark.parametrize("backend", ["dense", "frontier", "bitpacked", "blocksparse"])
def test_iteration_cap_masked_engines(worst17, backend):
    eng = QueryEngine(worst17, config=EngineConfig(engine=backend, device="cpu"))
    assert (0, 0) in eng.query(Query(T_BAL, "S", sources=(0,))).pairs


def test_iteration_cap_count(worst17):
    """The count closure reaches the deep pair too: one derivation per
    balanced path, and the worst-case graph's cycles make it divergent."""
    eng = QueryEngine(worst17, config=EngineConfig(device="cpu"))
    r = eng.query(Query(T_BAL, "S", sources=(0,), semantics="count"))
    rel = eng.query(Query(T_BAL, "S", sources=(0,)))
    assert (0, 0) in r.counts and set(r.counts) == rel.pairs
