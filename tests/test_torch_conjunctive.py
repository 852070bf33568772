"""The port's conjunctive semantics against the reference, bit for bit.

* ``ConjunctiveGrammar`` / ``ConjunctiveTables`` (rule validation, dedupe,
  the flattened tables) and the base matrices against the reference's;
* ``conjunctive_closure``, ``_conj_combine`` (bool planes and packed words
  with bit 31 set), ``masked_conjunctive_closure`` and
  ``masked_bitpacked_conjunctive_closure`` against their JAX counterparts
  (the packed one as the reference's tests run it, ``use_kernel=False``):
  ``T``, ``M`` and ``overflowed``, at a capacity that overflows and at full;
* the a^n b^n c^n golden case, soundness against string-level brute
  force, the over-approximation witness and the iteration-cap regression;
* the engine's conjunctive batches and ``apply_delta`` against the JAX
  engine's (pairs, cache statuses, ``DeltaStats``, plan keys) for every
  backend and ``auto``, and the server round trip.

Inputs are built with numpy from fixed seeds and handed to both packages.
Tolerance is exact everywhere (``np.array_equal``, set equality).  Each
reference result is computed once per module.
"""
import asyncio
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conjunctive as jconj
from repro.core import graph as jgraph
from repro.core import semantics as js
from repro.core.matrices import pack_bits as jpack
from repro.engine import CompiledClosureCache as JPlans
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch.core import conjunctive as tconj
from repro_torch.core import graph as tgraph
from repro_torch.core import matrices as tm
from repro_torch.core import semantics as ts
from repro_torch.core.grammar import CNFGrammar, Production
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.engine.plan import CompiledClosureCache, conj_engine_name

BACKENDS = ("dense", "frontier", "bitpacked", "blocksparse", "auto")

#: {a^n b^n c^n}:  S -> (AB . c^+) & (a^+ . BC), two S rules for the n = 1
#: and n >= 2 suffix split (binary rules only) — the reference test's
ABC_RULES = (
    {"a": ["A"], "b": ["B"], "c": ["C"]},
    [
        ("S", [("AB", "C"), ("A", "BC")]),
        ("S", [("AB", "Cp"), ("Ap", "BC")]),
        ("AB", [("A", "B")]),
        ("AB", [("A", "ABb")]),
        ("ABb", [("AB", "B")]),
        ("BC", [("B", "C")]),
        ("BC", [("B", "BCc")]),
        ("BCc", [("BC", "C")]),
        ("Cp", [("C", "C")]),
        ("Cp", [("C", "Cp")]),
        ("Ap", [("A", "A")]),
        ("Ap", [("A", "Ap")]),
    ],
)
PAR_RULES = ({"a": ["A"], "b": ["B"]}, [("S", [("A", "A"), ("B", "B")])])
#: a single-conjunct grammar is an ordinary CFG (the iteration-cap case)
BAL_RULES = (
    {"a": ["A"], "b": ["B"]},
    [("S", [("A", "X")]), ("S", [("A", "B")]), ("X", [("S", "B")])],
)


def _grammars(rules):
    return (jconj.ConjunctiveGrammar.from_rules(*rules),
            tconj.ConjunctiveGrammar.from_rules(*rules))


J_ABC, T_ABC = _grammars(ABC_RULES)
J_PAR, T_PAR = _grammars(PAR_RULES)

J_PLANS = JPlans()  # one reference compile cache for the module


def _pair(n: int, edges):
    return jgraph.Graph(n, list(edges)), tgraph.Graph(n, list(edges))


def _chain(word: str):
    return _pair(len(word) + 1, [(i, ch, i + 1) for i, ch in enumerate(word)])


def _random_edges(seed: int, n: int, m: int, labels="abc"):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(n)), labels[rng.integers(len(labels))],
             int(rng.integers(n))) for _ in range(m)]


def _in_language(word: str) -> bool:
    m = re.fullmatch(r"(a+)(b+)(c+)", word)
    return bool(m) and len(m.group(1)) == len(m.group(2)) == len(m.group(3))


def _brute_pairs(graph, max_len: int = 9) -> set:
    """String-level oracle: pairs joined by a path (length <= ``max_len``)
    whose label word is in {a^n b^n c^n}."""
    adj: dict[int, list] = {}
    for i, x, j in graph.edges:
        adj.setdefault(i, []).append((x, j))
    out = set()
    for start in range(graph.n_nodes):
        stack, seen = [(start, "")], set()
        while stack:
            node, word = stack.pop()
            if len(word) > max_len or (node, word) in seen:
                continue
            seen.add((node, word))
            if _in_language(word):
                out.add((start, node))
            for x, j in adj.get(node, ()):
                stack.append((j, word + x))
    return out


#: (name, (reference graph, port graph), grammars) of the closure cases
CASES = {
    "chain": (_chain("aabbcc"), (J_ABC, T_ABC)),
    "parallel_dag": (
        _pair(3, [(0, "a", 1), (1, "a", 2), (0, "b", 1), (1, "b", 2)]),
        (J_PAR, T_PAR),
    ),
    "random0": (_pair(5, _random_edges(7, 5, 10)), (J_ABC, T_ABC)),
    "random1": (_pair(6, _random_edges(8, 6, 14)), (J_ABC, T_ABC)),
    "anbncn3": (_chain("aaabbbccc"), (J_ABC, T_ABC)),
}


# ---------------------------------------------------------------------- #
# grammar, tables, base matrices
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("rules", [ABC_RULES, PAR_RULES, BAL_RULES],
                         ids=["abc", "parallel", "balanced"])
def test_grammar_and_tables_equal_the_reference(rules):
    jg, tg = _grammars(rules)
    assert (tg.nonterms, tg.term_prods, tg.conj_prods) == (
        jg.nonterms, jg.term_prods, jg.conj_prods)
    assert tg.nullable == jg.nullable == frozenset()
    jt = jconj.ConjunctiveTables.from_grammar(jg)
    tt = tconj.ConjunctiveTables.from_grammar(tg)
    assert (tt.a_idx, tt.conj_b, tt.conj_c, tt.prod_of, tt.n_nonterms) == (
        jt.a_idx, jt.conj_b, jt.conj_c, jt.prod_of, jt.n_nonterms)
    assert (tt.n_prods, tt.n_conjuncts) == (jt.n_prods, jt.n_conjuncts)
    assert tt.conj_groups() == jt.conj_groups()
    assert tt.lhs_groups() == jt.lhs_groups()


def test_from_rules_rejects_empty_conjuncts_and_dedupes():
    with pytest.raises(ValueError, match="no conjuncts"):
        tconj.ConjunctiveGrammar.from_rules({"a": ["A"]}, [("S", [])])
    rules = ({"a": ["A"], "b": ["B"]}, [("S", [("A", "B"), ("A", "B"), ("B", "A")])])
    jg, tg = _grammars(rules)
    ((_, pairs),) = tg.conj_prods
    assert len(pairs) == 2 and tg.conj_prods == jg.conj_prods
    assert tconj.ConjunctiveTables.from_grammar(tg).n_conjuncts == 2
    dup = tconj.ConjunctiveGrammar(tg.nonterms, tg.term_prods,
                                   ((tg.conj_prods[0][0], pairs + pairs[:1]),))
    _, graph = _pair(3, [(0, "a", 1), (1, "b", 2), (0, "b", 1), (1, "a", 2)])
    assert tconj.evaluate(graph, tg, "S", device="cpu") == tconj.evaluate(
        graph, dup, "S", device="cpu")


@pytest.mark.parametrize("name", ["chain", "random1"])
def test_base_matrices_equal_the_reference(name):
    (jg, tg), (jgr, tgr) = CASES[name]
    want = np.asarray(jconj.init_matrix(jg, jgr))
    np.testing.assert_array_equal(tconj.init_matrix(tg, tgr, device="cpu").numpy(), want)
    rows = [3, 0, 1]
    np.testing.assert_array_equal(
        tconj.init_matrix_rows(tg, tgr, rows),
        jconj.init_matrix_rows(jg, jgr, rows))


# ---------------------------------------------------------------------- #
# closures against the reference's
# ---------------------------------------------------------------------- #

_REF: dict = {}


def _src(n: int) -> np.ndarray:
    src = np.zeros(n, dtype=bool)
    src[0] = True
    return src


def _reference(name: str) -> dict:
    """The reference closures on case ``name`` (computed once)."""
    if name not in _REF:
        (jg, _), (jgr, _) = CASES[name]
        T0 = jconj.init_matrix(jg, jgr)
        tables = jconj.ConjunctiveTables.from_grammar(jgr)
        src = jnp.asarray(_src(T0.shape[-1]))
        out = {"all": np.asarray(jconj.conjunctive_closure(T0, jgr))}
        for cap in (1, T0.shape[-1]):
            for key, fn, kw in (
                ("dense", js.masked_conjunctive_closure, {}),
                ("bitpacked", js.masked_bitpacked_conjunctive_closure,
                 {"use_kernel": False}),
            ):
                T, M, ov = fn(T0, tables, src, row_capacity=cap, **kw)
                out[key, cap] = (np.asarray(T), np.asarray(M), bool(ov))
        _REF[name] = out
    return _REF[name]


@pytest.mark.parametrize("name", list(CASES))
def test_conjunctive_closure_equals_the_reference(name):
    (_, tg), (_, tgr) = CASES[name]
    got = tconj.conjunctive_closure(tconj.init_matrix(tg, tgr, device="cpu"), tgr)
    np.testing.assert_array_equal(got.numpy(), _reference(name)["all"])


@pytest.mark.parametrize("backend", ["dense", "bitpacked"])
@pytest.mark.parametrize("name", list(CASES))
def test_masked_conjunctive_closures_equal_the_reference(name, backend):
    """T, M and overflowed at capacity 1 (overflows) and at full capacity;
    the warm restart from the overflowed state reaches the full result."""
    (_, tg), (_, tgr) = CASES[name]
    T0 = tconj.init_matrix(tg, tgr, device="cpu")
    n = T0.shape[-1]
    tables = tconj.ConjunctiveTables.from_grammar(tgr)
    fn = {"dense": ts.masked_conjunctive_closure,
          "bitpacked": ts.masked_bitpacked_conjunctive_closure}[backend]
    src = torch.from_numpy(_src(n))
    for cap in (1, n):
        T, M, ov = fn(T0, tables, src, row_capacity=cap)
        wT, wM, wov = _reference(name)[backend, cap]
        np.testing.assert_array_equal(T.numpy(), wT)
        np.testing.assert_array_equal(M.numpy(), wM)
        assert ov == wov
    assert torch.equal(T0, tconj.init_matrix(tg, tgr, device="cpu"))  # input kept
    T, M, _ = fn(T0, tables, src, row_capacity=1)
    T, M, ov = fn(T, tables, M, row_capacity=n)  # warm restart
    assert not ov
    wT, wM, _ = _reference(name)[backend, n]
    np.testing.assert_array_equal(T.numpy()[:, wM], wT[:, wM])


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_conj_combine_equals_the_reference(packed):
    rng = np.random.default_rng(5)
    tables_j = jconj.ConjunctiveTables.from_grammar(J_ABC)
    tables_t = tconj.ConjunctiveTables.from_grammar(T_ABC)
    K = tables_j.n_conjuncts
    bits = rng.random((K, 6, 64)) < 0.6
    if packed:
        words = np.asarray(jpack(jnp.asarray(bits)))  # bit 31 set in many
        assert (words >= 2**31).any()
        want = np.asarray(js._conj_combine(jnp.asarray(words), tables_j))
        got = ts._conj_combine(torch.from_numpy(words.view(np.int32).copy()), tables_t)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    else:
        want = np.asarray(js._conj_combine(jnp.asarray(bits), tables_j))
        got = ts._conj_combine(torch.from_numpy(bits), tables_t)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------- #
# golden cases and the standalone semantics
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "word", ["abc", "aabbcc", "aaabbbccc", "aabbc", "abbcc", "aabcc",
             "aabbbccc", "abcabc", "ab", "acb"])
def test_anbncn_golden(word):
    jg, tg = _chain(word)
    got = tconj.evaluate(tg, T_ABC, "S", device="cpu")
    assert ((0, len(word)) in got) == _in_language(word)
    assert got == jconj.evaluate(jg, J_ABC, "S")


def test_soundness_and_the_upper_approximation():
    for seed in range(4):
        _, graph = _pair(4, _random_edges(seed, 4, 8))
        assert _brute_pairs(graph) <= tconj.evaluate(graph, T_ABC, "S", device="cpu")
    # 0 -> 2 via "aa" and via "bb": the node-pair conjunction holds though
    # no single path satisfies both conjuncts
    (_, graph), _ = CASES["parallel_dag"]
    assert (0, 2) in tconj.evaluate(graph, T_PAR, "S", device="cpu")
    _, chain = _chain("aa")
    assert (0, 2) not in tconj.evaluate(chain, T_PAR, "S", device="cpu")


@pytest.fixture(scope="module")
def worst17():
    """worst_case_graph(17) with the single-conjunct balanced grammar: the
    pair (0, 0) needs a derivation far deeper than n * N iterations."""
    jg, tg = _grammars(BAL_RULES)
    return (jgraph.worst_case_graph(17), tgraph.worst_case_graph(17), jg, tg)


def test_iteration_cap_reaches_deep_fixpoints(worst17):
    jgg, tgg, jg, tg = worst17
    got = tconj.evaluate(tgg, tg, "S", device="cpu")
    assert (0, 0) in got
    assert got == jconj.evaluate(jgg, jg, "S")


def test_iteration_cap_through_the_engine(worst17):
    _, tgg, _, tg = worst17
    for backend in ("dense", "bitpacked"):
        eng = QueryEngine(tgg, config=EngineConfig(engine=backend, device="cpu"))
        r = eng.query(Query(tg, "S", sources=(0,), semantics="conjunctive"))
        assert (0, 0) in r.pairs, backend


# ---------------------------------------------------------------------- #
# the engine against the reference engine
# ---------------------------------------------------------------------- #


def _key(k):
    return (k.engine, k.n, k.row_capacity, k.repair, k.ctx_capacity, k.semantics)


def _serve(engine, query_cls, grammar, steps):
    """Per step: per query (pairs, cache, semantics, batch_groups)."""
    out = []
    for step in steps:
        res = engine.query_batch([
            query_cls(grammar, "S", sources=src, semantics="conjunctive")
            for src in step])
        out.append([(r.pairs, r.stats["cache"], r.stats["semantics"],
                     r.stats["batch_groups"]) for r in res])
    return out


STEPS = ([(0,)], [(1, 2)], [None], [(0,), (2,)])


@pytest.fixture(scope="module")
def reference_engines():
    """Per backend: the reference engine's answers on every closure case
    and its plan keys (computed once)."""
    out = {}
    for backend in BACKENDS:
        for name, ((jg, _), (jgr, _)) in CASES.items():
            eng = JEngine(jg, plans=J_PLANS, config=JConfig(engine=backend))
            out[backend, name] = _serve(eng, JQuery, jgr, STEPS)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_the_reference_engine(backend, reference_engines):
    plans = CompiledClosureCache()
    for name, ((jg, tg), (jgr, tgr)) in CASES.items():
        eng = QueryEngine(tg, plans=plans,
                          config=EngineConfig(engine=backend, device="cpu"))
        assert _serve(eng, Query, tgr, STEPS) == reference_engines[backend, name], name
        want = jconj.evaluate(jg, jgr, "S")
        assert eng.query(Query(tgr, "S", semantics="conjunctive")).pairs == want
    # every backend aliases onto the two conjunctive closures
    assert {k.engine for k in plans._exe} <= {"dense", "bitpacked"}
    assert {k.semantics for k in plans._exe} == {"conjunctive"}


def test_plan_keys_and_aliasing_equal_the_reference():
    for engine in ("dense", "frontier", "bitpacked", "blocksparse", "opt"):
        from repro.engine.plan import conj_engine_name as jname

        assert conj_engine_name(engine) == jname(engine)
    (jg, tg), (jgr, tgr) = CASES["chain"]
    jplans, tplans = JPlans(), CompiledClosureCache()
    for backend in ("dense", "frontier", "bitpacked", "blocksparse"):
        JEngine(jg, plans=jplans, config=JConfig(engine=backend)).query(
            JQuery(jgr, "S", semantics="conjunctive"))
        QueryEngine(tg, plans=tplans, config=EngineConfig(
            engine=backend, device="cpu")).query(Query(tgr, "S", semantics="conjunctive"))
    assert sorted(map(_key, tplans._exe)) == sorted(map(_key, jplans._exe))
    assert tplans.stats.as_dict() == jplans.stats.as_dict()
    assert tplans.stats.compile_misses <= 2  # one dense + one bitpacked


def test_auto_routes_like_the_reference():
    (jg, tg), (jgr, tgr) = CASES["chain"]
    j = JEngine(jg, plans=J_PLANS).query(
        JQuery(jgr, "S", sources=(0,), semantics="conjunctive"))
    t = QueryEngine(tg, config=EngineConfig(device="cpu")).query(
        Query(tgr, "S", sources=(0,), semantics="conjunctive"))
    assert t.stats.planner["label"] == j.stats.planner["label"]
    assert t.stats.planner["label"].endswith("+conjunctive")
    assert t.pairs == j.pairs


def test_mixed_relational_conjunctive_batch():
    (_, tg), _ = CASES["chain"]
    cnf = CNFGrammar.from_productions([
        Production("S", ("A", "B")), Production("A", ("a",)), Production("B", ("b",))])
    eng = QueryEngine(tg, config=EngineConfig(device="cpu"))
    r_conj, r_rel = eng.query_batch([Query(T_ABC, "S", semantics="conjunctive"),
                                     Query(cnf, "S", semantics="relational")])
    assert r_conj.pairs == tconj.evaluate(tg, T_ABC, "S", device="cpu")
    assert r_rel.pairs == {(1, 3)}
    assert (r_conj.stats.semantics, r_rel.stats.semantics) == ("conjunctive", "relational")
    assert r_conj.stats.batch_groups == 2


def test_semantics_grammar_mismatch_rejected():
    (_, tg), _ = CASES["chain"]
    cnf = CNFGrammar.from_productions([
        Production("S", ("A", "B")), Production("A", ("a",)), Production("B", ("b",))])
    eng = QueryEngine(tg, config=EngineConfig(device="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        eng.query(Query(T_ABC, "S"))  # conjunctive grammar, relational default
    with pytest.raises(ValueError, match="does not match"):
        eng.query(Query(cnf, "S", semantics="conjunctive"))
    with pytest.raises(ValueError, match="unknown semantics"):
        eng.query(Query(T_ABC, "S", semantics="intersective"))


# ---------------------------------------------------------------------- #
# the delta contract: insert = warm re-seed, delete = full drop
# ---------------------------------------------------------------------- #

WORD = "aaabbbccc"
FULL = [(i, ch, i + 1) for i, ch in enumerate(WORD)]
#: (insert, delete) per epoch: two insert-only, a delete, a mixed one
EPOCHS = (([FULL[-2]], []), ([FULL[-1]], []), ([], [FULL[3]]),
          ([FULL[3]], [FULL[0]]))


def _delta_run(engine_cls, query_cls, graph_cls, grammar, plans, config):
    graph = graph_cls(len(WORD) + 1, FULL[:-2])
    eng = engine_cls(graph, plans=plans, config=config)
    q = query_cls(grammar, "S", semantics="conjunctive")
    r = eng.query(q)
    out = [(r.pairs, r.stats["cache"])]
    for ins, dele in EPOCHS:
        st = eng.apply_delta(insert=ins, delete=dele)
        r = eng.query(q)
        out.append((st.as_dict(), r.pairs, r.stats["cache"]))
    return out


@pytest.mark.parametrize("backend", ["auto", "dense", "bitpacked"])
def test_delta_interleaving_matches_the_reference(backend):
    want = _delta_run(JEngine, JQuery, jgraph.Graph, J_ABC, J_PLANS,
                      JConfig(engine=backend))
    got = _delta_run(QueryEngine, Query, tgraph.Graph, T_ABC,
                     CompiledClosureCache(), EngineConfig(engine=backend, device="cpu"))
    assert got == want
    # both sides of the contract ran: two repairs, then two drops
    stats = [s for s, _, _ in got[1:]]
    assert [(s["conj_repairs"], s["conj_drops"]) for s in stats] == [
        (1, 0), (1, 0), (0, 1), (0, 1)]
    assert stats[0]["rows_repaired"] > 0 and stats[2]["rows_evicted"] > 0
    assert [c for _, _, c in got[1:]] == ["hit", "hit", "miss", "miss"]
    assert got[2][1] == {(0, len(WORD))}


def test_delta_repair_matches_a_fresh_engine():
    word = "aabbcc"
    full = [(i, ch, i + 1) for i, ch in enumerate(word)]
    graph = tgraph.Graph(len(word) + 1, full[:2])
    eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
    q = Query(T_ABC, "S", semantics="conjunctive")
    eng.query(q)
    for e in full[2:]:
        eng.apply_delta(insert=[e])
        (st,) = eng._states.values()
        assert np.array_equal(st.T_host, st.T.numpy())  # host copy == device
        fresh = QueryEngine(tgraph.Graph(graph.n_nodes, list(graph.edges)),
                            config=EngineConfig(device="cpu"))
        assert eng.query(q).pairs == fresh.query(q).pairs == tconj.evaluate(
            graph, T_ABC, "S", device="cpu")


# ---------------------------------------------------------------------- #
# the serving loop
# ---------------------------------------------------------------------- #


def test_conjunctive_through_both_servers():
    from repro.serve import CFPQServer as JServer
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import CFPQServer, ServeConfig

    (jg, tg), _ = CASES["chain"]

    async def main(server, cfg, engine, query_cls, grammar):
        async with server(engine, cfg(max_batch=8, batch_window_s=0.005)) as srv:
            outs = await asyncio.wait_for(asyncio.gather(*[
                srv.submit(query_cls(grammar, "S", sources=(i,), semantics="conjunctive"))
                for i in range(3)]), 30)
            return [r.pairs for r in outs], srv.stats.planner_routes

    want, jroutes = asyncio.run(main(
        JServer, JServeConfig, JEngine(jg, plans=J_PLANS), JQuery, J_ABC))
    got, routes = asyncio.run(main(
        CFPQServer, ServeConfig, QueryEngine(tg, config=EngineConfig(device="cpu")),
        Query, T_ABC))
    assert got == want
    assert any(k.endswith("+conjunctive") for k in routes), routes
    assert sorted(routes) == sorted(jroutes)
