"""The port's QueryEngine against the reference QueryEngine.

The same scenario — cold, warm and hot single-source queries, a mixed
batch over two grammars, all-pairs — runs through both engines for every
backend the port serves (dense, frontier, bitpacked) and ``auto``.  The
pairs, the miss/warm/hit sequence and the plan-cache counters must match.
After a logged graph edit both engines repair their cached states row by
row; the port's answers and cache statuses must equal the reference
engine's after the same edit (tests/test_torch_delta.py holds the repair
itself bit for bit).  Reference runs are made once per backend, in a
module-scoped fixture.
"""
import pytest
import torch

from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro.obs.trace import Tracer as JTracer
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.obs.trace import Tracer

BACKENDS = ("dense", "frontier", "bitpacked", "auto")
COPIES = 3  # disjoint skos copies: sources in one copy never reach another
#: (label, [(grammar, sources)]) — one batch per step
STEPS = (
    ("cold", [("q1", (0, 5))]),
    ("same copy", [("q1", (3,))]),
    ("other copy", [("q1", (130,))]),
    ("repeat", [("q1", (0,))]),
    ("mixed batch", [("q1", (260,)), ("q2", (1, 2)), ("q1", (131, 140))]),
    ("all pairs", [("q1", None)]),
    ("all pairs again", [("q1", None), ("q2", (1,))]),
)
#: two new edges in the last copy; type_r·type makes (252, 260) an S-pair
EDIT_INSERT = [(252, "type_r", 377), (377, "type", 260)]
EDIT_QUERIES = [("q1", (252, 253)), ("q1", None)]


def _graphs():
    return (
        jgraph.paper_table_graph("skos").repeat(COPIES),
        tgraph.paper_table_graph("skos").repeat(COPIES),
    )


J_GRAMMARS = {"q1": jgrammar.query1_grammar().to_cnf(),
              "q2": jgrammar.query2_grammar().to_cnf()}
T_GRAMMARS = {"q1": tgrammar.query1_grammar().to_cnf(),
              "q2": tgrammar.query2_grammar().to_cnf()}


def _run(engine, query_cls, grammars, steps):
    """Per step: per query ``(pairs, cache, compile_misses, compile_hits,
    batch_groups)``."""
    out = []
    for _, batch in steps:
        res = engine.query_batch(
            [query_cls(grammars[k], "S", sources=s) for k, s in batch]
        )
        out.append([
            (r.pairs, r.stats["cache"], r.stats["compile_misses"],
             r.stats["compile_hits"], r.stats["batch_groups"])
            for r in res
        ])
    return out


@pytest.fixture(scope="module", params=BACKENDS)
def reference(request):
    backend = request.param
    jg, _ = _graphs()
    engine = JEngine(jg, config=JConfig(engine=backend))
    steps = _run(engine, JQuery, J_GRAMMARS, STEPS)
    assert engine.graph.insert_edges(EDIT_INSERT) == 1  # logged: repaired
    after = _run(engine, JQuery, J_GRAMMARS, [("edit", EDIT_QUERIES)])[0]
    return backend, steps, [(r[0], r[1]) for r in after]


@pytest.fixture(scope="module")
def port(reference):
    backend = reference[0]
    _, tg = _graphs()
    engine = QueryEngine(tg, config=EngineConfig(engine=backend, device="cpu"))
    return engine, _run(engine, Query, T_GRAMMARS, STEPS)


def test_pairs_match_reference(reference, port):
    _, want, _ = reference
    _, got = port
    for (label, _), w, g in zip(STEPS, want, got):
        assert [x[0] for x in g] == [x[0] for x in w], label


def test_cache_statuses_match_reference(reference, port):
    _, want, _ = reference
    _, got = port
    assert [[x[1] for x in s] for s in got] == [[x[1] for x in s] for s in want]
    assert {x[1] for s in got for x in s} == {"miss", "warm", "hit"}


def test_plan_cache_counters_match_reference(reference, port):
    _, want, _ = reference
    _, got = port
    assert [[x[2:] for x in s] for s in got] == [[x[2:] for x in s] for s in want]


def test_graph_edit_answers_like_a_fresh_reference_engine(reference, port):
    _, _, want = reference
    engine, _ = port
    epoch = engine.snapshot().epoch
    engine.graph.insert_edges(EDIT_INSERT)
    got = _run(engine, Query, T_GRAMMARS, [("edit", EDIT_QUERIES)])[0]
    assert [(r[0], r[1]) for r in got] == want  # pairs and cache statuses
    assert (252, 260) in got[0][0]
    assert got[0][1] == "hit"  # the edit repaired the cached states
    assert engine.snapshot().epoch == epoch + 1


def test_out_of_band_edit_drops_states():
    jg, tg = _graphs()
    engine = QueryEngine(tg, config=EngineConfig(engine="dense", device="cpu"))
    q = Query(T_GRAMMARS["q1"], "S", sources=(252,))
    before = engine.query(q).pairs
    tg.edges.extend(EDIT_INSERT)  # not through the edge log
    res = engine.query(q)
    jg.insert_edges(EDIT_INSERT)
    want = JEngine(jg, config=JConfig(engine="dense")).query(
        JQuery(J_GRAMMARS["q1"], "S", sources=(252,))
    ).pairs
    assert res.stats["cache"] == "miss"
    assert res.pairs == want and res.pairs != before


def test_iteration_events_match_reference():
    """Instrumented plans report the reference's per-iteration events."""
    jg, tg = _graphs()
    jt, tt = JTracer(), Tracer()
    JEngine(jg, config=JConfig(engine="dense"), tracer=jt).query(
        JQuery(J_GRAMMARS["q1"], "S", sources=(0, 130))
    )
    eng = QueryEngine(tg, config=EngineConfig(engine="dense", device="cpu"), tracer=tt)
    eng.query(Query(T_GRAMMARS["q1"], "S", sources=(0, 130)))
    assert all(k.instrumented for k in eng.plans._exe)

    def events(tracer):
        return [
            {k: int(v) for k, v in ev["args"].items()}
            for s in tracer.spans if s.name == "closure.execute"
            for ev in s.events if ev["name"] == "iteration"
        ]

    assert events(tt) and events(tt) == events(jt)


def test_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tg = _graphs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(tg, config=EngineConfig(engine="bitpacked"))


def test_unknown_engine_rejected():
    with pytest.raises(ValueError, match="unknown engine"):
        EngineConfig(engine="sparse")
