"""The port's cost-based planner and its engine routing against the
reference's (mirrors tests/test_planner.py and the planner tests of
tests/test_blocksparse.py).

Each scenario runs through both packages' engines or planners on the same
graph, grammar and profile: the decisions (as ``to_dict``), the fallback
events and the answers must be equal.  ``auto`` must answer as every
pinned backend of the port does, blocksparse included.  Reference runs are
made once per scenario, through the module-scoped ``reference`` fixture.
"""
from __future__ import annotations

import pytest

from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.core.blocksparse import DEFAULT_TILE as J_DEFAULT_TILE
from repro.engine import EngineConfig as JConfig
from repro.engine import PlanFeatures as JFeatures
from repro.engine import Planner as JPlanner
from repro.engine import PlannerProfile as JProfile
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.core.blocksparse import DEFAULT_TILE
from repro_torch.core.semantics import evaluate_relational
from repro_torch.engine import (
    EngineConfig,
    PlanFeatures,
    Planner,
    PlannerProfile,
    Query,
    QueryEngine,
)
from repro_torch.engine.plan import MASKED_ENGINES

ENGINES = sorted(MASKED_ENGINES)
J_G = jgrammar.query1_grammar().to_cnf()
T_G = tgrammar.query1_grammar().to_cnf()


def _ontology(pkg):
    return pkg.ontology_graph(40, 99, seed=2)


def _port_engine(graph=None, **config):
    return QueryEngine(graph or _ontology(tgraph),
                       config=EngineConfig(device="cpu", **config))


@pytest.fixture(scope="module")
def reference():
    """Memoized reference results, keyed by scenario."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


def _summary(r):
    """What the two engines must agree on for one served query."""
    d = r.stats.planner
    return (r.pairs, r.stats["cache"], r.stats["engine"],
            None if d is None else dict(d), r.stats.fallback)


# --------------------------------------------------------------------- #
# differential: auto == every pinned backend == the reference
# --------------------------------------------------------------------- #
def test_engine_choices_match_reference():
    from repro.engine.plan import MASKED_ENGINES as J_MASKED

    assert set(ENGINES) == set(J_MASKED)
    assert DEFAULT_TILE == J_DEFAULT_TILE


@pytest.mark.parametrize("pinned", ENGINES)
def test_auto_matches_pinned_relational(pinned, reference):
    """Masked and all-pairs relational results under auto equal every
    pinned backend's, on the paper example and an ontology graph; each
    pinned run equals the reference engine pinned to the same backend."""
    for name, graph_fn in (
        ("paper", lambda m: m.paper_example_graph()),
        ("ontology", _ontology),
    ):
        nn = graph_fn(tgraph).n_nodes
        sources_list = [(0,), tuple({1 % nn, 2 % nn}), None]

        def run_reference():
            eng = JEngine(graph_fn(jgraph), config=JConfig(engine=pinned))
            return [eng.query(JQuery(J_G, "S", sources=s)).pairs
                    for s in sources_list]

        want = reference(("pinned", pinned, name), run_reference)
        auto = _port_engine(graph_fn(tgraph))
        pin = _port_engine(graph_fn(tgraph), engine=pinned)
        for sources, w in zip(sources_list, want):
            qa = auto.query(Query(T_G, "S", sources=sources))
            qp = pin.query(Query(T_G, "S", sources=sources))
            assert qa.pairs == qp.pairs == w, (pinned, name, sources)


def test_decision_recorded_in_stats(reference):
    def run_reference():
        eng = JEngine(_ontology(jgraph))
        return [_summary(eng.query(JQuery(J_G, "S", sources=(0,))))
                for _ in range(2)]

    want = reference("decision", run_reference)
    eng = _port_engine()
    r = eng.query(Query(T_G, "S", sources=(0,)))
    d = r.stats.planner
    assert d is not None and not d["pinned"]
    assert d["engine"] in MASKED_ENGINES
    assert d["mode"] in ("masked", "allpairs")
    assert d["label"].startswith(d["engine"])
    assert d["candidates"]
    assert r.stats["engine"] == d["engine"]
    r2 = eng.query(Query(T_G, "S", sources=(0,)))
    assert r2.stats["cache"] == "hit"
    assert r2.stats.planner is None
    assert r2.stats["engine"] == d["engine"]
    assert [_summary(r), _summary(r2)] == want


def test_pinned_decision_recorded_and_never_falls_back(reference):
    kw = dict(fallback_active_frac=0.0, fallback_max_calls=0)

    def run_reference():
        eng = JEngine(_ontology(jgraph),
                      config=JConfig(engine="dense", profile=JProfile(**kw)))
        r = eng.query(JQuery(J_G, "S", sources=(0, 5, 17)))
        return _summary(r), r.stats["active_rows"], eng.planner.stats.fallbacks

    want = reference("pinned-no-fallback", run_reference)
    eng = _port_engine(engine="dense", profile=PlannerProfile(**kw))
    r = eng.query(Query(T_G, "S", sources=(0, 5, 17)))
    # the reachable set (139 rows) overflows the 128 bucket: observation
    # points occur, but a pinned engine never re-dispatches
    assert r.stats["active_rows"] > 128
    assert r.stats.planner["pinned"]
    assert r.stats.fallback is None
    assert eng.planner.stats.fallbacks == 0
    assert (_summary(r), r.stats["active_rows"], eng.planner.stats.fallbacks) == want


#: dense wins the masked bucket, bitpacked full capacity: the decision has
#: a distinct fallback target (dense work grows with cap², packed with cap)
FALLBACK_COEF = {
    "dense": (1e-3, 0.0),
    "bitpacked": (25e-3, 0.0),
    "frontier": (1.0, 1.0),
}


def test_forced_fallback_redispatches_and_stays_correct(reference):
    """A zero active-row threshold turns the first overflow into a forced
    fallback: the port re-dispatches as the reference does (same event,
    same decision) and the answer stays exact."""
    kw = dict(fallback_active_frac=0.0, reach_factor=1.0, coef=FALLBACK_COEF)
    sources = (0, 5, 17)

    def run_reference():
        eng = JEngine(_ontology(jgraph), config=JConfig(profile=JProfile(**kw)))
        r = eng.query(JQuery(J_G, "S", sources=sources))
        return _summary(r), eng.planner.stats.fallbacks

    want = reference("forced-fallback", run_reference)
    graph = _ontology(tgraph)
    eng = _port_engine(graph, profile=PlannerProfile(**kw))
    r = eng.query(Query(T_G, "S", sources=sources))
    fb = r.stats.fallback
    assert fb is not None, "the overflow point must have forced the fallback"
    assert fb["trigger"] == "active_rows"
    assert fb["to"] == r.stats.planner["fallback_engine"]
    assert fb["to"] != r.stats.planner["engine"]
    assert r.stats["engine"] == fb["to"]
    assert eng.planner.stats.fallbacks == 1
    full = evaluate_relational(graph, T_G, "S", device="cpu")
    assert r.pairs == {(i, j) for (i, j) in full if i in sources}
    assert (_summary(r), eng.planner.stats.fallbacks) == want


# --------------------------------------------------------------------- #
# profile persistence
# --------------------------------------------------------------------- #
def test_profile_round_trip_same_decisions(tmp_path):
    """A profile saved and reloaded decides as before, and as the
    reference's planner with the same coefficients decides."""
    kw = dict(host="test-host", fitted=True, reach_factor=8.0,
              coef={"dense": (3e-4, 2e-3), "bitpacked": (1e-3, 1e-3)})
    profile = PlannerProfile(**kw)
    reloaded = PlannerProfile.load(profile.save(tmp_path / "profile.json"))
    assert reloaded == profile
    a, b, j = Planner(profile), Planner(reloaded), JPlanner(JProfile(**kw))
    for n in (256, 1024):
        for r in (1, 64, 256):
            for sem in ("relational", "single_path"):
                f = dict(n=n, seed_rows=r, new_rows=r, density=2.0, n_prods=2,
                         n_nonterms=2, semantics=sem)
                d = a.decide(PlanFeatures(**f)).to_dict()
                assert d == b.decide(PlanFeatures(**f)).to_dict()
                assert d == j.decide(JFeatures(**f)).to_dict()


# --------------------------------------------------------------------- #
# occupied-block pricing and gating (tests/test_blocksparse.py)
# --------------------------------------------------------------------- #
def _both(features: dict, **decide):
    """The port's and the reference's decision dicts on ``features``."""
    got = Planner().decide(PlanFeatures(**features), **decide)
    want = JPlanner().decide(JFeatures(**features), **decide)
    assert got.to_dict() == want.to_dict()
    return got


def test_planner_picks_blocksparse_at_low_density():
    d = _both(dict(n=4096, seed_rows=16, new_rows=16, density=1.0, n_prods=2,
                   n_nonterms=3, occupied_blocks=40, tile=DEFAULT_TILE))
    assert d.engine == "blocksparse"
    assert "blocksparse:masked" in d.candidates


def test_planner_rejects_blocksparse_when_dense_or_small():
    d = _both(dict(n=4096, seed_rows=16, new_rows=16, density=50.0, n_prods=2,
                   n_nonterms=3, occupied_blocks=1024, tile=DEFAULT_TILE))
    assert d.engine != "blocksparse"
    d = _both(dict(n=256, seed_rows=16, new_rows=16, density=1.0, n_prods=2,
                   n_nonterms=3, occupied_blocks=4, tile=DEFAULT_TILE))
    assert "blocksparse:masked" not in d.candidates


def test_planner_ignores_blocksparse_without_occupancy_feature():
    d = _both(dict(n=4096, seed_rows=16, new_rows=16, density=1.0, n_prods=2,
                   n_nonterms=3))
    assert not any("blocksparse" in k for k in d.candidates)


def test_planner_pin_blocksparse_always_allowed():
    d = _both(dict(n=256, seed_rows=4, new_rows=4, density=9.0, n_prods=2,
                   n_nonterms=3), pin="blocksparse")
    assert d.engine == "blocksparse" and d.pinned
