"""The port's four CFPQ examples (examples/*_torch.py) run end to end on
the CPU at their smallest sizes: the quickstart's Fig. 9 relation (held
against the reference's on the same Fig. 5 query), the ontology suite
against the port's Hellings, the stream's reads after writes against a
fresh engine, and the async server's answers against a pinned engine."""
from __future__ import annotations

import asyncio
import importlib.util
from pathlib import Path

import pytest

from repro_torch.core.graph import Graph
from repro_torch.engine import EngineConfig, QueryEngine

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pinned(graph: Graph) -> QueryEngine:
    """A fresh dense engine on a copy of ``graph``'s current edges."""
    return QueryEngine(Graph(graph.n_nodes, list(graph.edges)),
                       config=EngineConfig(engine="dense", device="cpu"))


def test_quickstart_prints_fig9(capsys):
    from repro.core.grammar import Grammar as JGrammar
    from repro.core.graph import Graph as JGraph
    from repro.core.semantics import evaluate_relational as j_relational

    ex = _example("quickstart_torch")
    assert ex.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"R_S = {sorted(ex.FIG9)}" in out
    assert "witness 1 -> 2: type_r type" in out and "OK" in out
    g = ex.fig5_graph()
    want = j_relational(JGraph(g.n_nodes, list(g.edges)),
                        JGrammar.from_text(ex.GRAMMAR).to_cnf(), "S")
    assert want == ex.FIG9


def test_ontology_matches_hellings(capsys, monkeypatch):
    ex = _example("cfpq_ontology_torch")
    assert ex.main(["skos", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Q1: #results=    30" in out and "Q2: #results=    29" in out
    # a baseline that disagrees makes the example fail
    monkeypatch.setattr(ex, "hellings_cfpq", lambda graph, g: {"S": {(0, 0)}})
    assert ex.main(["skos", "--device", "cpu"]) == 1


def test_stream_reads_after_writes_equal_a_fresh_engine(capsys):
    ex = _example("stream_cfpq_torch")
    args = ex.parse_args(["--classes", "12", "--instances", "20", "--ops", "10",
                          "--batch", "4", "--write-frac", "0.4", "--seed", "3",
                          "--device", "cpu"])
    seen = []

    def on_read(eng, results):
        fresh = _pinned(eng.graph).query_batch([r.query for r in results])
        for r, f in zip(results, fresh):
            assert r.pairs == f.pairs, r.query
        seen.append(eng.graph.version)

    eng = ex.run_stream(args, on_read=on_read)
    assert eng.delta_stats.rows_repaired + eng.delta_stats.rows_evicted > 0
    assert seen and max(seen) > 0  # some read followed a write
    assert "[stream-cfpq] repair totals" in capsys.readouterr().out


def test_async_server_answers_equal_a_pinned_engine(capsys):
    ex = _example("serve_cfpq_torch")
    args = ex.parse_args(["--async", "--classes", "12", "--instances", "20",
                          "--requests", "12", "--batch", "4", "--qps", "400",
                          "--device", "cpu"])
    graph, workload = ex.make_workload(args)
    run = asyncio.run(asyncio.wait_for(ex.run_async(args, graph, workload), 30))
    assert len(run.results) + run.shed == len(workload) and run.results
    want = _pinned(graph).query_batch([r.query for r in run.results])
    for r, w in zip(run.results, want):
        assert r.pairs == w.pairs, r.query
        if r.query.semantics == "single_path":
            assert set(r.paths) == r.pairs
    assert "served /" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart_torch", "cfpq_ontology_torch",
                                  "stream_cfpq_torch", "serve_cfpq_torch"])
def test_examples_default_to_the_card(name):
    assert _example(name).parse_args([]).device == "cuda"
