"""The port's four CFPQ examples (examples/*_torch.py) run end to end on
the CPU at their smallest sizes: the quickstart's Fig. 9 relation (held
against the reference's on the same Fig. 5 query), the ontology suite
against the port's Hellings, the stream's reads after writes against a
fresh engine, and the async server's answers against a pinned engine.
The LM training example's resume claim at 6 steps: killed and run again,
it reproduces the uninterrupted run's losses bit for bit."""
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


class Killed(Exception):
    """The simulated kill of a training run."""


def _train_losses(monkeypatch, argv: list[str], kill_after: int | None = None) -> dict[int, float]:
    """``examples/train_lm_torch.py`` run with ``argv``: each step's loss, by
    step; with ``kill_after`` the run dies after that step (as a killed
    process would, before any later checkpoint)."""
    from repro_torch.train import trainer

    make = getattr(trainer.make_train_step, "original", trainer.make_train_step)
    losses: dict[int, float] = {}

    def recording(*a, **kw):
        step_fn = make(*a, **kw)

        def step(model, state, batch):
            metrics = step_fn(model, state, batch)
            step_no = int(state["step"]) - 1
            losses[step_no] = float(metrics["loss"])
            if kill_after is not None and step_no == kill_after:
                raise Killed(step_no)
            return metrics

        return step

    recording.original = make
    monkeypatch.setattr(trainer, "make_train_step", recording)
    if kill_after is None:
        assert _example("train_lm_torch").main(argv) == 0
    else:
        with pytest.raises(Killed):
            _example("train_lm_torch").main(argv)
    return losses


def test_train_lm_resumes_and_reproduces_the_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """The example's claim at 6 steps: killed after step 3 (its last
    checkpoint at step 2), then run again with the same ``--ckpt-dir``, it
    resumes and every loss equals the uninterrupted run's bit for bit."""
    small = ["--steps", "6", "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
             "--device", "cpu"]
    whole = _train_losses(monkeypatch, small + ["--ckpt-dir", str(tmp_path / "whole")])
    assert sorted(whole) == list(range(6))
    first = _train_losses(monkeypatch, small + ["--ckpt-dir", str(tmp_path / "cut")], kill_after=3)
    rest = _train_losses(monkeypatch, small + ["--ckpt-dir", str(tmp_path / "cut")])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert sorted(first) == [0, 1, 2, 3] and sorted(rest) == [2, 3, 4, 5]
    assert {**first, **rest} == whole and {k: first[k] for k in (2, 3)} == {k: rest[k] for k in (2, 3)}


def test_train_lm_example_defaults_to_the_card():
    mod = _example("train_lm_torch")
    assert mod.DEFAULTS[mod.DEFAULTS.index("--device") + 1] == "cuda"
    assert mod.DEFAULTS[mod.DEFAULTS.index("--steps") + 1] == "300"
