"""The port's async serving loop (``repro_torch.serve``) on the CPU.

Mirrors tests/test_serving.py — the batch-window policy with a fake clock,
size and deadline flushes, routes split by semantics, admission shedding,
cancellation, error propagation, the writer fence and a reader/writer
stress run with exactly-once accounting — and the traced-server and
metrics-endpoint tests of tests/test_obs.py, all over the port's engine
(``device="cpu"``).  One differential case drives the same fixed workload
through the port's and the reference's servers under size flushes: pair
sets, paths and flush counts must be equal.

Every event loop runs under ``asyncio.wait_for`` with a bound of at most
30 s, so a hang fails its test instead of stalling the run.
"""
from __future__ import annotations

import asyncio
import json
import threading

import numpy as np
import pytest

from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro.serve import CFPQServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.core.graph import Graph, ontology_graph
from repro_torch.core.grammar import query1_grammar
from repro_torch.core.semantics import evaluate_relational
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.engine.stats import QueryStats
from repro_torch.obs.chrome import to_chrome_trace
from repro_torch.obs.export import render_prometheus, snapshot
from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve import (
    BatchWindow,
    CFPQServer,
    FlushReason,
    Overloaded,
    ServeConfig,
    drive_open_loop,
    poisson_arrivals,
)
from helpers import assert_path_witness

BOUND_S = 30.0  # per event loop; a hang fails the test, not the run


def run(main, bound: float = BOUND_S):
    """``asyncio.run(main())`` under a time bound."""
    return asyncio.run(asyncio.wait_for(main(), timeout=bound))


class FakeClock:
    def __init__(self, now: float = 100.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


# --------------------------------------------------------------------- #
# BatchWindow policy (no asyncio)
# --------------------------------------------------------------------- #
def test_window_deadline_flush_fake_clock():
    clk = FakeClock()
    w = BatchWindow(max_batch=8, window_s=0.010, clock=clk)
    assert w.empty and not w.due() and w.deadline is None
    assert w.add("a") is None  # first item arms the deadline
    assert w.deadline == pytest.approx(clk.now + 0.010)
    clk.advance(0.009)
    assert not w.due()  # one tick short of the deadline
    clk.advance(0.002)
    assert w.due()
    assert w.add("b") is None  # late add doesn't reset the deadline
    assert w.take() == ["a", "b"]
    assert w.empty and w.deadline is None and not w.due()
    w.add("c")  # a fresh window with a fresh deadline
    assert w.deadline == pytest.approx(clk.now + 0.010) and not w.due()


def test_window_size_flush_fake_clock():
    w = BatchWindow(max_batch=3, window_s=10.0, clock=FakeClock())
    assert w.add(1) is None and w.add(2) is None
    assert w.add(3) == FlushReason.SIZE
    assert w.take() == [1, 2, 3]
    assert w.take() == [] and w.empty  # exactly-once


def test_window_discard_fake_clock():
    w = BatchWindow(max_batch=4, window_s=0.01, clock=FakeClock())
    a, b = object(), object()
    w.add(a)
    w.add(b)
    assert w.discard(a) and len(w) == 1
    assert not w.discard(a)
    assert w.discard(b) and w.empty and w.deadline is None


# --------------------------------------------------------------------- #
# server behavior
# --------------------------------------------------------------------- #
def _setup(n_classes=20, n_instances=40, tracer=None, metrics=None, **cfg):
    graph = ontology_graph(n_classes, n_instances, seed=0)
    g = query1_grammar().to_cnf()
    eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
    srv = CFPQServer(eng, ServeConfig(**cfg), tracer=tracer, metrics=metrics)
    return graph, g, eng, srv


def test_size_flush_coalesces_one_batch():
    async def main():
        _, g, _, srv = _setup(max_batch=4, batch_window_s=10.0)
        async with srv:
            rs = await asyncio.gather(
                *[srv.submit(Query(g, "S", sources=(i,))) for i in range(4)]
            )
        assert [r.stats["flush_reason"] for r in rs] == ["size"] * 4
        assert [r.stats["window_batch"] for r in rs] == [4] * 4
        assert srv.stats.batches == 1 and srv.stats.flushes["size"] == 1
        assert srv.stats.served == 4 == srv.stats.admitted

    run(main)


def test_deadline_flush_under_max_batch():
    async def main():
        _, g, _, srv = _setup(max_batch=64, batch_window_s=0.02)
        async with srv:
            rs = await asyncio.gather(
                *[srv.submit(Query(g, "S", sources=(i,))) for i in range(3)]
            )
        assert {r.stats["flush_reason"] for r in rs} == {"deadline"}
        assert {r.stats["window_batch"] for r in rs} == {3}
        assert srv.stats.flushes["deadline"] == 1

    run(main)


def test_routes_split_by_semantics():
    async def main():
        graph, g, _, srv = _setup(max_batch=2, batch_window_s=10.0)
        async with srv:
            rs = await asyncio.gather(
                srv.submit(Query(g, "S", sources=(1,))),
                srv.submit(Query(g, "S", sources=(2,))),
                srv.submit(Query(g, "S", sources=(1,), semantics="single_path")),
                srv.submit(Query(g, "S", sources=(2,), semantics="single_path")),
            )
        assert srv.stats.batches == 2  # two routes, two size flushes
        assert all(r.stats["window_batch"] == 2 for r in rs)
        assert rs[2].paths is not None and rs[0].paths is None
        assert rs[0].pairs == rs[2].pairs
        for (i, j), path in rs[2].paths.items():
            assert_path_witness(graph, g, "S", i, j, path)

    run(main)


def test_admission_sheds_with_overloaded():
    async def main():
        _, g, _, srv = _setup(max_batch=64, batch_window_s=10.0, max_queue_depth=2)
        t1 = asyncio.create_task(srv.submit(Query(g, "S", sources=(1,))))
        t2 = asyncio.create_task(srv.submit(Query(g, "S", sources=(2,))))
        await asyncio.sleep(0.01)  # both admitted, parked in the window
        with pytest.raises(Overloaded) as ei:
            await srv.submit(Query(g, "S", sources=(3,)))
        assert ei.value.depth == 2 and ei.value.limit == 2
        assert srv.stats.shed == 1 and srv.stats.admitted == 2
        await srv.drain()  # drain-flush resolves the parked queries
        r1, r2 = await t1, await t2
        assert r1.stats["flush_reason"] == "drain"
        assert r1.pairs is not None and r2.pairs is not None
        await srv.stop()
        assert srv.stats.served == 2 and srv.stats.failed == 0

    run(main)


def test_stopped_server_rejects_submits():
    async def main():
        _, g, _, srv = _setup()
        await srv.stop()
        with pytest.raises(RuntimeError):
            await srv.submit(Query(g, "S", sources=(1,)))
        with pytest.raises(RuntimeError):
            await srv.apply_delta(insert=[(0, "type", 1)])

    run(main)


def test_stop_without_drain_cancels_parked_queries():
    async def main():
        _, g, _, srv = _setup(max_batch=64, batch_window_s=10.0)
        t = asyncio.create_task(srv.submit(Query(g, "S", sources=(1,))))
        await asyncio.sleep(0.01)  # admitted, parked in the 10 s window
        await srv.stop(drain=False)
        with pytest.raises(asyncio.CancelledError):
            await t
        assert srv.stats.admitted == 1 and srv.stats.cancelled == 1
        assert srv.stats.served == 0 and srv.stats.failed == 0

    run(main)


def test_caller_timeout_discards_parked_query():
    async def main():
        _, g, _, srv = _setup(max_batch=4, batch_window_s=0.5)
        async with srv:
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(srv.submit(Query(g, "S", sources=(1,))), 0.02)
            assert srv.stats.cancelled == 1
            r = await srv.submit(Query(g, "S", sources=(2,)))
            assert r.stats["window_batch"] == 1  # not the ghost's batch
        assert srv.stats.admitted == 2
        assert srv.stats.served == 1 and srv.stats.cancelled == 1

    run(main)


def test_drain_returns_while_a_finished_batch_is_still_listed():
    """Regression: a batch task that has finished but whose done-callback
    (which drops it from ``_inflight``) has not run yet.  On Python 3.12
    ``gather`` of finished tasks does not yield, so a drain that awaits it
    again spins without ever letting the callback run — the hang of the
    reference's tests/test_serving.py.  The loop runs in a thread, so a
    regression fails here instead of hanging the run."""

    async def main():
        _, _, _, srv = _setup()

        async def finished():
            return None

        task = asyncio.get_running_loop().create_task(finished())
        await asyncio.sleep(0)
        assert task.done()
        srv._inflight.add(task)  # listed; its callback has not run
        await srv.drain()
        srv._inflight.discard(task)
        await srv.stop()

    th = threading.Thread(target=lambda: run(main), daemon=True)
    th.start()
    th.join(BOUND_S)
    assert not th.is_alive(), "drain spun on a finished batch"


def test_malformed_query_rejected_at_submit_not_batchmates():
    async def main():
        graph, g, _, srv = _setup(max_batch=4, batch_window_s=0.02)
        async with srv:
            good = asyncio.create_task(srv.submit(Query(g, "S", sources=(1,))))
            await asyncio.sleep(0)  # good query parked in the window
            with pytest.raises(ValueError):
                await srv.submit(Query(g, "S", sources=(graph.n_nodes + 7,)))
            with pytest.raises(ValueError):
                await srv.submit(Query(g, "S", semantics="bogus"))
            with pytest.raises(ValueError, match="does not match"):
                await srv.submit(Query(g, "S", semantics="conjunctive"))
            r = await good  # batchmate unharmed
            assert r.pairs is not None
        assert srv.stats.admitted == 1 and srv.stats.failed == 0

    run(main)


def test_batch_error_propagates_to_every_future():
    async def main():
        _, g, eng, srv = _setup(max_batch=2, batch_window_s=10.0)

        def boom(*a, **k):
            raise RuntimeError("engine exploded")

        eng.query_batch = boom
        async with srv:
            tasks = [
                asyncio.create_task(srv.submit(Query(g, "S", sources=(i,))))
                for i in (1, 2)
            ]
            for t in tasks:
                with pytest.raises(RuntimeError, match="engine exploded"):
                    await t
        assert srv.stats.failed == 2 and srv.stats.served == 0

    run(main)


def test_writer_fence_serves_prewrite_reads_at_old_epoch():
    async def main():
        graph, g, eng, srv = _setup(max_batch=64, batch_window_s=0.5)
        async with srv:
            reads = [
                asyncio.create_task(srv.submit(Query(g, "S", sources=(i,))))
                for i in range(3)
            ]
            await asyncio.sleep(0.01)  # parked in the window (0.5 s deadline)
            epoch_before = eng.clock.epoch
            await srv.apply_delta(insert=[(graph.n_nodes - 1, "type", 0)])
            assert eng.clock.epoch == epoch_before + 1
            rs = await asyncio.gather(*reads)
            # the fence flushed the parked reads BEFORE the commit
            assert {r.stats["flush_reason"] for r in rs} == {"fence"}
            assert {r.stats["epoch"] for r in rs} == {epoch_before}
            r = await srv.submit(Query(g, "S", sources=(1,)))
        assert r.stats["epoch"] == epoch_before + 1
        assert eng.metrics.delta_epoch_lag.value >= 0.0

    run(main)


def test_writer_fence_awaits_already_flushed_batches():
    async def main():
        graph, g, eng, srv = _setup(max_batch=1, batch_window_s=10.0)
        async with srv:
            await srv.submit(Query(g, "S", sources=(1,)))  # warm the state
            epoch_before = eng.clock.epoch
            # max_batch=1: this submit size-flushes at once, creating the
            # batch task; one tick lets submit() run but NOT the task
            t = asyncio.create_task(srv.submit(Query(g, "S", sources=(2,))))
            await asyncio.sleep(0)
            await srv.apply_delta(insert=[(graph.n_nodes - 1, "type", 0)])
            r = await t
            assert r.stats["epoch"] == epoch_before

    run(main)


def test_stress_concurrent_readers_and_writers():
    """Open-loop readers interleave with apply_delta writers; every
    admitted query resolves exactly once, against the graph as it stood at
    the result's epoch (oracle recomputed per epoch)."""

    async def main():
        graph, g, eng, srv = _setup(
            n_classes=10, n_instances=18, max_batch=4, batch_window_s=0.002,
            max_queue_depth=1024,
        )
        rng = np.random.default_rng(7)
        n_nodes = graph.n_nodes
        history = {eng.clock.epoch: frozenset(graph.edges)}
        inserted: list[tuple[int, str, int]] = []

        async def writer():
            for k in range(4):
                await asyncio.sleep(float(rng.uniform(0.002, 0.01)))
                if k >= 2 and inserted and rng.random() < 0.5:
                    await srv.apply_delta(delete=[inserted.pop()])
                else:
                    e = (int(rng.integers(0, n_nodes)), "type",
                         int(rng.integers(0, n_nodes)))
                    if e in history[eng.clock.epoch]:
                        continue
                    inserted.append(e)
                    await srv.apply_delta(insert=[e])
                history[eng.clock.epoch] = frozenset(eng.graph.edges)

        results: list = []

        async def reader(i: int):
            await asyncio.sleep(float(rng.uniform(0, 0.04)))
            sem = "single_path" if i % 3 == 0 else "relational"
            src = int(rng.integers(0, n_nodes))
            results.append(
                await srv.submit(Query(g, "S", sources=(src,), semantics=sem))
            )

        async with srv:
            await asyncio.gather(writer(), *[reader(i) for i in range(24)])
        assert srv.stats.admitted == srv.stats.served == 24
        assert srv.stats.failed == srv.stats.shed == srv.stats.cancelled == 0
        return results, history, g, n_nodes

    results, history, g, n_nodes = run(main)
    assert len(results) == 24
    oracle: dict[int, set] = {}
    for r in results:
        ep = r.stats["epoch"]
        assert ep in history, f"result served at unrecorded epoch {ep}"
        epoch_graph = Graph(n_nodes, sorted(history[ep]))
        if ep not in oracle:
            oracle[ep] = evaluate_relational(epoch_graph, g, "S", device="cpu")
        src = r.query.sources[0]
        assert r.pairs == {(i, j) for (i, j) in oracle[ep] if i == src}
        if r.paths is not None:
            for (i, j), path in r.paths.items():
                assert_path_witness(epoch_graph, g, "S", i, j, path)


def test_stress_accounting_is_exactly_once():
    async def main():
        _, g, _, srv = _setup(max_batch=3, batch_window_s=0.001)
        async with srv:
            tasks = [
                asyncio.create_task(srv.submit(Query(
                    g, "S", sources=(i % 9,),
                    semantics="single_path" if i % 4 == 0 else "relational",
                )))
                for i in range(16)
            ]
            await asyncio.sleep(0.001)
            tasks[5].cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        st = srv.stats
        assert st.admitted == 16 and st.failed == 0 and st.shed == 0
        assert st.served + st.failed + st.cancelled == st.admitted

    run(main)


def test_drive_open_loop_runs_through_the_port():
    graph = ontology_graph(8, 16, seed=0)
    g = query1_grammar().to_cnf()
    eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
    rng = np.random.default_rng(11)
    work = [Query(g, "S", sources=(int(s),)) for s in rng.integers(0, 8, 12)]
    out = run(lambda: drive_open_loop(
        eng, work, poisson_arrivals(12, 400.0, rng), ServeConfig(max_batch=4)
    ))
    assert len(out.results) + out.shed == 12 and out.shed == 0
    assert out.stats.served == 12 and out.busy_s > 0
    assert all(q >= 0 for q in out.queue_delay_s) and out.throughput_qps > 0


# --------------------------------------------------------------------- #
# the port's server against the reference's
# --------------------------------------------------------------------- #
def test_same_workload_as_reference_server():
    """Eight queries (relational and single-path) under size flushes only:
    the two servers give the same pairs, paths and flush counts."""
    jg, tg = jgraph.ontology_graph(8, 16, seed=0), ontology_graph(8, 16, seed=0)
    jgr, tgr = jgrammar.query1_grammar().to_cnf(), query1_grammar().to_cnf()
    sources = [(0,), (3,), (5, 6), (9,)]

    def workload(query_cls, g):
        return [query_cls(g, "S", sources=s, semantics=sem)
                for sem in ("relational", "single_path") for s in sources]

    async def drive(srv, work):
        async with srv:
            rs = await asyncio.gather(*[srv.submit(q) for q in work])
        return [(r.pairs, r.paths, r.stats["flush_reason"]) for r in rs], \
            srv.stats.as_dict()

    cfg = {"max_batch": 4, "batch_window_s": 10.0}
    want, want_stats = run(lambda: drive(
        JServer(JEngine(jg, config=JConfig(engine="dense")), JServeConfig(**cfg)),
        workload(JQuery, jgr),
    ))
    got, got_stats = run(lambda: drive(
        CFPQServer(QueryEngine(tg, config=EngineConfig(engine="dense", device="cpu")),
                   ServeConfig(**cfg)),
        workload(Query, tgr),
    ))
    assert got == want
    assert got_stats["flushes"] == want_stats["flushes"] == {
        "size": 2, "deadline": 0, "fence": 0, "drain": 0
    }
    for k in ("admitted", "served", "batches", "coalesced", "planner_routes"):
        assert got_stats[k] == want_stats[k], k


# --------------------------------------------------------------------- #
# observability of the serving loop (tests/test_obs.py's server tests)
# --------------------------------------------------------------------- #
def _tiny():
    return ontology_graph(8, 16, seed=0), query1_grammar().to_cnf()


def test_render_prometheus_text_format():
    reg = MetricsRegistry()
    Counter("reqs_total", "Requests", registry=reg).inc(7)
    h = Histogram("lat_seconds", "Latency", buckets=(0.5,), registry=reg)
    h.observe(0.2)
    h.observe(2.0)
    text = render_prometheus(reg)
    assert "# TYPE reqs_total counter" in text and "reqs_total 7" in text
    assert 'lat_seconds_bucket{le="0.5"} 1' in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_sum 2.2" in text and text.endswith("\n")


def test_querystats_snapshot_roundtrip_omits_unset_serve_fields():
    plain = QueryStats(latency_s=0.5, cache="miss", engine="dense")
    served = QueryStats(latency_s=0.5, cache="hit", engine="dense",
                        queue_delay_s=0.01, batch_exec_s=0.002,
                        flush_reason="size", window_batch=4)
    snap = json.loads(json.dumps(
        snapshot(MetricsRegistry(), query_stats=[plain, served])
    ))
    row0, row1 = snap["queries"]
    for k in ("queue_delay_s", "batch_exec_s", "flush_reason", "window_batch"):
        assert k not in row0 and k in row1


def test_traced_server_exactly_once_and_span_nesting():
    async def main():
        graph, g = _tiny()
        tr, reg = Tracer(), MetricsRegistry()
        eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
        srv = CFPQServer(eng, ServeConfig(max_batch=4, batch_window_s=0.002),
                         tracer=tr, metrics=reg)
        async with srv:
            qs = [Query(g, "S", sources=(i,)) for i in range(6)]
            results = await asyncio.gather(*[srv.submit(q) for q in qs])
            await srv.apply_delta(insert=[(0, "subClassOf", 3)])
        return tr, reg, srv, results

    tr, reg, srv, results = run(main)
    st = srv.stats
    assert len(results) == 6
    assert st.served + st.failed + st.cancelled == st.admitted == 6
    snap = reg.collect()
    outcomes = {s["labels"]["outcome"]: s["value"]
                for s in snap["serve_outcomes_total"]["series"]}
    assert outcomes["served"] == st.served and outcomes["failed"] == 0
    assert snap["serve_admitted_total"]["series"][0]["value"] == 6
    assert snap["serve_queue_delay_seconds"]["series"][0]["count"] == 6
    assert snap["serve_batch_exec_seconds"]["series"][0]["count"] >= 1
    assert snap["planner_route_total"]["series"]
    assert snap["delta_epoch_lag_seconds"]["series"][0]["value"] >= 0.0
    assert all(s.t_end is not None for s in tr.spans)
    by_id = {s.span_id: s for s in tr.spans}

    def chain(s):
        names = []
        while s.parent_id is not None:
            s = by_id[s.parent_id]
            names.append(s.name)
        return names

    reads = [s for s in tr.spans
             if s.name == "closure.execute" and "delta.repair" not in chain(s)]
    assert reads
    for s in reads:
        assert "window" in chain(s) and "request" in chain(s)
    assert any(s.name == "delta.repair" for s in tr.spans)
    evs = json.loads(json.dumps(to_chrome_trace(tr)))["traceEvents"]
    assert evs[0]["ph"] == "M"
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= {
        "request", "queue.wait", "window", "closure.execute", "scatter"
    }
    assert all(e["dur"] >= 0 for e in xs)
    assert any(e["ph"] == "i" and e["name"] == "iteration" for e in evs)


def test_traced_server_cancelled_accounting():
    async def main():
        graph, g = _tiny()
        tr, reg = Tracer(), MetricsRegistry()
        eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
        srv = CFPQServer(eng, ServeConfig(max_batch=64, batch_window_s=5.0),
                         tracer=tr, metrics=reg)
        task = asyncio.create_task(srv.submit(Query(g, "S", sources=(1,))))
        await asyncio.sleep(0.01)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await srv.stop(drain=False)
        return tr, reg, srv

    tr, reg, srv = run(main)
    st = srv.stats
    assert st.admitted == 1 and st.cancelled == 1
    assert st.served + st.failed + st.cancelled == st.admitted
    outcomes = {s["labels"]["outcome"]: s["value"]
                for s in reg.collect()["serve_outcomes_total"]["series"]}
    assert outcomes["cancelled"] == 1
    req = [s for s in tr.spans if s.name == "request"]
    assert len(req) == 1 and req[0].attrs["outcome"] == "cancelled"
    assert all(s.t_end is not None for s in tr.spans)


def test_metrics_endpoint_serves_both_formats():
    async def main():
        graph, g = _tiny()
        reg = MetricsRegistry()
        eng = QueryEngine(graph, config=EngineConfig(device="cpu"))
        cfg = ServeConfig(max_batch=4, batch_window_s=0.001, metrics_port=0)
        async with CFPQServer(eng, cfg, metrics=reg) as srv:
            port = srv.metrics_port
            assert port  # ephemeral port bound
            await srv.submit(Query(g, "S", sources=(1,)))

            async def get(path):
                r, w = await asyncio.open_connection("127.0.0.1", port)
                w.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
                raw = await r.read()
                w.close()
                head, body = raw.split(b"\r\n\r\n", 1)
                return head.decode(), body

            head, body = await get("/metrics")
            assert "200 OK" in head and b"serve_admitted_total 1" in body
            head, body = await get("/metrics.json")
            js = json.loads(body)
            assert "200 OK" in head and js["serve"]["admitted"] == 1
            assert "serve_queue_delay_seconds" in js["metrics"]
            head, _ = await get("/nope")
            assert "404" in head
        assert srv.metrics_port is None  # listener torn down on stop

    run(main)
