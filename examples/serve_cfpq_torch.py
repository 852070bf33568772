"""Batched CFPQ serving on the PyTorch/CUDA port.

    PYTHONPATH=src python3 examples/serve_cfpq_torch.py --requests 48 --batch 8
    PYTHONPATH=src python3 examples/serve_cfpq_torch.py --async --qps 96
    PYTHONPATH=src python3 examples/serve_cfpq_torch.py --async --device cpu

The port's counterpart of examples/serve_cfpq.py.  Builds an ontology
graph, generates a synthetic single-source workload over the paper's Query
1 and Query 2 grammars (Zipf-ish repeated sources, as a real serving mix
would see), and drives it through ``repro_torch``'s QueryEngine: requests
in the same batch are coalesced per (grammar, semantics) into one
masked-closure call, and repeated/overlapping requests are served from the
materialized closure cache.  A ``--path-frac`` slice of the mix asks for
``semantics="single_path"`` (paper Section 5) and gets one witness path
per result pair.  Prints per-request latency percentiles split by cache
state and semantics, plus plan-cache counters.

``--async`` drives the same workload through ``repro_torch.serve``'s
``CFPQServer`` instead of hand-assembled batches: requests arrive as an
open-loop Poisson process at ``--qps``, the server's batch-window
coalescer (``--batch`` / ``--window``) packs whatever arrives together,
the bounded admission queue (``--queue-depth``) sheds the excess as
``Overloaded``, and the report splits end-to-end latency into queue delay
vs batch execution.  ``--trace-out`` / ``--metrics-out`` write the run's
spans (Chrome trace JSON) and metric families through ``repro_torch.obs``.
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import time

import numpy as np

from repro_torch.core.grammar import query1_grammar, query2_grammar
from repro_torch.core.graph import Graph, ontology_graph
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.serve import (
    OpenLoopRun,
    ServeConfig,
    drive_open_loop,
    poisson_arrivals,
)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", type=int, default=120)
    ap.add_argument("--instances", type=int, default=280)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--path-frac", type=float, default=0.25,
                    help="fraction of requests served with single-path "
                         "semantics (witness paths)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive the workload through the repro_torch.serve "
                         "async loop (open-loop arrivals) instead of "
                         "explicit batches")
    ap.add_argument("--qps", type=float, default=96.0,
                    help="offered load of the --async arrival process")
    ap.add_argument("--window", type=float, default=0.005,
                    help="--async batch-window deadline (seconds)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="--async admission bound (queries in flight)")
    ap.add_argument("--trace-out", default=None,
                    help="--async only: write a Chrome trace JSON of the "
                         "run (load in Perfetto)")
    ap.add_argument("--metrics-out", default=None,
                    help="--async only: write a metrics snapshot JSON")
    ap.add_argument("--device", default="cuda",
                    help="where states live and closures run: cuda "
                         "(default) or cpu")
    return ap.parse_args(argv)


def make_workload(args: argparse.Namespace) -> tuple[Graph, list[Query]]:
    """The graph and the request mix: sources drawn from a small hot set
    plus a random tail."""
    graph = ontology_graph(args.classes, args.instances, seed=args.seed)
    grammars = [query1_grammar().to_cnf(), query2_grammar().to_cnf()]
    rng = np.random.default_rng(args.seed)
    hot = rng.integers(0, graph.n_nodes, size=8)
    workload = []
    for _ in range(args.requests):
        g = grammars[int(rng.integers(0, len(grammars)))]
        if rng.random() < 0.5:
            src = int(hot[int(rng.integers(0, len(hot)))])
        else:
            src = int(rng.integers(0, graph.n_nodes))
        sem = (
            "single_path"
            if rng.random() < args.path_frac
            else "relational"
        )
        workload.append(Query(g, "S", sources=(src,), semantics=sem))
    return graph, workload


def _engine(args: argparse.Namespace, graph: Graph) -> QueryEngine:
    return QueryEngine(
        graph, config=EngineConfig(engine=args.engine, device=args.device)
    )


async def run_async(args, graph, workload) -> OpenLoopRun:
    """Open-loop async serving: Poisson arrivals through CFPQServer."""
    eng = _engine(args, graph)
    cfg = ServeConfig(
        max_batch=args.batch,
        batch_window_s=args.window,
        max_queue_depth=args.queue_depth,
    )
    arrivals = poisson_arrivals(
        len(workload), args.qps, np.random.default_rng(args.seed + 1)
    )
    tracer = registry = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
        registry = MetricsRegistry()
    run = await drive_open_loop(
        eng, workload, arrivals, cfg, tracer=tracer, metrics=registry
    )
    if args.trace_out:
        from repro_torch.obs.chrome import write_chrome_trace

        write_chrome_trace(args.trace_out, tracer)
        print(
            f"[serve-cfpq] wrote {len(tracer.spans)} spans to "
            f"{args.trace_out} (open in Perfetto)"
        )
    if args.metrics_out:
        from repro_torch.obs.export import write_metrics_json

        write_metrics_json(
            args.metrics_out, registry=registry, serve_stats=run.stats
        )
        print(f"[serve-cfpq] wrote metrics snapshot to {args.metrics_out}")

    print(
        f"[serve-cfpq] async on {args.device}: offered {args.qps:.0f} qps, "
        f"window {args.window * 1e3:.1f}ms, max_batch {args.batch}, queue "
        f"depth {args.queue_depth}"
    )
    for name, ls in (
        ("end-to-end", run.e2e_s),
        ("queue delay", run.queue_delay_s),
        ("batch exec", run.batch_exec_s),
    ):
        if ls:
            print(
                f"[serve-cfpq] {name:11s}: p50={np.median(ls)*1e3:7.2f}ms  "
                f"p99={np.percentile(ls, 99)*1e3:7.2f}ms"
            )
    print(
        f"[serve-cfpq] {len(run.results)} served / {run.shed} shed; "
        f"{run.stats.batches} batches (mean size {run.stats.mean_batch:.1f}, "
        f"flushes {run.stats.flushes}); "
        f"{run.throughput_qps:.1f} req/s completed"
    )
    return run


def run_sync(args, graph, workload) -> list:
    """Explicit batches of ``--batch`` requests through one engine;
    returns the results in workload order."""
    eng = _engine(args, graph)
    lat: dict[tuple[str, str], list[float]] = {}
    results = []
    n_pairs = n_witnesses = 0
    t0 = time.perf_counter()
    for b in range(0, len(workload), args.batch):
        for r in eng.query_batch(workload[b : b + args.batch]):
            key = (r.stats["semantics"], r.stats["cache"])
            lat.setdefault(key, []).append(r.stats["latency_s"])
            n_pairs += len(r.pairs)
            if r.paths is not None:
                n_witnesses += len(r.paths)
            results.append(r)
    wall = time.perf_counter() - t0

    print(
        f"[serve-cfpq] graph: {graph.n_nodes} nodes / {graph.n_edges} edges, "
        f"engine={args.engine}, device={args.device}, {args.requests} "
        f"requests in batches of {args.batch}"
    )
    for sem in ("relational", "single_path"):
        for status in ("miss", "warm", "hit"):
            ls = lat.get((sem, status))
            if not ls:
                continue
            print(
                f"[serve-cfpq] {sem:11s} {status:4s}: {len(ls):3d} requests  "
                f"p50={np.median(ls)*1e3:8.2f}ms  "
                f"p95={np.percentile(ls, 95)*1e3:8.2f}ms"
            )
    stats = eng.plans.stats
    print(
        f"[serve-cfpq] plans: {stats.compile_misses} built, "
        f"{stats.compile_hits} reused; {n_pairs} result pairs "
        f"({n_witnesses} with witness paths); "
        f"{wall:.2f}s wall ({args.requests / wall:.1f} req/s)"
    )
    return results


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    graph, workload = make_workload(args)
    if args.use_async:
        asyncio.run(run_async(args, graph, workload))
    else:
        run_sync(args, graph, workload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
