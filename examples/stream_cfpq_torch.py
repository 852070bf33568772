"""Streaming CFPQ on the PyTorch/CUDA port: a live graph under writes and reads.

    PYTHONPATH=src python3 examples/stream_cfpq_torch.py --ops 60 --write-frac 0.3
    PYTHONPATH=src python3 examples/stream_cfpq_torch.py --device cpu

The port's counterpart of examples/stream_cfpq.py.  A stream of operations
over one ontology graph, where each op is either

  * a WRITE — a small batch of edge inserts (occasionally deletes) applied
    through ``QueryEngine.apply_delta``, which repairs the materialized
    closures row-wise (on the bitpacked route through the ``bitmm_or``
    kernel) instead of dropping them; or
  * a READ  — a coalesced batch of single-source queries over the paper's
    Query 1 / Query 2 grammars (Zipf-ish hot sources), a ``--path-frac``
    slice of which asks for single-path semantics — the cached length
    states ride through writes via min-plus row repair exactly like the
    Boolean states do.

Prints read-latency percentiles split by cache state, write (repair)
latencies, and the cumulative repair counters.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core.grammar import query1_grammar, query2_grammar
from repro_torch.core.graph import ontology_graph
from repro_torch.engine import EngineConfig, Query, QueryEngine


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", type=int, default=120)
    ap.add_argument("--instances", type=int, default=280)
    ap.add_argument("--ops", type=int, default=60)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--write-frac", type=float, default=0.3)
    ap.add_argument("--delete-frac", type=float, default=0.2,
                    help="fraction of writes that delete instead of insert")
    ap.add_argument("--path-frac", type=float, default=0.25,
                    help="fraction of reads served with single-path "
                         "semantics (witness paths)")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where states live and closures run: cuda "
                         "(default) or cpu")
    return ap.parse_args(argv)


def run_stream(args: argparse.Namespace, on_read=None) -> QueryEngine:
    """Drive the interleaved stream and print its report; returns the
    engine.  ``on_read(engine, results)`` is called after every read
    batch (the tests hold each against a fresh engine)."""
    graph = ontology_graph(args.classes, args.instances, seed=args.seed)
    grammars = [query1_grammar().to_cnf(), query2_grammar().to_cnf()]
    labels = sorted({x for _, x, _ in graph.edges})
    rng = np.random.default_rng(args.seed)
    hot = rng.integers(0, graph.n_nodes, size=8)

    eng = QueryEngine(
        graph, config=EngineConfig(engine=args.engine, device=args.device)
    )
    read_lat: dict[tuple[str, str], list[float]] = {}
    write_lat: list[float] = []
    n_pairs = n_reads = n_writes = n_witnesses = 0

    t0 = time.perf_counter()
    for _ in range(args.ops):
        if rng.random() < args.write_frac:
            n_writes += 1
            tw = time.perf_counter()
            if graph.edges and rng.random() < args.delete_frac:
                victim = graph.edges[int(rng.integers(0, graph.n_edges))]
                eng.apply_delta(delete=[victim])
            else:
                edits = [
                    (
                        int(rng.integers(0, graph.n_nodes)),
                        labels[int(rng.integers(0, len(labels)))],
                        int(rng.integers(0, graph.n_nodes)),
                    )
                    for _ in range(int(rng.integers(1, 4)))
                ]
                eng.apply_delta(insert=edits)
            write_lat.append(time.perf_counter() - tw)
        else:
            batch = []
            for _ in range(args.batch):
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
                batch.append(Query(g, "S", sources=(src,), semantics=sem))
            results = eng.query_batch(batch, snapshot=eng.snapshot())
            for r in results:
                key = (r.stats["semantics"], r.stats["cache"])
                read_lat.setdefault(key, []).append(r.stats["latency_s"])
                n_pairs += len(r.pairs)
                if r.paths is not None:
                    n_witnesses += len(r.paths)
                n_reads += 1
            if on_read is not None:
                on_read(eng, results)
    wall = time.perf_counter() - t0

    print(
        f"[stream-cfpq] graph: {graph.n_nodes} nodes / {graph.n_edges} "
        f"edges (v{graph.version}), engine={args.engine}, "
        f"device={args.device}, {n_reads} reads + {n_writes} writes in "
        f"{args.ops} ops"
    )
    for sem in ("relational", "single_path"):
        for status in ("miss", "warm", "hit"):
            ls = read_lat.get((sem, status))
            if not ls:
                continue
            print(
                f"[stream-cfpq] read {sem:11s} {status:4s}: {len(ls):3d}  "
                f"p50={np.median(ls)*1e3:8.2f}ms  "
                f"p95={np.percentile(ls, 95)*1e3:8.2f}ms"
            )
    if write_lat:
        print(
            f"[stream-cfpq] write (repair): {len(write_lat):3d}  "
            f"p50={np.median(write_lat)*1e3:8.2f}ms  "
            f"p95={np.percentile(write_lat, 95)*1e3:8.2f}ms"
        )
    d = eng.delta_stats
    print(
        f"[stream-cfpq] repair totals: {d.rows_repaired} rows repaired, "
        f"{d.rows_evicted} evicted, {d.repair_iters} closure calls; "
        f"epoch {eng.clock.epoch}; {eng.plans.stats.compile_misses} plans "
        f"built; {n_pairs} pairs ({n_witnesses} with witness paths); "
        f"{wall:.2f}s wall"
    )
    return eng


def main(argv: list[str] | None = None) -> int:
    run_stream(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
