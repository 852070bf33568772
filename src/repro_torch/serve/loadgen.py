"""Open-loop load generation against a :class:`CFPQServer`.

A copy of ``repro.serve.loadgen`` over the port's engine: a Poisson
arrival process submits a fixed workload at an *offered* rate — arrivals
don't wait for completions, which is what exposes queueing, coalescing,
and shedding — and the run report splits every latency into queue delay
vs batch execution and attributes each batch's execution time once
(``busy_s``), not per member.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.engine import Query, QueryEngine

from .config import Overloaded, ServeConfig, ServeStats
from .server import CFPQServer


@dataclass
class OpenLoopRun:
    """Results + server counters of one open-loop drive."""

    results: list
    shed: int
    wall_s: float
    stats: ServeStats

    @property
    def e2e_s(self) -> list[float]:
        """Per-request end-to-end latency: window wait + lock wait + exec."""
        return [
            r.stats["queue_delay_s"] + r.stats["batch_exec_s"]
            for r in self.results
        ]

    @property
    def queue_delay_s(self) -> list[float]:
        return [r.stats["queue_delay_s"] for r in self.results]

    @property
    def batch_exec_s(self) -> list[float]:
        return [r.stats["batch_exec_s"] for r in self.results]

    @property
    def busy_s(self) -> float:
        """Total engine execution time: each batch's exec attributed once
        (every member carries the batch figure, so divide it back out)."""
        return sum(
            r.stats["batch_exec_s"] / r.stats["window_batch"]
            for r in self.results
        )

    @property
    def throughput_qps(self) -> float:
        return len(self.results) / self.wall_s


def poisson_arrivals(
    n: int, qps: float, rng: np.random.Generator
) -> np.ndarray:
    """Cumulative arrival offsets of an open-loop Poisson process."""
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


async def drive_open_loop(
    engine: QueryEngine,
    workload: list[Query],
    arrivals: np.ndarray,
    cfg: ServeConfig,
    tracer=None,
    metrics=None,
) -> OpenLoopRun:
    """Submit ``workload[i]`` at offset ``arrivals[i]`` through a fresh
    server over ``engine``; shed (``Overloaded``) requests are counted,
    not retried.  Returns after every admitted request resolves.
    ``tracer``/``metrics`` thread observability (repro_torch.obs) through the
    server — ``bench_serving.py --trace-out`` rides on this."""
    results: list = []
    shed = 0

    t0 = time.perf_counter()
    async with CFPQServer(engine, cfg, tracer=tracer, metrics=metrics) as srv:

        async def one(q: Query, at: float) -> None:
            nonlocal shed
            await asyncio.sleep(at)
            try:
                results.append(await srv.submit(q))
            except Overloaded:
                shed += 1

        await asyncio.gather(
            *[one(q, float(at)) for q, at in zip(workload, arrivals)]
        )
        stats = srv.stats
    return OpenLoopRun(results, shed, time.perf_counter() - t0, stats)
