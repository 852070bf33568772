"""Standard instrument bundle for the query engine.

The stack's metric *names and labels* are the public interface
(OBSERVABILITY.md lists them all); this module pins them in one place so
``engine/service.py`` stays free of exposition details.  The bundle
registers its families on a registry once and caches labeled children up
front, so hot-path calls (``observe_cache``) are attribute bumps with no
dict construction.

This is the port's slice of the reference's bundles: the plan-cache,
closure and delta families.  The serving, count and block-sparse families
(and ``delta_epoch_lag``, fed by the serving loop) come with the slices
that feed them.

Bundles are memoized per registry (:meth:`EngineMetrics.on`): every
engine that asks for "the engine metrics of this registry" gets the same
families instead of a double-registration error.
"""
from __future__ import annotations

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY

# iteration counts per closure call: warm restarts double capacity, so
# calls are short; the tail bucket catches pathological grammars
ITER_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _Bundle:
    """Per-registry memoized family bundle."""

    _slot: str = ""  # subclass-specific cache attribute on the registry

    @classmethod
    def on(cls, registry: MetricsRegistry | None = None):
        registry = REGISTRY if registry is None else registry
        cached = getattr(registry, cls._slot, None)
        if cached is None:
            cached = cls(registry)
            setattr(registry, cls._slot, cached)
        return cached


class EngineMetrics(_Bundle):
    """Engine-side families: plan cache, closure calls and delta repair."""

    _slot = "_repro_engine_bundle"

    def __init__(self, registry: MetricsRegistry) -> None:
        self.cache_lookups = Counter(
            "plan_cache_lookups_total",
            "Compiled-closure cache lookups by result (hit|miss)",
            labelnames=("state",), registry=registry,
        )
        self.closure_calls = Counter(
            "closure_calls_total",
            "Compiled closure executions by engine backend",
            labelnames=("engine",), registry=registry,
        )
        self.closure_iters = Histogram(
            "closure_fixpoint_calls",
            "Warm-restart ladder length per fixpoint solve",
            buckets=ITER_BUCKETS, registry=registry,
        )
        self.delta_rows_repaired = Counter(
            "delta_rows_repaired_total",
            "Materialized rows repaired in place by delta ingest",
            registry=registry,
        )
        self.delta_rows_evicted = Counter(
            "delta_rows_evicted_total",
            "Materialized rows evicted (frozen-row overflow) by delta ingest",
            registry=registry,
        )
        self.delta_repair_iters = Counter(
            "delta_repair_iters_total",
            "Fixpoint iterations spent in delta repair closures",
            registry=registry,
        )
        self.delta_epoch = Gauge(
            "delta_epoch", "Current graph epoch of the engine",
            registry=registry,
        )
        self._hit = self.cache_lookups.labels(state="hit")
        self._miss = self.cache_lookups.labels(state="miss")

    def observe_cache(self, hit: bool) -> None:
        (self._hit if hit else self._miss).inc()

    def observe_closure(self, engine: str, calls: int) -> None:
        self.closure_calls.labels(engine=engine).inc(calls)
        self.closure_iters.observe(calls)

    def observe_delta(self, stats) -> None:
        """Fold one ``DeltaStats`` into the counters."""
        self.delta_rows_repaired.inc(stats.rows_repaired)
        self.delta_rows_evicted.inc(stats.rows_evicted)
        self.delta_repair_iters.inc(stats.repair_iters)
