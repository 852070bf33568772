"""Process-local metrics: counters, gauges, fixed-bucket histograms.

A :class:`MetricsRegistry` owns named metric families; each family fans
out into labeled children (``family.labels(reason="size")``) that are
created once and cached, so the hot path — ``child.inc()`` /
``child.observe(x)`` — is a dict-free attribute bump with no allocation.
``repro.obs.export`` renders a registry as Prometheus text exposition or
a JSON snapshot; OBSERVABILITY.md lists every metric the stack emits.

Conventions (mirroring Prometheus):

* counters end in ``_total`` or a unit; histograms carry base-unit names
  (``_seconds``) and fixed bucket boundaries chosen at registration;
* labels are a small closed set (flush reason, planner route, cache
  state) — never request-unique values, so cardinality stays bounded;
* one process-wide default :data:`REGISTRY` mirrors the Prometheus
  client idiom, but every constructor takes ``registry=`` so tests and
  benchmarks can isolate their own.

Thread-safety: every child carries its own pre-allocated
``threading.Lock`` and takes it for the read-modify-write increments
(``self.value += x`` is NOT atomic in CPython — it is a load, an add and
a store, and the serve loop feeds the same children from both the event
loop and the engine executor thread, so lock-free increments lose
updates under contention).  The lock is created once at child creation,
so the hot path stays allocation-free; exposition scrapes read without
the lock — a torn multi-field histogram read only mis-times a sample,
never corrupts state.  Child *creation* takes the family lock since it
mutates maps.
"""
from __future__ import annotations

import bisect
import threading
from typing import Iterable

# default histogram boundaries (seconds) for serve-path latencies: 0.5ms
# .. 8s, roughly ×2 per step — fine where batching windows live, coarse
# in the long tail
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0,
)
# small-integer size buckets (batch sizes, iteration counts)
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Child:
    """Base for one labeled series of a family."""

    __slots__ = ("labels", "_lock")

    def __init__(self, labels: dict) -> None:
        self.labels = labels
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels: dict) -> None:
        super().__init__(labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels: dict) -> None:
        super().__init__(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class _HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, labels: dict, bounds: tuple) -> None:
        super().__init__(labels)
        self.bounds = bounds
        # one slot per finite bound plus the +Inf overflow slot
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        slot = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[slot] += 1
            self.sum += value
            self.count += 1

    def cumulative(self) -> list:
        """Per-bucket cumulative counts (Prometheus ``le`` semantics)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class _Family:
    """A named metric family: help text, type, and its labeled children."""

    kind = "untyped"
    _child_cls: type = _Child

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        registry: "MetricsRegistry | None" = None,
        **kwargs,
    ) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()
        self._default: _Child | None = None
        if registry is None:
            registry = REGISTRY
        registry.register(self)
        if not self.labelnames:
            self._default = self._make({})

    def _make(self, labels: dict) -> _Child:
        child = self._child_cls(labels, **self._kwargs)
        self._children[_label_key(labels)] = child
        return child

    def labels(self, **labels):
        """The child for this label combination (created on first use;
        cache the return value on hot paths)."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key) or self._make(labels)
        return child

    @property
    def children(self) -> list:
        return list(self._children.values())

    # unlabeled families proxy the single child's API
    def _only(self):
        if self._default is None:
            raise ValueError(f"{self.name} is labeled; call .labels() first")
        return self._default


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    @property
    def value(self) -> float:
        return self._only().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._only().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    @property
    def value(self) -> float:
        return self._only().value


class Histogram(_Family):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: tuple = LATENCY_BUCKETS_S,
        registry: "MetricsRegistry | None" = None,
    ) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(
            name, help, labelnames, registry=registry, bounds=bounds
        )

    def observe(self, value: float) -> None:
        self._only().observe(value)


class MetricsRegistry:
    """Collection of metric families with stable registration order."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def register(self, family: _Family) -> None:
        with self._lock:
            if family.name in self._families:
                raise ValueError(f"metric {family.name!r} already registered")
            self._families[family.name] = family

    def get(self, name: str) -> _Family | None:
        return self._families.get(name)

    def families(self) -> list:
        return list(self._families.values())

    def collect(self) -> dict:
        """Plain-data view of every family: the substrate for both export
        formats (see repro.obs.export)."""
        out: dict = {}
        for fam in self.families():
            series = []
            for child in fam.children:
                if fam.kind == "histogram":
                    series.append(
                        {
                            "labels": dict(child.labels),
                            "buckets": {
                                str(b): c
                                for b, c in zip(
                                    child.bounds, child.cumulative()
                                )
                            },
                            "sum": child.sum,
                            "count": child.count,
                        }
                    )
                else:
                    series.append(
                        {"labels": dict(child.labels), "value": child.value}
                    )
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "series": series,
            }
        return out


#: process-wide default registry (pass ``registry=`` to isolate)
REGISTRY = MetricsRegistry()
