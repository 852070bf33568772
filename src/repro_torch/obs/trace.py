"""Explicit-clock tracing: spans, events, and the closure-iteration hook.

:class:`Tracer` records **spans** (named intervals with attributes and a
parent link) and **events** (point annotations inside a span) against an
injectable clock, so every layer of the stack — admission, batch window,
planner decision, closure execution — can show where a request's time
went.  The span tree is exported to Chrome ``trace_event`` JSON by
``repro.obs.chrome`` (open it in Perfetto) and summarized by the metrics
layer (``repro.obs.metrics``).

Design constraints (OBSERVABILITY.md has the operator story):

* **Zero overhead when disabled.**  A disabled tracer creates no span
  objects (``span()``/``start_span`` return the shared :data:`NULL_SPAN`
  and record nothing), and the engine compiles *uninstrumented*
  executables — the exact same ``PlanKey`` as before this subsystem
  existed, so the hot path is bit-for-bit the untraced one.  Tests assert
  this contract (tests/test_obs.py).
* **Explicit clock.**  ``clock`` is injectable (fake clocks in tests,
  ``time.perf_counter`` by default); spans never call ``time`` behind the
  caller's back.
* **Cross-thread propagation is explicit.**  The "current span" rides in
  a per-tracer :class:`contextvars.ContextVar` — correct under asyncio
  task interleaving — and :meth:`Tracer.wrap` hands a parent span across
  an executor-thread boundary (the serving loop runs engine work in a
  worker thread).

Closure-iteration events
------------------------
The masked fixpoint loops (core/closure.py) accept an ``iter_hook``
callable, called synchronously from the host loop at every iteration
boundary with ``(iteration, active_rows, changed, overflow)``.  Cached
closure callables bind ONE process-wide trampoline
(:func:`emit_iteration`) rather than any particular tracer, so
instrumented plans stay cacheable; the engine routes the trampoline to a
per-closure-run sink with :func:`iteration_scope`.  When the hook is
``None`` (uninstrumented plans) the loop calls nothing.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Span:
    """One named interval in the trace (see OBSERVABILITY.md taxonomy)."""

    name: str
    span_id: int
    parent_id: int | None
    t_start: float
    cat: str = ""
    tid: int = 0  # thread the span was opened on (Chrome track)
    t_end: float | None = None
    attrs: dict = field(default_factory=dict)
    #: point events: ``{"name", "t", "args"}`` dicts, in arrival order
    events: list = field(default_factory=list)

    def set(self, **attrs) -> "Span":
        """Attach/overwrite span attributes."""
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, t: float, **args) -> None:
        self.events.append({"name": name, "t": t, "args": args})

    @property
    def duration_s(self) -> float | None:
        return None if self.t_end is None else self.t_end - self.t_start


class _NullSpan:
    """Inert span returned by a disabled tracer: accepts every call,
    records nothing, and is falsy so callers can gate extra work on it."""

    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = None
    t_start = 0.0
    t_end = None
    events: list = []  # never appended to
    attrs: dict = {}  # never written (set() is a no-op)

    def set(self, **attrs) -> "_NullSpan":
        return self

    def add_event(self, name: str, t: float, **args) -> None:
        pass

    def __bool__(self) -> bool:
        return False


#: the shared inert span of every disabled tracer
NULL_SPAN = _NullSpan()


class Tracer:
    """Span/event recorder with an explicit clock.

    ``enabled=False`` makes every operation a no-op (the zero-overhead
    contract); ``iteration_events`` additionally gates whether the engine
    compiles *instrumented* closure executables that report per-iteration
    progress (see module docstring).  ``max_spans`` bounds memory on long
    serving runs — beyond it new spans are dropped (counted in
    ``dropped``), never partially recorded.
    """

    def __init__(
        self,
        enabled: bool = True,
        clock: Callable[[], float] = time.perf_counter,
        iteration_events: bool = True,
        max_spans: int = 200_000,
    ) -> None:
        self.enabled = enabled
        self.clock = clock
        self.iteration_events = iteration_events
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._current: contextvars.ContextVar[Span | None] = (
            contextvars.ContextVar(f"repro_obs_span_{id(self)}", default=None)
        )

    # ------------------------------------------------------------------ #
    @property
    def wants_iterations(self) -> bool:
        """Should the engine request instrumented closure executables?"""
        return self.enabled and self.iteration_events

    def current(self) -> Span | None:
        """The context's innermost open span (None outside any span)."""
        return self._current.get() if self.enabled else None

    # ------------------------------------------------------------------ #
    def start_span(
        self,
        name: str,
        parent: Span | None = None,
        cat: str = "",
        t_start: float | None = None,
        **attrs,
    ) -> Span:
        """Open a span without making it current (explicit lifecycle: the
        serving loop opens request spans at admission and finishes them at
        future resolution, on different code paths).  ``parent=None``
        links to the context's current span, if any."""
        if not self.enabled:
            return NULL_SPAN  # type: ignore[return-value]
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return NULL_SPAN  # type: ignore[return-value]
        if parent is None:
            parent = self._current.get()
        span = Span(
            name=name,
            span_id=next(self._ids),
            parent_id=(
                parent.span_id if isinstance(parent, Span) else None
            ),
            t_start=self.clock() if t_start is None else t_start,
            cat=cat,
            tid=threading.get_ident(),
            attrs=dict(attrs),
        )
        self.spans.append(span)
        return span

    def finish(self, span, t_end: float | None = None, **attrs) -> None:
        """Close a span (idempotent: a second finish is a no-op so shared
        cleanup paths can't double-close)."""
        if not isinstance(span, Span) or span.t_end is not None:
            return
        span.attrs.update(attrs)
        span.t_end = self.clock() if t_end is None else t_end

    @contextmanager
    def span(
        self,
        name: str,
        parent: Span | None = None,
        cat: str = "",
        t_start: float | None = None,
        **attrs,
    ):
        """Context-managed span that is *current* inside the block: nested
        ``span()`` calls and :meth:`event` attach to it automatically."""
        sp = self.start_span(name, parent=parent, cat=cat, t_start=t_start, **attrs)
        if not isinstance(sp, Span):
            yield sp
            return
        token = self._current.set(sp)
        try:
            yield sp
        finally:
            self._current.reset(token)
            self.finish(sp)

    def event(self, name: str, **args) -> None:
        """Point event on the context's current span (dropped if none)."""
        if not self.enabled:
            return
        sp = self._current.get()
        if sp is not None:
            sp.add_event(name, self.clock(), **args)

    def wrap(self, parent, fn: Callable) -> Callable:
        """Carry ``parent`` across a thread boundary: the returned callable
        installs it as the current span in the *executing* thread's
        context for the duration of ``fn`` (contexts are per-thread, so
        this can't leak into the caller's)."""
        if not self.enabled or not isinstance(parent, Span):
            return fn

        def inner(*a, **k):
            token = self._current.set(parent)
            try:
                return fn(*a, **k)
            finally:
                self._current.reset(token)

        return inner

    # ------------------------------------------------------------------ #
    def iteration_sink(self, span) -> Callable | None:
        """Sink for :func:`iteration_scope` appending ``iteration`` events
        (iteration index, active-row count, changed units, overflow flag)
        to ``span``.  None when iteration events are off or the span is
        inert — callers pass that straight to ``iteration_scope``."""
        if not self.wants_iterations or not isinstance(span, Span):
            return None

        def sink(it, active_rows, changed, overflow) -> None:
            span.add_event(
                "iteration",
                self.clock(),
                iteration=int(it),
                active_rows=int(active_rows),
                changed=int(changed),
                overflow=bool(overflow),
            )

        return sink

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0


#: shared disabled tracer — the default wiring of every engine/server, so
#: constructing them never allocates tracing state.
NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------- #
# Closure-iteration trampoline.
#
# Instrumented closure callables (PlanKey.instrumented) bind
# `emit_iteration` as their iter_hook; at run time it forwards to whatever
# sink the innermost `iteration_scope` installed.  The indirection is what
# lets one cached callable serve every traced closure run (the sink changes
# per run, the bound callable never does).  The engine serializes closure
# runs under its own lock, so a plain module global is race-free; the
# scope still save/restores to stay correct under re-entrancy.
# ---------------------------------------------------------------------- #
_ITER_SINK: Callable | None = None


def emit_iteration(it, active_rows, changed, overflow) -> None:
    """Iteration-boundary callback bound into instrumented closure
    callables (see core/closure.py ``iter_hook``)."""
    sink = _ITER_SINK
    if sink is not None:
        sink(it, active_rows, changed, overflow)


@contextmanager
def iteration_scope(sink: Callable | None):
    """Route :func:`emit_iteration` to ``sink`` for the duration of one
    closure run.  The hook is called synchronously by the closure loop, so
    every event has landed by the time the scope exits."""
    global _ITER_SINK
    prev = _ITER_SINK
    _ITER_SINK = sink
    try:
        yield
    finally:
        _ITER_SINK = prev
