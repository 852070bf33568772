"""Async serving loop in front of :class:`~repro_torch.engine.QueryEngine`
— a copy of ``repro.serve.server`` pointed at the port's engine.

``CFPQServer`` is the piece between the fast masked-closure kernel and
heavy concurrent traffic (ROADMAP "async serving loop"; SERVING.md has the
operator-facing story).  Per awaited ``submit(query)``:

admission
    A bounded count of admitted-but-unresolved queries
    (``ServeConfig.max_queue_depth``).  Beyond it, ``submit`` sheds load by
    raising :class:`~repro_torch.serve.config.Overloaded` synchronously — the
    caller never holds a queue slot it can't get served from.

coalescing
    Admitted queries route to a :class:`~repro_torch.serve.coalesce.BatchWindow`
    keyed ``(grammar, semantics, backend)``.  A window flushes when it
    holds ``max_batch`` queries or ``batch_window_s`` after its first query
    — whichever comes first — into ONE ``QueryEngine.query_batch`` call,
    and the batch results are scattered back to the per-caller futures.

consistency (the writer path)
    All engine work — read batches and ``apply_delta`` writes — runs under
    one FIFO ``asyncio.Lock``, in a single-worker thread pool, against an
    engine that additionally holds its own reentrancy lock; a batch
    therefore executes against exactly one epoch.  Each batch pins the
    epoch lock-free at formation, revalidates it under the lock
    (``EpochClock.holds``; re-pins if an out-of-band writer advanced it)
    and passes it to ``query_batch`` (which validates again — torn reads
    fail loudly as ``StaleSnapshotError`` rather than mixing epochs).  A
    writer first *fences*: every pending window is flushed and those
    batches — plus any already in flight — are awaited to completion, so
    queries admitted before the write are served the pre-write epoch;
    only then does the delta commit, with no batch in flight.

Threads: every engine call runs in the pool's one worker thread, and the
event-loop thread only times and resolves futures.  The engine places
every tensor it makes on ``EngineConfig.device`` (with several cards,
name one: ``"cuda:1"``), so the worker needs no current-device setting
of its own.

Exactly-once: every admitted query's future is resolved exactly once —
with a result, with the batch's error, or with cancellation (its caller
timed out / went away, or ``stop(drain=False)``); ``ServeStats`` counts
``served + failed + cancelled == admitted`` at quiescence, which
tests/test_torch_serve.py asserts under concurrent load.
"""
from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Iterable

from repro_torch.engine import Query, QueryEngine, QueryResult, grammar_key
from repro_torch.obs.export import MetricsEndpoint
from repro_torch.obs.instruments import ServeMetrics
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

from .coalesce import BatchWindow
from .config import FlushReason, Overloaded, ServeConfig, ServeStats


@dataclass
class _Pending:
    """One admitted query waiting in a batch window."""

    query: Query
    future: asyncio.Future
    t_admit: float
    span: object = None  # root "request" span (admission -> resolution)
    qspan: object = None  # "queue.wait" child (admission -> batch start)


@dataclass
class _Route:
    """Per-(grammar, semantics, backend) coalescing state."""

    window: BatchWindow
    gen: int = 0  # flush generation; stale deadline timers no-op
    timer: object | None = None  # asyncio.TimerHandle of the armed deadline
    due: bool = False  # deadline passed while the engine was busy
    span: object | None = None  # open "window" span of the current window


class CFPQServer:
    """Admission-controlled, batch-coalescing async front of one engine."""

    def __init__(
        self,
        engine: QueryEngine,
        config: ServeConfig | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        metrics: MetricsRegistry | None = None,
    ) -> None:
        self.engine = engine
        self.config = config if config is not None else ServeConfig()
        self.stats = ServeStats()
        self._clock = clock
        self._routes: dict[tuple, _Route] = {}
        self._inflight: set[asyncio.Task] = set()
        self._engine_lock = asyncio.Lock()  # FIFO: fence order is honored
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cfpq-serve"
        )
        self._depth = 0
        self._closed = False
        # Observability (repro_torch.obs; OBSERVABILITY.md): per-request spans
        # (request -> queue.wait/window -> engine spans) plus the serving
        # metric families.  The tracer is shared with the engine so
        # planner/closure spans nest under this loop's window spans; the
        # default NULL_TRACER records nothing.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics_registry = metrics if metrics is not None else REGISTRY
        self.metrics = ServeMetrics.on(self.metrics_registry)
        if tracer is not None:
            engine.set_tracer(tracer)
        if metrics is not None:
            engine.set_metrics(metrics)
        self._endpoint: MetricsEndpoint | None = None

    # ------------------------------------------------------------------ #
    # metrics endpoint (optional; ServeConfig.metrics_port)
    # ------------------------------------------------------------------ #
    @property
    def metrics_port(self) -> int | None:
        """Bound port of the running metrics endpoint, if any."""
        return self._endpoint.port if self._endpoint is not None else None

    async def start_metrics_endpoint(self) -> int | None:
        """Start the HTTP exposition listener when configured (idempotent;
        also called by ``async with``).  Returns the bound port."""
        if self.config.metrics_port is None or self._endpoint is not None:
            return self.metrics_port
        self._endpoint = await MetricsEndpoint(
            self.metrics_registry,
            host=self.config.metrics_host,
            port=self.config.metrics_port,
            snapshot_extra=lambda: {"serve_stats": self.stats},
        ).start()
        return self._endpoint.port

    # ------------------------------------------------------------------ #
    # reader path
    # ------------------------------------------------------------------ #
    async def submit(self, query: Query) -> QueryResult:
        """Admit one query and await its result.

        Raises :class:`Overloaded` synchronously when the bounded queue is
        full (load shed: nothing was admitted), ``RuntimeError`` after
        ``stop()``.  Otherwise resolves exactly once with the
        ``QueryResult`` (stats gain ``queue_delay_s`` / ``batch_exec_s`` /
        ``flush_reason`` / ``window_batch``) or the batch's error.
        """
        if self._closed:
            raise RuntimeError("CFPQServer is stopped")
        if self._depth >= self.config.max_queue_depth:
            self.stats.shed += 1
            self.metrics.shed.inc()
            raise Overloaded(self._depth, self.config.max_queue_depth)
        # reject malformed queries at their caller, before admission — a
        # bad query inside a coalesced batch would fail the whole batch
        self.engine.validate_query(query)
        loop = asyncio.get_running_loop()
        item = _Pending(query, loop.create_future(), self._clock())
        key = self._route_key(query)
        self._depth += 1
        self.stats.admitted += 1
        self.metrics.admitted.inc()
        self.metrics.queue_depth.set(self._depth)
        tracer = self.tracer
        item.span = tracer.start_span(
            "request",
            parent=None,
            cat="serve",
            semantics=query.semantics,
            start=query.start,
            sources=len(query.sources) if query.sources is not None else -1,
        )
        item.qspan = tracer.start_span(
            "queue.wait", parent=item.span, cat="serve"
        )
        try:
            route = self._routes.get(key)
            if route is None:
                route = self._routes[key] = _Route(
                    BatchWindow(
                        self.config.max_batch,
                        self.config.batch_window_s,
                        clock=self._clock,
                    )
                )
            first = route.window.empty
            reason = route.window.add(item)
            if first:
                # one span per window generation, opened with its first
                # item and parented to that item's request (later items'
                # requests link via their own queue.wait timing)
                route.span = tracer.start_span(
                    "window", parent=item.span, cat="serve"
                )
            if reason is not None:  # size flush, right now
                self._flush(key, reason)
            elif first:  # arm the deadline for this window generation
                gen = route.gen
                route.timer = loop.call_later(
                    self.config.batch_window_s, self._deadline_fire, key, gen
                )
            return await item.future
        finally:
            self._depth -= 1
            self.metrics.queue_depth.set(self._depth)
            if item.future.cancelled():
                # the caller went away (e.g. wait_for timeout) — if the
                # query is still parked in its window, pull it out so it
                # neither consumes engine work nor haunts the accounting
                self._discard(key, item)
            tracer.finish(item.qspan)
            tracer.finish(
                item.span,
                outcome=(
                    "cancelled"
                    if item.future.cancelled()
                    else "failed"
                    if item.future.exception() is not None
                    else "served"
                ),
            )

    def _discard(self, key: tuple, item: _Pending) -> None:
        """Remove a cancelled caller's query from its window (no-op if the
        window already flushed it — _run_batch skips done futures)."""
        route = self._routes.get(key)
        if route is None or not route.window.discard(item):
            return
        self.stats.cancelled += 1
        self.metrics.observe_outcome("cancelled")
        if route.window.empty:  # disarm the now-empty window's deadline
            route.gen += 1
            route.due = False
            if route.timer is not None:
                route.timer.cancel()
                route.timer = None
            self.tracer.finish(route.span, outcome="cancelled")
            route.span = None

    def _route_key(self, q: Query) -> tuple:
        # the backend is fixed per engine today; it rides in the key so
        # routing stays correct if one server ever fronts several engines
        return (grammar_key(q.grammar), q.semantics, self.engine.engine)

    # ------------------------------------------------------------------ #
    # writer path
    # ------------------------------------------------------------------ #
    async def apply_delta(
        self,
        insert: Iterable[tuple[int, str, int]] = (),
        delete: Iterable[tuple[int, str, int]] = (),
    ):
        """Commit edge edits, fenced against in-flight read batches.

        Every pending window is flushed (``FlushReason.FENCE``) and those
        batches awaited, so queries admitted before this call are served
        against the pre-write epoch; the delta then commits under the
        engine lock with no batch in flight — readers never observe torn
        state.  Returns the delta's ``DeltaStats``.
        """
        if self._closed:
            raise RuntimeError("CFPQServer is stopped")
        t_req = self._clock()
        fence = set(self._flush_all(FlushReason.FENCE)) | set(self._inflight)
        if fence:
            # await the flushed windows AND batches already in flight — a
            # batch whose window flushed just before this call may not have
            # reached the engine lock yet, and its queries were admitted
            # pre-write, so it must complete before the delta commits
            await asyncio.gather(*fence, return_exceptions=True)
        loop = asyncio.get_running_loop()
        try:
            async with self._engine_lock:
                self.stats.writes += 1
                # fence + lock wait = how long this write lagged behind its
                # request; the gauge tracks the freshest write's lag
                self.engine.metrics.delta_epoch_lag.set(
                    self._clock() - t_req
                )
                fn = partial(
                    self.engine.apply_delta, list(insert), list(delete)
                )
                return await loop.run_in_executor(self._pool, fn)
        finally:
            self._kick()  # dispatch windows that came due during the write

    # ------------------------------------------------------------------ #
    # coalescer internals
    # ------------------------------------------------------------------ #
    def _deadline_fire(self, key: tuple, gen: int) -> None:
        route = self._routes.get(key)
        if route is None or route.gen != gen:
            return  # a size/fence/drain flush already took this window
        if self._engine_lock.locked():
            # engine busy: dispatching now would only queue a small batch
            # behind the lock.  Leave the window open — arrivals during
            # the in-flight batch coalesce into it — and dispatch the
            # moment the engine frees up (_kick on batch completion).
            # Work-conserving: these queries wait no longer than they
            # would have in the lock queue, and the batch they join is
            # bigger.  Size flushes are not deferred (the window is full).
            route.due = True
            return
        self._flush(key, FlushReason.DEADLINE)

    def _kick(self) -> None:
        """Dispatch every window whose deadline passed while the engine
        was busy; called after each batch/write completes."""
        for key in list(self._routes):
            route = self._routes.get(key)
            if route is None or route.window.empty:
                continue
            if route.due or route.window.due():
                self._flush(key, FlushReason.DEADLINE)

    def _flush(self, key: tuple, reason: str) -> asyncio.Task | None:
        """Drain one route's window into a batch task (exactly-once: the
        window is emptied atomically and its deadline generation bumped, so
        a racing timer no-ops)."""
        route = self._routes.get(key)
        if route is None:
            return None
        route.gen += 1
        route.due = False
        if route.timer is not None:
            route.timer.cancel()
            route.timer = None
        items = route.window.take()
        wspan, route.span = route.span, None
        if not items:
            self.tracer.finish(wspan, outcome="empty")
            return None
        self.stats.note_flush(reason, len(items))
        self.metrics.observe_flush(reason, len(items))
        # pin the epoch lock-free: engine.snapshot() takes the engine's
        # threading lock, which a running closure holds for its whole
        # duration — blocking here would stall the event loop.  A torn
        # read (writer mid-advance) is benign: holds() fails in
        # _run_batch and the snapshot is re-taken under the lock.
        task = asyncio.get_running_loop().create_task(
            self._run_batch(
                items, reason, self.engine.clock.snapshot(), wspan
            )
        )
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)
        return task

    def _flush_all(self, reason: str) -> list[asyncio.Task]:
        return [
            t
            for t in (self._flush(k, reason) for k in list(self._routes))
            if t is not None
        ]

    async def _run_batch(
        self, items: list[_Pending], reason: str, snap, wspan=None
    ) -> None:
        try:
            await self._run_batch_locked(items, reason, snap, wspan)
        finally:
            self._kick()  # dispatch windows that came due while we ran

    async def _run_batch_locked(
        self, items: list[_Pending], reason: str, snap, wspan=None
    ) -> None:
        queries = [it.query for it in items]
        loop = asyncio.get_running_loop()
        tracer = self.tracer
        async with self._engine_lock:
            # under the lock no writer can interleave: the snapshot pins
            # the one epoch this whole batch reads, and query_batch
            # revalidates it (StaleSnapshotError == a consistency bug).
            # The snapshot was read lock-free at batch formation; if it no
            # longer holds — a torn formation read, or an out-of-band
            # writer (engine.apply_delta called directly, bypassing the
            # server fence) advanced the epoch while the batch waited —
            # re-take it here, where the worker is idle and the engine
            # lock is uncontended: submit() pins no particular epoch, so
            # serving the current one is correct.
            if not self.engine.clock.holds(snap):
                snap = self.engine.snapshot()
            t0 = self._clock()
            # batch execution starts now: the per-request queue.wait spans
            # end here, the engine work nests under the window span (wrap
            # carries it into the worker thread's context)
            for it in items:
                tracer.finish(it.qspan)
            try:
                results = await loop.run_in_executor(
                    self._pool,
                    tracer.wrap(
                        wspan,
                        partial(
                            self.engine.query_batch,
                            queries,
                            snapshot=snap,
                            stats_extra={
                                "flush_reason": reason,
                                "window_batch": len(items),
                            },
                        ),
                    ),
                )
            except BaseException as exc:  # noqa: BLE001 — forwarded, not hidden
                self.stats.failed += len(items)
                self.metrics.observe_outcome("failed", len(items))
                tracer.finish(
                    wspan, reason=reason, batch=len(items), outcome="failed"
                )
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(exc)
                return
            t1 = self._clock()
        self.stats.served += len(items)
        self.metrics.observe_outcome("served", len(items))
        self.metrics.batch_exec.observe(t1 - t0)
        if results:
            # one window == one (grammar, semantics) route == one closure
            # group, so the whole batch shares one planner decision; tally
            # it once (None on a pure cache hit — nothing was planned)
            self.stats.note_decision(
                results[0].stats.planner, results[0].stats.fallback
            )
            planner = results[0].stats.planner
            if planner is not None:
                self.metrics.observe_decision(
                    planner.get("label", "?"),
                    results[0].stats.fallback is not None,
                )
        with tracer.span("scatter", parent=wspan, cat="serve") as ssp:
            for it, r in zip(items, results):
                r.stats["queue_delay_s"] = t0 - it.t_admit
                r.stats["batch_exec_s"] = t1 - t0
                self.metrics.queue_delay.observe(t0 - it.t_admit)
                if not it.future.done():  # caller may have gone away (cancel)
                    it.future.set_result(r)
            ssp.set(batch=len(items))
        tracer.finish(
            wspan, reason=reason, batch=len(items), outcome="served"
        )

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    async def drain(self) -> None:
        """Flush every pending window and await all in-flight batches.

        Only unfinished tasks are awaited.  A finished batch stays in
        ``_inflight`` until its done-callback runs, and on Python 3.12
        ``gather`` of finished tasks completes without yielding to the
        loop, so awaiting it again would spin forever (the reference's
        ``drain`` does, and its tests/test_serving.py hangs)."""
        tasks = self._flush_all(FlushReason.DRAIN)
        pending = {t for t in set(tasks) | self._inflight if not t.done()}
        while pending:
            await asyncio.gather(*pending, return_exceptions=True)
            pending = {t for t in self._inflight if not t.done()}

    async def stop(self, drain: bool = True) -> None:
        """Stop admitting; drain (default) or cancel what's queued."""
        if self._closed:
            return
        self._closed = True
        if drain:
            await self.drain()
        for key in list(self._routes):
            route = self._routes.pop(key)
            if route.timer is not None:
                route.timer.cancel()
            for it in route.window.take():
                if not it.future.done():
                    self.stats.cancelled += 1
                    self.metrics.observe_outcome("cancelled")
                    it.future.cancel()
            self.tracer.finish(route.span, outcome="cancelled")
            route.span = None
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        self._pool.shutdown(wait=True)
        if self._endpoint is not None:
            await self._endpoint.stop()
            self._endpoint = None

    async def __aenter__(self) -> "CFPQServer":
        await self.start_metrics_endpoint()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()
