"""Batch-window coalescing policy, separated from asyncio plumbing.

:class:`BatchWindow` buffers compatible queries for one route
(grammar, semantics, backend) and decides *when* the buffer becomes a
batch: on reaching ``max_batch`` (size flush) or ``window_s`` after the
first buffered item (deadline flush) — whichever comes first.  It holds no
timers itself; it exposes the absolute ``deadline`` and a ``due(now)``
predicate against an injectable ``clock``, so the policy is unit-testable
with a fake clock (tests/test_torch_serve.py) while ``CFPQServer`` drives it
with ``loop.call_later`` on the real one.

Invariant: an item added to a window is removed by exactly one ``take()``
— ``take`` atomically empties the buffer and disarms the deadline, so a
size flush racing a deadline timer can never hand the same query to two
batches (the late flusher sees an empty window and no-ops).

Every flushed window becomes ONE ``QueryEngine.query_batch`` call and
therefore ONE planner decision (``repro_torch.engine.planner``): the engine
plans per closure-call group, and a route key fixes (grammar, semantics),
so coalescing is also what amortizes planning — the batch's union source
mask is the seed-row feature the cost model prices.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from .config import FlushReason


class BatchWindow:
    """Size/deadline flush policy over an opaque item buffer."""

    def __init__(
        self,
        max_batch: int,
        window_s: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.max_batch = max_batch
        self.window_s = window_s
        self._clock = clock
        self._items: list[Any] = []
        self._deadline: float | None = None
        self._t_open: float | None = None

    def __len__(self) -> int:
        return len(self._items)

    @property
    def empty(self) -> bool:
        return not self._items

    @property
    def deadline(self) -> float | None:
        """Absolute clock time of the pending deadline flush, if armed."""
        return self._deadline

    @property
    def t_open(self) -> float | None:
        """Clock time the current window opened (its first ``add``), None
        while empty — the coalesce interval start the tracing layer
        backdates window spans to."""
        return self._t_open

    def add(self, item: Any) -> str | None:
        """Buffer one item.  The first item arms the window deadline.
        Returns ``FlushReason.SIZE`` when the buffer just reached
        ``max_batch`` (the caller must flush now), else None."""
        if not self._items:
            self._t_open = self._clock()
            self._deadline = self._t_open + self.window_s
        self._items.append(item)
        if len(self._items) >= self.max_batch:
            return FlushReason.SIZE
        return None

    def due(self, now: float | None = None) -> bool:
        """True when a non-empty window's deadline has passed."""
        if not self._items:
            return False
        if now is None:
            now = self._clock()
        return now >= self._deadline  # type: ignore[operator]

    def discard(self, item: Any) -> bool:
        """Remove one buffered item (by identity); True if it was here.
        The caller disarms its own timer when the window empties."""
        for i, it in enumerate(self._items):
            if it is item:
                del self._items[i]
                if not self._items:
                    self._deadline = None
                    self._t_open = None
                return True
        return False

    def take(self) -> list[Any]:
        """Atomically drain the buffer and disarm the deadline."""
        items, self._items, self._deadline = self._items, [], None
        self._t_open = None
        return items
