"""Epoch-tagged snapshot consistency for the serving layer.

Every committed delta advances the engine's *epoch* (graph versions may
advance by more than one per epoch when a delta batch coalesces several
log entries).  Results carry the epoch they were served under, and a
:class:`Snapshot` pins an epoch: a batch holding a snapshot from before a
delta fails loudly with :class:`StaleSnapshotError` instead of silently
mixing rows from two graph versions.  The engine is single-writer — the
guard exists so callers that cache a snapshot across batches (an async
admission queue, a long-running cursor) get a consistency error rather
than stale pairs.

The async serving loop (repro/serve) is that admission queue: each
coalesced read batch pins the epoch it is about to read
(``engine.snapshot()`` under the engine lock) and ``query_batch``
revalidates it, and its writer path *fences* — flushes and awaits every
in-flight batch before committing a delta — using :meth:`EpochClock.holds`
as the non-raising staleness probe.  Under that protocol
``StaleSnapshotError`` is unreachable; it firing means the fence is broken.
"""
from __future__ import annotations

from dataclasses import dataclass


class StaleSnapshotError(RuntimeError):
    """The graph advanced past the snapshot's epoch."""


@dataclass(frozen=True)
class Snapshot:
    """A pinned (epoch, graph version) pair."""

    epoch: int
    version: int


@dataclass
class EpochClock:
    """Monotone epoch counter tied to the graph version it serves."""

    epoch: int = 0
    version: int = 0

    def advance(self, version: int) -> int:
        """Commit a delta: one epoch per observed version jump."""
        self.epoch += 1
        self.version = version
        return self.epoch

    def snapshot(self) -> Snapshot:
        return Snapshot(self.epoch, self.version)

    def holds(self, snap: Snapshot | None) -> bool:
        """Non-raising form of :meth:`validate`: does ``snap`` still pin
        the current epoch?  ``None`` (no pin) trivially holds.  The serving
        loop's writer fence uses this to probe whether queued batches may
        still be served before paying the executor hop."""
        return snap is None or (
            snap.epoch == self.epoch and snap.version == self.version
        )

    def validate(self, snap: Snapshot | None) -> None:
        if not self.holds(snap):
            raise StaleSnapshotError(
                f"snapshot pinned epoch {snap.epoch} (graph v{snap.version}) "
                f"but the engine is at epoch {self.epoch} "
                f"(graph v{self.version})"
            )
