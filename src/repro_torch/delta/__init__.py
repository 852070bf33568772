"""Delta subsystem of the port: so far only the epoch clock
(:mod:`repro_torch.delta.txn`); row-level repair is not ported yet."""
from .txn import EpochClock, Snapshot, StaleSnapshotError

__all__ = ["EpochClock", "Snapshot", "StaleSnapshotError"]
