"""Engine construction knobs as one typed config (the public API).

``QueryEngine(graph, config=EngineConfig(...))``.  ``engine="auto"`` — the
default — routes every closure call through the cost-based planner
(``repro_torch.engine.planner``); naming a backend string pins it (a
pinned engine never falls back and always uses the capacity ladder).
``device`` says where the engine keeps its states and runs its closures;
``mesh``, as in the reference, shards the ``opt`` closures over a
``torch.distributed`` device mesh of that device type.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

from repro_torch.shard.plans import check_mesh

from .plan import MASKED_ENGINES
from .planner import PlannerProfile

#: engine names accepted by :class:`EngineConfig` — the planner plus
#: every pinnable backend.
ENGINE_CHOICES = tuple(sorted(MASKED_ENGINES)) + ("auto",)


@dataclass(frozen=True)
class EngineConfig:
    """Knobs of one :class:`~repro_torch.engine.QueryEngine`.

    ``engine``
        ``"auto"`` (default): the planner picks the cheapest closure per
        call.  ``"dense"`` / ``"frontier"`` / ``"bitpacked"`` / ``"opt"``
        / ``"blocksparse"`` pins it.
    ``device``
        Where states live and closures run: ``"cuda"`` (default; raises on
        a machine without a card) or ``"cpu"``.  With a ``mesh``, each
        rank's device is its current one (``cuda:<local rank>``).
    ``mesh``
        A ``torch.distributed`` ``DeviceMesh`` with axes ``data`` and
        ``model`` (and an optional leading ``pod``) for sharded
        execution.  Requires ``engine`` to be ``"opt"`` (the only sharded
        backend) or ``"auto"`` (the planner may choose the sharded closure
        when the mesh has more than one rank), a live process group, and
        the mesh's device type equal to ``device``'s: ``cuda`` runs NCCL,
        ``cpu`` gloo.  Every rank builds its engine and makes the same
        calls in the same order (SPMD).  The first query of a grammar
        checks that every rank numbers it the same way (``to_cnf`` walks
        sets, so two processes with other hash seeds may not) and raises
        on every rank if not.
    ``row_capacity``
        Floor of the masked-closure capacity bucket ladder.  For the
        ``blocksparse`` backend the same ladder counts occupied *blocks*.
    ``tile``
        Bit-tile edge of the ``blocksparse`` backend (must be a multiple
        of 32 that divides the padded matrix size; 32/64/128 always do).
        Ignored by the dense-state backends.
    ``profile``
        Planner cost profile: a :class:`PlannerProfile`, a path to a JSON
        profile, or ``None`` for the defaults (the port's own
        ``REPRO_TORCH_PLANNER_PROFILE`` environment variable, if set, names
        the file to load; the reference's ``REPRO_PLANNER_PROFILE`` is not
        read).
    """

    engine: str = "auto"
    device: str = "cuda"
    mesh: Any = None
    row_capacity: int = 128
    tile: int = 128
    profile: PlannerProfile | str | Path | None = None

    def __post_init__(self) -> None:
        if self.engine not in ENGINE_CHOICES:
            raise ValueError(
                f"unknown engine {self.engine!r}; pick one of "
                f"{sorted(ENGINE_CHOICES)}"
            )
        if self.mesh is not None:
            if self.engine not in ("opt", "auto"):
                raise ValueError(
                    "mesh sharding is only supported by the 'opt' engine (or "
                    f"engine='auto'), not {self.engine!r}"
                )
            check_mesh(self.mesh, self.device)
        if self.row_capacity < 1:
            raise ValueError("row_capacity must be >= 1")
        if self.tile < 32 or self.tile % 32:
            raise ValueError("tile must be a multiple of 32 (>= 32)")

    def resolved_profile(self) -> PlannerProfile:
        if isinstance(self.profile, PlannerProfile):
            return self.profile
        if self.profile is not None:
            return PlannerProfile.load(self.profile)
        return PlannerProfile.default()
