"""Engine construction knobs as one typed config (the public API).

``QueryEngine(graph, config=EngineConfig(...))``.  ``engine="auto"`` — the
default — routes every closure call through the cost-based planner
(``repro_torch.engine.planner``); naming a backend string pins it (a
pinned engine never falls back and always uses the capacity ladder).
``device`` replaces the reference's ``mesh``: the engine keeps its states
and runs its closures there.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

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
        call.  ``"dense"`` / ``"frontier"`` / ``"bitpacked"`` /
        ``"blocksparse"`` pins it.
    ``device``
        Where states live and closures run: ``"cuda"`` (default; raises on
        a machine without a card) or ``"cpu"``.
    ``row_capacity``
        Floor of the masked-closure capacity bucket ladder.  For the
        ``blocksparse`` backend the same ladder counts occupied *blocks*.
    ``tile``
        Bit-tile edge of the ``blocksparse`` backend (must be a multiple
        of 32 that divides the padded matrix size; 32/64/128 always do).
        Ignored by the dense-state backends.
    ``profile``
        Planner cost profile: a :class:`PlannerProfile`, a path to a JSON
        profile, or ``None`` for the defaults (the ``REPRO_PLANNER_PROFILE``
        environment variable, if set, names the file to load).
    """

    engine: str = "auto"
    device: str = "cuda"
    row_capacity: int = 128
    tile: int = 128
    profile: PlannerProfile | str | Path | None = None

    def __post_init__(self) -> None:
        if self.engine not in ENGINE_CHOICES:
            raise ValueError(
                f"unknown engine {self.engine!r}; pick one of "
                f"{sorted(ENGINE_CHOICES)}"
            )
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
