"""Cost-based adaptive query planning: pick the cheapest closure executable.

The engine has four backends (dense / frontier / bitpacked / opt) × two
capacity modes (masked ladder vs all-pairs-sized) × two placements (local
vs mesh-sharded), all serving identical results — which one is cheapest
depends on the batch (source count, graph shape, grammar size) and on the
host (MXU vs interpreted-kernel throughput, collective latency).  The
caller used to guess; :class:`Planner` chooses per closure call from a
**measured cost model**, in the spirit of the SSC1→SSC2 alpha/beta
adaptive switch: a static pick up front, plus a mid-closure runtime
fallback when the pick's assumptions are violated.

Cost model
----------
Each candidate executable family has a fitted affine cost

    cost_s ≈ beta + alpha · work_Munits

where ``work`` counts the family's dominant contraction per fixpoint call
(in 1e6-operation units):

* ``dense`` / ``frontier`` masked:  ``|P| · cap² · n``  (MXU bool matmul
  over the compacted active block)
* ``bitpacked`` masked:             ``|P| · cap · n · w``  (uint32 AND/OR
  words, ``w = n/32``)
* ``opt`` (mesh-sharded):           bitpacked work ``/ devices`` (the
  packed exchange rides in beta)
* ``sp_*``:                         the min-plus analogs on the f32 length
  matrix (no packed layout — dense-shaped work)
* ``move``:                         host round-trip of a cached state
  whose placement doesn't match the candidate (``|N| · n²`` elements)

``cap`` is the capacity bucket predicted from the seed rows and the
fitted ``reach_factor`` (how much the active set tends to outgrow its
seed on this workload).  The **all-pairs mode** of a backend is the same
executable at ``cap = n`` — skipping the bucket ladder entirely, which
wins when the seed is expected to reach most of the graph (the paper's
original all-pairs regime).

Coefficients live in a versioned JSON :class:`PlannerProfile`
(``tools/calibrate_planner_torch.py`` fits them per host and device and
persists them).  Uncalibrated hosts get the reference's conservative
CPU-measured defaults, unchanged, so an uncalibrated port routes exactly
as the reference does.

Runtime fallback
----------------
The masked fixpoint reports at every capacity overflow (the executable
returns with ``overflowed=True``).  At that observation point the engine
consults :meth:`Planner.should_fallback`: if the active set outgrew
``fallback_active_frac · n`` or the run burned ``fallback_max_calls``
executable calls, the *remaining* closure is re-dispatched onto the
decision's fallback executable (cheapest all-pairs-mode candidate) via
the ordinary monotone warm restart — no work is lost, and the event is
recorded in ``QueryResult.stats.fallback`` and ``ServeStats``.
"""
from __future__ import annotations

import json
import os
import platform
from dataclasses import dataclass, field
from pathlib import Path

from .plan import bucket_for

PROFILE_VERSION = 1

#: environment override: path of the planner profile to load when the
#: engine config doesn't name one explicitly.  The port's own variable: a
#: profile fitted for the reference package does not steer the port.
PROFILE_ENV = "REPRO_TORCH_PLANNER_PROFILE"

#: default (alpha s/Munit, beta s) per executable family — measured on a
#: CPU host (interpret-mode kernels); a calibrated profile replaces them.
_DEFAULT_COEF: dict[str, tuple[float, float]] = {
    "dense": (2.0e-4, 2.0e-3),
    "frontier": (2.4e-4, 2.5e-3),
    "bitpacked": (1.6e-3, 2.0e-3),
    "opt": (1.6e-3, 8.0e-3),
    # host-driven per-pair tile contraction: high alpha (Python-enumerated
    # pairs + per-chunk dispatch), moderate beta — it wins on *work*, which
    # for this family scales with occupied blocks, not n².
    "blocksparse": (4.0e-3, 4.0e-3),
    "sp_dense": (1.0e-3, 3.0e-3),
    "sp_frontier": (1.2e-3, 3.5e-3),
    "sp_opt": (1.0e-3, 1.0e-2),
    "move": (2.0e-3, 1.0e-3),
}


@dataclass(frozen=True)
class PlannerProfile:
    """Fitted per-host cost coefficients + fallback thresholds (JSON-able).

    ``coef`` maps executable family → ``(alpha, beta)``; ``reach_factor``
    is the observed active-set/seed expansion used to predict the capacity
    bucket; the ``fallback_*`` thresholds arm the mid-closure re-dispatch.
    ``fitted`` distinguishes a calibrated profile from the built-in
    defaults (surfaced in every decision for observability).
    """

    version: int = PROFILE_VERSION
    host: str = ""
    fitted: bool = False
    coef: dict = field(default_factory=lambda: dict(_DEFAULT_COEF))
    reach_factor: float = 16.0
    fallback_active_frac: float = 0.5
    fallback_max_calls: int = 4

    # ------------------------------------------------------------------ #
    @classmethod
    def default(cls) -> "PlannerProfile":
        """Built-in defaults, unless :data:`PROFILE_ENV` names a file."""
        path = os.environ.get(PROFILE_ENV)
        if path:
            return cls.load(path)
        return cls()

    def alpha_beta(self, family: str) -> tuple[float, float]:
        ab = self.coef.get(family)
        if ab is None:
            ab = _DEFAULT_COEF.get(family, (1e-3, 1e-3))
        return float(ab[0]), float(ab[1])

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "host": self.host,
            "fitted": self.fitted,
            "coef": {k: [float(a), float(b)] for k, (a, b) in self.coef.items()},
            "reach_factor": self.reach_factor,
            "fallback_active_frac": self.fallback_active_frac,
            "fallback_max_calls": self.fallback_max_calls,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "PlannerProfile":
        ver = obj.get("version")
        if ver != PROFILE_VERSION:
            raise ValueError(
                f"planner profile version {ver!r} != supported "
                f"{PROFILE_VERSION} (recalibrate with "
                "tools/calibrate_planner_torch.py)"
            )
        return cls(
            version=ver,
            host=obj.get("host", ""),
            fitted=bool(obj.get("fitted", True)),
            coef={k: tuple(v) for k, v in obj.get("coef", {}).items()},
            reach_factor=float(obj.get("reach_factor", 16.0)),
            fallback_active_frac=float(obj.get("fallback_active_frac", 0.5)),
            fallback_max_calls=int(obj.get("fallback_max_calls", 4)),
        )

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "PlannerProfile":
        return cls.from_json(json.loads(Path(path).read_text()))


def host_fingerprint(device: str = "cuda") -> str:
    """Informational host tag stamped into calibrated profiles:
    ``node:device type:device name`` (the card's name on ``cuda``)."""
    import torch

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{platform.node()}:{dev.type}:{name}"


@dataclass(frozen=True)
class PlanFeatures:
    """Everything the planner sees — features the engine already has."""

    n: int  # padded matrix size
    seed_rows: int  # rows the fixpoint starts active (union R + warm mask)
    new_rows: int  # seed rows not already materialized
    density: float  # edges per node
    n_prods: int  # grammar binary productions
    n_nonterms: int
    semantics: str = "relational"
    repair: bool = False
    cache: str = "miss"  # hit | warm | miss (state temperature)
    placement: str = "none"  # none | local | sharded (state placement)
    mesh_devices: int = 0  # 0 = no mesh available
    #: occupied B×B blocks of the base graph (label-blind edge-coordinate
    #: count) and the configured tile edge.  0/0 — features absent — keeps
    #: the blocksparse backend out of the auto candidate set entirely, so
    #: callers that don't measure occupancy (and calibration grids fit on
    #: the dense families) are untouched.
    occupied_blocks: int = 0
    tile: int = 0
    #: flattened conjunct count of a conjunctive grammar — the work
    #: multiplier for ``semantics="conjunctive"`` (each conjunct is one
    #: full contraction per iteration, exactly like a binary production);
    #: 0 for every other semantics so existing features are unchanged.
    conjuncts: int = 0


@dataclass
class PlanDecision:
    """One routing decision: which executable serves this closure call."""

    engine: str  # backend name (PlanKey.engine after aliasing)
    mode: str  # "masked" (predicted bucket) | "allpairs" (cap = n)
    sharded: bool  # mesh-sharded (opt) executable
    row_capacity: int  # starting capacity bucket
    est_cost_s: float
    candidates: dict  # label -> estimated cost_s (all considered)
    fallback_engine: str | None = None  # mid-closure re-dispatch target
    pinned: bool = False  # caller pinned the backend; no fallback
    profile_fitted: bool = False
    semantics: str = "relational"

    @property
    def label(self) -> str:
        tag = f"{self.engine}:{self.mode}"
        if self.sharded:
            tag += "+mesh"
        # only the conjunctive and count routes are labeled:
        # relational/single_path keep their pre-existing labels
        # (dashboards key on them)
        if self.semantics == "conjunctive":
            tag += "+conjunctive"
        elif self.semantics == "count":
            tag += "+count"
        return tag

    def to_dict(self) -> dict:
        return {
            "engine": self.engine,
            "mode": self.mode,
            "sharded": self.sharded,
            "row_capacity": self.row_capacity,
            "est_cost_s": round(self.est_cost_s, 6),
            "candidates": {
                k: round(v, 6) for k, v in sorted(self.candidates.items())
            },
            "fallback_engine": self.fallback_engine,
            "pinned": self.pinned,
            "profile_fitted": self.profile_fitted,
            "semantics": self.semantics,
            "label": self.label,
        }


@dataclass
class PlannerStats:
    """Cumulative routing counters (merged into serving stats)."""

    decisions: dict = field(default_factory=dict)  # label -> count
    fallbacks: int = 0

    def note(self, decision: PlanDecision) -> None:
        self.decisions[decision.label] = (
            self.decisions.get(decision.label, 0) + 1
        )


def _work_munits(
    family: str, n_prods: int, cap: int, n: int, devices: int
) -> float:
    """Dominant per-call contraction work of one executable family, in
    1e6-op units (see module docstring for the per-family formulas)."""
    w = max(n // 32, 1)
    if family == "bitpacked":
        work = n_prods * cap * n * w
    elif family == "opt":
        work = n_prods * cap * n * w / max(devices, 1)
    elif family == "sp_opt":
        work = n_prods * cap * cap * n / max(devices, 1)
    elif family == "blocksparse":
        # capacity-only estimate (no occupancy feature): cap here counts
        # blocks; each block pair is a tile³-bit contraction.  The planner's
        # own pricing (:meth:`Planner._cost`) refines this with measured
        # occupancy — this form exists so calibration can fit the family.
        from repro_torch.core.blocksparse import DEFAULT_TILE

        work = n_prods * cap * DEFAULT_TILE * DEFAULT_TILE * (DEFAULT_TILE // 32)
    else:  # dense / frontier / sp_dense / sp_frontier
        work = n_prods * cap * cap * n
    return work / 1e6


class Planner:
    """Cost-based executable chooser for one :class:`QueryEngine`.

    Stateless between calls except for cumulative :class:`PlannerStats`;
    decisions are a pure function of ``(profile, features, pin)``, which
    is what makes the calibration round-trip (fit → persist → reload →
    same decisions) checkable.
    """

    def __init__(self, profile: PlannerProfile | None = None) -> None:
        self.profile = profile if profile is not None else PlannerProfile.default()
        self.stats = PlannerStats()

    # ------------------------------------------------------------------ #
    def _candidate_backends(self, f: PlanFeatures) -> list[str]:
        if f.semantics == "count":
            # one masked counting executable exists (plan.COUNT_ENGINES):
            # u32 saturating planes have no packed/frontier/sharded variant,
            # so every backend aliases onto the dense count closure
            return ["dense"]
        if f.semantics == "conjunctive":
            # the two real conjunctive executables (plan.CONJ_ENGINES);
            # frontier is unsound under AND, opt/blocksparse have no
            # conjunctive variant (conjunctive states never repair via
            # the planner — delete is a full drop, insert re-enters here)
            return ["dense", "bitpacked"]
        if f.semantics == "single_path":
            if f.repair:  # one repair fn serves every backend (keys dense)
                return ["dense"]
            out = ["dense", "frontier"]
            if f.mesh_devices > 1:
                out.append("opt")
            return out
        if f.repair:  # REPAIR_ENGINES families (frontier aliases dense)
            out = ["dense", "bitpacked"]
            if self._blocksparse_eligible(f):
                out.append("blocksparse")
            return out
        out = ["dense", "frontier", "bitpacked"]
        if f.mesh_devices > 1:
            out.append("opt")
        if self._blocksparse_eligible(f):
            out.append("blocksparse")
        return out

    @staticmethod
    def _blocksparse_eligible(f: PlanFeatures) -> bool:
        """The block-sparse backend is a candidate only when the caller
        measured occupancy (features present) and the graph is big enough
        for block skipping to matter — below ~8 tiles per edge the dense
        engines' fixed costs always win, and pricing from an absent
        occupancy feature would be fiction."""
        return (
            f.occupied_blocks > 0
            and f.tile > 0
            and f.n >= 8 * f.tile
            and f.n % f.tile == 0
        )

    def _family(self, backend: str, f: PlanFeatures) -> str:
        return f"sp_{backend}" if f.semantics == "single_path" else backend

    def estimate_active(self, f: PlanFeatures) -> int:
        """Predicted fixpoint active-row count.  A warm state's mask rows
        are already in ``seed_rows``; only the new rows expand."""
        grow = max(f.new_rows, 1) * self.profile.reach_factor
        base = f.seed_rows - f.new_rows
        return int(min(f.n, max(f.seed_rows, base + grow)))

    def _cost(self, backend: str, cap: int, f: PlanFeatures) -> float:
        alpha, beta = self.profile.alpha_beta(self._family(backend, f))
        devices = f.mesh_devices if backend == "opt" else 1
        if backend == "blocksparse" and f.occupied_blocks > 0 and f.tile > 0:
            # priced by occupied-block count: the closure fills in more
            # blocks than the base graph occupies (fill fudge), the mask
            # restricts contraction to roughly cap/n of the row-blocks,
            # and each occupied pair costs one tile³-bit contraction.
            grid = max(f.n // f.tile, 1)
            occ = min(f.occupied_blocks * 4.0, float(grid * grid))
            frac = min(1.0, cap / f.n)
            pairs = occ * frac * (occ / grid)
            tile_work = f.tile * f.tile * (f.tile // 32)
            cost = beta + alpha * (f.n_prods * pairs * tile_work) / 1e6
        else:
            # conjunctive work scales with the flattened conjunct count —
            # each conjunct is one full contraction per iteration, exactly
            # like a binary production on the other semantics
            n_units = (
                f.conjuncts
                if f.semantics == "conjunctive" and f.conjuncts
                else f.n_prods
            )
            if f.semantics == "count":
                # count-plane work multiplier: the saturating contraction
                # runs three closure phases on u32 planes (Boolean support,
                # divergence gfp, Jacobi) instead of one Boolean pass, and
                # the u32 multiply-accumulate has no MXU bool shortcut —
                # price it at 4x the relational contraction
                n_units *= 4
            cost = beta + alpha * _work_munits(
                self._family(backend, f), n_units, cap, f.n, devices
            )
        # placement penalty: consuming a cached state somewhere other than
        # where it lives pays one host round-trip of the whole tensor
        want = "sharded" if backend == "opt" and f.mesh_devices > 1 else "local"
        if f.placement in ("local", "sharded") and f.placement != want:
            m_alpha, m_beta = self.profile.alpha_beta("move")
            cost += m_beta + m_alpha * (f.n_nonterms * f.n * f.n) / 1e6
        return cost

    # ------------------------------------------------------------------ #
    def decide(
        self,
        f: PlanFeatures,
        pin: str | None = None,
        min_capacity: int = 128,
    ) -> PlanDecision:
        """Choose the executable for one closure call.

        ``pin`` short-circuits to the caller's explicit backend with the
        legacy capacity ladder and no runtime fallback — pinning means *no
        surprises*.  ``min_capacity`` is the engine's configured floor.
        """
        seed_cap = bucket_for(max(min_capacity, f.seed_rows), f.n)
        if pin is not None:
            d = PlanDecision(
                engine=pin,
                mode="masked",
                sharded=(pin == "opt" and f.mesh_devices > 1 and not f.repair),
                row_capacity=seed_cap,
                est_cost_s=0.0,
                candidates={},
                fallback_engine=None,
                pinned=True,
                profile_fitted=self.profile.fitted,
                semantics=f.semantics,
            )
            self.stats.note(d)
            return d

        est_active = self.estimate_active(f)
        masked_cap = max(seed_cap, bucket_for(est_active, f.n))
        candidates: dict[str, tuple[float, str, str, int]] = {}
        for backend in self._candidate_backends(f):
            sharded = backend == "opt" and f.mesh_devices > 1
            tag = "+mesh" if sharded else ""
            candidates[f"{backend}:masked{tag}"] = (
                self._cost(backend, masked_cap, f),
                backend,
                "masked",
                masked_cap,
            )
            if not f.repair and masked_cap < f.n:
                # all-pairs mode: same executable, capacity jumped to n —
                # skips the ladder when the seed will reach most rows
                candidates[f"{backend}:allpairs{tag}"] = (
                    self._cost(backend, f.n, f),
                    backend,
                    "allpairs",
                    f.n,
                )
        label = min(candidates, key=lambda k: candidates[k][0])
        cost, backend, mode, cap = candidates[label]
        # fallback target: the cheapest full-capacity candidate on a
        # *different* executable than the chosen one (else the ordinary
        # bucket ladder already is the escalation path)
        fallback = None
        if not f.repair:
            full = {
                k: v
                for k, v in candidates.items()
                if v[2] == "allpairs" or v[3] >= f.n
            }
            if full:
                fb_label = min(full, key=lambda k: full[k][0])
                if full[fb_label][1] != backend:
                    fallback = full[fb_label][1]
        d = PlanDecision(
            engine=backend,
            mode=mode,
            sharded=(backend == "opt" and f.mesh_devices > 1),
            row_capacity=cap,
            est_cost_s=cost,
            candidates={k: v[0] for k, v in candidates.items()},
            fallback_engine=fallback,
            pinned=False,
            profile_fitted=self.profile.fitted,
            semantics=f.semantics,
        )
        self.stats.note(d)
        return d

    # ------------------------------------------------------------------ #
    def should_fallback(
        self, decision: PlanDecision, active_rows: int, n: int, calls: int
    ) -> str | None:
        """Consulted at every capacity-overflow observation point of the
        running fixpoint; returns the trigger name when the remaining
        closure should re-dispatch onto ``decision.fallback_engine``."""
        if decision.pinned or decision.fallback_engine is None:
            return None
        p = self.profile
        if active_rows >= p.fallback_active_frac * n:
            return "active_rows"
        if calls >= p.fallback_max_calls:
            return "calls"
        return None

    def note_fallback(self) -> None:
        self.stats.fallbacks += 1
