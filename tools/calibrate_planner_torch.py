"""Fit the port's planner cost profile on one device and persist it as JSON.

    PYTHONPATH=src python3 tools/calibrate_planner_torch.py --out h100.json
    PYTHONPATH=src python3 tools/calibrate_planner_torch.py --smoke --device cpu --out /tmp/p.json

The port's planner (``repro_torch.engine.planner``) prices each candidate
closure as ``cost_s ≈ beta + alpha · work_Munits``.  This tool *measures*
those coefficients on one device (the card by default) instead of trusting
the built-in defaults, which were fitted on a CPU host: for every closure
family it runs real pinned closures of the port's ``QueryEngine`` over an
(n, sources) grid on the community workload, records ``(work, seconds)``
observations, and least-squares fits ``(alpha, beta)`` per family.
``reach_factor`` — how far the active set outgrows its seed — is measured
from the same runs.  The ``move`` family (placement-mismatch penalty) is
timed as a device → host → device round trip of a state tensor.

On the card one small query per family runs before the first timed
point, so the first launch of each kernel (which builds its CUDA
extension) and the first library call (which makes its handle) fall
outside the timed runs; the CPU's plain versions have no such first-call
cost.  Every point is then one cold query, timed once (the reference
runs each point twice, to keep its XLA compile out of the timing; the
port compiles nothing per shape).  On the card every clock read follows
a ``torch.cuda.synchronize()``.  At
small n the card is host- and launch-bound, so a family's time hardly
grows with its work and its ``alpha`` may clamp at 1e-9: the log says so
for every clamped coefficient.

The fitted :class:`~repro_torch.engine.planner.PlannerProfile` is persisted
versioned (``PROFILE_VERSION``); the port's engines pick it up via
``EngineConfig(profile=...)`` or the ``REPRO_TORCH_PLANNER_PROFILE``
environment variable.

Every run ends with the **calibration round-trip check**: the profile is
saved, reloaded, and the reloaded planner must make identical decisions
across a feature grid — persistence can never change routing.  Exit status
is nonzero if the round trip fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core.grammar import Grammar
from repro_torch.core.graph import Graph
from repro_torch.engine import (
    CompiledClosureCache,
    EngineConfig,
    PlanFeatures,
    Planner,
    PlannerProfile,
    Query,
    QueryEngine,
)
from repro_torch.engine.planner import _DEFAULT_COEF, _work_munits, host_fingerprint

GRAMMAR = "S -> up S down | up down"
COMMUNITY = 128  # nodes per disjoint tree community
ALPHA_FLOOR, BETA_FLOOR = 1e-9, 1e-6  # fit_affine's clamps


def community_graph(n: int, branching: int = 3, seed: int = 0) -> Graph:
    """A forest of n/COMMUNITY disjoint trees with up/down edge pairs
    (the reference's engine-benchmark workload: single-source reach stays
    in-community)."""
    rng = np.random.default_rng(seed)
    edges: list[tuple[int, str, int]] = []
    for c in range(1, COMMUNITY):
        p = int(rng.integers(max(0, (c - 1) // branching), c))
        edges.append((c, "up", p))
        edges.append((p, "down", c))
    return Graph(COMMUNITY, edges).repeat(n // COMMUNITY)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: str) -> tuple[object, float]:
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def measure_backend(
    backend: str,
    semantics: str,
    sizes: list[int],
    source_counts: list[int | str],
    plans: CompiledClosureCache,
    device: str = "cuda",
    log=None,
) -> tuple[list[tuple[float, float]], list[float]]:
    """``(work_Munits, seconds)`` observations for one (backend, semantics)
    family over the measurement grid, plus observed active/seed reach
    ratios.  Each point is a cold pinned query on ``device`` (after
    :func:`warm_up` on the card); ``log`` gets one line per point."""
    g = Grammar.from_text(GRAMMAR).to_cnf()
    family = f"sp_{backend}" if semantics == "single_path" else backend
    obs: list[tuple[float, float]] = []
    reach: list[float] = []
    for n in sizes:
        graph = community_graph(n)
        cfg = EngineConfig(engine=backend, device=device)
        for r_spec in source_counts:
            r = n if r_spec == "n" else min(int(r_spec), n // COMMUNITY)
            if r_spec == "n":
                q = Query(g, "S", semantics=semantics)  # all-pairs
                seed = graph.n_nodes
            else:
                srcs = tuple(t * COMMUNITY + 1 for t in range(r))
                q = Query(g, "S", sources=srcs, semantics=semantics)
                seed = r
            eng = QueryEngine(graph, plans=plans, config=cfg)
            res, secs = _time(lambda: eng.query(q), device)
            active = res.stats["active_rows"]
            # the decision prices one fixpoint run at the planner's
            # predicted capacity; regress against the capacity the run
            # actually needed so alpha reflects converged work
            cap = res.stats.planner["row_capacity"] if res.stats.planner else n
            cap = max(cap, active)
            work = _work_munits(
                family, max(len(g.binary_prods), 1), cap, n, 1
            )
            obs.append((work, secs))
            if r_spec != "n":
                reach.append(active / max(seed, 1))
            if log is not None:
                log(f"[calibrate] {family} n={n} sources={r_spec}: "
                    f"work={work:.4g} Munits, {secs:.4f} s, {active} active rows")
    return obs, reach


def _families(backends: list[str]) -> list[tuple[str, str]]:
    """``(semantics, backend)`` of every measured family: single-path has
    no bitpacked family."""
    return [("relational", b) for b in backends] + [
        ("single_path", b) for b in backends if b != "bitpacked"
    ]


def warm_up(backends: list[str], plans: CompiledClosureCache, device: str) -> None:
    """On the card, one small masked and one all-pairs query per family
    before any timed point: each kernel's first launch builds its CUDA
    extension, the first library call makes its handle."""
    if torch.device(device).type != "cuda":
        return
    g = Grammar.from_text(GRAMMAR).to_cnf()
    graph = community_graph(2 * COMMUNITY)
    for semantics, backend in _families(backends):
        eng = QueryEngine(
            graph, plans=plans, config=EngineConfig(engine=backend, device=device)
        )
        eng.query(Query(g, "S", sources=(1,), semantics=semantics))
        eng.query(Query(g, "S", semantics=semantics))
    _sync(device)


def measure_move(sizes: list[int], device: str = "cuda") -> list[tuple[float, float]]:
    """Device → host → device round trip of a state tensor (the placement
    penalty the cost model charges when a state lives elsewhere); one
    untimed round trip first."""
    g = Grammar.from_text(GRAMMAR).to_cnf()
    obs: list[tuple[float, float]] = []
    for n in sizes:
        T = torch.zeros((g.n_nonterms, n, n), dtype=torch.bool, device=device)

        def round_trip():
            host = T.to("cpu", copy=True).numpy()
            return torch.from_numpy(host).to(device, copy=True)

        _time(round_trip, device)
        _, secs = _time(round_trip, device)
        obs.append((g.n_nonterms * n * n / 1e6, secs))
    return obs


def fit_affine(obs: list[tuple[float, float]]) -> tuple[float, float]:
    """Least-squares ``seconds ≈ beta + alpha · work``, clamped positive
    (a negative intercept/slope would invert the cost ranking)."""
    a = np.array([[w, 1.0] for w, _ in obs])
    y = np.array([s for _, s in obs])
    alpha, beta = np.linalg.lstsq(a, y, rcond=None)[0]
    return max(float(alpha), ALPHA_FLOOR), max(float(beta), BETA_FLOOR)


def _clamps(ab: tuple[float, float]) -> str:
    names = [k for k, v, floor in (("alpha", ab[0], ALPHA_FLOOR),
                                   ("beta", ab[1], BETA_FLOOR)) if v <= floor]
    return f" ({' and '.join(names)} clamped)" if names else ""


def calibrate(
    sizes: list[int],
    source_counts: list[int | str],
    backends: list[str],
    device: str = "cuda",
    log=print,
    extra: tuple = (),
) -> PlannerProfile:
    """Fit every family of ``backends`` (both semantics; single-path has
    no bitpacked family) over ``sizes`` x ``source_counts`` on ``device``,
    and ``move`` over ``sizes``.  ``extra`` holds more ``(sizes,
    source_counts, semantics)`` grids, each measured for the families of
    the semantics it names and joining their fits (a larger n without its
    all-pairs point, say)."""
    plans = CompiledClosureCache()  # shared across points
    warm_up(backends, plans, device)
    coef: dict[str, tuple[float, float]] = {}
    reach_all: list[float] = []
    for semantics, backend in _families(backends):
        obs, reach = [], []
        grids = [(sizes, source_counts)] + [
            (more_sizes, more_sources)
            for more_sizes, more_sources, names in extra
            if semantics in names
        ]
        for grid_sizes, grid_sources in grids:
            o, r = measure_backend(
                backend, semantics, grid_sizes, grid_sources, plans,
                device=device, log=log,
            )
            obs += o
            reach += r
        family = f"sp_{backend}" if semantics == "single_path" else backend
        coef[family] = fit_affine(obs)
        reach_all.extend(reach)
        log(
            f"[calibrate] {family}: alpha={coef[family][0]:.3e} "
            f"beta={coef[family][1]:.3e} ({len(obs)} points)"
            f"{_clamps(coef[family])}"
        )
    coef["move"] = fit_affine(measure_move(sizes, device))
    log(
        f"[calibrate] move: alpha={coef['move'][0]:.3e} "
        f"beta={coef['move'][1]:.3e}{_clamps(coef['move'])}"
    )
    # families not measured here (opt without a mesh, blocksparse unless
    # asked for) keep the built-in defaults so the profile stays complete
    for family, ab in _DEFAULT_COEF.items():
        coef.setdefault(family, ab)
    reach = float(np.median(reach_all)) if reach_all else 16.0
    return PlannerProfile(
        host=host_fingerprint(device),
        fitted=True,
        coef=coef,
        reach_factor=max(reach, 1.0),
    )


def grid_features() -> list[PlanFeatures]:
    """The canonical feature grid of :func:`decision_grid`, in its order."""
    return [
        PlanFeatures(
            n=n,
            seed_rows=seed_rows,
            new_rows=seed_rows,
            density=2.0,
            n_prods=2,
            n_nonterms=2,
            semantics=semantics,
            mesh_devices=mesh_devices,
        )
        for n in (256, 1024, 4096)
        for seed_rows in (1, 8, 128, n)
        for semantics in ("relational", "single_path")
        for mesh_devices in (0, 2)
    ]


def decision_grid(profile: PlannerProfile) -> list[dict]:
    """Planner decisions across a canonical feature grid — the round-trip
    equivalence check (fit → persist → reload → same decisions) compares
    these between the in-memory and reloaded profiles."""
    planner = Planner(profile)
    return [planner.decide(f).to_dict() for f in grid_features()]


def verify_round_trip(profile: PlannerProfile, path) -> bool:
    """Persist → reload → identical decisions on the canonical grid."""
    reloaded = PlannerProfile.load(path)
    return decision_grid(profile) == decision_grid(reloaded)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="planner_profile.json")
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument(
        "--sources",
        nargs="+",
        default=["1", "4", "n"],
        help="source counts per size; 'n' means all-pairs",
    )
    ap.add_argument(
        "--backends", nargs="+", default=["dense", "frontier", "bitpacked"]
    )
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="tiny grid (n=256, two points/backend): seconds, for CI",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the measured closures run: cuda (default) or cpu",
    )
    args = ap.parse_args(argv)
    sizes = [256] if args.smoke else args.sizes
    sources: list[int | str] = ["1", "n"] if args.smoke else args.sources
    sources = [s if s == "n" else int(s) for s in sources]

    profile = calibrate(sizes, sources, args.backends, device=args.device)
    path = profile.save(args.out)
    print(f"[calibrate] profile -> {path}")
    if not verify_round_trip(profile, path):
        print("[calibrate] ROUND-TRIP FAILED: reloaded profile decides differently")
        return 1
    print("[calibrate] round-trip OK: reloaded profile makes identical decisions")
    print(json.dumps(profile.to_json(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
