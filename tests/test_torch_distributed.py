"""The port's ``opt`` family sharded over gloo worlds of 1x1, 2x1, 1x2, 2x2
and 3x1 ranks (``data`` x ``model``) on the CPU.

Each world is one test: its ranks (tests/torch_opt_worker.py, which
imports only torch and the port) join through a ``FileStore`` under a
temporary directory — no port to clash over between xdist workers — run
their cases on their ``DeviceMesh`` and save their results; the world is
killed at a deadline, so a hang fails its test, not the run.  All worlds
start together when the module's first test asks for them and run while
the reference results are computed.  Here the
results are held against the reference's unsharded runs
(tests/torch_opt_cases.py): in every world every closure bit-identical
(the all-pairs case, the masked cases of WORLD_MASKED, the capacity
ladder); in the worlds of ENGINE_SHAPES the mesh-backed engine equal to
the reference engine under the delta interleaving, frozen rows
bit-identical after a sharded state's repair; and every rank with the
same answers and the same routes (a route names the mesh when it has
more than one rank).
3x1 shards n = 128 rows unevenly (43, 43, 42); 2x2 catches a transposed
exchange, and its ranks also run the ontology case's relational closure
on a 2 x 1 x 2 ``(pod, data, model)`` mesh, whose row axis is ``(pod,
data)``.  The ranks of the 2x1 world also build their own grammar, each
under another hash seed, which the engine must refuse.
"""
from __future__ import annotations

import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import torch_opt_worker
from helpers import assert_path_witness
from repro_torch.core.matrices import to_reference
from torch_opt_cases import (
    FROZEN_SP_SOURCES,
    LADDER_CAPS,
    frozen_case,
    interleaving_case,
    ladder_case,
    masked_cases,
    opt_cases,
    ref_frozen,
    ref_interleaving,
    ref_ladder,
    ref_masked,
    ref_opt,
)

MESH_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 1)]
#: the worlds that also run the engine cases: the one-rank path, both axes
#: sharded at once, and uneven row shards (2x1 and 1x2 shard one axis each,
#: as 2x2 does both)
ENGINE_SHAPES = [(1, 1), (2, 2), (3, 1)]
#: the world whose ranks also build their own grammar, each under another
#: hash seed
GRAMMAR_CHECK_SHAPE = (2, 1)
#: the masked cases the worlds run: one random grammar and Query 1 (all
#: of them run against the reference in tests/test_torch_opt.py)
WORLD_MASKED = ("seed0", "ontology")
#: seconds a world may take from start to its last rank's exit
WORLD_DEADLINE_S = 120

# Ranks fork from a server that has imported torch and the port once, so a
# world does not pay each rank's import.
_CTX = mp.get_context("forkserver")
_CTX.set_forkserver_preload(["torch", "torch_opt_worker"])


def _cases() -> dict:
    """The port's inputs of every case, as the worker reads them."""
    _, _, tgraph, tg, sources = ladder_case()
    _, _, igraph, ig, steps, _ = interleaving_case()
    _, _, fgraph, fg, insert = frozen_case()
    return {
        "opt": {k: (v[2], v[3]) for k, v in opt_cases().items()},
        "masked": {k: (v[2], v[3], v[4]) for k, v in masked_cases().items()
                   if k in WORLD_MASKED},
        "ladder": (tgraph, tg, sources, LADDER_CAPS),
        "interleaving": (igraph, ig, steps),
        "frozen": (fgraph, fg, insert, FROZEN_SP_SOURCES),
    }


class World:
    """The ranks of one ``shape`` world, started on the inputs at
    ``cases_path``; :meth:`results` waits for them until the deadline."""

    def __init__(self, shape, root, cases_path) -> None:
        self.shape, self.world = shape, shape[0] * shape[1]
        root.mkdir()
        self.out = str(root / "rank%d.pt")
        self.procs = [
            _CTX.Process(target=torch_opt_worker.run, args=(
                rank, self.world, shape, str(root / "store"), str(cases_path),
                self.out, shape in ENGINE_SHAPES, shape == GRAMMAR_CHECK_SHAPE))
            for rank in range(self.world)
        ]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + WORLD_DEADLINE_S

    def kill(self) -> list[int]:
        """Kill the ranks still running; their ranks."""
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        return hung

    def results(self) -> list[dict]:
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = self.kill()
        results = []
        for rank in range(self.world):
            try:
                results.append(torch.load(self.out % rank, weights_only=False))
            except FileNotFoundError:
                results.append({"error": f"rank {rank} left no results"})
        errors = [r["error"] for r in results if "error" in r]
        assert not hung and not errors, (
            f"{self.shape} world: ranks {hung} hung past {WORLD_DEADLINE_S} s; "
            + "\n".join(errors)
        )
        return results


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world, started at once: they run while the reference results
    are computed here."""
    root = tmp_path_factory.mktemp("opt_worlds")
    cases_path = root / "cases.pt"
    torch.save(_cases(), cases_path)
    started = {s: World(s, root / f"{s[0]}x{s[1]}", cases_path) for s in MESH_SHAPES}
    yield started
    for w in started.values():
        w.kill()


def _reference() -> None:
    """Compute (once) every reference result the checks read."""
    for name in opt_cases():
        ref_opt(name)
    for name in masked_cases():
        ref_masked(name, False), ref_masked(name, True)
    for cap in LADDER_CAPS:
        ref_ladder(cap, False), ref_ladder(cap, True)
    ref_interleaving(), ref_frozen()


def _equal(a, b) -> bool:
    """Deep equality of two ranks' results (tensors by ``torch.equal``)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


def _check_closures(res: dict) -> None:
    for name in opt_cases():
        want, want_step = ref_opt(name)
        np.testing.assert_array_equal(to_reference(res["opt", name]), want)
        np.testing.assert_array_equal(to_reference(res["opt_step", name]), want_step)
    for name in WORLD_MASKED:
        for key, single_path in (("masked", False), ("masked_sp", True)):
            state, M, ovf = res[key, name]
            want, want_M, want_ovf = ref_masked(name, single_path)
            if single_path:
                assert torch.equal(state, torch.from_numpy(want.copy())), (key, name)
            else:
                np.testing.assert_array_equal(to_reference(state), want)
            np.testing.assert_array_equal(M.numpy(), want_M)
            assert ovf == want_ovf
    for cap in LADDER_CAPS:
        for key, single_path in (("ladder", False), ("ladder_sp", True)):
            got, want = res[key, cap], ref_ladder(cap, single_path)
            assert len(got) == len(want) > 1, (key, cap)
            for (t, m), (jt, jm) in zip(got, want):
                np.testing.assert_array_equal(t.numpy(), jt)
                np.testing.assert_array_equal(m.numpy(), jm)


def _check_engines(res: dict, world: int) -> None:
    _, _, _, tg, _, edge_sets = interleaving_case()
    want_queries, _, _ = ref_interleaving()
    rows = res["interleaving"]
    assert len(rows) == len(want_queries)
    for k, ((rel, sp, place, sp_place), (pairs, sp_pairs, _)) in enumerate(
        zip(rows, want_queries)
    ):
        assert rel["pairs"] == pairs and sp["pairs"] == sp_pairs, k
        assert rel["engine"] == sp["engine"] == "opt"
        # a planned call's route names the mesh when it has several ranks
        for r in (rel, sp):
            if r["route"] is not None:
                assert r["route"].endswith("+mesh") == (world > 1), r["route"]
        # a closure leaves its state sharded (on more than one rank); a
        # repair localized it, until the next closure
        for r, p in ((rel, place), (sp, sp_place)):
            if r["cache"] != "hit":
                assert p == ("sharded" if world > 1 else "local"), k
        step = type("G", (), {"edge_set": lambda self, e=edge_sets[k]: e})()
        for (i, j), path in sp["paths"].items():
            assert_path_witness(step, tg, "S", i, j, path)
    _, _, fgraph, _, _ = frozen_case()
    pairs, (T_ref, L_ref, mask_ref, sp_mask_ref), stats, requery = ref_frozen()
    fr = res["frozen"]
    before, after = fr["before"], fr["after"]
    assert fr["pairs"] == pairs and fr["requery"] == requery
    assert fr["stats"] == stats
    # the repair localized the sharded states (the interleaving shows the
    # next closure sharding them again; here every row stays a cache hit)
    sharded = "sharded" if world > 1 else "local"
    assert before["kind"] == "ShardedState" and after["kind"] == "Tensor"
    assert before["placement"] == (sharded, sharded)
    assert after["placement"] == ("local", "local")
    np.testing.assert_array_equal(after["mask"], mask_ref)
    np.testing.assert_array_equal(after["sp_mask"], sp_mask_ref)
    np.testing.assert_array_equal(after["T"][:, mask_ref, :], T_ref[:, mask_ref, :])
    np.testing.assert_array_equal(
        after["L"][:, sp_mask_ref, :], L_ref[:, sp_mask_ref, :])
    frozen = before["mask"] & ~fr["affected"]
    half = fgraph.n_nodes // 2
    assert frozen[half : fgraph.n_nodes].any()  # the second community froze
    np.testing.assert_array_equal(after["T"][:, frozen, :], before["T"][:, frozen, :])
    np.testing.assert_array_equal(after["L"][:, frozen, :], before["L"][:, frozen, :])
    was = np.isfinite(before["L"])
    np.testing.assert_array_equal(after["L"][was], before["L"][was])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_opt_family_matches_reference(shape, worlds):
    _reference()
    results = worlds[shape].results()
    world = shape[0] * shape[1]
    coords = sorted(r["coords"] for r in results)
    assert coords == sorted((d, m) for d in range(shape[0]) for m in range(shape[1]))
    first = results[0]
    for rank, res in enumerate(results[1:], 1):  # the same answers and routes
        for key in first:
            if key not in ("coords", "pod_coords", "grammar_check"):
                assert _equal(first[key], res[key]), (shape, rank, key)
    _check_closures(first)
    if shape in ENGINE_SHAPES:
        _check_engines(first, world)
    else:
        assert "interleaving" not in first
    if world == 4:  # the ontology case's relational closure on a
        # (pod, data, model) mesh too
        assert sorted(r["pod_coords"] for r in results) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        state, M, ovf = first["pod", "masked", "ontology"]
        want, want_M, want_ovf = ref_masked("ontology", False)
        np.testing.assert_array_equal(to_reference(state), want)
        np.testing.assert_array_equal(M.numpy(), want_M)
        assert ovf == want_ovf


def test_ranks_numbering_a_grammar_differently_are_refused(worlds):
    """Each rank of the 2x1 world builds Query 1 in CNF itself, in an
    interpreter started with its own ``PYTHONHASHSEED`` (its rank), so the
    two number their nonterminals differently; the mesh-backed engine
    raises on both ranks, where sharded planes of different nonterminals
    would have mixed into wrong pairs."""
    results = worlds[GRAMMAR_CHECK_SHAPE].results()
    checks = [r["grammar_check"] for r in results]
    assert checks[0]["nonterms"] != checks[1]["nonterms"]  # not vacuous
    for c in checks:
        assert c["error"] is not None and "disagree on the grammar" in c["error"], c
