"""The port's planner calibration tool (tools/calibrate_planner_torch.py)
against the reference's (tools/calibrate_planner.py), and the port's own
profile variable.

The workload graph, the affine fit and the canonical decision grid must
equal the reference tool's; a smoke calibration on the CPU must write a
complete, versioned, fitted profile stamped with the CPU's fingerprint.
No JAX closure runs here: the reference tool is only imported.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro.engine import PlannerProfile as JProfile
from repro_torch.engine import PlannerProfile
from repro_torch.engine.planner import _DEFAULT_COEF, PROFILE_ENV, host_fingerprint

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load("calibrate_planner_torch"), _load("calibrate_planner")


@pytest.mark.parametrize("n", [256, 512])
def test_community_graph_matches_the_reference(tools, n):
    port, ref = tools
    got, want = port.community_graph(n), ref.community_graph(n)
    assert got.n_nodes == want.n_nodes == n
    assert got.edges == want.edges


def _observations(seed: int, slope: float, intercept: float):
    rng = np.random.default_rng(seed)
    work = rng.uniform(0.1, 100.0, size=7)
    secs = intercept + slope * work + rng.normal(0.0, 1e-4, size=7)
    return [(float(w), float(s)) for w, s in zip(work, secs)]


@pytest.mark.parametrize("seed,slope,intercept", [
    (0, 2e-4, 3e-3),     # an ordinary fit
    (1, -1e-3, 5e-2),    # a falling line: alpha clamps at 1e-9
    (2, 1e-3, -2e-1),    # a negative intercept: beta clamps at 1e-6
])
def test_fit_affine_matches_the_reference(tools, seed, slope, intercept):
    port, ref = tools
    obs = _observations(seed, slope, intercept)
    got = port.fit_affine(obs)
    assert got == ref.fit_affine(obs)
    if slope < 0:
        assert got[0] == port.ALPHA_FLOOR
    if intercept < 0:
        assert got[1] == port.BETA_FLOOR


def test_decision_grid_matches_the_reference(tools):
    """One seeded fitted profile: every decision of the canonical grid is
    the reference planner's with the same coefficients."""
    port, ref = tools
    rng = np.random.default_rng(5)
    coef = {k: (float(a * rng.uniform(0.01, 10.0)), float(b * rng.uniform(0.01, 10.0)))
            for k, (a, b) in _DEFAULT_COEF.items()}
    kw = dict(host="seeded", fitted=True, coef=coef,
              reach_factor=float(rng.uniform(1.0, 32.0)))
    got = port.decision_grid(PlannerProfile(**kw))
    assert got == ref.decision_grid(JProfile(**kw))
    assert len(got) == len(port.grid_features()) == 48
    # the seeded coefficients move some route off the defaults' choice
    assert got != port.decision_grid(PlannerProfile())


def test_smoke_calibration_on_the_cpu(tools, tmp_path, capsys):
    port, _ = tools
    out = tmp_path / "profile.json"
    assert port.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    obj = json.loads(out.read_text())
    assert obj["version"] == 1 and obj["fitted"] is True
    assert set(obj["coef"]) == set(_DEFAULT_COEF)
    assert obj["host"].endswith(":cpu:cpu") and obj["host"] == host_fingerprint("cpu")
    for family in ("opt", "sp_opt", "blocksparse"):  # not measured: defaults
        assert tuple(obj["coef"][family]) == _DEFAULT_COEF[family]
    assert obj["reach_factor"] >= 1.0
    assert "round-trip OK" in capsys.readouterr().out


def test_only_the_ports_variable_steers_the_port(tmp_path, monkeypatch):
    path = PlannerProfile(host="h", fitted=True, reach_factor=3.0).save(
        tmp_path / "p.json")
    assert PROFILE_ENV == "REPRO_TORCH_PLANNER_PROFILE"
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    monkeypatch.setenv("REPRO_PLANNER_PROFILE", str(path))
    assert PlannerProfile.default() == PlannerProfile()
    monkeypatch.setenv(PROFILE_ENV, str(path))
    assert PlannerProfile.default() == PlannerProfile.load(path)
    assert PlannerProfile.default().reach_factor == 3.0
