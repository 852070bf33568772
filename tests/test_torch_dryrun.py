"""The port's dry run (``repro_torch.launch.specs``, ``components``,
``dryrun``) against the reference package on the CPU.

* Cells: for every cell of ``registry.all_cells()`` plus the two ``cfpq``
  shapes, on both production meshes, each argument leaf's global shape and
  dtype, its per-rank shape from the specs and the per-rank argument bytes
  equal the reference's ``build_cell`` (its per-rank shapes from
  ``NamedSharding.shard_shape``).  The reference side runs in one
  subprocess with 512 host devices, started by a fixture and read last;
  its ``jax.eval_shape`` is memoized there on the function's code, closure
  and argument shapes (the cells of one arch trace the same initializers),
  which leaves every shape as it is.
  The ``cfpq`` cells hold a bool state on both sides (packed words would
  be int32 against uint32).
* ``model_flops`` equals the reference's exactly, cell by cell.
* Counting: the depth extension of a reduced train cell equals its direct
  count, on a plan with a pod axis too; a pod plan's per-rank count is
  the pod-less plan's at half the global batch, its gradient sums' groups
  twice as large; the components of a reduced smollm train step with 2 microbatches,
  times their multipliers, equal the direct count of the whole step
  (FLOPs and transcendentals exactly, apart from the block's last product,
  which the checkpoint's recompute skips; bytes within 2%: the embedding
  gather, the microbatch losses' mean and the gradients' accumulation
  are in the step only, the components' ``sum`` of the block output in
  the components only).
* ``dense_step`` is bit-equal to the reference's on the tests' graphs.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import closure as jc
from repro.core import matrices as jm
from repro.roofline import analysis as janalysis
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec, TransformerConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.core import closure as tc
from repro_torch.core import matrices as tm
from repro_torch.launch import components, dryrun, specs
from repro_torch.launch.mesh import production_plan
from repro_torch.models.transformer import _block_counts
from repro_torch.roofline import analysis
from repro_torch.roofline.count import count
from repro_torch.shard.plans import MeshPlan
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import make_train_step
from torch_helpers import NAMED_CASES, case

ROOT = Path(__file__).resolve().parents[1]
JOBS, SKIPS = dryrun.iter_jobs()

REF_DRIVER = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.launch import specs
from repro.launch.mesh import make_production_mesh

# jax.eval_shape memoized on the function's code (its bytecode and names,
# so that the like lambdas of the train, prefill and decode cells share an
# entry), its closure's values and its arguments' shapes: the cells of one
# arch trace the same init_params and init_opt_state again and again, with
# the same results
_eval_shape, _memo = jax.eval_shape, {}

def eval_shape(fn, *args):
    leaves, tree = jax.tree.flatten(args)
    code = fn.__code__
    key = (code.co_code, code.co_consts, code.co_names, code.co_freevars,
           tuple(c.cell_contents for c in fn.__closure__ or ()), tree,
           tuple((x.shape, str(x.dtype)) for x in leaves))
    if key not in _memo:
        _memo[key] = _eval_shape(fn, *args)
    return _memo[key]

jax.eval_shape = eval_shape
out = {}
for arch, shape, mesh_kind in json.loads(sys.argv[1]):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    cell = specs.build_cell(arch, shape, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(cell.args)
    shardings = jax.tree_util.tree_leaves(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    leaves, arg_bytes = {}, 0
    for (path, x), sh in zip(flat, shardings):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        local = sh.shard_shape(x.shape)
        leaves[key] = [list(x.shape), str(x.dtype), list(local)]
        n = 1
        for d in local:
            n *= d
        arg_bytes += n * x.dtype.itemsize
    out["__".join((arch, shape, mesh_kind))] = {"leaves": leaves, "arg_bytes": arg_bytes}
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    """The reference's cells, from a subprocess started here and read by
    the tests that need them (last in this file)."""
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, "-c", REF_DRIVER, json.dumps(JOBS), str(path)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cache = {}

    def read():
        if not cache:
            out, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, out[-3000:]
            cache.update(json.loads(path.read_text()))
        return cache

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_the_reference_starts(reference_cells):
    """Starts the reference's subprocess before the counting tests run."""
    assert callable(reference_cells)


def test_jobs_and_skips_match_the_reference():
    """``iter_jobs`` of the reference (its module sets XLA_FLAGS when
    imported, so its loop is repeated here on its registry)."""
    from repro.configs import registry as jregistry

    jobs, skips = [], []
    for arch, shape, skip in jregistry.all_cells():
        for mesh_kind in ("single", "multi"):
            if skip:
                skips.append((arch, shape.name, mesh_kind, skip))
            else:
                jobs.append((arch, shape.name, mesh_kind))
    jobs += [("cfpq", shape, m) for shape in ("closure_64k", "closure_256k") for m in ("single", "multi")]
    assert JOBS == jobs and SKIPS == skips
    assert len(JOBS) == 76 and len(SKIPS) == 8


@pytest.mark.parametrize("job", JOBS, ids=["__".join(j) for j in JOBS])
def test_model_flops_equal_the_reference(job):
    arch, shape, mesh_kind = job
    n_dev = 512 if mesh_kind == "multi" else 256
    assert analysis.model_flops(arch, shape, n_dev) == janalysis.model_flops(arch, shape, n_dev)


def test_orchestrate_counts_in_workers_and_reports_failures(tmp_path):
    """``--all``'s runner: a job whose JSON exists is done; the others are
    counted in spawned workers (one here: each imports torch), and a
    worker's JSON is ``run_cell``'s here but for the seconds; a job that
    raises comes back with its traceback."""
    done, real, bad = (("cfpq", "closure_256k", "single"), ("deepfm", "serve_p99", "single"),
                       ("nonesuch", "serve_p99", "single"))
    (tmp_path / "cfpq__closure_256k__single.json").write_text("{}")
    heard = []
    failures = dryrun.orchestrate([done, bad, real], str(tmp_path), 1, timeout=120, log=heard.append)
    assert [job for job, _ in failures] == [bad] and "nonesuch" in failures[0][1]
    assert heard[0].startswith("[dryrun] FAIL ('nonesuch'")
    assert heard[1] == "[dryrun] done ('deepfm', 'serve_p99', 'single') (2 total)"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "cfpq__closure_256k__single.json", "deepfm__serve_p99__single.json"]
    assert (tmp_path / "cfpq__closure_256k__single.json").read_text() == "{}"
    got = json.loads((tmp_path / "deepfm__serve_p99__single.json").read_text())
    want = json.loads(json.dumps(dryrun.run_cell(*real, None)))
    for key in ("lower_s", "compile_s"):
        del got[key], want[key]
    assert got == want and got["method"] == "global_over_ranks"


def test_main_counts_one_cell(tmp_path, monkeypatch, capsys):
    """Single-cell mode: the cell's JSON under ``--out`` and its line."""
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "gcn-cora", "--shape", "full_graph_sm",
                                      "--out", str(tmp_path)])
    dryrun.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[dryrun] OK gcn-cora__full_graph_sm__single ")
    got = json.loads((tmp_path / "gcn-cora__full_graph_sm__single.json").read_text())
    assert json.loads(out[1]) == got["memory"] and got["memory"]["code_bytes"] is None
    assert got["cost"]["flops"] > 0 and got["method"] == "global_over_ranks"


# ---------------------------------------------------------------------- #
# Counting
# ---------------------------------------------------------------------- #

S = 64


def _reduced(arch: str, **kw):
    return dataclasses.replace(reduce_config(registry.get_config(arch)), **kw)


def _hold_depth_extension(monkeypatch, plan: MeshPlan) -> None:
    """A reduced per-rank train cell on ``plan``, 4 microbatches of 3
    blocks (2 rows each): counted at 2-3 microbatches x 1-2 blocks and
    extended, it equals the whole step counted directly (the peak within
    5%: it is not linear in depth, only near it)."""
    monkeypatch.setattr(specs, "N_MICRO", 4)
    cfg = _reduced("internlm2-20b", n_layers=3)
    cell = specs._lm_train_cell(cfg, ShapeSpec("t", "train", (("seq_len", S), ("global_batch", 8))), plan)
    assert cell.depth == {"n_micro": 4, "n_blocks": 3} and cell.method == "per_rank"
    direct = specs.count_cell(cell, direct=True)
    extended = specs.count_cell(cell)
    assert extended["depth"]["counted"] == {"n_micro": [2, 3], "n_blocks": [1, 2]}
    for key in ("flops", "bytes_accessed", "transcendentals", "ops"):
        assert extended[key] == direct[key], key
    assert extended["flops_by_dtype"] == direct["flops_by_dtype"]
    assert extended["collectives"] == direct["collectives"]
    assert direct["collectives"]["_total"]["count"] > 0
    assert extended["peak_bytes"] == pytest.approx(direct["peak_bytes"], rel=0.05)


def test_depth_extension_equals_the_direct_count(monkeypatch):
    """On a 2 x 2 plan."""
    _hold_depth_extension(monkeypatch, MeshPlan(None, "data", "model", 1, 2, 2))


def test_depth_extension_equals_the_direct_count_on_a_pod_plan(monkeypatch):
    """On a 2 x 1 x 2 ``(pod, data, model)`` plan."""
    _hold_depth_extension(monkeypatch, MeshPlan("pod", "data", "model", 2, 1, 2))


def test_pod_plan_counts_the_pod_less_plan_at_half_the_batch(monkeypatch):
    """The pod axis is pure data parallelism: a reduced MoE train cell's
    per-rank count on a 2 x 2 x 2 plan equals the 2 x 2 plan's at half
    the global batch (the same rows per rank) in FLOPs, bytes and
    transcendentals, and its collectives are the same call sites, called
    as often and moving as many bytes, their groups as large but for
    those that sum over the rows: every parameter's gradient (its
    replicas are in the other pod too), the gradient norm, the loss's
    token count and value and the MoE's router statistics, whose groups
    are twice as large."""
    from repro_torch.shard import collectives as C
    from repro_torch.shard import plans

    monkeypatch.setattr(specs, "N_MICRO", 2)
    cfg = _reduced("qwen3-moe-235b-a22b", n_layers=2)
    sizes, used = collections.defaultdict(list), set()
    note, use = C.note, C.use

    def noted(name, sent, size=None):
        sizes[name].append(size)
        note(name, sent, size)

    def used_as(p, plan, spec, gather=("data",), name="fsdp"):
        used.add(name)
        return use(p, plan, spec, gather, name)

    monkeypatch.setattr(C, "note", noted)
    monkeypatch.setattr(C, "use", used_as)
    counts, groups, sent = {}, {}, {}
    for pod, batch in ((2, 16), (1, 8)):
        sizes.clear()
        plans.reset_exchanges()
        plan = MeshPlan("pod" if pod > 1 else None, "data", "model", pod, 2, 2)
        cell = specs._lm_train_cell(cfg, ShapeSpec("t", "train", (("seq_len", S), ("global_batch", batch))), plan)
        counts[pod] = specs.count_cell(cell, direct=True)
        groups[pod], sent[pod] = dict(sizes), (dict(plans.exchanged), dict(plans.exchange_calls))
    plans.reset_exchanges()
    for key in ("flops", "bytes_accessed", "transcendentals", "flops_by_dtype"):
        assert counts[2][key] == counts[1][key], key
    assert counts[2]["flops"] > 0
    assert sent[2] == sent[1]
    assert groups[2].keys() == groups[1].keys()
    rows = {"grad_norm", "loss.count", "loss.value", "moe.aux", "moe.aux.grad"} | {n + ".grad" for n in used}
    assert rows <= groups[2].keys()
    for name, got in groups[2].items():
        want = [k * (2 if name in rows else 1) for k in groups[1][name]]
        assert got == want, name


def test_components_compose_to_the_direct_count():
    cfg = _reduced("smollm-360m", attn_chunk=S)
    comps = components.lm_components(
        cfg, ShapeSpec("t", "train", (("seq_len", S), ("global_batch", 4))), n_micro=2)
    assert [(c.name, c.multiplier) for c in comps] == [
        ("block_fwd", 4), ("block_fwdbwd", 4), ("head_fwdbwd", 2), ("opt", 1)]
    composed = {"flops": 0, "transcendentals": 0, "bytes_accessed": 0}
    for comp in comps:
        got = components.count_component(comp)
        for k in composed:
            composed[k] += got[k] * comp.multiplier
    model = specs._lm_model(cfg, None, torch.float32)
    ocfg = opt.OptimizerConfig()
    batch = {k: torch.empty((2, 2, S), dtype=torch.int32, device="meta") for k in ("tokens", "targets")}
    _, direct = count(make_train_step(cfg, ocfg, 2), model, opt.init_opt_state(model, ocfg), batch)
    # the step's checkpointed blocks stop recomputing once the saved tensors
    # are rebuilt, so the block's last product (the FFN's down projection,
    # 2 * tokens * d_ff * d) is not run again in the backward
    n_blocks, _ = _block_counts(cfg)
    last = 2 * (2 * S) * cfg.d_ff * cfg.d_model
    assert direct["flops"] == composed["flops"] - 2 * n_blocks * last
    assert direct["transcendentals"] == composed["transcendentals"]
    assert direct["bytes_accessed"] == pytest.approx(composed["bytes_accessed"], rel=0.02)


#: the reference's step under one jit per graph (its eager ops compile one by one)
_jdense_step = jax.jit(jc.dense_step, static_argnames="tables")


@pytest.mark.parametrize("name", NAMED_CASES)
def test_dense_step_matches_the_reference(name):
    jg, jgr, tg, tgr, _ = case(name)
    T0 = jm.init_matrix(jg, jgr)
    jtab, ttab = jm.ProductionTables.from_grammar(jgr), tm.ProductionTables.from_grammar(tgr)
    want, got = T0, torch.from_numpy(np.array(T0))
    for _ in range(2):
        want = _jdense_step(want, tables=jtab)
        got = tc.dense_step(got, ttab)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------- #
# Cells against the reference (its subprocess read here, last)
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port_cells():
    plans = {"single": production_plan(), "multi": production_plan(multi_pod=True)}
    out = {}
    for arch, shape, mesh_kind in JOBS:
        plan = plans[mesh_kind]
        cell = specs.build_cell(arch, shape, plan)
        leaves = {}
        for i, (tree, spec) in enumerate(zip(cell.args, cell.in_specs)):
            for path, (glob, local, dt) in specs.per_rank_leaves(tree, spec, plan).items():
                key = "/".join(str(k) for k in (i, *path))
                leaves[key] = [list(glob), str(dt).removeprefix("torch."), list(local)]
        arg_bytes = sum(specs.per_rank_bytes(t, s, plan) for t, s in zip(cell.args, cell.in_specs))
        out["__".join((arch, shape, mesh_kind))] = {"leaves": leaves, "arg_bytes": arg_bytes,
                                                    "method": cell.method}
    return out


@pytest.mark.parametrize("job", JOBS, ids=["__".join(j) for j in JOBS])
def test_cell_shapes_and_bytes_match_the_reference(job, port_cells, reference_cells):
    key = "__".join(job)
    got, want = port_cells[key], reference_cells()[key]
    assert got["leaves"] == want["leaves"]
    assert got["arg_bytes"] == want["arg_bytes"]
    arch, shape, mesh_kind = job
    kind = next(s.kind for s in registry.get_shapes(arch) if s.name == shape)
    per_rank = isinstance(registry.get_config(arch), TransformerConfig) and kind in ("train", "prefill")
    assert got["method"] == ("per_rank" if per_rank else "global_over_ranks")
