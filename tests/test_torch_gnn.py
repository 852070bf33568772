"""The port's GNN family (``repro_torch.models.gnn``, ``gnn_batch``, the GNN
branch of the trainer, of the checkpoints and of ``launch/train.py``)
against the reference package on the CPU.

Weights are drawn by the port and handed to both packages as one numpy
tree; batches come from the port's ``gnn_batch`` (self-loops included),
with some edges and nodes masked.  Each reference function is compiled
once per module, at XLA's backend optimisation level 0 (``_compile``, as
in ``test_torch_train.py``).  Tolerances: the forward, the loss and every
gradient leaf within rtol 1e-4 and atol 1e-6; segment ops and the radial
basis within 1e-6; one AdamW step's parameters and moments within 1e-6;
the E(3) invariance within rtol 1e-3 and atol 1e-4 and padded edges within
rtol 1e-5 and atol 1e-6, as ``tests/test_gnn.py`` holds the reference;
data, sampler arrays and checkpoints exact.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as j_reduce_config
from repro.models.gnn import api as japi
from repro.models.gnn import common as jcommon
from repro.models.gnn import mace as jmace
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.launch import train as launch_train
from repro_torch.models.common import to_numpy
from repro_torch.models.gnn import api, common
from repro_torch.models.gnn import mace as tmace
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer

ARCHS = [a for a, c in registry.ARCHS.items() if isinstance(c, GNNConfig)]
GRAD = dict(rtol=1e-4, atol=1e-6)
N, E, D_FEAT = 40, 120, 12
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``COMPILE_OPTIONS``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE_OPTIONS)


def _cfgs(arch: str):
    return reduce_config(registry.get_config(arch)), j_reduce_config(jregistry.get_config(arch))


def _leaves(tree) -> dict:
    """``{key path: numpy leaf}`` with the checkpoints' key strings."""
    return {k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tckpt._flatten(tree).items()}


def _assert_trees(got, want, exact: bool = False, **tol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path in want:
        if exact:
            assert np.array_equal(got[path], want[path]), path
        else:
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


def _tree(arch: str) -> dict:
    cfg, _ = _cfgs(arch)
    return api.to_reference(api.GNN(cfg, D_FEAT, device="cpu", seed=ARCHS.index(arch)))


def _batch(arch: str, n: int = N, e: int = E) -> dict:
    """``gnn_batch`` with every 9th edge and every 7th node masked."""
    cfg, _ = _cfgs(arch)
    b = tdata.gnn_batch(cfg, n, e, D_FEAT, step=ARCHS.index(arch))
    b["edge_mask"][::9] = 0.0
    b["node_mask"][::7] = 0.0
    return b


def _torch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def cache():
    return {}


def _jax_arch(cache, arch: str):
    """The reference's forward, loss, metrics and gradients on ``_tree`` and
    ``_batch``, from one compile per arch."""
    if arch not in cache:
        _, jcfg = _cfgs(arch)
        params = jax.tree.map(jnp.asarray, _tree(arch))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}

        def run(p, b):
            (loss, metrics), grads = jax.value_and_grad(
                lambda p: japi.loss_fn(p, b, jcfg), has_aux=True)(p)
            return japi.forward(p, b, jcfg), loss, metrics, grads

        cache[arch] = jax.tree.map(np.asarray, _compile(run, params, batch)(params, batch))
    return cache[arch]


# ---------------------------------------------------------------------- #
# models/gnn/common.py
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
def test_segment_agg_matches_the_reference_with_an_empty_segment(kind):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(30, 5)).astype(np.float32)
    ids = rng.integers(0, 6, 30).astype(np.int64)
    ids[ids == 2] = 3  # segment 2 empty; 7 and 8 past every id
    got = common.segment_agg(torch.from_numpy(data), torch.from_numpy(ids), 9, kind).numpy()
    want = np.asarray(jcommon.segment_agg(jnp.asarray(data), jnp.asarray(ids), 9, kind))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    empty = {"sum": 0.0, "mean": 0.0, "max": -np.inf}[kind]
    assert np.all(got[[2, 7, 8]] == empty)


def test_segment_mean_of_rank_3_data_divides_each_segment_by_its_count():
    """The reference's mean broadcasts the counts as (num_segments, 1), so
    (30, 3, 4) data over 9 segments raises there; the port divides each
    segment by its count."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(30, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 6, 30)
    with pytest.raises((TypeError, ValueError)):
        jcommon.segment_agg(jnp.asarray(data), jnp.asarray(ids), 9, "mean")
    got = common.segment_agg(torch.from_numpy(data), torch.from_numpy(ids), 9, "mean").numpy()
    want = np.stack([data[ids == s].mean(axis=0) if (ids == s).any() else np.zeros((3, 4), np.float32)
                     for s in range(9)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_segment_max_splits_the_gradient_between_ties():
    x = np.array([2.0, 2.0, 1.0, 5.0], np.float32)
    ids = np.array([0, 0, 0, 1])
    t = torch.from_numpy(x).requires_grad_()
    common.segment_agg(t, torch.from_numpy(ids), 3, "max").sum().backward()
    want = jax.grad(lambda v: jcommon.segment_agg(v, jnp.asarray(ids), 2, "max").sum())(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), [0.5, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_segment_softmax_and_gaussian_rbf_match_the_reference():
    rng = np.random.default_rng(6)
    scores = rng.normal(size=(50, 3)).astype(np.float32) * 4
    scores[::5] = -1e30  # masked edges, as Equiformer-v2 masks them
    ids = rng.integers(0, 12, 50).astype(np.int64)
    got = common.segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids), 13).numpy()
    want = np.asarray(jcommon.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), 13))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    r = np.abs(rng.normal(size=64) * 3).astype(np.float32)
    r[:3] = [0.0, 5.0, 7.5]  # on the cutoff and past it
    for n_rbf in (4, 8):
        np.testing.assert_allclose(common.gaussian_rbf(torch.from_numpy(r), n_rbf).numpy(),
                                   np.asarray(jcommon.gaussian_rbf(jnp.asarray(r), n_rbf)),
                                   rtol=1e-6, atol=1e-6)


def test_sampler_arrays_equal_the_reference():
    g, jg = common.CSRGraph.random(1000, 20_000, seed=3), jcommon.CSRGraph.random(1000, 20_000, seed=3)
    assert g.n_nodes == jg.n_nodes
    assert np.array_equal(g.indices, jg.indices) and np.array_equal(g.indptr, jg.indptr)
    assert g.indices.dtype == jg.indices.dtype and g.indptr.dtype == jg.indptr.dtype
    for fanouts in ((5, 3), (15, 10), (4,), ()):
        assert common.sampled_sizes(16, fanouts) == jcommon.sampled_sizes(16, fanouts)
    assert common.sampled_sizes(1024, (15, 10)) == (169_984, 168_960)
    sparse = common.CSRGraph.random(400, 300, seed=1)  # nodes without in-edges
    for graph, jgraph, seeds in ((g, jg, np.arange(16, dtype=np.int32)),
                                 (sparse, jcommon.CSRGraph.random(400, 300, seed=1),
                                  np.arange(0, 400, 25, dtype=np.int32))):
        for seed in (0, 7):
            got = common.sample_subgraph(graph, seeds, (5, 3), seed=seed)
            want = jcommon.sample_subgraph(jgraph, seeds, (5, 3), seed=seed)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------- #
# The four archs against the reference
# ---------------------------------------------------------------------- #


def test_the_coupling_paths_and_the_dims_match_the_reference():
    for l_max in (0, 1, 2):
        assert tmace._order2_paths(l_max) == jmace._order2_paths(l_max)
        assert tmace._order3_paths(l_max) == jmace._order3_paths(l_max)
    assert (len(tmace._order2_paths(2)), len(tmace._order3_paths(2))) == (8, 29)
    assert api.D_EDGE == japi.D_EDGE and api.D_OUT == japi.D_OUT
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        assert api.needs_positions(cfg) == japi.needs_positions(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_every_gradient_match_the_reference(cache, arch):
    out, loss, metrics, grads = _jax_arch(cache, arch)
    cfg, _ = _cfgs(arch)
    model = api.params_from_reference(_tree(arch), cfg, device="cpu")
    batch = _torch(_batch(arch))
    got_loss, got_metrics = api.loss_fn(model, batch, cfg)
    got_loss.backward()
    np.testing.assert_allclose(api.forward(model, batch, cfg).detach().numpy(), out, **GRAD)
    np.testing.assert_allclose(got_loss.item(), loss, **GRAD)
    assert got_metrics.keys() == metrics.keys() == ({"nll"} if cfg.model == "gcn" else {"mse"})
    got_grads = api.to_reference(model, {n: p.grad for n, p in model.named_parameters()})
    _assert_trees(got_grads, grads, **GRAD)
    d_out = cfg.n_classes if cfg.model == "gcn" else api.D_OUT[cfg.model]
    assert out.shape == (N, d_out)


def test_the_model_holds_the_reference_tree():
    """Parameter names follow the reference's nesting; the tree survives
    ``params_from_reference`` and ``to_reference`` bit for bit; the full
    configs' shapes equal ``jax.eval_shape(init_params)``'s."""
    names = {arch: dict(api.GNN(_cfgs(arch)[0], D_FEAT, device="meta").named_parameters())
             for arch in ARCHS}
    assert {"w.0", "w.1"} == set(names["gcn-cora"])
    assert "blocks.1.edge_mlp.1.b" in names["meshgraphnet"]
    assert {"layers.0.w_re.0", "layers.1.w_im.1", "layers.0.radial_gate.1.b"} <= set(names["equiformer-v2"])
    assert {"layers.1.w_b3", "layers.0.radial.0.w", "readout.1.b"} <= set(names["mace"])
    for arch in ARCHS:
        cfg, _ = _cfgs(arch)
        tree = _tree(arch)
        _assert_trees(api.to_reference(api.params_from_reference(tree, cfg, device="cpu")), tree, exact=True)
        shapes = jax.eval_shape(lambda k, c=jregistry.get_config(arch): japi.init_params(k, c, d_feat=D_FEAT),
                                jax.random.PRNGKey(0))
        full = api.reference_tree(api.GNN(registry.get_config(arch), D_FEAT, device="meta"))
        assert {k: tuple(v.shape) for k, v in tckpt._flatten(full).items()} == {
            jax.tree_util.keystr(p): tuple(s.shape) for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    assert sum(p.numel() for p in api.GNN(registry.get_config("equiformer-v2"), 32, device="meta")
               .parameters()) == 35_654_533


@pytest.mark.parametrize("arch", ["meshgraphnet", "mace", "equiformer-v2"])
def test_padded_edges_leave_the_output_unchanged(arch):
    cfg, _ = _cfgs(arch)
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=3)
    b = tdata.gnn_batch(cfg, 20, 50, D_FEAT, step=4)
    pad = 17
    b2 = dict(b)
    b2["edge_src"] = np.concatenate([b["edge_src"], np.zeros(pad, np.int32)])
    b2["edge_dst"] = np.concatenate([b["edge_dst"], np.arange(pad, dtype=np.int32) % 20])
    b2["edge_feat"] = np.concatenate([b["edge_feat"], np.full((pad, 4), 3.33, np.float32)])
    b2["edge_mask"] = np.concatenate([b["edge_mask"], np.zeros(pad, np.float32)])
    with torch.no_grad():
        out = api.forward(model, _torch(b), cfg).numpy()
        out2 = api.forward(model, _torch(b2), cfg).numpy()
    np.testing.assert_allclose(out, out2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["equiformer-v2", "mace"])
def test_rotation_invariance_at_the_full_l_max(arch):
    """A random proper rotation plus a translation of the positions leaves
    the readout unchanged (the reference test's shape and tolerance)."""
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=2, d_hidden=8, n_heads=2)
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=1)
    rng = np.random.default_rng(1)
    b = tdata.gnn_batch(cfg, 12, 36, D_FEAT, step=1)
    a = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(a) < 0:
        a[:, 0] = -a[:, 0]
    rot = dict(b, positions=(b["positions"] @ a.T + 1.5).astype(np.float32))
    with torch.no_grad():
        out = api.forward(model, _torch(b), cfg).numpy()
        out_rot = api.forward(model, _torch(rot), cfg).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, out_rot, rtol=1e-3, atol=1e-4)


def test_equiformer_self_loops_stay_finite_under_grad():
    """``gnn_batch`` draws self-loops: their zero-length edges give R = 0
    and are masked, with no NaN in the loss or any gradient."""
    cfg, _ = _cfgs("equiformer-v2")
    b = tdata.gnn_batch(cfg, 10, 60, D_FEAT, step=0)
    b["edge_dst"][:10] = b["edge_src"][:10]
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=2)
    loss, _ = api.loss_fn(model, _torch(b), cfg)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_gcn_learns_labels():
    """12 steps of SGD reduce the loss by 10% (the reference's test)."""
    cfg, _ = _cfgs("gcn-cora")
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=2)
    batch = _torch(tdata.gnn_batch(cfg, N, E, D_FEAT, step=2))
    losses = []
    for _ in range(12):
        loss, _ = api.loss_fn(model, batch, cfg)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.5 * p.grad
                p.grad = None
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------------------------------------------------------------- #
# train/: data, the train step, checkpoints, the driver
# ---------------------------------------------------------------------- #


def test_gnn_batch_equals_the_reference_under_the_port_seed(monkeypatch):
    monkeypatch.setattr(jdata, "_rng", tdata._rng)
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        got, want = tdata.gnn_batch(cfg, 50, 200, 7, step=3), jdata.gnn_batch(jcfg, 50, 200, 7, step=3)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (arch, k)
    assert not np.array_equal(tdata.gnn_batch(cfg, 50, 200, 7, step=4)["edge_src"], got["edge_src"])
    # the data pipeline stays numpy only: it reads D_OUT without torch
    code = "import sys, repro_torch.train.data; print('torch' in sys.modules)"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    assert out.strip() == "False"


def test_make_train_step_matches_the_reference_for_gcn(cache):
    cfg, jcfg = _cfgs("gcn-cora")
    ocfg = topt.OptimizerConfig(lr=1e-2)
    batch = _batch("gcn-cora")
    if "step" not in cache:
        params = jax.tree.map(jnp.asarray, _tree("gcn-cora"))
        state = jopt.init_opt_state(params, jopt.OptimizerConfig(lr=1e-2))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        step = jtrainer.make_train_step(jcfg, jopt.OptimizerConfig(lr=1e-2))
        cache["step"] = jax.tree.map(np.asarray, _compile(step, params, state, jbatch)(params, state, jbatch))
    params, state, metrics = cache["step"]
    model = api.params_from_reference(_tree("gcn-cora"), cfg, device="cpu")
    tstate = topt.init_opt_state(model, ocfg)
    got = trainer.make_train_step(cfg, ocfg)(model, tstate, batch)
    assert got.keys() == metrics.keys() == {"loss", "nll", "grad_norm"}
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), metrics[k], rtol=1e-6, atol=1e-6)
    tree = to_numpy(tckpt.training_tree(model, tstate))
    _assert_trees(tree["params"], params, rtol=1e-6, atol=1e-6)
    _assert_trees(tree["opt"], state, rtol=1e-6, atol=1e-6)


def _reference_opt_state(params):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(lambda p: jopt.init_opt_state(p, jopt.OptimizerConfig()), params))


def _random_like(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(rng.integers(1, 100), np.int32).reshape(a.shape)
                        if a.dtype == np.int32 else rng.normal(size=a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("arch", ["mace", "equiformer-v2"])
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    """A GNN training tree saved by the reference restores in the port, and
    one saved by the port restores in the reference, with the same file
    names."""
    cfg, _ = _cfgs(arch)
    jtree = {"params": _random_like(_tree(arch), 1)}
    jtree["opt"] = _random_like(_reference_opt_state(jtree["params"]), 2)
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(5, jtree)
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=4)
    state = topt.init_opt_state(model, topt.OptimizerConfig())
    step, tree, meta = tckpt.CheckpointManager(str(tmp_path / "ref")).restore_latest(
        tckpt.training_tree(model, state))
    assert step == 5 and meta["step"] == 5
    tckpt.load_training_tree(tree, model, state)
    _assert_trees(tckpt.training_tree(model, state), jtree, exact=True)

    saved = tckpt.save(str(tmp_path / "port"), 5, tckpt.training_tree(model, state))
    template = {"params": _tree(arch), "opt": _reference_opt_state(_tree(arch))}
    back, _ = jckpt.restore(saved, template)
    _assert_trees(jax.tree.map(np.asarray, back), jtree, exact=True)
    assert sorted(os.listdir(saved)) == sorted(os.listdir(tmp_path / "ref" / "step_00000005"))


def test_none_leaves_pass_through_the_tree_functions(monkeypatch, tmp_path):
    """MACE with no order-3 path has ``w_b3 = None`` (no config reaches
    it): the model registers it as ``None``, the tree keeps it, the
    flat layout and both packages' checkpoints leave it out."""
    monkeypatch.setattr(tmace, "_order3_paths", lambda l_max: [])
    cfg, _ = _cfgs("mace")
    model = api.GNN(cfg, D_FEAT, device="cpu", seed=5)
    assert model.layers[0].w_b3 is None and model.layers[0]["w_b2"] is not None
    tree = api.to_reference(model)
    assert tree["layers"][1]["w_b3"] is None
    assert not any("w_b3" in k for k in api.unstack_reference(tree))
    _assert_trees(api.to_reference(api.params_from_reference(tree, cfg, device="cpu")), tree, exact=True)
    state = topt.init_opt_state(model, topt.OptimizerConfig())
    loss, _ = api.loss_fn(model, _torch(_batch("mace")), cfg)
    assert np.isfinite(loss.item())
    saved = tckpt.save(str(tmp_path), 1, tckpt.training_tree(model, state))
    assert not any("w_b3" in name for name in os.listdir(saved))
    fresh = api.GNN(cfg, D_FEAT, device="cpu", seed=6)
    fstate = topt.init_opt_state(fresh, topt.OptimizerConfig())
    restored, _ = tckpt.restore(saved, tckpt.training_tree(fresh, fstate))
    tckpt.load_training_tree(restored, fresh, fstate)
    _assert_trees(tckpt.training_tree(fresh, fstate), tckpt.training_tree(model, state), exact=True)
    back, _ = jckpt.restore(saved, to_numpy(tckpt.training_tree(model, state)))
    assert back["params"]["layers"][0]["w_b3"] is None


def test_chip_smoke_sizes_each_gnn_row_from_its_registry_shape():
    """``chip_smoke.py``'s ``gnn_train`` rows: a full graph as it is, the
    sampled shape at ``sampled_sizes(1024, (15, 10))``, 128 molecules
    flattened; every row's arch and shape are in the registry."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sizes = {}
    for arch, shape in smoke.GNN_ROWS:
        spec = {s.name: s for s in registry.get_shapes(arch)}[shape]
        sizes[arch, shape] = smoke.gnn_row_size(spec)
    assert sizes == {
        ("gcn-cora", "full_graph_sm"): (2708, 10556, 1433),
        ("gcn-cora", "ogb_products"): (2_449_029, 61_859_140, 100),
        ("meshgraphnet", "minibatch_lg"): (169_984, 168_960, 602),
        ("equiformer-v2", "molecule"): (3840, 8192, 32),
        ("mace", "molecule"): (3840, 8192, 32),
    }
    assert {a for a, _ in smoke.GNN_ROWS} == set(ARCHS)


STEP_LINE = re.compile(r"\[train\] step (\d+) loss \d+\.\d{4} gnorm \d+\.\d{3} \d+ms")


@pytest.mark.parametrize("arch", ["gcn-cora", "mace"])
def test_train_driver_trains_a_gnn_and_resumes(tmp_path, capsys, arch):
    ckpt = str(tmp_path / "run")
    common_args = ["--arch", arch, "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2",
                   "--log-every", "1"]
    assert launch_train.main(["--steps", "3", *common_args]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [STEP_LINE.fullmatch(x).group(1) for x in lines if x.startswith("[train] step")] == ["0", "1", "2"]
    assert f"[train] checkpoint -> {os.path.join(ckpt, 'step_00000002')}" in lines
    assert lines[-1] == "[train] done"
    assert launch_train.main(["--steps", "4", *common_args]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resumed from step 3"
    assert [STEP_LINE.fullmatch(x).group(1) for x in lines if x.startswith("[train] step")] == ["3"]
    assert lines[-1] == "[train] done"
