"""The port's DeepFM (``repro_torch.models.recsys.deepfm``) against the
reference package on the CPU, at the reduced config (6 fields of 1,000 rows,
dim 8, MLP (32, 32)).

The weights are drawn by the port and handed to both packages as one numpy
tree; batches come from numpy with a seed, as in the reference's
``test_recsys.py``.  The reference's forward, loss, gradients, per-field
bags and retrieval scores come from one compile (``COMPILE_OPTIONS`` of
``test_torch_train.py``).  Tolerance: 1e-5 (rtol and atol).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as j_reduce_config
from repro.models.recsys import deepfm as jdeepfm
from repro_torch.configs import registry
from repro_torch.configs.reduce import reduce_config
from repro_torch.models.recsys import deepfm
from repro_torch.models.common import to_numpy
from repro_torch.train import data, optimizer as opt, trainer

CFG = reduce_config(registry.get_config("deepfm"))
JCFG = j_reduce_config(jregistry.get_config("deepfm"))
TOL = dict(rtol=1e-5, atol=1e-5)
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def _batch(rng, b=16):
    M = CFG.multi_hot
    return {
        "sparse_ids": rng.integers(0, CFG.vocab_per_field, (b, CFG.n_sparse, M)).astype(np.int32),
        "sparse_mask": (rng.random((b, CFG.n_sparse, M)) < 0.7).astype(np.float32),
        "dense_feat": rng.normal(size=(b, CFG.n_dense)).astype(np.float32),
        "labels": rng.integers(0, 2, b).astype(np.int32),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def case():
    """The port's seeded weights (bias set off zero), a batch of 16 with one
    id repeated within a bag, a query of one with 500 candidates, and the
    reference's results on them."""
    model = deepfm.DeepFM(CFG, device="cpu", seed=0)
    with torch.no_grad():
        model.bias.fill_(0.25)
    tree = deepfm.to_reference(model)
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    batch["sparse_ids"][0, 0] = 7  # the same row four times in one bag
    query = _batch(rng, b=1)
    query["candidate_ids"] = rng.integers(0, CFG.vocab_per_field, 500).astype(np.int32)

    def run(p, b, q):
        (loss, aux), grads = jax.value_and_grad(lambda p: jdeepfm.loss_fn(p, b, JCFG), has_aux=True)(p)
        return {"logits": jdeepfm.forward(p, b, JCFG), "loss": loss, "aux": aux, "grads": grads,
                "fields": jdeepfm.field_embeddings(p, b, JCFG),
                "scores": jdeepfm.retrieval_scores(p, q, JCFG)}

    args = [jax.tree.map(jnp.asarray, x) for x in (tree, batch, query)]
    want = jax.jit(run).lower(*args).compile(compiler_options=COMPILE_OPTIONS)(*args)
    return tree, batch, query, jax.tree.map(np.asarray, want)


def test_forward_loss_gradients_and_retrieval_match_the_reference(case):
    tree, batch, query, want = case
    model = deepfm.params_from_reference(tree, CFG, device="cpu")
    tb = _torch(batch)
    with torch.no_grad():
        np.testing.assert_allclose(deepfm.forward(model, tb, CFG).numpy(), want["logits"], **TOL)
        np.testing.assert_allclose(deepfm.field_embeddings(model, tb, CFG).numpy(), want["fields"], **TOL)
        scores = deepfm.retrieval_scores(model, _torch(query), CFG)
    assert scores.shape == (500,)
    np.testing.assert_allclose(scores.numpy(), want["scores"], **TOL)
    loss, aux = deepfm.loss_fn(model, tb, CFG)
    assert aux.keys() == want["aux"].keys() == {"bce"}
    np.testing.assert_allclose(loss.item(), want["loss"], **TOL)
    loss.backward()
    grads = to_numpy(deepfm.reference_tree({n: p.grad for n, p in model.named_parameters()}))
    flat, jflat = deepfm.unstack_reference(grads), deepfm.unstack_reference(want["grads"])
    assert flat.keys() == jflat.keys()
    for name in flat:
        np.testing.assert_allclose(flat[name], jflat[name], err_msg=name, **TOL)
    assert grads["bias"].shape == ()


def test_embedding_bag_masks():
    """The reference test's case: masked ids drop out, repeated ids count
    every time; and the reference's own ``embedding_bag`` on the same."""
    table = np.random.default_rng(2).normal(size=(50, 8)).astype(np.float32)
    ids = np.array([[1, 2, 3], [4, 4, 0]], np.int32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    out = deepfm.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[0], table[1] + table[2], rtol=1e-6)
    np.testing.assert_allclose(out[1], 2 * table[4] + table[0], rtol=1e-6)
    want = jdeepfm.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-6)


def test_fm_term_is_the_pairwise_sum(case):
    """With the MLP's last layer and every first-order weight zeroed, the
    logit is the bias plus the FM term: the sum over field pairs of their
    bags' inner products."""
    tree, batch, _, _ = case
    model = deepfm.params_from_reference(tree, CFG, device="cpu")
    with torch.no_grad():
        for p in (model.mlp[-1]["w"], model.mlp[-1]["b"], model.w1_tables, model.w1_dense):
            p.zero_()
        v = deepfm.field_embeddings(model, _torch(batch), CFG).double().numpy()
        got = deepfm.forward(model, _torch(batch), CFG).numpy()
    pairs = sum((v[:, i] * v[:, j]).sum(-1) for i in range(CFG.n_sparse) for j in range(i + 1, CFG.n_sparse))
    np.testing.assert_allclose(got, 0.25 + pairs, rtol=1e-5, atol=1e-6)


def test_training_reduces_loss():
    """The reference test's criterion, through the port's train step (AdamW,
    the trainer's default config) on one fixed batch of 64."""
    model = deepfm.DeepFM(CFG, device="cpu", seed=2)
    cfg = opt.OptimizerConfig()
    state = opt.init_opt_state(model, cfg)
    step = trainer.make_train_step(CFG, cfg)
    batch = data.recsys_batch(CFG, 64, step=0)
    losses = [float(step(model, state, batch)["loss"]) for _ in range(15)]
    assert losses[-1] < losses[0] * 0.95, losses
    assert model.bias.shape == ()


def test_deepfm_parameters_are_seeded_and_round_trip(case):
    a, b = (deepfm.DeepFM(CFG, device="cpu", seed=0) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.tables, deepfm.DeepFM(CFG, device="cpu", seed=1).tables)
    tree = case[0]
    back = deepfm.to_reference(deepfm.params_from_reference(tree, CFG, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(x, y)
    assert all(p.requires_grad for p in a.parameters())


def test_full_width_shapes_on_meta():
    """Every parameter of the full config (39 fields of 10^6 rows), built on
    ``meta``, has the shape of the reference's ``init_params`` leaf."""
    full, jfull = registry.get_config("deepfm"), jregistry.get_config("deepfm")
    model = deepfm.DeepFM(full, device="meta")
    want = jax.eval_shape(lambda: jdeepfm.init_params(jax.random.PRNGKey(0), jfull))
    got = deepfm.reference_tree(dict(model.named_parameters()))
    assert jax.tree.map(lambda a: tuple(a.shape), got) == jax.tree.map(lambda a: tuple(a.shape), want)
    n = sum(p.numel() for p in model.parameters())
    assert n == 39 * 1_000_000 * 11 + 13 + (39 * 10 + 13) * 400 + 2 * 400 * 400 + 400 + 3 * 400 + 1 + 1
