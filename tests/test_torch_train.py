"""The port's LM training path (``repro_torch.train`` and ``launch/train``,
the loss and the remat of ``models/``) against the reference package on the
CPU.

Weights are drawn by the port and handed to both packages as one numpy
tree (norm scales replaced by seeded draws, as in ``test_torch_lm.py``);
inputs come from numpy with a seed.  Each reference function is compiled
once per module, at XLA's backend optimisation level 0 (``_compile``, as in
``test_torch_lm.py``).  Tolerances: the loss and every gradient leaf in f32
within rtol 1e-4 and atol 1e-6; the bf16 loss within 2e-2; optimizer
parameters and decoded moments within 1e-6, bf16 moments bit-equal; int8
codes equal and their scales within 1e-7.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as j_reduce_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig, TransformerConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.common import to_numpy
from repro_torch.models.weights import params_from_reference, reference_tree, to_reference
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = [a for a, c in registry.ARCHS.items() if isinstance(c, TransformerConfig)]
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 24


# XLA's backend optimisation level 0 (as in test_torch_lm.py) and the CPU's
# older loop emitters instead of its fusion emitters: the same programs,
# compiled in about half the time (the five LMs' gradients: 25 s against 46 s
# on one core), whose gradients differ from the default build's by float
# rounding only (2e-8 on gemma's).
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``COMPILE_OPTIONS``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE_OPTIONS)


def _cfgs(arch: str, dtype: str | None = None):
    cfg = reduce_config(registry.get_config(arch))
    jcfg = j_reduce_config(jregistry.get_config(arch))
    if dtype:
        cfg, jcfg = (dataclasses.replace(c, dtype=dtype) for c in (cfg, jcfg))
    return cfg, jcfg


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _assert_trees(got, want, exact: bool = False, **tol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path in want:
        if exact:
            assert np.array_equal(got[path], want[path]), path
        else:
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


@pytest.fixture(scope="module")
def cache():
    return {}


def _tree(arch: str):
    """The port's seeded weights as the reference's numpy tree, the norm
    scales drawn so that the ``(1 + scale)`` form is exercised."""
    cfg, _ = _cfgs(arch)
    tree = to_reference(ttf.Transformer(cfg, device="cpu", seed=LM_ARCHS.index(arch)))
    rng = np.random.default_rng(200 + LM_ARCHS.index(arch))

    def perturb(node, name=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        return rng.normal(0.0, 0.1, node.shape).astype(np.float32) if "norm" in name else node

    return perturb(tree)


def _batch(arch: str):
    """Tokens and targets (B, S), three targets masked with -1."""
    cfg, _ = _cfgs(arch)
    rng = np.random.default_rng(300 + LM_ARCHS.index(arch))
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :3] = -1
    return {"tokens": toks[:, :-1], "targets": targets}


BF16_ARCH = "smollm-360m"  # the arch the card trains in bf16


def _jax_lm(cache, arch: str):
    """The reference's f32 ``loss_fn`` value, metrics and gradients and, for
    ``BF16_ARCH``, its bf16 loss (else None), from one compile per arch.
    (``test_torch_lm.py`` holds every arch's bf16 logits.)"""
    key = ("lm", arch)
    if key not in cache:
        _, jcfg32 = _cfgs(arch, "float32")
        _, jcfg16 = _cfgs(arch, "bfloat16")
        params = jax.tree.map(jnp.asarray, _tree(arch))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}

        def run(p, b):
            (loss, metrics), grads = jax.value_and_grad(
                lambda p: jtf.loss_fn(p, b, jcfg32), has_aux=True)(p)
            if arch != BF16_ARCH:
                return loss, metrics, grads, loss, loss
            head = jtf.lm_head_loss(p, _hidden(arch), b["targets"], jcfg32)
            return loss, metrics, grads, jtf.loss_fn(p, b, jcfg16)[0], head

        loss, metrics, grads, loss16, head = _compile(run, params, batch)(params, batch)
        extra = (float(loss16), float(head)) if arch == BF16_ARCH else (None, None)
        cache[key] = (float(loss), {k: float(v) for k, v in metrics.items()},
                      jax.tree.map(np.asarray, grads), *extra)
    return cache[key]


def _hidden(arch: str) -> np.ndarray:
    """Seeded hidden states (B, S, d) for ``lm_head_loss``."""
    cfg, _ = _cfgs(arch)
    return np.random.default_rng(500).normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _port_grads(model, batch, cfg):
    loss, metrics = ttf.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.item(), {k: v.item() for k, v in metrics.items()}, to_reference(model, grads)


# ---------------------------------------------------------------------- #
# The loss, its gradients and the remat
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_every_gradient_match_the_reference(cache, arch):
    loss, metrics, grads, loss16, head = _jax_lm(cache, arch)
    cfg32, _ = _cfgs(arch, "float32")
    model = params_from_reference(_tree(arch), cfg32, device="cpu")
    got_loss, got_metrics, got_grads = _port_grads(model, _batch(arch), cfg32)
    np.testing.assert_allclose(got_loss, loss, **GRAD)
    assert got_metrics.keys() == metrics.keys() == {"nll", "aux"}
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k], metrics[k], **GRAD)
    _assert_trees(got_grads, grads, **GRAD)
    if loss16 is None:
        return
    cfg16, _ = _cfgs(arch, "bfloat16")
    with torch.no_grad():
        got16, _ = ttf.loss_fn(model, {k: torch.from_numpy(v) for k, v in _batch(arch).items()}, cfg16)
        got_head = ttf.lm_head_loss(model, torch.from_numpy(_hidden(arch)),
                                    torch.from_numpy(_batch(arch)["targets"]), cfg32)
    np.testing.assert_allclose(float(got16), loss16, **BF16)
    np.testing.assert_allclose(float(got_head), head, **GRAD)


def test_blocks_and_attention_chunks_are_recomputed_only_under_grad(monkeypatch):
    """With grad on, ``forward`` checkpoints each block and
    ``chunked_attention`` each chunk; under ``no_grad`` neither does, and
    the logits are the same bits."""
    cfg, _ = _cfgs("internlm2-20b", "float32")
    cfg = dataclasses.replace(cfg, attn_chunk=8)
    model = ttf.Transformer(cfg, device="cpu", seed=4)
    tokens = torch.from_numpy(_batch("internlm2-20b")["tokens"])
    calls = {"block": 0, "chunk": 0}

    def counting(name, real):
        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(ttf, "checkpoint", counting("block", ttf.checkpoint))
    monkeypatch.setattr(tattn, "checkpoint", counting("chunk", tattn.checkpoint))
    with torch.no_grad():
        plain, _ = ttf.forward(model, tokens, cfg)
    assert calls == {"block": 0, "chunk": 0}
    remat, _ = ttf.forward(model, tokens, cfg)
    n_blocks, _ = ttf._block_counts(cfg)
    assert calls["block"] == n_blocks
    assert calls["chunk"] == cfg.n_layers * S // 8
    assert torch.equal(plain, remat.detach())
    remat.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_serving_builds_no_graph_with_grad_enabled(monkeypatch, arch):
    """``prefill_step`` and ``serve_step`` called with grad on (the
    parameters require grad) return logits and cache tensors that do not,
    checkpoint no block, and give the same bits as under ``no_grad``."""
    cfg, _ = _cfgs(arch, "float32")
    model = ttf.Transformer(cfg, device="cpu", seed=6)
    tokens = torch.from_numpy(_batch(arch)["tokens"][:, :4])
    monkeypatch.setattr(ttf, "checkpoint", lambda *a, **k: pytest.fail("serving checkpointed a block"))
    assert torch.is_grad_enabled() and all(p.requires_grad for p in model.parameters())
    prefill = ttf.prefill_step(model, tokens, cfg)
    kv = ttf.init_cache(cfg, B, 4, device="cpu")
    steps = [ttf.serve_step(model, kv, tokens[:, t:t + 1], t, cfg)[0] for t in range(4)]
    assert not prefill.requires_grad and not any(s.requires_grad for s in steps)
    assert not any(c[k].requires_grad for c in kv for k in ("k", "v"))
    with torch.no_grad():
        assert torch.equal(prefill, ttf.prefill_step(model, tokens, cfg))
        kv2 = ttf.init_cache(cfg, B, 4, device="cpu")
        for t in range(4):
            assert torch.equal(steps[t], ttf.serve_step(model, kv2, tokens[:, t:t + 1], t, cfg)[0])


def _qkv(seed, Sq, KV, G, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, Sq, KV * G, hd), (B, Sq, KV, hd), (B, Sq, KV, hd), (B, Sq, KV * G, hd))]


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention_gradient_matches_the_reference(cache, window):
    """The gradients of <out, ct> in q, k and v over four chunks of 16, one
    compile holding both windows."""
    q, k, v, ct = _qkv(9, 64, 2, 3, 8)
    if "attn" not in cache:
        def run(q, k, v, ct):
            def f(window):
                return jax.grad(lambda q, k, v: jnp.sum(jattn.chunked_attention(
                    q, k, v, causal=True, window=window, chunk=16) * ct), argnums=(0, 1, 2))(q, k, v)
            return {w: f(w) for w in (0, 8)}

        args = [jnp.asarray(a) for a in (q, k, v, ct)]
        cache["attn"] = jax.tree.map(np.asarray, _compile(run, *args)(*args))
    want = cache["attn"][window]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=True, window=window, chunk=16)
    (out * torch.from_numpy(ct)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, **GRAD)


MOE = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24, every=1, d_ff_shared=16)


@pytest.mark.parametrize("drop_tokens", [True, False])
def test_moe_gradient_matches_the_reference(cache, drop_tokens):
    """The gradients of <y, ct> + aux in every MoE weight (router, experts,
    shared expert) and in x, with capacity drops on and off: most tokens
    pick expert 0, so drops happen."""
    params = tmoe.moe_params(32, MOE, generator=torch.Generator().manual_seed(5), device="cpu")
    params["router"][:, 0] += 0.5
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 1.0, size=(40, 32)).astype(np.float32)
    ct = rng.normal(size=(40, 32)).astype(np.float32)
    if "moe" not in cache:
        jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}

        def run(p, x, ct):
            def f(drop):
                def loss(p, x):
                    y, aux = jmoe.moe_apply(p, x, MOE, None, drop)
                    return jnp.sum(y * ct) + aux
                return jax.grad(loss, argnums=(0, 1))(p, x)
            return {d: f(d) for d in (True, False)}

        args = (jp, jnp.asarray(x), jnp.asarray(ct))
        cache["moe"] = jax.tree.map(np.asarray, _compile(run, *args)(*args))
    want_p, want_x = cache["moe"][drop_tokens]
    tp = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(tp, tx, MOE, drop_tokens)
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    assert tp.keys() == want_p.keys()
    for name in tp:
        np.testing.assert_allclose(tp[name].grad.numpy(), want_p[name], err_msg=name, **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, **GRAD)
    _, choice = torch.topk(torch.softmax(tx.detach() @ params["router"], -1), MOE.top_k, -1)
    cap = max(4, -(-int(40 * MOE.top_k / MOE.n_experts * MOE.capacity_factor) // 4) * 4)
    assert torch.bincount(choice.reshape(-1)).max() > cap


# ---------------------------------------------------------------------- #
# train/optimizer.py
# ---------------------------------------------------------------------- #


SHAPES = [(3,), (17, 5), (4, 6, 16), ()]


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_q8_codec_matches_the_reference(cache, sqrt_domain):
    rng = np.random.default_rng(11)
    xs = [np.asarray(rng.normal(size=shape) * 3, dtype=np.float32) for shape in SHAPES]
    key = ("q8", sqrt_domain)
    if key not in cache:
        def run(xs):
            encs = [jopt.q8_encode(x, sqrt_domain) for x in xs]
            return encs, [jopt.q8_decode(e, x.shape, sqrt_domain) for e, x in zip(encs, xs)]

        cache[key] = jax.tree.map(np.asarray, _compile(run, xs)(xs))
    encs, decs = cache[key]
    for x, want, want_dec in zip(xs, encs, decs):
        got = topt.q8_encode(torch.from_numpy(x), sqrt_domain)
        assert np.array_equal(got["q"].numpy(), want["q"])
        np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-7, atol=0)
        dec = topt.q8_decode(got, x.shape, sqrt_domain)
        assert dec.shape == x.shape  # the reference's decode of a 0-d x is (1,)
        # q times a scale within 1e-7, squared in the sqrt domain: twice the
        # scale's error and two f32 roundings
        np.testing.assert_allclose(dec.numpy().reshape(-1), want_dec.reshape(-1), rtol=4e-7, atol=0)


def _params(seed: int = 12) -> dict[str, np.ndarray]:
    """A stacked (blocks, layers, d, heads) weight, a matrix and a norm."""
    rng = np.random.default_rng(seed)
    return {"wq": rng.normal(size=(2, 3, 8, 4)).astype(np.float32),
            "w": rng.normal(size=(6, 5)).astype(np.float32),
            "norm": rng.normal(0.0, 0.1, 8).astype(np.float32)}


def _grads(step: int, scale: float = 0.05) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(400 + step)
    return {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in _params().items()}


def _jax_adamw(cache, ocfg, params, state, grads):
    """The reference's ``apply_updates``, one compile per config."""
    key = ("adamw", ocfg)
    if key not in cache:
        jcfg = jopt.OptimizerConfig(**dataclasses.asdict(ocfg))
        cache[key] = _compile(lambda p, g, s: jopt.apply_updates(p, g, s, jcfg), params, grads, state)
    return cache[key](params, grads, state)


def _decode(moments: dict, sqrt: bool) -> dict[str, np.ndarray]:
    return {k: np.asarray(jopt._read(jax.tree.map(jnp.asarray, v), _params()[k].shape, sqrt))
            for k, v in moments.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_apply_updates_matches_the_reference_over_three_steps(cache, moment_dtype):
    """Three AdamW steps from the same seeded gradients: parameters and
    decoded moments within 1e-6, bf16 moments the same bits, int8 codes
    equal."""
    ocfg = topt.OptimizerConfig(lr=1e-2, moment_dtype=moment_dtype)
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    state = topt.init_opt_state(params, ocfg)
    jparams = jax.tree.map(jnp.asarray, _params())
    jstate = jopt.init_opt_state(jparams, jopt.OptimizerConfig(moment_dtype=moment_dtype))
    for step in range(3):
        grads = _grads(step)
        m = topt.apply_updates(params, {k: torch.from_numpy(v) for k, v in grads.items()}, state, ocfg)
        jparams, jstate, jm = _jax_adamw(cache, ocfg, jparams, jstate, jax.tree.map(jnp.asarray, grads))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    _assert_trees(to_numpy(params), jax.tree.map(np.asarray, jparams), rtol=1e-6, atol=1e-6)
    for key, sqrt in (("m", False), ("v", True)):
        got, want = to_numpy(state[key]), jax.tree.map(np.asarray, jstate[key])
        _assert_trees(_decode(got, sqrt), _decode(want, sqrt), rtol=1e-6, atol=1e-6)
        if moment_dtype == "bfloat16":
            assert all(v.dtype == torch.bfloat16 for v in state[key].values())
            _assert_trees(got, {k: v.astype(np.float32) for k, v in want.items()}, exact=True)
        if moment_dtype == "int8":
            _assert_trees({k: v["q"] for k, v in got.items()}, {k: v["q"] for k, v in want.items()},
                          exact=True)


def test_stacked_int8_moments_are_the_reference_encoding():
    """``reference_tree`` of a model's per-layer int8 moments equals the
    reference codec applied to the stacked moments: the scales run along
    the last axis, which stacking leaves alone."""
    cfg, _ = _cfgs("llama4-maverick-400b-a17b")  # dense FFNs, MoE, shared expert
    model = ttf.Transformer(cfg, device="cpu", seed=1)
    ocfg = topt.OptimizerConfig(moment_dtype="int8")
    state = topt.init_opt_state(model, ocfg)
    rng = np.random.default_rng(13)
    grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    topt.apply_updates(model, grads, state, ocfg)
    for key, sqrt in (("m", False), ("v", True)):
        stacked = reference_tree(model, state[key])
        decoded = reference_tree(model, {n: topt.q8_decode(e, model.get_parameter(n).shape, sqrt)
                                         for n, e in state[key].items()})
        want = jax.tree.map(lambda x: topt.q8_encode(x, sqrt), decoded)
        _assert_trees(to_numpy(stacked), to_numpy(want), exact=True)


def test_grad_clip_reports_the_norm_before_clipping(cache):
    cfg = topt.OptimizerConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    g = {k: np.full(v.shape, 1e6, np.float32) for k, v in _params().items()}
    m = topt.apply_updates(params, {k: torch.from_numpy(v) for k, v in g.items()},
                           topt.init_opt_state(params, cfg), cfg)
    jp = jax.tree.map(jnp.asarray, _params())
    jp, _, jm = _jax_adamw(cache, cfg, jp, jopt.init_opt_state(jp, jopt.OptimizerConfig()),
                           jax.tree.map(jnp.asarray, g))
    assert float(m["grad_norm"]) > 1e5  # reported before the clip
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    _assert_trees(to_numpy(params), jax.tree.map(np.asarray, jp), rtol=1e-6, atol=1e-6)


def test_int8_step_keeps_a_0d_parameter_0d(cache):
    """The reference hands a 0-d parameter back as shape (1,) after an int8
    step (``q8_decode``'s ``shape if shape else (1,)``); the port keeps it
    0-d with the reference's value, twice over."""
    cfg = topt.OptimizerConfig(lr=0.1, moment_dtype="int8")
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    params = {"bias": torch.zeros(()), "w": torch.ones(3)}
    jp = {"bias": jnp.zeros(()), "w": jnp.ones(3)}
    state, jstate = topt.init_opt_state(params, cfg), jopt.init_opt_state(jp, jcfg)
    for g_bias in (0.5, -0.25):
        g = {"bias": np.float32(g_bias), "w": np.array([0.1, -0.2, 0.3], np.float32)}
        topt.apply_updates(params, {k: torch.tensor(v) for k, v in g.items()}, state, cfg)
        # the first call takes a 0-d bias, the second the (1,) one it returned
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jp, jstate, _ = _compile(functools.partial(jopt.apply_updates, cfg=jcfg), jp, jg, jstate)(jp, jg, jstate)
    assert params["bias"].shape == () and jp["bias"].shape == (1,)
    np.testing.assert_allclose(params["bias"].numpy().reshape(1), np.asarray(jp["bias"]), rtol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6)
    assert state["m"]["bias"]["q"].shape == (1,)  # stored as the reference stores it


def test_moment_bytes_and_moment_dtypes():
    model = ttf.Transformer(_cfgs("smollm-360m")[0], device="cpu")
    n = sum(p.numel() for p in model.parameters())
    for dtype, per in (("float32", 8), ("bfloat16", 4)):
        assert topt.moment_bytes(topt.init_opt_state(model, topt.OptimizerConfig(moment_dtype=dtype))) == n * per
    int8 = topt.init_opt_state(model, topt.OptimizerConfig(moment_dtype="int8"))
    rows = sum(p.numel() // p.shape[-1] for p in model.parameters())
    assert topt.moment_bytes(int8) == 2 * (n + 4 * rows)


# ---------------------------------------------------------------------- #
# ---------------------------------------------------------------------- #
# train/trainer.py
# ---------------------------------------------------------------------- #


def test_microbatched_step_gradients_equal_the_full_batch(monkeypatch):
    """The gradients the step hands to AdamW: 4 accumulated microbatches of
    2 against one batch of 8 (f32; the reference's test)."""
    cfg, _ = _cfgs("smollm-360m", "float32")
    seen = []
    real = trainer.opt.apply_updates
    monkeypatch.setattr(trainer.opt, "apply_updates",
                        lambda p, g, s, c: seen.append({k: v.clone() for k, v in g.items()}) or real(p, g, s, c))
    ocfg = topt.OptimizerConfig(lr=1e-3)
    batch = tdata.lm_batch(cfg, batch=8, seq=16, step=0)
    metrics = []
    for n_micro in (1, 4):
        model = ttf.Transformer(cfg, device="cpu", seed=0)
        step = trainer.make_train_step(cfg, ocfg, n_micro=n_micro)
        b = batch if n_micro == 1 else {k: v.reshape(4, 2, 16) for k, v in batch.items()}
        metrics.append(step(model, topt.init_opt_state(model, ocfg), b))
    full, micro = metrics
    assert full.keys() == {"loss", "nll", "aux", "grad_norm"} and micro.keys() == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(full["loss"]), float(micro["loss"]), rtol=1e-6)
    assert seen[0].keys() == seen[1].keys()
    for name in seen[0]:
        np.testing.assert_allclose(seen[0][name].numpy(), seen[1][name].numpy(), err_msg=name, **GRAD)


def test_make_loss_fn_refuses_the_gnn_family():
    """The GNN family is no longer refused: a ``GNNConfig`` goes to the GNN
    loss (``tests/test_torch_gnn.py`` holds it against the reference); a
    config of no trainable family still is."""
    from repro_torch.models.gnn import api as gnn_api

    cfg = reduce_config(registry.get_config("gcn-cora"))
    model = gnn_api.GNN(cfg, 16, device="cpu", seed=0)
    batch = trainer.to_device(tdata.gnn_batch(cfg, 32, 64, 16, step=0), "cpu")
    loss, metrics = trainer.make_loss_fn(cfg)(model, batch)
    assert metrics.keys() == {"nll"} and torch.equal(loss, gnn_api.loss_fn(model, batch, cfg)[0])
    with pytest.raises(TypeError):
        trainer.make_loss_fn(registry.get_config("cfpq"))


def _run(model, state, step_fn, cfg, start: int, stop: int):
    for s in range(start, stop):
        step_fn(model, state, tdata.lm_batch(cfg, batch=4, seq=16, step=s))


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_restart_from_a_checkpoint_is_bitwise(tmp_path, moment_dtype):
    """3 steps, a checkpoint, a fresh model and optimizer restored from it
    and 3 more steps equal 6 uninterrupted steps bit for bit."""
    cfg, _ = _cfgs("smollm-360m")
    ocfg = topt.OptimizerConfig(lr=1e-3, moment_dtype=moment_dtype)
    step_fn = trainer.make_train_step(cfg, ocfg)
    ref = ttf.Transformer(cfg, device="cpu", seed=0)
    ref_state = topt.init_opt_state(ref, ocfg)
    _run(ref, ref_state, step_fn, cfg, 0, 6)

    model = ttf.Transformer(cfg, device="cpu", seed=0)
    state = topt.init_opt_state(model, ocfg)
    _run(model, state, step_fn, cfg, 0, 3)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(3, tckpt.training_tree(model, state))
    fresh = ttf.Transformer(cfg, device="cpu", seed=9)
    fresh_state = topt.init_opt_state(fresh, ocfg)
    step, tree, _ = mgr.restore_latest(tckpt.training_tree(fresh, fresh_state))
    assert step == 3
    tckpt.load_training_tree(tree, fresh, fresh_state)
    _assert_trees(to_numpy(tckpt.training_tree(fresh, fresh_state)),
                  to_numpy(tckpt.training_tree(model, state)), exact=True)
    _run(fresh, fresh_state, step_fn, cfg, 3, 6)
    _assert_trees(to_numpy(tckpt.training_tree(fresh, fresh_state)),
                  to_numpy(tckpt.training_tree(ref, ref_state)), exact=True)


# ---------------------------------------------------------------------- #
# train/checkpoint.py: the reference's on-disk format, both ways
# ---------------------------------------------------------------------- #


def _reference_opt_state(params, moment_dtype: str):
    """The shapes and dtypes of the reference's ``init_opt_state`` (traced,
    not run)."""
    cfg = jopt.OptimizerConfig(moment_dtype=moment_dtype)
    return jax.eval_shape(lambda p: jopt.init_opt_state(p, cfg), params)


def _random_like(tree, seed: int):
    rng = np.random.default_rng(seed)

    def draw(a):
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if a.dtype == np.int32:
            return np.asarray(rng.integers(1, 100), np.int32).reshape(a.shape)
        return np.abs(rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree.map(draw, tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, moment_dtype):
    cfg, _ = _cfgs("smollm-360m")
    ocfg = topt.OptimizerConfig(moment_dtype=moment_dtype)
    jtree = {"params": _tree("smollm-360m")}
    jtree["opt"] = _random_like(_reference_opt_state(jtree["params"], moment_dtype), 1)
    jckpt.CheckpointManager(str(tmp_path)).save(5, jtree)
    model = ttf.Transformer(cfg, device="cpu", seed=3)
    state = topt.init_opt_state(model, ocfg)
    step, tree, meta = tckpt.CheckpointManager(str(tmp_path)).restore_latest(
        tckpt.training_tree(model, state))
    assert step == 5 and meta["step"] == 5
    tckpt.load_training_tree(tree, model, state)
    _assert_trees(to_numpy(tckpt.training_tree(model, state)), jtree, exact=True)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, moment_dtype):
    """The port writes the reference's file names and manifest; the
    reference restores the same values (bf16 moments, saved as their f32
    values, come back as the same bits)."""
    cfg, _ = _cfgs("smollm-360m")
    ocfg = topt.OptimizerConfig(moment_dtype=moment_dtype)
    model = ttf.Transformer(cfg, device="cpu", seed=2)
    state = topt.init_opt_state(model, ocfg)
    rng = np.random.default_rng(6)
    for key in ("m", "v"):
        for name, leaf in state[key].items():
            if isinstance(leaf, dict):
                leaf["q"].copy_(torch.from_numpy(rng.integers(-127, 128, tuple(leaf["q"].shape)).astype(np.int8)))
                leaf["scale"].copy_(torch.rand(leaf["scale"].shape))
            else:
                leaf.copy_(torch.randn(leaf.shape))
    state["step"] = torch.tensor(7, dtype=torch.int32)
    saved = tckpt.save(str(tmp_path / "port"), 7, tckpt.training_tree(model, state))

    params = to_reference(model)
    template = {"params": params, "opt": jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), _reference_opt_state(params, moment_dtype))}
    tree, meta = jckpt.restore(saved, template)
    want = to_numpy(tckpt.training_tree(model, state))
    _assert_trees(jax.tree.map(lambda a: np.asarray(a).astype(np.float32) if a.dtype == jnp.bfloat16
                               else np.asarray(a), tree), want, exact=True)
    assert jax.tree.map(lambda a: a.dtype, tree) == jax.tree.map(lambda a: a.dtype, template)
    if moment_dtype == "bfloat16":
        assert set(meta["dtypes"]) == {k for k in meta["manifest"] if k.startswith("['opt']['m']")
                                       or k.startswith("['opt']['v']")}
    if moment_dtype != "bfloat16":  # the reference cannot save a bf16 leaf to numpy
        jckpt.save(str(tmp_path / "ref"), 7, tree)
        assert sorted(os.listdir(tmp_path / "ref" / "step_00000007")) == sorted(os.listdir(saved))


def test_checkpoint_keeps_the_newest_and_ignores_partial_saves(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.arange(3.0)})
    assert mgr.steps() == [3, 4] and mgr.latest() == 4
    os.makedirs(tmp_path / "tmp-7")
    assert mgr.latest() == 4
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path / "step_00000004"), {"x": torch.zeros(4)})


# ---------------------------------------------------------------------- #
# train/data.py
# ---------------------------------------------------------------------- #


def test_batches_equal_the_reference_under_the_port_seed(monkeypatch):
    """With the reference's ``_rng`` swapped for the port's (in this test
    only), both pipelines draw the same batches."""
    monkeypatch.setattr(jdata, "_rng", tdata._rng)
    cfg = registry.get_config("smollm-360m")
    jcfg = jregistry.get_config("smollm-360m")
    for n_micro in (1, 2):
        got = tdata.lm_batch(cfg, 4, 16, step=3, n_micro=n_micro)
        want = jdata.lm_batch(jcfg, 4, 16, step=3, n_micro=n_micro)
        _assert_trees(got, want, exact=True)
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    rs, jrs = (reduce_config(registry.get_config("deepfm")),
               j_reduce_config(jregistry.get_config("deepfm")))
    _assert_trees(tdata.recsys_batch(rs, 32, step=5), jdata.recsys_batch(jrs, 32, step=5), exact=True)
    assert not np.array_equal(tdata.lm_batch(cfg, 4, 16, step=4)["tokens"],
                              tdata.lm_batch(cfg, 4, 16, step=3)["tokens"])


def test_port_batches_do_not_depend_on_the_hash_seed():
    """Two processes with different ``PYTHONHASHSEED`` draw the same batch
    (the reference seeds from ``hash(arch_id)``, which they salt
    differently)."""
    code = ("import hashlib, sys; from repro_torch.configs import registry; "
            "from repro_torch.train import data; "
            "b = data.lm_batch(registry.get_config('smollm-360m'), 2, 8, step=1); "
            "print(hashlib.sha256(b['tokens'].tobytes()).hexdigest(), hash('smollm-360m'))")
    out = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=str(ROOT / "src"))
        out.append(subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                                  text=True, check=True, timeout=60).stdout.split())
    assert out[0][0] == out[1][0]
    assert out[0][1] != out[1][1]  # what the reference's seed is made from
    want = hashlib.sha256(tdata.lm_batch(registry.get_config("smollm-360m"), 2, 8, step=1)["tokens"]
                          .tobytes()).hexdigest()
    assert out[0][0] == want


# ---------------------------------------------------------------------- #
# launch/train.py
# ---------------------------------------------------------------------- #

STEP_LINE = re.compile(r"\[train\] step (\d+) loss \d+\.\d{4} gnorm \d+\.\d{3} \d+ms")


def test_train_driver_prints_the_reference_lines_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    common = ["--device", "cpu", "--batch", "2", "--seq", "8", "--ckpt-dir", ckpt,
              "--ckpt-every", "2", "--log-every", "1"]
    assert launch_train.main(["--steps", "3", *common]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [STEP_LINE.fullmatch(x).group(1) for x in lines if x.startswith("[train] step")] == ["0", "1", "2"]
    assert f"[train] checkpoint -> {os.path.join(ckpt, 'step_00000002')}" in lines
    assert lines[-1] == "[train] done"
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    assert launch_train.main(["--steps", "5", *common]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resumed from step 3"
    assert [STEP_LINE.fullmatch(x).group(1) for x in lines if x.startswith("[train] step")] == ["3", "4"]
    assert lines[-1] == "[train] done"


def test_train_driver_flags_stragglers_and_trains_deepfm(capsys, monkeypatch):
    """A fake clock makes step 6 take 5 s against 1 s for the others."""
    ticks = iter(np.cumsum([x for s in range(8) for x in (0.0, 5.0 if s == 6 else 1.0)]).tolist())
    monkeypatch.setattr(launch_train, "time", types.SimpleNamespace(time=lambda: next(ticks)))
    assert launch_train.main(["--arch", "deepfm", "--device", "cpu", "--steps", "8",
                              "--batch", "16", "--log-every", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "[train] step 0 " + lines[0].split("step 0 ")[1],
        "[train] step 4 " + lines[1].split("step 4 ")[1],
        "[train] WARN step 6 straggled: 5.000s vs p50 1.000s",
        "[train] step 7 " + lines[3].split("step 7 ")[1],
        "[train] done",
    ]
    assert all(STEP_LINE.fullmatch(lines[i]) for i in (0, 1, 3))
    with pytest.raises(SystemExit, match="not trainable"):
        launch_train.main(["--arch", "cfpq", "--device", "cpu"])
    assert launch_train.parse_args(["--no-reduced"]).reduced is False
    assert launch_train.parse_args([]).reduced is True and launch_train.parse_args([]).device == "cuda"


def test_chip_smoke_counts_the_model_flops_of_a_train_step():
    """``chip_smoke.py``'s mfu numerator for the full smollm at train_4k's
    sequence: 6 x the matmul parameters (all but the embedding and the norm
    scales) x tokens, plus 12 x H x hd per causal (query, key) pair."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = registry.get_config("smollm-360m")
    got = smoke.lm_train_flops(cfg, 8, 4096)
    matmul = cfg.param_count() - cfg.vocab * cfg.d_model - (2 * cfg.n_layers + 1) * cfg.d_model
    assert got["matmul_params"] == matmul == 361_758_720
    pairs = cfg.n_layers * 4096 * 4097 // 2
    assert got["flops"] == 6 * matmul * 8 * 4096 + 12 * cfg.n_heads * cfg.hd * pairs * 8
    # a local layer counts only the pairs inside its window
    gemma = reduce_config(registry.get_config("gemma3-12b"))
    local = smoke.lm_train_flops(gemma, 1, 40)["attention_flops"]
    n_local = sum(gemma.layer_is_local(i) for i in range(gemma.n_layers))
    want = 12 * gemma.n_heads * gemma.hd * ((gemma.n_layers - n_local) * 40 * 41 // 2
                                            + n_local * sum(min(i + 1, gemma.window) for i in range(40)))
    assert local == want and n_local == gemma.local_global_ratio
