"""The port's LM serving path (``repro_torch.configs``, ``models`` and
``launch.serve``) against the reference package on the CPU.

The weights are drawn once per arch by the port (``Transformer(seed)``),
their norm scales replaced by seeded numpy draws so the ``(1 + scale)``
form is exercised, and handed to both packages as the same numpy tree;
inputs come from numpy with a seed.  Each JAX result is computed once, in a
module-scoped cache, by one compile per (arch, dtype) that also holds the
MoE prefill.  The reference's jitted functions are compiled at XLA's
backend optimisation level 0 (``_compile``): the same program, built in
about half the time, whose results differ from the default level's by
float rounding only (up to 1.2e-6 in f32 and one bf16 step in bf16 on the
reduced forwards).  Tolerances: f32 within 1e-4 (rtol and atol), the
configs' own bf16 within 2e-2 (the reference's ``test_lm_smoke.py``).
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as j_reduce_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig, TransformerConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.core.matrices import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.weights import params_from_reference, reference_tree, to_reference

LM_ARCHS = [a for a, c in registry.ARCHS.items() if isinstance(c, TransformerConfig)]
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 24
S_ROLL = 40  # gemma past its reduced window of 16: the local caches roll


def _cfgs(arch: str, dtype: str | None = None):
    """(the port's, the reference's) reduced config, in ``dtype`` if given."""
    cfg = reduce_config(registry.get_config(arch))
    jcfg = j_reduce_config(jregistry.get_config(arch))
    if dtype:
        cfg, jcfg = (dataclasses.replace(c, dtype=dtype) for c in (cfg, jcfg))
    return cfg, jcfg


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _seq_len(arch: str) -> int:
    return S_ROLL if arch == "gemma3-12b" else S


@pytest.fixture(scope="module")
def cache():
    """Results computed once per module: the numpy weight trees and the
    reference's logits, keyed by what produced them."""
    return {}


def _tree(cache, arch: str):
    key = ("tree", arch)
    if key not in cache:
        cfg, _ = _cfgs(arch)
        tree = to_reference(ttf.Transformer(cfg, device="cpu", seed=LM_ARCHS.index(arch)))
        rng = np.random.default_rng(100 + LM_ARCHS.index(arch))

        def perturb(node, name=""):
            if isinstance(node, dict):
                return {k: perturb(v, k) for k, v in node.items()}
            if "norm" in name:
                return rng.normal(0.0, 0.1, node.shape).astype(np.float32)
            return node

        cache[key] = perturb(tree)
    return cache[key]


def _tokens(arch: str, seq: int) -> np.ndarray:
    cfg, _ = _cfgs(arch)
    return np.random.default_rng(7 + seq).integers(0, cfg.vocab, (B, seq))


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's backend optimisation
    level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _jax_forward(cache, arch: str, dtype: str, tokens: np.ndarray):
    """The reference's forward logits and aux loss over ``tokens`` and, for
    a MoE arch in f32, its ``prefill_step`` (capacity drops on; else the
    forward's last position): one compile per (arch, dtype, shape)."""
    key = ("forward", arch, dtype, tokens.shape)
    if ("jax_tree", arch) not in cache:
        cache[("jax_tree", arch)] = _jax_tree(_tree(cache, arch))
    params, jtokens = cache[("jax_tree", arch)], jnp.asarray(tokens)
    if key not in cache:
        _, jcfg = _cfgs(arch, dtype)

        def run(p, t):
            logits, aux = jtf.forward(p, t, jcfg)
            if jcfg.moe and dtype == "float32":  # the prefill test's case
                return logits, aux, jtf.prefill_step(p, t, jcfg)
            return logits, aux, logits[:, -1]

        cache[key] = _compile(run, params, jtokens)
    logits, aux, prefill = cache[key](params, jtokens)
    return np.asarray(logits), float(aux), np.asarray(prefill)


# ---------------------------------------------------------------------- #
# Configs
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", list(jregistry.ARCHS))
def test_configs_equal_the_reference(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(j_reduce_config(jcfg))
    assert [dataclasses.asdict(s) for s in registry.get_shapes(arch)] == \
        [dataclasses.asdict(s) for s in jregistry.get_shapes(arch)]
    if isinstance(cfg, TransformerConfig):
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert ttf._block_counts(cfg) == jtf._block_counts(jcfg)


def test_registry_cells_equal_the_reference():
    def plain(cells):
        return [(a, dataclasses.asdict(s), skip) for a, s, skip in cells]

    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    assert plain(registry.all_cells()) == plain(jregistry.all_cells())


# ---------------------------------------------------------------------- #
# models/common.py
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(0.0, 0.3, 16).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else BF16
    got = tcommon.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    want = jcommon.rms_norm(jx, jnp.asarray(scale), 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    got = tcommon.rope(tx, torch.from_numpy(pos), 10_000.0)
    want = jcommon.rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_mlp_apply_matches_the_reference():
    layers = tcommon.mlp_params((12, 20, 7), generator=torch.Generator().manual_seed(3), device="cpu")
    x = np.random.default_rng(3).normal(size=(5, 12)).astype(np.float32)
    got = tcommon.mlp_apply(layers, torch.from_numpy(x))
    jlayers = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in layers]
    want = jcommon.mlp_apply(jlayers, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert [tuple(layer["w"].shape) for layer in layers] == [(12, 20), (20, 7)]


def test_dense_init_is_a_seeded_truncated_fan_in_normal():
    def draw(seed):
        return tcommon.dense_init((400, 300), generator=torch.Generator().manual_seed(seed), device="cpu")

    w = draw(0)
    assert torch.equal(w, draw(0)) and not torch.equal(w, draw(1))
    std = 400**-0.5
    assert w.abs().max() <= 2 * std + 1e-7
    # a standard normal cut at +-2 has std 0.8796
    assert abs(w.std().item() / std - 0.8796) < 0.01
    meta = tcommon.dense_init((400, 300), generator=None, device="meta")
    assert meta.is_meta and meta.shape == (400, 300)


# ---------------------------------------------------------------------- #
# models/attention.py
# ---------------------------------------------------------------------- #


def _qkv(seed, Bq, Sq, Sk, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bq, Sq, KV * G, hd)).astype(np.float32),
            rng.normal(size=(Bq, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(Bq, Sk, KV, hd)).astype(np.float32))


def _both(fn_t, fn_j, arrays, dtype="float32", **kw):
    got = fn_t(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), **kw)
    jarrays = [jnp.asarray(a).astype(dtype) for a in arrays]
    want = _compile(functools.partial(fn_j, **kw), *jarrays)(*jarrays)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("gqa", [1, 4])
def test_chunked_attention_matches_the_reference(window, gqa):
    arrays = _qkv(3, 2, 64, 64, 2, gqa, 8)
    got, want = _both(tattn.chunked_attention, jattn.chunked_attention, arrays,
                      causal=True, window=window, chunk=16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got, want = _both(tattn.reference_attention, jattn.reference_attention, arrays,
                      causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    oracle = tattn.reference_attention(*(torch.from_numpy(a) for a in arrays), causal=True, window=window)
    np.testing.assert_allclose(got, oracle.numpy(), rtol=1e-4, atol=1e-5)


def test_chunked_attention_in_bf16_matches_the_reference():
    got, want = _both(tattn.chunked_attention, jattn.chunked_attention, _qkv(4, 2, 32, 32, 2, 3, 16),
                      "bfloat16", causal=True, window=0, chunk=8)
    np.testing.assert_allclose(got, want, **BF16)


def test_banded_attention_matches_the_reference_and_the_masked_oracle():
    arrays = _qkv(7, 2, 128, 128, 2, 3, 8)
    got, want = _both(tattn.banded_attention, jattn.banded_attention, arrays, window=32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    oracle = tattn.reference_attention(*(torch.from_numpy(a) for a in arrays), causal=True, window=32)
    np.testing.assert_allclose(got, oracle.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("pos", [0, 3, 7, 8, 13, 29])
def test_decode_attention_matches_the_reference(cache, window, pos):
    """A cache of 8 slots: below 8 the slot arithmetic's modulo operand is
    negative (a floor modulo), past it the cache rolls."""
    q, k, v = _qkv(11 + pos, 2, 1, 8, 2, 3, 16)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos,
                                 window=window)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    if ("decode", window) not in cache:  # the position is traced, as in serve_step
        cache[("decode", window)] = _compile(
            functools.partial(jattn.decode_attention, window=window), *args)
    want = cache[("decode", window)](*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------- #
# models/moe.py
# ---------------------------------------------------------------------- #

MOE = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24, every=1, d_ff_shared=16)


def _moe_inputs():
    params = tmoe.moe_params(32, MOE, generator=torch.Generator().manual_seed(5), device="cpu")
    # inputs with a positive mean and a router column that adds them up: most
    # tokens pick expert 0, so capacity really drops pairs
    params["router"][:, 0] += 0.5
    x = np.random.default_rng(5).normal(0.5, 1.0, size=(40, 32)).astype(np.float32)
    return params, x


def _jax_moe(cache, params, x: np.ndarray, dtype: str):
    """The reference's ``moe_apply`` with capacity drops on and off, one
    compile per dtype."""
    key = ("moe", dtype)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jx = jnp.asarray(x).astype(dtype)
    if key not in cache:
        cache[key] = _compile(lambda p, x: {drop: jmoe.moe_apply(p, x, MOE, None, drop)
                                            for drop in (True, False)}, jparams, jx)
    return cache[key](jparams, jx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop_tokens", [True, False])
def test_moe_apply_matches_the_reference(cache, drop_tokens, dtype):
    params, x = _moe_inputs()
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y, aux = tmoe.moe_apply(params, tx, MOE, drop_tokens)
    jy, jaux = _jax_moe(cache, params, x, dtype)[drop_tokens]
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **tol)
    # the case drops pairs when capacity applies: expert 0 takes more than cap
    _, choice = torch.topk(torch.softmax(tx.float() @ params["router"], -1), MOE.top_k, -1)
    cap = max(4, -(-int(40 * MOE.top_k / MOE.n_experts * MOE.capacity_factor) // 4) * 4)
    assert torch.bincount(choice.reshape(-1)).max() > cap


# ---------------------------------------------------------------------- #
# models/transformer.py
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_the_reference(cache, arch, dtype):
    seq = _seq_len(arch) if dtype == "float32" else S
    cfg, _ = _cfgs(arch, dtype)
    tokens = _tokens(arch, seq)
    want, want_aux, _ = _jax_forward(cache, arch, dtype, tokens)
    model = params_from_reference(_tree(cache, arch), cfg, device="cpu")
    with torch.no_grad():
        logits, aux = ttf.forward(model, torch.from_numpy(tokens), cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, seq, cfg.vocab)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(logits.numpy(), want, **tol)
    np.testing.assert_allclose(float(aux), want_aux, **tol)


def test_forward_takes_the_banded_path_at_long_sequences(cache, monkeypatch):
    """gemma at S = 8 windows: its local layers go through banded_attention
    (held to the reference's above), and the logits equal those of the
    masked window path."""
    arch, seq = "gemma3-12b", 128
    cfg, _ = _cfgs(arch, "float32")
    tokens = torch.from_numpy(_tokens(arch, seq))
    model = params_from_reference(_tree(cache, arch), cfg, device="cpu")
    calls = []
    monkeypatch.setattr(ttf, "banded_attention",
                        lambda *a: calls.append(1) or tattn.banded_attention(*a))
    with torch.no_grad():
        banded, _ = ttf.forward(model, tokens, cfg)
        assert len(calls) == cfg.local_global_ratio
        monkeypatch.setattr(ttf, "banded_attention", lambda q, k, v, w: tattn.chunked_attention(
            q, k, v, causal=True, window=w, chunk=cfg.attn_chunk))
        masked, _ = ttf.forward(model, tokens, cfg)
    np.testing.assert_allclose(banded.numpy(), masked.numpy(), **F32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_step_reproduces_the_reference_forward(cache, arch):
    """Token-by-token decode in f32 equals the reference's teacher-forced
    logits at every step (gemma at S = 40, past its window, so its local
    caches roll), with the same greedy tokens."""
    seq = _seq_len(arch)
    cfg, _ = _cfgs(arch, "float32")
    tokens = _tokens(arch, seq)
    want, _, _ = _jax_forward(cache, arch, "float32", tokens)
    model = params_from_reference(_tree(cache, arch), cfg, device="cpu")
    kv = ttf.init_cache(cfg, B, seq, device="cpu")
    if cfg.window:
        assert kv[0]["k"].shape[1] == cfg.window
        assert kv[cfg.local_global_ratio]["k"].shape[1] == seq
    with torch.inference_mode():
        for t in range(seq):
            logits, kv = ttf.serve_step(model, kv, torch.from_numpy(tokens[:, t:t + 1]), t, cfg)
            np.testing.assert_allclose(logits.numpy(), want[:, t], **F32)
            assert np.array_equal(logits.numpy().argmax(-1), want[:, t].argmax(-1))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_prefill_step_matches_the_reference(cache, arch):
    """Last-token logits, with capacity-drop MoE dispatch (a dense arch's
    prefill is the forward's last position)."""
    cfg, _ = _cfgs(arch, "float32")
    tokens = _tokens(arch, S)
    want = _jax_forward(cache, arch, "float32", tokens)[2]
    with torch.no_grad():
        got = ttf.prefill_step(params_from_reference(_tree(cache, arch), cfg, device="cpu"),
                               torch.from_numpy(tokens), cfg)
    assert got.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **F32)


# ---------------------------------------------------------------------- #
# models/weights.py and the full configs
# ---------------------------------------------------------------------- #


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_width_shapes_on_meta(arch):
    """Every parameter of the full config, built on ``meta``, has the shape
    of the reference's ``init_params`` leaf it unstacks from."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    model = ttf.Transformer(cfg, device="meta")
    want = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    assert _flat(reference_tree(model)) == _flat(want)
    n = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the q/k norm scales (two head_dim vectors a layer)
    qk_norms = cfg.n_layers * 2 * cfg.hd if cfg.qk_norm else 0
    assert n == cfg.param_count() + qk_norms
    if arch == "smollm-360m":
        assert n == 409_007_040


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_step_bound_is_what_a_step_must_move():
    """``chip_smoke.py``'s decode-step bound for the full smollm: the stored
    f32 weights once (the embedding's rows only), the attended cache slots
    and the logits; the code's own traffic adds the bf16 casts."""
    smoke = _load(Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cfg = registry.get_config("smollm-360m")
    batch, prompt_len, gen = 4, 32, 16
    got = smoke.lm_step_traffic(cfg, batch, prompt_len, gen)
    n, embed = cfg.param_count(), cfg.vocab * cfg.d_model
    slot = batch * cfg.n_kv_heads * cfg.hd * 2
    mean_pos = prompt_len + (gen - 1) / 2
    want = ((n - embed) * 4 + batch * cfg.d_model * 4 + batch * 8 + batch * cfg.vocab * 4
            + cfg.n_layers * 2 * (mean_pos + 1) * slot)
    assert got["need_bytes"] == pytest.approx(want, rel=1e-12)
    assert got["bound_by"] == "bytes" and got["bound_ms"] == pytest.approx(want / 3.35e9)
    # each weight of the blocks 4 + 2 + 2 bytes, the unembedding 16
    assert got["impl_bytes"] > 2 * (n - embed) * 4
    f32 = smoke.lm_step_traffic(dataclasses.replace(cfg, dtype="float32"), batch, prompt_len, gen)
    assert f32["impl_bytes"] >= f32["need_bytes"] > got["need_bytes"]
    with pytest.raises(ValueError, match="routing"):
        smoke.lm_step_traffic(registry.get_config("qwen3-moe-235b-a22b"), batch, prompt_len, gen)


def test_weights_round_trip(cache):
    arch = "llama4-maverick-400b-a17b"  # dense FFNs, MoE and a shared expert
    tree = _tree(cache, arch)
    cfg, _ = _cfgs(arch)
    model = params_from_reference(tree, cfg, device="cpu")
    back = to_reference(model)
    assert _flat(tree) == _flat(back)
    for leaf, got in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert np.array_equal(leaf, got)
    assert all(p.requires_grad for p in model.parameters())  # ordinary trainable parameters
    blocks = dict(tree["blocks"])
    blocks["moe"] = {k: v for k, v in blocks["moe"].items() if k != "ws_up"}
    with pytest.raises(RuntimeError, match="ws_up"):
        params_from_reference({**tree, "blocks": blocks}, cfg, device="cpu")


def test_transformer_is_seeded():
    cfg, _ = _cfgs("smollm-360m")
    a, b = (ttf.Transformer(cfg, device="cpu", seed=s) for s in (0, 0))
    c = ttf.Transformer(cfg, device="cpu", seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)


# ---------------------------------------------------------------------- #
# launch/serve.py and examples/serve_lm_torch.py
# ---------------------------------------------------------------------- #


def test_serve_decodes_the_reference_greedy_tokens(cache):
    """``serve()`` on the CPU: its tokens are the reference forward's greedy
    choices over the sequence it served (f32, 8 + 16 = S tokens)."""
    arch, P, G = "smollm-360m", 8, S - 8
    cfg, _ = _cfgs(arch, "float32")
    res = serve(cfg, B, P, G, device="cpu", seed=3,
                model=params_from_reference(_tree(cache, arch), cfg, device="cpu"))
    assert res["tokens"].shape == (B, G) and len(res["decode_ms"]) == G
    assert res["prefill_ms"] > 0 and res["p95_ms"] >= res["p50_ms"] > 0
    prompts = res["prompts"]
    # the first greedy token follows the prompt alone (the forward is causal)
    seq = np.concatenate([prompts, np.zeros((B, G), prompts.dtype)], axis=1)
    first = _jax_forward(cache, arch, "float32", seq)[0][:, P - 1].argmax(-1)
    seq = np.concatenate([prompts, first[:, None], res["tokens"][:, :-1]], axis=1)
    logits = _jax_forward(cache, arch, "float32", seq)[0]
    assert np.array_equal(logits[:, P:].argmax(-1), res["tokens"])


def test_serve_is_seeded_and_checks_its_model():
    cfg, _ = _cfgs("internlm2-20b")
    a, b = (serve(cfg, 2, 4, 3, device="cpu", seed=1) for _ in range(2))
    assert np.array_equal(a["prompts"], b["prompts"]) and np.array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="prompt_len"):
        serve(cfg, 2, 0, 3, device="cpu")
    with pytest.raises(ValueError, match="not on"):
        serve(cfg, 2, 4, 3, device="meta", model=ttf.Transformer(cfg, device="cpu"))
    # the model's config decides the shapes; the caller's, the activation dtype
    serve(dataclasses.replace(cfg, dtype="float32"), 2, 4, 3, device="cpu",
          model=ttf.Transformer(cfg, device="cpu"))
    wider = dataclasses.replace(cfg, d_ff=2 * cfg.d_ff)
    with pytest.raises(ValueError, match="another config"):
        serve(wider, 2, 4, 3, device="cpu", model=ttf.Transformer(cfg, device="cpu"))
    with pytest.raises(ValueError, match="another config"):
        ttf.forward(ttf.Transformer(cfg, device="cpu"), torch.zeros((1, 2), dtype=torch.long), wider)


def test_example_serves_with_the_reference_output_lines(capsys):
    ex = _load(Path(__file__).resolve().parents[1] / "examples" / "serve_lm_torch.py")
    assert ex.main(["--device", "cpu", "--arch", "gemma3-12b", "--batch", "2",
                    "--prompt-len", "5", "--gen", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[serve] arch=gemma3-12b batch=2"
    assert lines[1].startswith("[serve] prefill 5 tokens: ") and lines[1].endswith("ms")
    assert lines[2].startswith("[serve] decode latency p50=") and " p95=" in lines[2]
    assert lines[3].startswith("[serve] generated token ids (first row): [")
    assert len(ast.literal_eval(lines[3].split(": ", 1)[1])) == 3
    assert ex.parse_args([]).reduced and ex.parse_args([]).device == "cuda"
    assert not ex.parse_args(["--no-reduced"]).reduced


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg, _ = _cfgs("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.Transformer(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_cache(cfg, 1, 4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, 1, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(to_reference(ttf.Transformer(cfg, device="cpu")), cfg)
