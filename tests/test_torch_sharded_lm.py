"""The port's sharded LM (``repro_torch.shard``, the ``plan`` branches of
``models/``, the sharded train step, the compressed all-reduce and the
elastic checkpoint) against the reference package on the CPU.

Specs are compared on hand-built plans, with no world: the reference's
``param_specs``, ``cache_specs``, ``opt_state_specs`` and ``attn_mode``
equal the port's as tuples for every LM arch at full width.

Everything else runs in gloo worlds of 2 x 2, 1 x 2 and 4 x 1 ranks
(``data`` x ``model``): each rank runs tests/torch_lm_worker.py, which
imports only torch and the port, and the parent holds the results to the
reference.  The four ranks of the 2 x 2 world also build a 2 x 1 x 2
``(pod, data, model)`` mesh, and those of the 4 x 1 world a 2 x 2 x 1
one, and run the pod cases there.  The reference runs on one device, its
jitted functions given a ``MeshPlan`` of the world's sizes built by hand
under a 1 x 1 x 1 ``(pod, data, model)`` mesh of Auto axes: its plan
changes its math only through the MoE's token groups, so that runs the
plan's code paths on one device, and a dense arch's step is the
unsharded one whatever the plan.  The reduced configs
are the reference's ``reduce_config``, in f32, but gemma's, cut to one
local and one global layer (``CUT``).  Tolerances: the loss
and the gradient norm within rtol 1e-5, parameters within rtol 5e-4 and
atol 1e-5 (the reference's own sharded-step test); f32 moments within
rtol 5e-4 and atol 1e-4 of the leaf's largest magnitude (a gradient off
by a constant factor, which AdamW's update barely shows, moves every
moment); int8 moments within one code step of the reference's and their
scales within rtol 1e-4;
every replica of a block bit-identical across the ranks that hold it; the
MoE dispatch and prefill logits within rtol 1e-5; the compressed
all-reduce and the checkpoints bit-equal.
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_lm_worker
from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as j_reduce_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.shard import plans as jplans
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig, TransformerConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.launch.mesh import production_plan
from repro_torch.models import transformer as ttf
from repro_torch.models import weights
from repro_torch.shard.plans import MeshPlan, local_shard
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = [a for a, c in registry.ARCHS.items() if isinstance(c, TransformerConfig)]
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=5e-4, atol=1e-5)
#: f32 moments: rtol, and atol as a share of the leaf's largest magnitude
MOMENTS = dict(rtol=5e-4, atol_share=1e-4)
B, S = 8, 32

# XLA's backend optimisation level 0 without the CPU fusion emitters, as in
# test_torch_train.py: the same programs, compiled in about half the time
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}
#: the reference's plans, with a pod axis or without, run on one device
#: under this mesh (Auto axes: ``jax.make_mesh`` without ``axis_types``
#: makes Explicit ones, which the reference's sharding constraints reject)
JMESH = jax.make_mesh((1, 1, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)


# ---------------------------------------------------------------------- #
# (a) Specs, on hand-built plans
# ---------------------------------------------------------------------- #

SPEC_PLANS = {"16x16": (1, 16, 16), "2x16x16": (2, 16, 16), "2x2": (1, 2, 2),
              "4x2": (1, 4, 2), "1x4": (1, 1, 4)}


def _plans(name: str):
    pod, data, model = SPEC_PLANS[name]
    kw = dict(pod_axis="pod" if pod > 1 else None, data_axis="data", model_axis="model",
              pod_size=pod, data_size=data, model_size=model)
    port = production_plan(multi_pod=pod > 1) if model == 16 else MeshPlan(**kw)
    return jplans.MeshPlan(**kw), port


def _tuples(tree):
    """A spec tree with every spec a plain tuple (of tuples)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tuple(a) if isinstance(a, tuple) else a for a in tree)


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
@pytest.mark.parametrize("plan", list(SPEC_PLANS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_specs_match_the_reference(arch, plan, decode):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    jplan, tplan = _plans(plan)
    assert (tplan.pod_size, tplan.data_size, tplan.model_size) == SPEC_PLANS[plan]
    assert _tuples(ttf.param_specs(cfg, tplan, decode)) == _tuples(jtf.param_specs(jcfg, jplan, decode))
    for seq_shard in (False, True):
        assert _tuples(ttf.cache_specs(cfg, tplan, seq_shard)) == _tuples(
            jtf.cache_specs(jcfg, jplan, seq_shard))
    assert tplan.attn_mode(cfg.n_heads, cfg.hd, decode) == jplan.attn_mode(jcfg.n_heads, jcfg.hd, decode)
    assert tuple(ttf._x_spec(cfg, tplan)) == tuple(jtf._x_spec(jcfg, jplan))


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@functools.cache
def _shape_tree(cfg):
    """The reference layout's leaf shapes, from the port's model on ``meta``."""
    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else _Shape(node.shape)

    return walk(weights.reference_tree(ttf.Transformer(cfg, device="meta")))


@pytest.mark.parametrize("moment", ["float32", "int8"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_opt_state_specs_match_the_reference(arch, moment):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    shapes = _shape_tree(cfg)
    for plan in ("16x16", "2x2"):
        jplan, tplan = _plans(plan)
        got = topt.opt_state_specs(ttf.param_specs(cfg, tplan), topt.OptimizerConfig(moment_dtype=moment),
                                   shapes)
        want = jopt.opt_state_specs(jtf.param_specs(jcfg, jplan), jopt.OptimizerConfig(moment_dtype=moment),
                                    shapes)
        assert _tuples(got) == _tuples(want)


@pytest.mark.parametrize("env", [{}, {"REPRO_ATTN_FALLBACK": "hd"}, {"REPRO_ATTN_FORCE": "seq"},
                                 {"REPRO_ATTN_FALLBACK": "none"}], ids=lambda e: ",".join(e) or "default")
def test_attn_mode_matches_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for plan in SPEC_PLANS:
        jplan, tplan = _plans(plan)
        for heads in (3, 4, 15, 16, 40, 64):
            for hd in (16, 24, 64, 128):
                for decode in (False, True):
                    assert tplan.attn_mode(heads, hd, decode) == jplan.attn_mode(heads, hd, decode)


# ---------------------------------------------------------------------- #
# The inputs of the worlds
# ---------------------------------------------------------------------- #

#: (mesh shape, arch, moment dtype, n_micro, forced attention mode)
TRAIN_CASES = [
    ((2, 2), "internlm2-20b", "float32", 1, None),
    ((2, 2), "internlm2-20b", "int8", 2, None),
    ((2, 2), "internlm2-20b", "float32", 1, "hd"),
    ((2, 2), "smollm-360m", "float32", 1, None),
    ((2, 2), "qwen3-moe-235b-a22b", "float32", 1, None),
    ((2, 2), "gemma3-12b", "float32", 1, "seq"),
    ((1, 2), "smollm-360m", "float32", 1, None),
    ((1, 2), "internlm2-20b", "float32", 1, None),
    ((4, 1), "internlm2-20b", "float32", 1, None),
    # (pod, data, model) meshes over the ranks of the 2 x 2 and 4 x 1 worlds
    ((2, 1, 2), "smollm-360m", "float32", 1, None),
    ((2, 1, 2), "internlm2-20b", "int8", 2, None),
    ((2, 1, 2), "qwen3-moe-235b-a22b", "float32", 1, None),
    ((2, 1, 2), "gemma3-12b", "float32", 1, "seq"),
    ((2, 2, 1), "smollm-360m", "float32", 1, None),
]
SHAPES = [(2, 2), (1, 2), (4, 1)]
#: the world whose ranks build each pod mesh
POD_HOSTS = {(2, 1, 2): (2, 2), (2, 2, 1): (4, 1)}
#: the microbatched case clips at a quarter, so that clipping (and the
#: global norm it reads) decides the update
CLIP = {2: 0.25}
ELASTIC_SOURCE = ((2, 2), "internlm2-20b", "int8", 2, None)
ELASTIC_SHAPES = [(1, 4), (4, 1), (2, 1, 2)]
#: the same step on the pod mesh, saved there and restored without pods
POD_ELASTIC_SOURCE = ((2, 1, 2), "internlm2-20b", "int8", 2, None)
POD_ELASTIC_SHAPES = [(2, 2), (4, 1)]
#: (mesh shape, tokens per row rank): G = 4 and G = 2 with the experts
#: split, and one group across the row ranks when (T / G) * k < E; on the
#: pod mesh G = 4 over (pod, data), and the one-group path
MOE_CASES = [((4, 1), 16), ((2, 2), 16), ((2, 2), 1), ((2, 2, 1), 16), ((2, 2, 1), 1)]
PREFILL_ARCHS = ["smollm-360m", "qwen3-moe-235b-a22b"]
POD_PREFILL_SHAPE = (2, 1, 2)
COMPRESS_ROUNDS = 30
WORLD_DEADLINE_S = 120

# Ranks fork from a server that has imported torch and the worker once, and
# torch._dynamo, which a rank's first checkpointed forward imports (2 s).
# tests/test_torch_distributed.py preloads its own worker the same way; the
# list of the module imported last wins, so this one names both workers.
_CTX = mp.get_context("forkserver")
_CTX.set_forkserver_preload(["torch", "torch._dynamo", "torch_opt_worker", "torch_lm_worker"])


#: gemma's reduced config cut further, to one local and one global layer
#: (its reduced period of 5 local layers and a global one takes the
#: reference 8 s to compile, this 3 s)
CUT = {"gemma3-12b": dict(local_global_ratio=1, n_layers=2)}


def _cfgs(arch: str):
    kw = dict(CUT.get(arch, {}), dtype="float32")
    cfg = dataclasses.replace(reduce_config(registry.get_config(arch)), **kw)
    jcfg = dataclasses.replace(j_reduce_config(jregistry.get_config(arch)), **kw)
    return cfg, jcfg


@functools.cache
def _tree(arch: str):
    """The port's seeded weights as the reference's numpy tree, the norm
    scales drawn so that the ``(1 + scale)`` form is exercised (cached:
    read only)."""
    cfg, _ = _cfgs(arch)
    tree = weights.to_reference(ttf.Transformer(cfg, device="cpu", seed=LM_ARCHS.index(arch)))
    rng = np.random.default_rng(700 + LM_ARCHS.index(arch))

    def perturb(node, name=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        return rng.normal(0.0, 0.1, node.shape).astype(np.float32) if "norm" in name else node

    return perturb(tree)


def _batch(arch: str, n_micro: int):
    """Tokens and targets (B, S), three targets masked with -1; with
    microbatches (n_micro, B / n_micro, S)."""
    cfg, _ = _cfgs(arch)
    rng = np.random.default_rng(800 + LM_ARCHS.index(arch))
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets}
    if n_micro > 1:
        batch = {k: v.reshape(n_micro, B // n_micro, S) for k, v in batch.items()}
    return batch


MOE = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, every=1, d_ff_shared=8, capacity_factor=1.0)


def _moe_inputs(shape, per_rank: int):
    """MoE weights and tokens with the router skewed to expert 0, so that
    each group drops tokens."""
    rng = np.random.default_rng(900 + per_rank)
    d = 8
    E, f, fs = MOE.n_experts, MOE.d_ff_expert, MOE.d_ff_shared
    p = {
        "router": rng.normal(0, 0.3, (d, E)).astype(np.float32),
        "we_gate": rng.normal(0, 0.3, (E, d, f)).astype(np.float32),
        "we_up": rng.normal(0, 0.3, (E, d, f)).astype(np.float32),
        "we_down": rng.normal(0, 0.3, (E, f, d)).astype(np.float32),
        "ws_gate": rng.normal(0, 0.3, (d, fs)).astype(np.float32),
        "ws_up": rng.normal(0, 0.3, (d, fs)).astype(np.float32),
        "ws_down": rng.normal(0, 0.3, (fs, d)).astype(np.float32),
    }
    p["router"][:, 0] += 1.5
    x = rng.normal(0, 1, (per_rank * _row_size(shape), d)).astype(np.float32)
    x[:, :] += 0.5
    return p, x


def _compress_grads() -> np.ndarray:
    """One gradient per world rank of the 4 x 1 world."""
    return np.random.default_rng(1000).normal(size=(4, 64, 32)).astype(np.float32)


#: the compressed all-reduce's meshes in the 4 x 1 world and the axis each
#: reduces over: the four data ranks, and the pod pairs of 2 x 2 x 1
#: (world ranks d and 2 + d of data rank d)
COMPRESS_CASES = {(4, 1): "data", (2, 2, 1): "pod"}


def _row_size(shape) -> int:
    """Ranks along the row axes (``(pod, data)``, or ``data``) of a mesh."""
    return int(np.prod(shape[:-1]))


def _host(shape):
    return POD_HOSTS.get(shape, shape)


def _moe_host(shape):
    """The MoE dispatch on a pod mesh runs in the 2 x 2 world, which so
    builds both pod meshes: meshes of the same ranks and axis names must
    not share groups."""
    return (2, 2) if len(shape) == 3 else shape


def _world_cases(shape, ref_dir: str) -> dict:
    """The cases of the ``shape`` world: its own and those of the pod mesh
    its ranks build."""
    cases = {"train": [], "moe": [], "prefill": [], "compress": [], "elastic": []}
    for case in TRAIN_CASES:
        if _host(case[0]) != shape:
            continue
        _, arch, moment, n_micro, force = case
        cases["train"].append({
            "key": case, "cfg": _cfgs(arch)[0], "tree": _tree(arch), "batch": _batch(arch, n_micro),
            "moment": moment, "n_micro": n_micro, "force": force, "clip": CLIP.get(n_micro, 1.0)})
    for mshape, per in MOE_CASES:
        if _moe_host(mshape) == shape:
            p, x = _moe_inputs(mshape, per)
            cases["moe"].append({"key": (mshape, per), "m": MOE, "p": p, "x": x})
    for mshape, key in [((2, 2), a) for a in PREFILL_ARCHS] + [
            (POD_PREFILL_SHAPE, (POD_PREFILL_SHAPE, a)) for a in PREFILL_ARCHS]:
        if _host(mshape) == shape:
            arch = key if mshape == (2, 2) else key[1]
            cases["prefill"].append({"key": key, "shape": mshape, "cfg": _cfgs(arch)[0], "tree": _tree(arch),
                                     "tokens": _batch(arch, 1)["tokens"]})
    for source, shapes in ((ELASTIC_SOURCE, ELASTIC_SHAPES), (POD_ELASTIC_SOURCE, POD_ELASTIC_SHAPES)):
        if _host(source[0]) == shape:
            _, arch, moment, _, _ = source
            cases["elastic"].append({
                "source": source, "shapes": shapes, "ref_dir": ref_dir,
                "cfg": _cfgs(arch)[0], "tree": _tree(arch), "moment": moment})
    for mshape, axis in COMPRESS_CASES.items():
        if _host(mshape) == shape:
            cases["compress"].append({"shape": mshape, "axis": axis, "grads": _compress_grads(),
                                      "rounds": COMPRESS_ROUNDS})
    return cases


class World:
    """The ranks of one ``shape`` world, started on its input file;
    :meth:`results` waits for them until the deadline."""

    def __init__(self, shape, root: Path, cases: dict) -> None:
        self.shape, self.world = shape, shape[0] * shape[1]
        root.mkdir()
        cases_path = root / "cases.pt"
        torch.save(cases, cases_path)
        self.out = str(root / "rank%d.pt")
        self.procs = [
            _CTX.Process(target=torch_lm_worker.run, args=(
                rank, self.world, shape, str(root / "store"), str(cases_path), self.out))
            for rank in range(self.world)
        ]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + WORLD_DEADLINE_S
        self._results = None

    def kill(self) -> list[int]:
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        return hung

    def results(self) -> list[dict]:
        if self._results is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = self.kill()
            results = []
            for rank in range(self.world):
                try:
                    results.append(torch.load(self.out % rank, weights_only=False))
                except FileNotFoundError:
                    results.append({"error": f"rank {rank} left no results"})
            self._results = (hung, results)
        hung, results = self._results
        errors = [r["error"] for r in results if "error" in r]
        assert not hung and not errors, (
            f"{self.shape} world: ranks {hung} hung past {WORLD_DEADLINE_S} s; " + "\n".join(errors))
        return results


# ---------------------------------------------------------------------- #
# The reference's results
# ---------------------------------------------------------------------- #


def _jplan(shape):
    """The reference's plan of a ``(data, model)`` or ``(pod, data, model)``
    mesh shape, built by hand."""
    pod, data, model = shape if len(shape) == 3 else (1, *shape)
    return jplans.MeshPlan(pod_axis="pod" if len(shape) == 3 else None, data_axis="data",
                           model_axis="model", pod_size=pod, data_size=data, model_size=model)


def _compile(fn, *args):
    with JMESH:
        return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE_OPTIONS)


_REF: dict = {}


def _ref_key(case) -> tuple:
    """Only the MoE's groups, ``G = pod * data`` of them, read the plan's
    sizes, so a dense arch's step is the same in every world, and an MoE
    arch's the same in the worlds of one ``G``: the 2 x 1 x 2 mesh's is
    the 2 x 2 world's (the MoE dispatch and the prefill hold the reference
    under a pod plan itself)."""
    shape, arch, moment, n_micro, _ = case
    return arch, _row_size(shape) if _cfgs(arch)[1].moe else None, moment, n_micro


def _reference() -> dict:
    """Every reference result the checks read: the train step of each train
    case under its plan (loss, grad_norm, parameters and moments),
    ``moe_apply`` on each MoE case under its plan and on the first without
    one, and the MoE arch's ``prefill_step`` on 2 x 2 and on the pod mesh.
    One jitted program per arch, one for the MoE cases and one for the
    prefill (a program per call would compile the int8 step's gradient
    again; one program for all compiles slower than these)."""
    if _REF:
        return _REF
    jobs = {}
    for case in TRAIN_CASES:
        key = _ref_key(case)
        if ("train", key) in jobs:
            continue
        shape, arch, moment, n_micro, _ = case
        _, jcfg = _cfgs(arch)
        ocfg = jopt.OptimizerConfig(moment_dtype=moment, grad_clip=CLIP.get(n_micro, 1.0))
        params = jax.tree.map(jnp.asarray, _tree(arch))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch, n_micro).items()}
        jobs["train", key] = (arch, jtrainer.make_train_step(jcfg, ocfg, n_micro, plan=_jplan(shape)),
                              (params, jopt.init_opt_state(params, ocfg), batch))
    for c in MOE_CASES:
        jobs["moe", c] = ("moe", functools.partial(jmoe.moe_apply, m=MOE, plan=_jplan(c[0]), drop_tokens=True),
                          jax.tree.map(jnp.asarray, _moe_inputs(*c)))
    jobs["moe", "plain"] = ("moe", functools.partial(jmoe.moe_apply, m=MOE, plan=None, drop_tokens=True),
                            jobs["moe", MOE_CASES[0]][2])
    arch = PREFILL_ARCHS[1]
    for shape, key in (((2, 2), ("prefill", arch)), (POD_PREFILL_SHAPE, ("prefill", POD_PREFILL_SHAPE, arch))):
        jobs[key] = ("prefill", functools.partial(jtf.prefill_step, cfg=_cfgs(arch)[1], plan=_jplan(shape)),
                     (jax.tree.map(jnp.asarray, _tree(arch)), jnp.asarray(_batch(arch, 1)["tokens"])))
    for group in dict.fromkeys(job[0] for job in jobs.values()):
        keys = [k for k, job in jobs.items() if job[0] == group]
        args = [jobs[k][2] for k in keys]

        def program(args, keys=keys):
            return [jobs[k][1](*a) for k, a in zip(keys, args)]

        for key, out in zip(keys, _compile(program, args)(args)):
            if key[0] == "train":
                p, s, m = out
                out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "params": jax.tree.map(np.asarray, p), "m": jax.tree.map(np.asarray, s["m"]),
                       "v": jax.tree.map(np.asarray, s["v"]), "step": int(s["step"])}
            elif key[0] == "moe":
                out = (np.asarray(out[0]), float(out[1]))
            else:
                out = np.asarray(out)
            _REF[key] = out
    return _REF


def _ref_step(case) -> dict:
    return _reference()["train", _ref_key(case)]


COMPRESS_DRIVER = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.train.compression import make_compressed_allreduce
g = np.load(sys.argv[1])
# compiled at XLA's backend level 0: at higher levels LLVM fuses the carry's
# multiply and subtract, which the eager reference does not
reduce_fn = jax.jit(make_compressed_allreduce(jax.make_mesh((4,), ("data",)), "data")).lower(
    {"w": jnp.asarray(g)}, {"w": jnp.zeros_like(g)}).compile({"xla_backend_optimization_level": 0})
grads, err = {"w": jnp.asarray(g)}, {"w": jnp.zeros_like(g)}
out = {}
for i in range(int(sys.argv[3])):
    g_hat, err = reduce_fn(grads, err)
    out[f"g{i}"], out[f"e{i}"] = np.asarray(g_hat["w"]), np.asarray(err["w"])
np.savez(sys.argv[2], **out)
# over "pod" on 2 x 2 x 1: data rank d's pair, world ranks d and 2 + d
pair = g[[0, 2]]
reduce_fn = jax.jit(make_compressed_allreduce(jax.make_mesh((2,), ("pod",)), "pod")).lower(
    {"w": jnp.asarray(pair)}, {"w": jnp.zeros_like(pair)}).compile({"xla_backend_optimization_level": 0})
out = {}
for d in range(2):
    grads, err = {"w": jnp.asarray(g[[d, 2 + d]])}, {"w": jnp.zeros_like(pair)}
    for i in range(int(sys.argv[3])):
        g_hat, err = reduce_fn(grads, err)
        out[f"g{d}_{i}"], out[f"e{d}_{i}"] = np.asarray(g_hat["w"]), np.asarray(err["w"])
np.savez(sys.argv[4], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world, started at once after the reference's checkpoint is
    written; the reference's compressed all-reduce starts beside them in a
    subprocess with four host devices."""
    root = tmp_path_factory.mktemp("lm_worlds")
    ref = _ref_step(ELASTIC_SOURCE)
    ref_dir = jckpt.save(str(root / "ref_ckpt"), ref["step"],
                         {"params": ref["params"], "opt": {"step": np.int32(ref["step"]),
                                                           "m": ref["m"], "v": ref["v"]}})
    np.save(root / "grads.npy", _compress_grads())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    compress = subprocess.Popen(
        [sys.executable, "-c", COMPRESS_DRIVER, str(root / "grads.npy"), str(root / "compress.npz"),
         str(COMPRESS_ROUNDS), str(root / "compress_pod.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    worlds = {s: World(s, root / f"{s[0]}x{s[1]}", _world_cases(s, ref_dir)) for s in SHAPES}
    yield {"worlds": worlds, "ref_dir": ref_dir, "compress": compress, "root": root}
    for w in worlds.values():
        w.kill()
    if compress.poll() is None:
        compress.kill()
    compress.wait()


# ---------------------------------------------------------------------- #
# (b) The sharded train step
# ---------------------------------------------------------------------- #


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _assert_q8(got, want, what: str) -> None:
    """int8 moments: scales within rtol 1e-4, each decoded entry within one
    code step of the reference's."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path in want:
        if path.endswith("/scale"):
            np.testing.assert_allclose(got[path], want[path], rtol=1e-4, err_msg=what + path)
    for path in [p for p in want if p.endswith("/q")]:
        base = path[:-2]
        dec = lambda t: t[base + "/q"].astype(np.float32) * t[base + "/scale"]  # noqa: E731
        step = want[base + "/scale"] * (1 + 1e-4)
        assert np.all(np.abs(dec(got) - dec(want)) <= step + 1e-12), what + path


def _sizes(shape) -> dict:
    """Ranks along each axis of a ``(data, model)`` or ``(pod, data,
    model)`` mesh shape."""
    return dict(zip(("pod", "data", "model")[3 - len(shape):], shape))


def _plan(shape, row: int = 0, col: int = 0) -> MeshPlan:
    """The port's plan of a mesh shape at the coordinates ``(row, col)``,
    built by hand (no process groups)."""
    s = _sizes(shape)
    return MeshPlan("pod" if "pod" in s else None, "data", "model", s.get("pod", 1), s["data"], s["model"],
                    row_rank=row, model_rank=col)


def _name(shape) -> str:
    return "x".join(map(str, shape))


def _assemble(ranks: list[dict], case, key: str = "local") -> dict:
    """The whole parameter tree (reference layout, numpy) from every rank's
    blocks (``local``, or ``local_m`` / ``local_v`` of f32 moments), each
    written at its place."""
    specs = ranks[0]["train"][case]["specs"]
    sizes = _sizes(case[0])
    whole = {}
    for name, spec in specs.items():
        first = ranks[0]["train"][case][key][name]
        out = np.zeros([n * (sizes[a] if a else 1) for n, a in zip(first.shape, spec)], np.float32)
        for r in ranks:
            pos = r["train"][case]["pos"]
            idx = tuple(slice(pos[a] * n, (pos[a] + 1) * n) if a else slice(None)
                        for n, a in zip(first.shape, spec))
            out[idx] = r["train"][case][key][name].numpy()
        whole[name] = out
    return weights.reference_tree(ttf.Transformer(_cfgs(case[1])[0], device="meta"), whole)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{_name(c[0])}-{c[1]}-{c[2]}-m{c[3]}"
                         + (f"-{c[4]}" if c[4] else ""))
def test_sharded_train_step_matches_the_reference(run, case):
    want = _ref_step(case)
    ranks = run["worlds"][_host(case[0])].results()
    got = ranks[0]["train"][case]
    expect_mode = case[4] or ("seq" if case[1] == "smollm-360m" and case[0][-1] == 2 else "head")
    assert got["mode"] == expect_mode
    for r in ranks:  # every rank reports the global loss and norm
        assert r["train"][case]["loss"] == got["loss"]
        assert r["train"][case]["grad_norm"] == got["grad_norm"]
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **LOSS)
    params = _leaves(_assemble(ranks, case))
    w = _leaves(want["params"])
    assert params.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(params[path], w[path], err_msg=path, **PARAMS)
    if case[2] == "int8":  # to_reference gathers the same tree on every rank
        for r in ranks:
            g = _leaves(r["train"][case]["params"])
            assert all(np.array_equal(g[k], params[k]) for k in w)
        _assert_q8(got["m"], want["m"], "m")
        _assert_q8(got["v"], want["v"], "v")
        return
    for moment in ("m", "v"):
        have, ref = _leaves(_assemble(ranks, case, "local_" + moment)), _leaves(want[moment])
        assert have.keys() == ref.keys()
        for path in ref:
            np.testing.assert_allclose(have[path], ref[path], rtol=MOMENTS["rtol"],
                                       atol=MOMENTS["atol_share"] * np.abs(ref[path]).max(),
                                       err_msg=moment + path)


#: the 2 x 2 world's train cases without a forced mode, whose step the dry
#: run counts on a plan without process groups, and one of each pod mesh
SHAPE_ONLY_CASES = [c for c in TRAIN_CASES if c[0] == (2, 2) and c[4] is None] + [
    ((2, 1, 2), "smollm-360m", "float32", 1, None), ((2, 2, 1), "smollm-360m", "float32", 1, None)]


@pytest.mark.parametrize("case", SHAPE_ONLY_CASES, ids=lambda c: (f"{_name(c[0])}-" if len(c[0]) == 3 else "")
                         + f"{c[1]}-{c[2]}-m{c[3]}")
def test_shape_only_plan_sends_what_the_world_sent(run, case):
    """The sharded step on ``meta`` tensors under a plan of the world's
    sizes and each rank's coordinates, with no process group (the dry
    run's ``launch/specs.py``), records in ``plans.exchanged`` and
    ``exchange_calls`` what that rank of the gloo world recorded."""
    from repro_torch.shard import plans
    from repro_torch.train.trainer import make_train_step

    shape, arch, moment, n_micro, _ = case
    cfg, _ = _cfgs(arch)
    ocfg = topt.OptimizerConfig(moment_dtype=moment, grad_clip=CLIP.get(n_micro, 1.0))
    batch = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
             for k, v in _batch(arch, n_micro).items()}
    for r in run["worlds"][_host(shape)].results():
        plan = _plan(shape, *r["train"][case]["coords"])
        meta = weights.shard_model(ttf.Transformer(cfg, device="meta"), plan)
        state = topt.init_opt_state(meta, ocfg)
        step = make_train_step(cfg, ocfg, n_micro, plan)
        plans.reset_exchanges()
        step(meta, state, batch)
        got = r["train"][case]
        assert plans.exchanged == got["exchanged"], got["coords"]
        assert plans.exchange_calls == got["exchange_calls"], got["coords"]
    plans.reset_exchanges()


def _block_key(spec, pos: dict) -> tuple:
    """Which block of a leaf split by ``spec`` the rank at ``pos`` (its
    coordinate on each mesh axis) holds."""
    return tuple(pos[a] if a is not None else 0 for a in spec)


@pytest.mark.parametrize("shape", SHAPES + list(POD_HOSTS), ids=_name)
def test_replicas_are_bit_identical_across_ranks(run, shape):
    """After a step, every rank holding the same block of a parameter (or
    of its moments) holds the same bits, the ranks of other pods
    included, and the blocks differ where the spec splits."""
    ranks = run["worlds"][_host(shape)].results()
    sizes = _sizes(shape)
    for case in [c for c in TRAIN_CASES if c[0] == shape]:
        specs = ranks[0]["train"][case]["specs"]
        for name, spec in specs.items():
            held = {}
            for r in ranks:
                res = r["train"][case]
                key = _block_key(spec, res["pos"])
                leaves = [res["local"][name]]
                for moment in (res["local_m"][name], res["local_v"][name]):
                    leaves += [moment["q"], moment["scale"]] if case[2] == "int8" else [moment]
                if key in held:
                    for a, b in zip(held[key], leaves):
                        assert torch.equal(a, b), (case, name, key)
                else:
                    held[key] = leaves
            assert len(held) == int(np.prod([sizes[a] for a in spec if a is not None])), (case, name)


# ---------------------------------------------------------------------- #
# (c) Grouped MoE dispatch, (d) prefill with a plan
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("moe_case", MOE_CASES, ids=lambda c: f"{_name(c[0])}-T{c[1]}")
def test_grouped_moe_dispatch_matches_the_reference(run, moe_case):
    shape, per = moe_case
    y, aux = _reference()["moe", moe_case]
    if moe_case == MOE_CASES[0]:  # the groups decide which tokens drop
        assert not np.allclose(y, _reference()["moe", "plain"][0], rtol=1e-3)
    for r in run["worlds"][_moe_host(shape)].results():
        got = r["moe"][moe_case]
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got["aux"]), aux, rtol=1e-5)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_step_with_a_plan(run, arch):
    """On 2 x 2: smollm-360m ("seq" mode) equals the port's unsharded
    prefill; the MoE arch, whose capacity follows the plan, the
    reference's prefill under the same plan."""
    for r in run["worlds"][(2, 2)].results():
        got = r["prefill"][arch]
        assert got["logits"].shape == (B, _cfgs(arch)[0].vocab)
        if arch == "smollm-360m":
            np.testing.assert_allclose(got["logits"].numpy(), got["plain"].numpy(), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got["logits"].numpy(), _reference()["prefill", arch], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_step_on_a_pod_mesh(run, arch):
    """On 2 x 1 x 2, the logits gathered over ``(pod, data)``: smollm-360m
    ("seq" mode) equals the port's unsharded prefill; the MoE arch the
    reference's prefill under the pod plan."""
    key = (POD_PREFILL_SHAPE, arch)
    for r in run["worlds"][_host(POD_PREFILL_SHAPE)].results():
        got = r["prefill"][key]
        assert got["logits"].shape == (B, _cfgs(arch)[0].vocab)
        want = got["plain"].numpy() if arch == "smollm-360m" else _reference()["prefill", *key]
        np.testing.assert_allclose(got["logits"].numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# (e) The compressed all-reduce, (f) the elastic checkpoint
# ---------------------------------------------------------------------- #


def test_compressed_allreduce_matches_the_reference(run):
    out, _ = run["compress"].communicate(timeout=WORLD_DEADLINE_S)
    assert run["compress"].returncode == 0, out.decode()
    want = np.load(run["root"] / "compress.npz")
    ranks = run["worlds"][(4, 1)].results()
    g = _compress_grads()
    exact, bound = g.mean(axis=0), np.abs(g).max() / 127
    for r in ranks:
        rounds = r["compress"][(4, 1)]
        assert len(rounds) == COMPRESS_ROUNDS
        for i, (g_hat, err) in enumerate(rounds):
            assert np.array_equal(g_hat.numpy(), want[f"g{i}"]), i
            assert np.array_equal(err.numpy(), want[f"e{i}"][r["coords"][0]]), i
        assert np.abs(rounds[0][0].numpy() - exact).max() <= bound + 1e-6
        mean = np.mean([gh.numpy() for gh, _ in rounds], axis=0)
        np.testing.assert_allclose(mean, exact, atol=bound / 10)


def test_compressed_allreduce_over_pods_matches_the_reference(run):
    """``make_compressed_allreduce(mesh, "pod")`` on 2 x 2 x 1: each pod
    pair (world ranks d and 2 + d) reduces its two gradients, per round
    bit-equal to the reference's over a ``pod`` mesh of two devices and
    within its one-shot bound of the pair's mean."""
    out, _ = run["compress"].communicate(timeout=WORLD_DEADLINE_S)
    assert run["compress"].returncode == 0, out.decode()
    want = np.load(run["root"] / "compress_pod.npz")
    g = _compress_grads()
    for rank, r in enumerate(run["worlds"][(4, 1)].results()):
        rounds = r["compress"][(2, 2, 1)]
        pod, d = divmod(rank, 2)
        pair = g[[d, 2 + d]]
        assert len(rounds) == COMPRESS_ROUNDS
        for i, (g_hat, err) in enumerate(rounds):
            assert np.array_equal(g_hat.numpy(), want[f"g{d}_{i}"]), (rank, i)
            assert np.array_equal(err.numpy(), want[f"e{d}_{i}"][pod]), (rank, i)
        bound = np.abs(pair).max() / 127
        assert np.abs(rounds[0][0].numpy() - pair.mean(axis=0)).max() <= bound + 1e-6


def _blocks_equal(local, whole, specs, plan: MeshPlan, what) -> None:
    """Each leaf of ``local`` (this rank's restored blocks) is its block of
    ``whole``, bit for bit."""
    if isinstance(local, dict):
        assert local.keys() == whole.keys(), what
        for k in local:
            _blocks_equal(local[k], whole[k], specs[k], plan, f"{what}/{k}")
        return
    assert np.array_equal(local.detach().numpy(), local_shard(np.asarray(whole), specs, plan)), what


def _check_elastic(run, source, shapes) -> None:
    """The checkpoint of ``source``'s trained step (int8 moments), saved on
    its mesh, restored bit for bit on each of ``shapes``; the reference's
    restore reads it, and the port restores the reference's onto each of
    ``shapes``."""
    ranks = run["worlds"][_host(source[0])].results()
    trained = ranks[0]["train"][source]
    saved = {"params": trained["params"], "opt": {"step": np.int32(1), "m": trained["m"], "v": trained["v"]}}
    want = _ref_step(source)
    ref = {"params": want["params"], "opt": {"step": np.int32(want["step"]), "m": want["m"], "v": want["v"]}}
    for shape in shapes:
        for name, whole in (("port", saved), ("reference", ref)):
            for r in ranks:
                got = r["elastic"][source][name, shape]
                _blocks_equal(got["tree"], whole, got["specs"], _plan(shape, *got["coords"]), f"{name} {shape}")
    arch = source[1]
    template = jax.tree.map(jnp.asarray, {"params": _tree(arch), "opt": jopt.init_opt_state(
        jax.tree.map(jnp.asarray, _tree(arch)), jopt.OptimizerConfig(moment_dtype="int8"))})
    tree, meta = jckpt.restore(ranks[0]["elastic"][source]["path"], template)
    assert meta["step"] == 1
    a, b = _leaves(jax.tree.map(np.asarray, tree)), _leaves(saved)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_elastic_checkpoint_crosses_meshes_and_packages(run):
    """Saved under 2 x 2, restored under 1 x 4, 4 x 1 and the 2 x 1 x 2
    pod mesh."""
    _check_elastic(run, ELASTIC_SOURCE, ELASTIC_SHAPES)


def test_elastic_checkpoint_from_a_pod_mesh(run):
    """Saved under 2 x 1 x 2 (every rank's blocks gathered within its pod,
    world rank 0 writes), restored under 2 x 2 and 4 x 1."""
    _check_elastic(run, POD_ELASTIC_SOURCE, POD_ELASTIC_SHAPES)


@pytest.mark.parametrize("window", [0, 16], ids=["global", "local"])
def test_attention_of_a_sequence_shard_equals_its_rows_of_the_whole(window):
    """A "seq" rank's queries at an offset against the gathered keys give
    its rows of the whole sequence's attention: chunked (windowed or not,
    several key chunks) and banded (S = 8 windows, shards of 2 and 4
    windows), the same values."""
    from repro_torch.models import attention as tattn

    gen = torch.Generator().manual_seed(5)
    B, S_, H, KV, hd = 2, 128, 4, 2, 16
    q, k, v = (torch.randn((B, S_, n, hd), generator=gen) for n in (H, KV, KV))
    whole = tattn.chunked_attention(q, k, v, window=window, chunk=32)
    for parts in (2, 4):
        per = S_ // parts
        for r in range(parts):
            rows = slice(r * per, (r + 1) * per)
            got = tattn.chunked_attention(q[:, rows], k, v, window=window, chunk=32, q_offset=r * per)
            torch.testing.assert_close(got, whole[:, rows], rtol=0, atol=0)
            if window:
                band = tattn.banded_attention(q[:, rows], k, v, window, q_offset=r * per)
                torch.testing.assert_close(band, tattn.banded_attention(q, k, v, window)[:, rows],
                                           rtol=0, atol=0)
                torch.testing.assert_close(band, whole[:, rows], rtol=1e-5, atol=1e-6)


def test_weights_cross_to_any_plan_and_back():
    """The reference tree goes to every rank's blocks of a plan (built by
    hand: no world), and the blocks of all ranks, written back at their
    places, are the tree bit for bit, each place held by as many ranks as
    the spec leaves it whole over."""
    arch = "qwen3-moe-235b-a22b"
    cfg, _ = _cfgs(arch)
    tree = _tree(arch)
    full = {k: p.detach() for k, p in weights.params_from_reference(tree, cfg, device="cpu").named_parameters()}
    for data, model in ((2, 2), (4, 1), (1, 4)):
        back = {k: torch.zeros_like(v) for k, v in full.items()}
        held = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in full.items()}
        for r in range(data * model):
            plan = MeshPlan(pod_axis=None, data_axis="data", model_axis="model", pod_size=1,
                            data_size=data, model_size=model, row_rank=r // model, model_rank=r % model)
            specs = weights.named_specs(cfg, plan)
            for name, p in weights.params_from_reference(tree, cfg, device="cpu", plan=plan).named_parameters():
                idx = []
                for dim, axis in enumerate(specs[name]):
                    n = p.shape[dim]
                    c = 0 if axis is None else plan.axis_rank(axis)
                    idx.append(slice(c * n, (c + 1) * n))
                back[name][tuple(idx)] = p.detach()
                held[name][tuple(idx)] += 1
        for name, v in full.items():
            copies = data * model // int(np.prod(
                [plan.axis_size(a) for a in weights.named_specs(cfg, plan)[name] if a is not None]))
            assert torch.equal(back[name], v), (data, model, name)
            assert bool((held[name] == copies).all()), (data, model, name)
