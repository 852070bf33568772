"""The port's roofline (``repro_torch.roofline``: ``hlo``, ``count``,
``analysis``) against the reference package and hand counts, on the CPU.

* ``collective_stats`` equals the reference's on ``test_roofline.py``'s
  sample and on lines with ``-start``/``-done`` pairs and explicit replica
  groups.
* ``roofline_row`` and ``full_table``, fed the same JSON, give the
  reference's FLOPs, bytes, collective bytes and ``useful_ratio``; their
  time terms differ by the constants only (the H100's against the
  reference's chip).
* Per component, the counter's FLOPs against XLA's compiled
  ``cost_analysis()`` at reduced width (f32, one chunk of attention):
  forward components within [0.90, 1.0] of XLA's (XLA counts the
  elementwise FLOPs too, the counter only products); the block's forward
  + backward counts more, exactly the attention chunk's products run
  again by the port's per-chunk remat (``models/attention.py``), and
  without them it lies within [0.90, 1.0] as well.
* The counter on hand-counted cases: a matmul chain, an elementwise chain,
  a kernel wrapper's meta path, the peak of live bytes, and the
  shape-only collectives of a plan without process groups.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduce import reduce_config as jreduce
from repro.models import transformer as jtf
from repro.roofline import analysis as janalysis
from repro.roofline import hlo as jhlo
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.reduce import reduce_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import components
from repro_torch.launch.mesh import production_plan
from repro_torch.roofline import analysis, hlo
from repro_torch.roofline.count import Counter, count
from repro_torch.shard import collectives as C
from repro_torch.shard import plans
from repro_torch.shard.plans import P
from test_roofline import HLO_SAMPLE

ASYNC_SAMPLE = """
  %ags = (bf16[4,64]{1,0}, bf16[16,64]{1,0}) all-gather-start(%a), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %agd = bf16[16,64]{1,0} all-gather-done(%ags)
  %ars = f32[256,128]{1,0} all-reduce-start(%b), replica_groups={{0,2},{1,3}}, to_apply=%add
  %ard = f32[256,128]{1,0} all-reduce-done(%ars)
  %a2a = s32[8,32]{1,0} all-to-all(%c), replica_groups=[2,8]<=[16], dimensions={0}
  %one = f32[64]{0} all-reduce(%d), replica_groups={{0}}, to_apply=%add
  %cps = (u8[1024]{0}, u8[1024]{0}) collective-permute-start(%e), source_target_pairs={{0,1},{1,0}}
  %cpd = u8[1024]{0} collective-permute-done(%cps)
"""


@pytest.mark.parametrize("text,n", [(HLO_SAMPLE, 256), (ASYNC_SAMPLE, 16), (HLO_SAMPLE + ASYNC_SAMPLE, 8)])
def test_collective_stats_match_the_reference(text, n):
    assert hlo.collective_stats(text, n) == jhlo.collective_stats(text, n)
    assert hlo.op_histogram(text) == jhlo.op_histogram(text)


def test_async_pairs_count_once_and_groups_size_the_ring():
    stats = hlo.collective_stats(ASYNC_SAMPLE, 16)
    assert stats["all-gather"]["count"] == 1 and stats["all-reduce"]["count"] == 1  # the 1-rank group moves nothing
    assert stats["all-reduce"]["moved_bytes"] == 256 * 128 * 4 * 2 * (2 - 1) / 2
    assert stats["all-to-all"]["moved_bytes"] == 8 * 32 * 4 * 7 / 8
    for op, k in (("all-gather", 4), ("all-reduce", 2), ("reduce-scatter", 4), ("all-to-all", 8),
                  ("collective-permute", 2)):
        assert hlo.moved_bytes(op, 1000, k) == jhlo.collective_stats(
            f"%x = u8[1000]{{0}} {op}(%y), replica_groups={{{{{','.join(map(str, range(k)))}}}}}", k
        )[op]["moved_bytes"]


# ---------------------------------------------------------------------- #
# roofline_row and full_table on the same JSON
# ---------------------------------------------------------------------- #


def _coll(moved: float) -> dict:
    return {"all-reduce": {"count": 3, "out_bytes": moved / 2, "moved_bytes": moved},
            "_total": {"count": 3, "out_bytes": moved / 2, "moved_bytes": moved}}


def _dryrun(arch, shape, mesh, flops, byts, moved, n_dev=256):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n_dev,
            "memory": {"argument_bytes": 3e9, "output_bytes": 1e9, "temp_bytes": 7e9,
                       "alias_bytes": 1e9, "code_bytes": None},
            "cost": {"flops": flops, "bytes_accessed": byts, "transcendentals": 1e6},
            "collectives": _coll(moved)}


ROWS = [
    _dryrun("smollm-360m", "train_4k", "single", 1e13, 2e12, 5e10),
    _dryrun("gcn-cora", "full_graph_sm", "single", 1.1e6, 2.3e5, 1.8e5),
    _dryrun("deepfm", "serve_p99", "single", 2e6, 7e6, 1e5),
    _dryrun("cfpq", "closure_64k", "multi", 1.3e13, 3.5e9, 3.5e9, n_dev=512),
    # the multi-pod LM cells are counted per rank too: half the rows of each rank
    _dryrun("smollm-360m", "train_4k", "multi", 5e12, 1e12, 5e10, n_dev=512),
]
COMPS = [("smollm-360m", "train_4k", "single", name, mult, f, b, m) for name, mult, f, b, m in (
    ("block_fwd", 256, 1.8e10, 3e9, 6e7), ("block_fwdbwd", 256, 6.2e10, 9e9, 1.7e8),
    ("head_fwdbwd", 8, 1.45e11, 2.5e10, 2.3e8), ("opt", 1, 0.0, 7.5e10, 8.0))]


@pytest.fixture
def experiments(tmp_path, monkeypatch):
    """The same JSON under the reference's layout and the port's."""
    for sub in ("dryrun", "components", "dryrun_torch", "components_torch"):
        (tmp_path / sub).mkdir()
    for rec in ROWS:
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        for sub in ("dryrun", "dryrun_torch"):
            (tmp_path / sub / f"{tag}.json").write_text(json.dumps(rec))
    for arch, shape, mesh, name, mult, f, b, m in COMPS:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "component": name, "multiplier": mult,
               "flops": f, "bytes_accessed": b, "collectives": _coll(m)}
        for sub in ("components", "components_torch"):
            (tmp_path / sub / f"{arch}__{shape}__{mesh}__{name}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(janalysis, "EXP_DIR", str(tmp_path))
    monkeypatch.setattr(analysis, "EXP_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_full_table_matches_the_reference(experiments, mesh):
    got, want = analysis.full_table(mesh), janalysis.full_table(mesh)
    assert [(r["arch"], r["shape"], r["method"]) for r in got] == [
        (r["arch"], r["shape"], r["method"]) for r in want]
    assert got and len(got) == len([r for r in ROWS if r["mesh"] == mesh])
    for g, w in zip(got, want):
        for key in ("flops_dev", "bytes_dev", "coll_bytes_dev", "useful_ratio", "model_flops_dev",
                    "hbm_bytes_dev", "args_bytes_dev"):
            assert g[key] == w[key], key
        # the terms differ by the constants only
        assert g["t_compute_s"] * analysis.BF16_OPS_PER_S == pytest.approx(
            w["t_compute_s"] * janalysis.PEAK_FLOPS, rel=1e-12)
        assert g["t_memory_s"] * analysis.HBM_BYTES_PER_S == pytest.approx(
            w["t_memory_s"] * janalysis.HBM_BW, rel=1e-12)
        assert g["t_collective_s"] * analysis.NETWORK_BYTES_PER_S == pytest.approx(
            w["t_collective_s"] * janalysis.LINK_BW, rel=1e-12)
        assert g["fits"] is True
    assert "smollm-360m" in analysis.format_table(got)


def test_roofline_row_prices_each_dtype_at_its_peak(experiments):
    rec = dict(ROWS[1], cost=dict(ROWS[1]["cost"], flops_by_dtype={"bfloat16": 6e5, "float32": 5e5}),
               method="global_over_ranks")
    row = analysis.compose_row(rec, [])
    assert row["t_compute_s"] == 6e5 / 989e12 + 5e5 / 67e12
    assert row["count_method"] == "global_over_ranks"
    skipped = analysis.compose_row(dict(rec, cost=None, collectives=None, method="skipped",
                                        reason="why"), [])
    assert skipped["method"] == "skipped" and skipped["reason"] == "why" and skipped["fits"]
    assert "count skipped: why" in analysis.format_table([skipped])
    assert analysis.link_bytes_per_s(8) == 450e9 and analysis.link_bytes_per_s(16) == 50e9


# ---------------------------------------------------------------------- #
# Components against XLA's cost_analysis, reduced width
# ---------------------------------------------------------------------- #

S, B = 256, 2
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}
#: port / XLA FLOPs per component (without the chunk remat's products)
RATIO = (0.90, 1.0)


#: gemma3-12b's reduced period of 5 local layers and a global one cut to one
#: of each (as tests/test_torch_sharded_lm.py cuts it): the reference
#: compiles the block in half the time
CUT = {"gemma3-12b": dict(local_global_ratio=1, n_layers=2)}


def _xla_flops(arch: str) -> dict:
    jcfg = dataclasses.replace(jreduce(jregistry.get_config(arch)), attn_chunk=S, dtype="float32",
                               **CUT.get(arch, {}))
    _, e = jtf._block_counts(jcfg)
    one = dataclasses.replace(jcfg, n_layers=e)
    params = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), one))
    bp = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype), params["blocks"])
    x = jax.ShapeDtypeStruct((B, S, jcfg.d_model), jnp.float32)
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)

    def block_fwd(bp_, x_):
        y, aux = jtf.apply_block(bp_, x_, one, None)
        return y.astype(jnp.float32).sum() + aux

    def head_fwdbwd(hp, tokens, targets):
        def f(hp):
            xx = hp["embed"][tokens] * jnp.asarray(jcfg.d_model**0.5, jnp.float32)
            return jtf.lm_head_loss(hp, xx, targets, one)
        return jax.grad(f)(hp)

    head = {k: params[k] for k in ("embed", "unembed", "final_norm")}
    jobs = {"block_fwd": (block_fwd, (bp, x)),
            "block_fwdbwd": (lambda b, xx: jax.grad(block_fwd, argnums=(0, 1))(b, xx), (bp, x)),
            "head_fwdbwd": (head_fwdbwd, (head, toks, toks))}
    return {name: jax.jit(fn).lower(*args).compile(COMPILE_OPTIONS).cost_analysis()["flops"]
            for name, (fn, args) in jobs.items()}


def _port_flops(arch: str, names=("block_fwd", "block_fwdbwd", "head_fwdbwd")) -> dict:
    cfg = dataclasses.replace(reduce_config(registry.get_config(arch)), dtype="float32",
                              **CUT.get(arch, {}))
    comps = components.lm_components(cfg, ShapeSpec("t", "train", (("seq_len", S), ("global_batch", B))),
                                     n_micro=1)
    return {c.name: components.count_component(c)["flops"] for c in comps if c.name in names}


def _chunk_remat_flops(arch: str) -> int:
    """The products the per-chunk remat runs again in the backward: the
    scores and the weighted values of every layer on the chunked form (at
    S >= 8 windows a local layer takes the banded form, without a remat)."""
    cfg = dataclasses.replace(reduce_config(registry.get_config(arch)), **CUT.get(arch, {}))
    _, e = jtf._block_counts(cfg)
    chunked = sum(1 for i in range(e) if not (cfg.window and cfg.layer_is_local(i) and S >= 8 * cfg.window))
    return chunked * 2 * (2 * B * cfg.n_heads * S * S * cfg.hd)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b", "gemma3-12b"])
def test_component_flops_track_xla(arch, monkeypatch):
    want, got = _xla_flops(arch), _port_flops(arch)
    for name in ("block_fwd", "head_fwdbwd"):
        assert RATIO[0] <= got[name] / want[name] <= RATIO[1], (name, got[name] / want[name])
    # the fwd + bwd excess is the chunk remat's recompute, exactly
    import repro_torch.models.attention as attention

    monkeypatch.setattr(attention, "checkpoint", lambda fn, *a, use_reentrant=False: fn(*a))
    plain = _port_flops(arch, ["block_fwdbwd"])["block_fwdbwd"]
    assert got["block_fwdbwd"] - plain == _chunk_remat_flops(arch)
    assert RATIO[0] <= plain / want["block_fwdbwd"] <= RATIO[1], plain / want["block_fwdbwd"]


# ---------------------------------------------------------------------- #
# The counter on hand-counted cases
# ---------------------------------------------------------------------- #


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_chain():
    a, b, c = _meta(8, 16), _meta(16, 32, dtype=torch.bfloat16), _meta(32, 4)
    _, s = count(lambda: (a @ b.float()) @ c)
    assert s["flops_by_dtype"] == {"float32": 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4}
    # the cast reads bf16 and writes f32; each product reads its inputs and writes its output
    assert s["bytes_accessed"] == (16 * 32 * 2 + 16 * 32 * 4) + (8 * 16 + 16 * 32 + 8 * 32) * 4 + (
        8 * 32 + 32 * 4 + 8 * 4) * 4
    assert s["ops"] == 3 and s["transcendentals"] == 0
    _, s = count(lambda: torch.einsum("bij,bjk->bik", _meta(3, 4, 5, dtype=torch.bfloat16),
                                      _meta(3, 5, 6, dtype=torch.bfloat16)))
    assert s["flops_by_dtype"] == {"bfloat16": 2 * 3 * 4 * 5 * 6}
    _, s = count(lambda: _meta(7, 9) @ _meta(9))
    assert s["flops"] == 2 * 7 * 9


def test_elementwise_chain_and_views():
    x = _meta(10, 20)
    _, s = count(lambda: torch.exp(x.t().reshape(200) * 2.0).sum())
    # t, reshape of a non-contiguous view copies (clone), mul, exp, sum
    n = 200 * 4
    assert s["flops"] == 0 and s["transcendentals"] == 200
    assert s["bytes_accessed"] == 2 * n + 2 * n + 2 * n + (n + 4)
    # a broadcast input is read once
    _, s = count(lambda: _meta(1, 20).expand(10, 20) + x)
    assert s["bytes_accessed"] == 20 * 4 + 200 * 4 + 200 * 4


def test_live_bytes_peak():
    x = _meta(1000)

    def f():
        a = x + 1  # 4,000 live
        b = a * 2  # 8,000
        del a  # 4,000
        c = b.view(10, 100)  # a view: no new bytes
        d = torch.cat([c, c])  # 12,000
        return d.sum()

    with Counter() as c:
        f()
    assert c.peak_bytes == 12_004  # b, d and the sum
    assert c.live == 0  # every storage the run made has died
    with Counter() as c:
        x.add_(1)  # in place on an argument: read and written, no new storage
    assert c.peak_bytes == 0 and c.bytes == 8_000


def test_uploads_are_not_counted():
    """Host data put on the device is a constant the step caches, as XLA
    embeds its constants (``models/gnn/mace.py::_gaunt``): no op, byte or
    live byte, so a count does not depend on what the process ran first."""
    host, x = np.arange(12.0).reshape(3, 4), _meta(4, 5)
    _, s = count(lambda: torch.as_tensor(host, dtype=torch.float32, device="meta") @ x)
    assert s["ops"] == 1 and s["flops"] == 2 * 3 * 4 * 5
    assert s["bytes_accessed"] == 4 * (12 + 20 + 15) and s["peak_bytes"] == 4 * 15
    # the MACE cell counted cold (its coupling tensors made) and warm
    from repro_torch.launch import specs
    from repro_torch.models.gnn import mace

    cell = specs.build_cell("mace", "molecule", production_plan())
    mace._gaunt.cache_clear()
    cold, warm = specs.count_cell(cell), specs.count_cell(cell)
    for key in ("flops", "bytes_accessed", "ops", "peak_bytes"):
        assert cold[key] == warm[key], key


def test_kernel_wrappers_report_on_meta():
    B, m, k, w = 2, 64, 128, 3
    lhs, rhs = _meta(B, m, k // 32, dtype=torch.int32), _meta(B, k, w, dtype=torch.int32)
    launches = kops.launches
    out, s = count(kops.bitmm, lhs, rhs)
    assert out.shape == (B, m, w) and out.is_meta and kops.launches == launches
    assert s["kernels"] == {"bitmm": 1}
    assert s["flops_by_dtype"] == {"int32": B * m * k * w}
    assert s["bytes_accessed"] == 4 * (B * m * k // 32 + B * k * w + B * m * w)
    out, s = count(kops.bitmm_or, lhs, rhs, _meta(B, m, w, dtype=torch.int32))
    assert s["kernels"] == {"bitmm_or": 1} and s["flops"] == B * m * k * w
    lhs = _meta(2, 4, 5)
    out, s = count(kops.minplus, lhs, _meta(3, 5, 7), torch.zeros(2, dtype=torch.int64, device="meta"),
                   torch.zeros(5, dtype=torch.int64, device="meta"))
    assert out.shape == (2, 4, 7) and s["kernels"] == {"minplus": 1}
    assert s["flops_by_dtype"]["float32"] == 2 * 2 * 4 * 5 * 7
    out, s = count(kops.count_mm, _meta(2, 4, 5, dtype=torch.int32), _meta(2, 5, 7, dtype=torch.int32))
    assert s["kernels"] == {"count_mm": 1} and s["flops_by_dtype"]["int32"] == 2 * 2 * 4 * 5 * 7
    tiles = _meta(10, 64, 2, dtype=torch.int32)
    idx = torch.zeros(6, dtype=torch.int32, device="meta")
    (new, flags), s = count(kops.tile_contract_chunk, tiles, idx, idx, idx, idx, idx, 3,
                            kops.tile_work(64, 8, tiles.device))
    assert new.shape == (3, 64, 2) and s["kernels"] == {"tile_contract": 1}
    assert s["flops_by_dtype"]["int32"] == 6 * 64 * 64 * 2


def test_collectives_are_shape_only_on_meta():
    plan = production_plan()
    plans.reset_exchanges()
    with Counter() as c:
        g = C.all_gather(_meta(4, 6), 1, plan, ("model",), "t.gather")
        r = C.all_reduce(_meta(4, 6), plan, ("data",), "t.sum")
        u = C.use(_meta(60, 8), plan, P("data", None), name="t.use")
    assert g.shape == (4, 96) and r.shape == (4, 6) and u.shape == (960, 8)
    assert plans.exchanged == {"t.gather": 96, "t.sum": 96, "t.use": 60 * 8 * 4}
    stats = c.collective_stats()
    assert stats["all-gather"] == {"count": 2, "out_bytes": 4 * 96 * 4 + 960 * 8 * 4,
                                   "moved_bytes": (4 * 96 * 4 + 960 * 8 * 4) * 15 / 16}
    assert stats["all-reduce"] == {"count": 1, "out_bytes": 96, "moved_bytes": 96 * 2 * 15 / 16}
    plans.reset_exchanges()
