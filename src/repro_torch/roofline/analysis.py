"""Three-term roofline per (arch x shape x mesh) from the port's dry-run
artifacts (the counterpart of the reference's ``roofline/analysis.py``),
priced at one NVIDIA H100 SXM's rates:

    compute term    = per-rank FLOPs of each dtype / that dtype's peak
    memory term     = per-rank bytes accessed / 3.35e12 B/s HBM3
    collective term = per-rank moved collective bytes / the link rate

Inputs are per-rank quantities (``launch/dryrun.py``, ``launch/
components.py``).  A cell with component JSONs is composed from them
times their multipliers; the others come straight from the dry-run JSON;
CFPQ is reported per fixpoint iteration.  A JSON without a per-dtype
split (the reference's) is priced at the bf16 peak, as the reference
prices it at its chip's.

MODEL_FLOPS (the "useful work" yardstick, the reference's formula):
    LM train:    6 * N_active * tokens        (fwd 2x + bwd 4x)
    LM prefill:  2 * N_active * tokens (+ attention term)
    LM decode:   2 * N_active * batch  (+ 2*KV attention reads)
    GNN/recsys:  analytic per model (edges * d ops, table lookups)
    CFPQ:        2 * |P| * n^3 * density-free upper bound per iteration
"""
from __future__ import annotations

import glob
import json
import os

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W limit
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (the port enables no TF32)
# INT32 operations on the SMs' integer lanes: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost clock (the packed kernels' word operations)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12  # HBM3
HBM_BYTES = 80e9  # one card's memory
# NVLink 4 within a group of up to 8 ranks (one HGX H100 board), per
# direction; beyond it one 400 Gb/s NDR InfiniBand port per GPU, as in a
# DGX H100
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
NVLINK_GROUP = 8

#: the peak each dtype's operations are priced at
PEAK = {
    "bfloat16": BF16_OPS_PER_S,
    "float16": BF16_OPS_PER_S,
    "float32": FP32_OPS_PER_S,
    "int32": INT32_OPS_PER_S,
}

EXP_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "../../../artifacts"))


def _load(path_glob: str) -> list[dict]:
    out = []
    for p in sorted(glob.glob(path_glob)):
        with open(p) as fh:
            out.append(json.load(fh))
    return out


def link_bytes_per_s(n_devices: int) -> float:
    """The rate a collective of a mesh of ``n_devices`` ranks runs at: its
    groups span more than one board beyond ``NVLINK_GROUP`` ranks."""
    return NVLINK_BYTES_PER_S if n_devices <= NVLINK_GROUP else NETWORK_BYTES_PER_S


def compute_seconds(flops: float, by_dtype: dict | None = None) -> float:
    """Each dtype's operations over its own peak; without a split, all at
    the bf16 peak."""
    if not by_dtype:
        return flops / BF16_OPS_PER_S
    return sum(v / PEAK.get(k, FP32_OPS_PER_S) for k, v in by_dtype.items())


def model_flops(arch: str, shape_name: str, n_dev: int) -> float:
    """Analytic useful-FLOPs per device per step (6ND convention)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import (
        CFPQConfig,
        GNNConfig,
        RecSysConfig,
        TransformerConfig,
    )

    cfg = registry.get_config(arch)
    shape = next(s for s in registry.get_shapes(arch) if s.name == shape_name)
    d = dict(shape.dims)
    if isinstance(cfg, TransformerConfig):
        n_active = cfg.active_param_count()
        if shape.kind == "train":
            tokens = d["seq_len"] * d["global_batch"]
            total = 6 * n_active * tokens
        elif shape.kind == "prefill":
            tokens = d["seq_len"] * d["global_batch"]
            attn = 2 * 2 * tokens * d["seq_len"] / 2 * cfg.n_heads * cfg.hd
            total = 2 * n_active * tokens + attn
        else:  # decode
            toks = d["global_batch"]
            attn = 2 * 2 * toks * d["seq_len"] * cfg.n_heads * cfg.hd
            total = 2 * n_active * toks + attn
        return total / n_dev
    if isinstance(cfg, GNNConfig):
        e, dh = d.get("n_edges", 0), cfg.d_hidden
        if shape.kind == "graph_sampled":
            from repro_torch.models.gnn.common import sampled_sizes

            _, e = sampled_sizes(d["batch_nodes"], (d["fanout1"], d["fanout2"]))
        if shape.kind == "graph_batched":
            e = d["n_edges"] * d["batch"]
        k = {"gcn": 2, "meshgraphnet": 6 * cfg.mlp_layers}.get(cfg.model, 0)
        if cfg.model == "equiformer_v2":
            K = (cfg.l_max + 1) ** 2
            k = 6 * K  # rotate, mix, rotate-back per channel
        if cfg.model == "mace":
            k = 8 * (cfg.l_max + 1) ** 2
        total = 2 * 3 * e * dh * dh * max(1, cfg.n_layers) * max(k, 2) / 2
        return total / n_dev
    if isinstance(cfg, RecSysConfig):
        b = d.get("batch", 1)
        mlp = sum(
            a * bb for a, bb in zip(
                (cfg.n_sparse * cfg.embed_dim + cfg.n_dense, *cfg.mlp),
                (*cfg.mlp, 1),
            )
        )
        total = 2 * b * mlp * (3 if shape.kind == "train" else 1)
        if shape.kind == "retrieval":
            total = 2 * d["n_candidates"] * cfg.embed_dim
        return total / n_dev
    if isinstance(cfg, CFPQConfig):
        from repro_torch.launch.specs import cfpq_grammar_tables

        g, tables = cfpq_grammar_tables()
        n = d["n_nodes"]
        return 2 * tables.n_prods * n**3 / n_dev  # per iteration (dense bound)
    raise TypeError(cfg)


def _moved(rec: dict) -> float:
    return rec["collectives"]["_total"]["moved_bytes"]


def roofline_row(arch: str, shape: str, mesh: str) -> dict | None:
    """Compose one table row from the dry-run and component JSONs; a cell
    whose count was skipped gives a row with its reason and no terms."""
    dr = _load(f"{EXP_DIR}/dryrun_torch/{arch}__{shape}__{mesh}.json")
    if not dr:
        return None
    return compose_row(dr[0], _load(f"{EXP_DIR}/components_torch/{arch}__{shape}__{mesh}__*.json"))


def compose_row(dr: dict, comps: list[dict]) -> dict:
    """One table row from a dry-run result and its components' (none: the
    dry run's own count)."""
    arch, shape, mesh = dr["arch"], dr["shape"], dr["mesh"]
    n_dev = dr["n_devices"]
    row = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "count_method": dr.get("method"),
        "hbm_bytes_dev": dr["memory"]["temp_bytes"],
        "args_bytes_dev": dr["memory"]["argument_bytes"],
    }
    row["fits"] = (row["args_bytes_dev"] or 0) + (row["hbm_bytes_dev"] or 0) <= HBM_BYTES
    if dr.get("cost") is None:
        return {**row, "method": "skipped", "reason": dr.get("reason")}
    if comps:  # composed
        flops = sum(c["flops"] * c["multiplier"] for c in comps)
        byts = sum(c["bytes_accessed"] * c["multiplier"] for c in comps)
        coll = sum(_moved(c) * c["multiplier"] for c in comps)
        by_dtype: dict = {}
        for c in comps:
            for k, v in (c.get("flops_by_dtype") or {}).items():
                by_dtype[k] = by_dtype.get(k, 0) + v * c["multiplier"]
        method = "composed(%d)" % len(comps)
    else:
        flops = dr["cost"]["flops"]
        byts = dr["cost"]["bytes_accessed"]
        coll = _moved(dr)
        by_dtype = dr["cost"].get("flops_by_dtype")
        method = "direct"
    t_c = compute_seconds(flops, by_dtype)
    t_m = byts / HBM_BYTES_PER_S
    t_x = coll / link_bytes_per_s(n_dev)
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(arch, shape, n_dev)
    return {
        **row,
        "method": method,
        "flops_dev": flops,
        "flops_by_dtype_dev": by_dtype,
        "bytes_dev": byts,
        "coll_bytes_dev": coll,
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dominant,
        "model_flops_dev": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": (
            mf / BF16_OPS_PER_S / max(t_c, t_m, t_x) if max(t_c, t_m, t_x) else 0.0
        ),
    }


def full_table(mesh: str = "single") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(f"{EXP_DIR}/dryrun_torch/*__{mesh}.json")):
        base = os.path.basename(path)[: -len(f"__{mesh}.json")]
        arch, shape = base.split("__")[:2]
        row = roofline_row(arch, shape, mesh)
        if row:
            rows.append(row)
    return rows


def format_table(rows: list[dict]) -> str:
    hdr = (
        f"{'arch':28s} {'shape':14s} {'t_comp':>9s} {'t_mem':>9s} "
        f"{'t_coll':>9s} {'dom':>5s} {'useful':>7s} {'roofline%':>9s} "
        f"{'HBM(GB)':>8s} {'args(GB)':>8s} {'fits':>4s} {'count':>17s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        tail = (f"{(r['hbm_bytes_dev'] or 0)/1e9:8.2f} {(r['args_bytes_dev'] or 0)/1e9:8.2f} "
                f"{'yes' if r['fits'] else 'no':>4s} {r['count_method'] or '':>17s}")
        if r["method"] == "skipped":
            lines.append(f"{r['arch']:28s} {r['shape']:14s} {'count skipped: ' + str(r['reason']):69s} {tail}")
            continue
        lines.append(
            f"{r['arch']:28s} {r['shape']:14s} "
            f"{r['t_compute_s']:9.2e} {r['t_memory_s']:9.2e} "
            f"{r['t_collective_s']:9.2e} {r['dominant'][:5]:>5s} "
            f"{r['useful_ratio']:7.2f} {100*r['roofline_fraction']:8.1f}% {tail}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.roofline.analysis [single|multi]``: the table
    of the dry run's JSON under ``EXP_DIR``."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    print(format_table(full_table(argv[0] if argv else "single")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
