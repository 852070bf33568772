"""--arch registry: every assigned architecture + the paper's own CFPQ.

Exact configs from the assignment sheet (sources noted inline).
"""
from __future__ import annotations

from .base import (
    CFPQ_SHAPES,
    CFPQConfig,
    GNN_SHAPES,
    GNNConfig,
    LM_SHAPES,
    MoEConfig,
    RECSYS_SHAPES,
    RecSysConfig,
    ShapeSpec,
    TransformerConfig,
)

ARCHS: dict[str, object] = {}
SHAPES: dict[str, tuple[ShapeSpec, ...]] = {}


def _reg(cfg, shapes):
    ARCHS[cfg.arch_id] = cfg
    SHAPES[cfg.arch_id] = shapes
    return cfg


# -------------------------- LM transformers --------------------------- #

# [arXiv:2403.17297; hf] — GQA kv=8
INTERNLM2_20B = _reg(
    TransformerConfig(
        arch_id="internlm2-20b",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92544, head_dim=128, rope_theta=1_000_000.0,
    ),
    LM_SHAPES,
)

# [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k context
GEMMA3_12B = _reg(
    TransformerConfig(
        arch_id="gemma3-12b",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_ff=15360, vocab=262144, head_dim=256,
        window=1024, local_global_ratio=5, qk_norm=True,
        rope_theta=1_000_000.0,
    ),
    LM_SHAPES,
)

# [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small
SMOLLM_360M = _reg(
    TransformerConfig(
        arch_id="smollm-360m",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab=49152, head_dim=64, rope_theta=10_000.0,
    ),
    LM_SHAPES,
)

# [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE 128e top-1,
# interleaved MoE every 2nd layer, shared expert (early-fusion backbone).
LLAMA4_MAVERICK = _reg(
    TransformerConfig(
        arch_id="llama4-maverick-400b-a17b",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128, rope_theta=500_000.0,
        moe=MoEConfig(
            n_experts=128, top_k=1, d_ff_expert=8192, every=2,
            d_ff_shared=8192,
        ),
    ),
    LM_SHAPES,
)

# [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts top-8, per-layer MoE, qk-norm
QWEN3_MOE = _reg(
    TransformerConfig(
        arch_id="qwen3-moe-235b-a22b",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, every=1),
    ),
    LM_SHAPES,
)

# ------------------------------- GNNs --------------------------------- #

# [arXiv:1609.02907; paper]
GCN_CORA = _reg(
    GNNConfig(
        arch_id="gcn-cora", model="gcn", n_layers=2, d_hidden=16,
        aggregator="mean", n_classes=7,
    ),
    GNN_SHAPES,
)

# [arXiv:2010.03409; unverified]
MESHGRAPHNET = _reg(
    GNNConfig(
        arch_id="meshgraphnet", model="meshgraphnet", n_layers=15,
        d_hidden=128, aggregator="sum", mlp_layers=2,
    ),
    GNN_SHAPES,
)

# [arXiv:2306.12059; unverified] — SO(2)-eSCN equivariant graph attention
EQUIFORMER_V2 = _reg(
    GNNConfig(
        arch_id="equiformer-v2", model="equiformer_v2", n_layers=12,
        d_hidden=128, l_max=6, m_max=2, n_heads=8,
    ),
    GNN_SHAPES,
)

# [arXiv:2206.07697; paper] — E(3)-ACE higher-order message passing
MACE = _reg(
    GNNConfig(
        arch_id="mace", model="mace", n_layers=2, d_hidden=128,
        l_max=2, correlation_order=3, n_rbf=8,
    ),
    GNN_SHAPES,
)

# ------------------------------ RecSys -------------------------------- #

# [arXiv:1703.04247; paper]
DEEPFM = _reg(
    RecSysConfig(
        arch_id="deepfm", n_sparse=39, embed_dim=10, mlp=(400, 400, 400),
        interaction="fm",
    ),
    RECSYS_SHAPES,
)

# ------------------------- CFPQ (the paper) --------------------------- #

CFPQ = _reg(
    CFPQConfig(
        arch_id="cfpq", n_nodes=65536, n_nonterms=8, n_prods=8,
        engine="dense",
    ),
    CFPQ_SHAPES,
)


def get_config(arch_id: str):
    return ARCHS[arch_id]


def get_shapes(arch_id: str) -> tuple[ShapeSpec, ...]:
    return SHAPES[arch_id]


def all_cells():
    """Every (arch, shape) dry-run cell, with inapplicable cells flagged."""
    cells = []
    for arch_id, cfg in ARCHS.items():
        if arch_id == "cfpq":
            continue  # the paper's workload has its own bench path
        for shape in SHAPES[arch_id]:
            skip = None
            if (
                isinstance(cfg, TransformerConfig)
                and shape.name == "long_500k"
                and not cfg.sub_quadratic
            ):
                skip = (
                    "pure full-attention arch: long_500k requires a "
                    "sub-quadratic attention story (DESIGN.md §Arch-applicability)"
                )
            cells.append((arch_id, shape, skip))
    return cells
