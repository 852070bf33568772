"""Architecture/config dataclasses for every assigned family.

A copy of the reference's ``configs/base.py`` (it imports no JAX), so the
port keeps its own.  Every config is hashable and carries its own shape
table; ``repro_torch/configs/registry.py`` maps ``--arch`` ids to instances.
"""
from __future__ import annotations

from dataclasses import dataclass, field


# ---------------------------------------------------------------------- #
# LM transformers
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1  # MoE layer every `every` layers (llama4 interleaves)
    d_ff_shared: int = 0  # shared-expert FFN width (0 = none)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class TransformerConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    window: int = 0  # sliding-window size for local layers (0 = none)
    local_global_ratio: int = 0  # e.g. 5 -> pattern [5x local, 1x global]
    moe: MoEConfig | None = None
    qk_norm: bool = False
    dtype: str = "bfloat16"
    attn_chunk: int = 1024  # flash-attention KV chunk (roofline counting
    # variants lower with attn_chunk == seq_len so the chunk scan vanishes
    # and cost_analysis sees the whole contraction)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_is_local(self, layer: int) -> bool:
        if not self.local_global_ratio or not self.window:
            return False
        return (layer % (self.local_global_ratio + 1)) != self.local_global_ratio

    def layer_is_moe(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every == self.moe.every - 1)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch has a sub-quadratic attention story (local:global
        interleave) — gates the long_500k shape per the assignment."""
        return bool(self.window and self.local_global_ratio)

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        per_dense = 3 * d * self.d_ff
        total = 0
        for layer in range(self.n_layers):
            total += attn + 2 * d  # norms
            if self.layer_is_moe(layer):
                m = self.moe
                total += m.n_experts * 3 * d * m.d_ff_expert
                total += self.n_heads * 0  # router below
                total += d * m.n_experts
                if m.d_ff_shared:
                    total += 3 * d * m.d_ff_shared
            else:
                total += per_dense
        total += 2 * self.vocab * d + d  # embed, unembed, final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (6*N_active*D convention for MoE)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        total = 0
        for layer in range(self.n_layers):
            total += attn + 2 * d
            if self.layer_is_moe(layer):
                m = self.moe
                total += m.top_k * 3 * d * m.d_ff_expert + d * m.n_experts
                if m.d_ff_shared:
                    total += 3 * d * m.d_ff_shared
            else:
                total += 3 * d * self.d_ff
        total += 2 * self.vocab * d + d
        return total


# ---------------------------------------------------------------------- #
# GNNs
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    model: str  # gcn | meshgraphnet | equiformer_v2 | mace
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    mlp_layers: int = 2
    l_max: int = 0
    m_max: int = 0
    n_heads: int = 0
    correlation_order: int = 0
    n_rbf: int = 8
    n_classes: int = 16
    dtype: str = "float32"


# ---------------------------------------------------------------------- #
# RecSys
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class RecSysConfig:
    arch_id: str
    n_sparse: int = 39
    n_dense: int = 13
    embed_dim: int = 10
    mlp: tuple[int, ...] = (400, 400, 400)
    interaction: str = "fm"
    vocab_per_field: int = 1_000_000  # rows per sparse table
    multi_hot: int = 4  # lookups per field (embedding-bag width)
    dtype: str = "float32"


# ---------------------------------------------------------------------- #
# CFPQ (the paper's own workload, as a first-class arch)
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class CFPQConfig:
    arch_id: str
    n_nodes: int  # padded matrix size
    n_nonterms: int
    n_prods: int
    engine: str = "dense"  # dense | bitpacked | frontier


# ---------------------------------------------------------------------- #
# Shape descriptors
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | graph_full | graph_sampled | ...
    dims: tuple[tuple[str, int], ...] = field(default_factory=tuple)

    def dim(self, key: str) -> int:
        return dict(self.dims)[key]


LM_SHAPES = (
    ShapeSpec("train_4k", "train", (("seq_len", 4096), ("global_batch", 256))),
    ShapeSpec("prefill_32k", "prefill", (("seq_len", 32768), ("global_batch", 32))),
    ShapeSpec("decode_32k", "decode", (("seq_len", 32768), ("global_batch", 128))),
    ShapeSpec("long_500k", "decode", (("seq_len", 524288), ("global_batch", 1))),
)

GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm",
        "graph_full",
        (("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433)),
    ),
    ShapeSpec(
        "minibatch_lg",
        "graph_sampled",
        (
            ("n_nodes", 232_965),
            ("n_edges", 114_615_892),
            ("batch_nodes", 1024),
            ("fanout1", 15),
            ("fanout2", 10),
            ("d_feat", 602),
        ),
    ),
    ShapeSpec(
        "ogb_products",
        "graph_full",
        (("n_nodes", 2_449_029), ("n_edges", 61_859_140), ("d_feat", 100)),
    ),
    ShapeSpec(
        "molecule",
        "graph_batched",
        (("n_nodes", 30), ("n_edges", 64), ("batch", 128), ("d_feat", 32)),
    ),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", (("batch", 65536),)),
    ShapeSpec("serve_p99", "serve", (("batch", 512),)),
    ShapeSpec("serve_bulk", "serve", (("batch", 262144),)),
    ShapeSpec(
        "retrieval_cand", "retrieval", (("batch", 1), ("n_candidates", 1_000_000))
    ),
)

CFPQ_SHAPES = (
    ShapeSpec("closure_64k", "cfpq", (("n_nodes", 65536),)),
    ShapeSpec("closure_256k", "cfpq", (("n_nodes", 262144),)),
)
