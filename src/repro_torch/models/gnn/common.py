"""The GNN substrate as torch ops (the port of the reference's
``models/gnn/common.py``): segment aggregation, the radial basis, and the
host-side neighbour sampler.

Message passing is a gather by edge source (``index_select``, whose
backward is an ``index_add``), per-edge math, then a scatter by edge
destination: ``index_add`` for sums, ``scatter_reduce(..., "amax")`` for
max.  The semantics are ``jax.ops``': an empty segment's sum is 0 and its
max ``-inf``; the max's gradient splits evenly between ties; a mean divides
by ``max(count, 1)``, for data of any rank (the reference's mean broadcasts
the counts as ``(num_segments, 1)``, which fits 2-D data only).  On the
card the scatter-adds are atomic, so f32 sums land in a varying order.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_full((num_segments, *data.shape[1:]), -math.inf)
    index = segment_ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=True)


def segment_agg(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    kind: str = "sum",
) -> torch.Tensor:
    if kind == "sum":
        return segment_sum(data, segment_ids, num_segments)
    if kind == "mean":
        s = segment_sum(data, segment_ids, num_segments)
        cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
        return s / torch.clamp(cnt, min=1.0).reshape(-1, *([1] * (data.dim() - 1)))
    if kind == "max":
        return segment_max(data, segment_ids, num_segments)
    raise ValueError(kind)


def segment_softmax(
    scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Softmax over edges grouped by destination (attention over neighbours)."""
    mx = segment_max(scores, segment_ids, num_segments)
    ex = torch.exp(scores - mx.index_select(0, segment_ids))
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(den.index_select(0, segment_ids), min=1e-20)


def gaussian_rbf(r: torch.Tensor, n_rbf: int, r_cut: float = 5.0) -> torch.Tensor:
    """(E,) -> (E, n_rbf) gaussian radial basis with a cosine cutoff."""
    mu = torch.linspace(0.0, r_cut, n_rbf, dtype=r.dtype, device=r.device)
    gamma = (n_rbf / r_cut) ** 2
    basis = torch.exp(-gamma * (r[:, None] - mu[None, :]) ** 2)
    envelope = 0.5 * (torch.cos(math.pi * torch.clamp(r / r_cut, 0, 1)) + 1.0)
    return basis * envelope[:, None]


# ---------------------------------------------------------------------- #
# Neighbour sampling (minibatch_lg): the host-side CSR fanout sampler,
# numpy as in the reference.
# ---------------------------------------------------------------------- #


class CSRGraph:
    """Host-side CSR adjacency for sampling."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(dst, kind="stable")
        self.n_nodes = n_nodes
        self.indices = src[order].astype(np.int32)  # in-neighbours per node
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        self.indptr = np.cumsum(self.indptr)

    @classmethod
    def random(cls, n_nodes: int, n_edges: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
        dst = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
        return cls(n_nodes, src, dst)


def sampled_sizes(batch_nodes: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """(max_nodes, max_edges) of the fixed-shape sampled subgraph."""
    n, e, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += frontier * f
        frontier = frontier * f
        n += frontier
    return n, e


def sample_subgraph(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    seed: int = 0,
):
    """Layer-wise uniform fanout sampling (GraphSAGE style).

    Returns fixed-shape arrays (padded): a local edge list (src, dst) over a
    node table whose first ``len(seeds)`` entries are the seeds, plus the
    global node ids and a validity mask.
    """
    rng = np.random.default_rng(seed)
    max_nodes, max_edges = sampled_sizes(len(seeds), fanouts)
    nodes = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    e_src, e_dst = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi == lo:
                continue
            picks = g.indices[rng.integers(lo, hi, size=min(f, hi - lo))]
            for u in picks:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                e_src.append(local[u])
                e_dst.append(local[int(v)])
        frontier = nxt
    n, e = len(nodes), len(e_src)
    node_ids = np.zeros(max_nodes, np.int32)
    node_ids[:n] = nodes
    node_mask = np.zeros(max_nodes, np.float32)
    node_mask[:n] = 1.0
    src = np.full(max_edges, max_nodes - 1, np.int32)
    dst = np.full(max_edges, max_nodes - 1, np.int32)
    src[:e] = e_src
    dst[:e] = e_dst
    edge_mask = np.zeros(max_edges, np.float32)
    edge_mask[:e] = 1.0
    return {
        "node_ids": node_ids,
        "node_mask": node_mask,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": edge_mask,
    }
