"""Stateless synthetic data pipelines, keyed by (arch, step): the port of the
reference's ``train/data.py`` (numpy only, no torch).

Every batch is a pure function of the arch and the global step, so a
restarted run replays the same sequence with no reader state to persist
(the checkpoint holds only the step counter).  The seed comes from
``zlib.crc32`` of the arch id, which every process computes alike; the
reference hashes the id with ``hash``, which Python salts per process, so
its batches change from one process to the next.  Past that the formula is
the reference's.
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.configs.base import GNNConfig, RecSysConfig, TransformerConfig
from repro_torch.models.gnn.dims import D_OUT


def _rng(arch_id: str, step: int) -> np.random.Generator:
    seed = (zlib.crc32(arch_id.encode()) & 0xFFFF_FFFF) ^ (step * 0x9E3779B9 & 0xFFFF_FFFF)
    return np.random.default_rng(seed)


def lm_batch(cfg: TransformerConfig, batch: int, seq: int, step: int, n_micro: int = 1):
    """``{"tokens", "targets"}`` int32 (batch, seq), the targets the tokens
    shifted by one; with ``n_micro > 1`` reshaped to (n_micro, batch //
    n_micro, seq)."""
    rng = _rng(cfg.arch_id, step)
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int64)
    b = {
        "tokens": toks[:, :-1].astype(np.int32),
        "targets": toks[:, 1:].astype(np.int32),
    }
    if n_micro > 1:
        if batch % n_micro:
            raise ValueError(f"batch {batch} does not split into {n_micro} microbatches")
        b = {k: v.reshape(n_micro, batch // n_micro, seq) for k, v in b.items()}
    return b


def gnn_batch(cfg: GNNConfig, n: int, e: int, d_feat: int, step: int):
    """A random graph of ``n`` nodes and ``e`` edges (uniform endpoints, so
    self-loops and repeats occur) in the GNN batch layout
    (``models/gnn/api.py``): normal positions and features, the edges'
    relative positions and lengths, every node and edge valid, class
    labels and normal regression targets."""
    rng = _rng(cfg.arch_id, step)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    rel = pos[dst] - pos[src]
    d_out = D_OUT.get(cfg.model) or 1
    return {
        "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
        "positions": pos,
        "edge_src": src,
        "edge_dst": dst,
        "edge_feat": np.concatenate(
            [rel, np.linalg.norm(rel, axis=1, keepdims=True)], axis=1
        ).astype(np.float32),
        "node_mask": np.ones(n, np.float32),
        "edge_mask": np.ones(e, np.float32),
        "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
        "targets": rng.normal(size=(n, d_out)).astype(np.float32),
    }


def recsys_batch(cfg: RecSysConfig, batch: int, step: int):
    """Multi-hot ids with a validity mask (7 in 10 kept), dense features and
    0/1 labels."""
    rng = _rng(cfg.arch_id, step)
    M = cfg.multi_hot
    return {
        "sparse_ids": rng.integers(
            0, cfg.vocab_per_field, (batch, cfg.n_sparse, M)
        ).astype(np.int32),
        "sparse_mask": (rng.random((batch, cfg.n_sparse, M)) < 0.7).astype(
            np.float32
        ),
        "dense_feat": rng.normal(size=(batch, cfg.n_dense)).astype(np.float32),
        "labels": rng.integers(0, 2, batch).astype(np.int32),
    }
