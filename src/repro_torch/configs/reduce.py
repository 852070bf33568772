"""Reduced same-family configs for CPU tests and the card's quick checks; a copy
of the reference's ``configs/reduce.py``.  Of the full LM configs the card
serves ``smollm-360m``; the tests build the others on the ``meta`` device."""
from __future__ import annotations

import dataclasses

from .base import GNNConfig, MoEConfig, RecSysConfig, TransformerConfig


def reduce_config(cfg):
    if isinstance(cfg, TransformerConfig):
        moe = cfg.moe
        if moe is not None:
            moe = MoEConfig(
                n_experts=4,
                top_k=min(moe.top_k, 2),
                d_ff_expert=32,
                every=moe.every,
                d_ff_shared=32 if moe.d_ff_shared else 0,
            )
        if cfg.moe:
            n_layers = cfg.moe.every * 2  # two full blocks
        elif cfg.local_global_ratio:
            n_layers = cfg.local_global_ratio + 1  # one local:global period
        else:
            n_layers = 2
        odd_heads = cfg.n_heads % 2 == 1  # keep smollm's odd-head regime
        return dataclasses.replace(
            cfg,
            n_layers=n_layers,
            d_model=64,
            n_heads=3 if odd_heads else 4,
            n_kv_heads=1 if odd_heads else 2,
            head_dim=16,
            d_ff=96,
            vocab=256,
            window=min(cfg.window, 16) if cfg.window else 0,
            moe=moe,
        )
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(
            cfg,
            n_layers=2,
            d_hidden=16,
            l_max=min(cfg.l_max, 2) if cfg.l_max else 0,
            n_heads=min(cfg.n_heads, 2) if cfg.n_heads else 0,
            n_rbf=4 if cfg.n_rbf else 0,
        )
    if isinstance(cfg, RecSysConfig):
        return dataclasses.replace(
            cfg,
            n_sparse=6,
            embed_dim=8,
            mlp=(32, 32),
            vocab_per_field=1000,
        )
    return cfg
