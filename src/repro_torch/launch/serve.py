"""Batched LM serving: prefill a batch of prompts, then decode greedily with
a KV cache (the library side of the reference's ``launch/serve.py``; the
CLI is ``examples/serve_lm_torch.py``).

As the reference does, the prompt goes through ``serve_step`` one token at a
time (the cache's warm-up), then each decode step feeds the last greedy
token.  ``serve`` returns the timings and the token ids and prints nothing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.core.matrices import resolve_device
from repro_torch.models.transformer import Transformer, init_cache, serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prompts(cfg: TransformerConfig, batch: int, prompt_len: int, seed: int = 0) -> torch.Tensor:
    """The seeded prompt ids (batch, prompt_len), drawn on the CPU so that
    every device serves the same prompts."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)


def serve(cfg: TransformerConfig, batch: int, prompt_len: int, gen: int, *, device="cuda",
          seed: int = 0, model: Transformer | None = None) -> dict:
    """Serve ``batch`` seeded prompts of ``prompt_len`` tokens and decode
    ``gen`` greedy steps.  ``model`` defaults to a ``Transformer`` drawn
    from ``seed`` on ``device``; one given must be built from ``cfg`` (its
    ``dtype`` aside: ``cfg`` sets the activation dtype).

    Returns ``prefill_ms`` (the prompt through the cache), ``decode_ms`` (one
    host-clock latency per step, each ending in a synchronize), their
    ``p50_ms`` / ``p95_ms``, ``tokens_per_s`` (batch * gen over the decode
    time), ``prompts`` and ``tokens`` (the ids each decode step chose,
    (batch, gen), as the reference prints them).
    """
    if prompt_len < 1 or gen < 1:
        raise ValueError(f"need a prompt and a decode step, got prompt_len={prompt_len}, gen={gen}")
    dev = resolve_device(device)
    if model is None:
        model = Transformer(cfg, device=dev, seed=seed)
    elif model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, not on {dev}")
    dev = model.device
    max_seq = prompt_len + gen
    ids = _prompts(cfg, batch, prompt_len, seed).to(dev)
    cache = init_cache(cfg, batch, max_seq, device=dev)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(prompt_len):
            logits, cache = serve_step(model, cache, ids[:, t:t + 1], t, cfg)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3

        tok = logits.argmax(dim=-1)[:, None]
        out, lat = [], []
        for t in range(prompt_len, max_seq):
            t0 = time.perf_counter()
            logits, cache = serve_step(model, cache, tok, t, cfg)
            tok = logits.argmax(dim=-1)[:, None]
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            out.append(tok[:, 0])
    return {
        "arch": cfg.arch_id,
        "batch": batch,
        "prompt_len": prompt_len,
        "gen": gen,
        "device": str(dev),
        "prefill_ms": prefill_ms,
        "decode_ms": lat,
        "p50_ms": float(np.median(lat)),
        "p95_ms": float(np.percentile(lat, 95)),
        "tokens_per_s": batch * gen / (sum(lat) / 1e3),
        "prompts": ids.cpu().numpy(),
        "tokens": torch.stack(out, dim=1).cpu().numpy(),
    }
