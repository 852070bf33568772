"""Batched LM serving on the PyTorch/CUDA port: prefill a batch of prompts,
decode greedily with a KV cache.

    PYTHONPATH=src python3 examples/serve_lm_torch.py --no-reduced      # smollm-360m at full width, on the card
    PYTHONPATH=src python3 examples/serve_lm_torch.py --arch gemma3-12b \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu                 # the reduced config

The flags and output lines of the reference's ``repro.launch.serve``, plus
``--device`` (default ``cuda``; without a card that raises).  ``--reduced``
is on by default and ``--no-reduced`` serves the full config.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import registry
from repro_torch.configs.reduce import reduce_config
from repro_torch.launch.serve import serve


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (default); --no-reduced serves the full one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    res = serve(cfg, args.batch, args.prompt_len, args.gen, device=args.device)
    print(f"[serve] arch={cfg.arch_id} batch={args.batch}")
    print(f"[serve] prefill {args.prompt_len} tokens: {res['prefill_ms']:.0f}ms")
    print(f"[serve] decode latency p50={res['p50_ms']:.1f}ms p95={res['p95_ms']:.1f}ms")
    print(f"[serve] generated token ids (first row): {res['tokens'][0].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
