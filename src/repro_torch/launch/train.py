"""End-to-end training driver with fault tolerance (the port of the
reference's ``repro.launch.train``).

    PYTHONPATH=src python3 -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 --device cpu
    PYTHONPATH=src python3 -m repro_torch.launch.train --no-reduced    # full width, on the card

The reference driver's flags, behaviour and output lines, plus ``--device``
(default ``cuda``; without a card that raises) and ``--reduced`` as a
boolean flag (on by default; ``--no-reduced`` trains the full config):

  * checkpoint every ``--ckpt-every`` steps, atomic, auto-resume from the
    latest (kill the process at any point and run the same command again);
  * the stateless data pipeline keyed by step (a restart replays exactly);
  * a step-time watchdog: p50 over the last 20 steps, slow steps flagged.

Parameters are drawn from a ``torch.Generator`` seeded with 0, as the
reference driver seeds its parameters with ``PRNGKey(0)``.
The LM, GNN and DeepFM families train (a GNN on a random graph of 256
nodes and 1,024 edges with 16 features, as the reference driver draws it).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="train the reduced config (default); --no-reduced trains the full one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.configs.base import GNNConfig, RecSysConfig, TransformerConfig
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.core.matrices import resolve_device
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import data, optimizer as opt, trainer

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    opt_cfg = opt.OptimizerConfig(lr=args.lr)
    dev = resolve_device(args.device)

    if isinstance(cfg, TransformerConfig):
        from repro_torch.models.transformer import Transformer

        model = Transformer(cfg, device=dev, seed=0)

        def batch_fn(step):
            return data.lm_batch(cfg, args.batch, args.seq, step)

    elif isinstance(cfg, RecSysConfig):
        from repro_torch.models.recsys.deepfm import DeepFM

        model = DeepFM(cfg, device=dev, seed=0)

        def batch_fn(step):
            return data.recsys_batch(cfg, args.batch, step)

    elif isinstance(cfg, GNNConfig):
        from repro_torch.models.gnn.api import GNN

        model = GNN(cfg, d_feat=16, device=dev, seed=0)

        def batch_fn(step):
            return data.gnn_batch(cfg, n=256, e=1024, d_feat=16, step=step)

    else:
        raise SystemExit(f"--arch {args.arch} is not trainable (use benchmarks for cfpq)")

    opt_state = opt.init_opt_state(model, opt_cfg)
    step_fn = trainer.make_train_step(cfg, opt_cfg, n_micro=1)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir, keep=3)
        restored = mgr.restore_latest(ckpt_mod.training_tree(model, opt_state))
        if restored:
            start, tree, _ = restored
            ckpt_mod.load_training_tree(tree, model, opt_state)
            print(f"[train] resumed from step {start}")

    times: list[float] = []
    for step in range(start, args.steps):
        t0 = time.time()
        metrics = step_fn(model, opt_state, batch_fn(step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        times.append(dt)
        if len(times) > 20:
            times.pop(0)
        p50 = float(np.median(times))
        if len(times) >= 5 and dt > args.straggler_factor * p50:
            print(f"[train] WARN step {step} straggled: {dt:.3f}s vs p50 {p50:.3f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"[train] step {step} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt*1000:.0f}ms"
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            path = mgr.save(step + 1, ckpt_mod.training_tree(model, opt_state))
            print(f"[train] checkpoint -> {path}")
    if mgr:
        mgr.save(args.steps, ckpt_mod.training_tree(model, opt_state))
    print("[train] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
