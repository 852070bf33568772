"""End-to-end driver on the PyTorch/CUDA port: train a reduced LM for a few
hundred steps with checkpoint/restart fault tolerance.

    PYTHONPATH=src python3 examples/train_lm_torch.py                 # on the card
    PYTHONPATH=src python3 examples/train_lm_torch.py --device cpu

Equivalent to:
    python3 -m repro_torch.launch.train --arch smollm-360m --steps 300 \\
        --batch 8 --seq 128 --ckpt-dir $TMPDIR/repro_torch_lm_run --ckpt-every 100

The reference's ``examples/train_lm.py`` with the same flags, plus
``--device`` (default ``cuda``; without a card that raises); any flag
given here overrides its default.  Kill it at any point and re-run: it
resumes from the last checkpoint and reproduces the uninterrupted run
exactly (the data pipeline is keyed by step).
"""
from __future__ import annotations

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

DEFAULTS = [
    "--arch", "smollm-360m",
    "--steps", "300",
    "--batch", "8",
    "--seq", "128",
    "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_lm_run"),
    "--ckpt-every", "100",
    "--device", "cuda",
]


def main(argv: list[str] | None = None) -> int:
    return train_main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
