"""Quickstart: train a reduced gemma2 for 100 steps, watch the loss
fall, checkpoint, and resume (counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card by default; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    cfg = reduced(get_config("gemma2-2b"), layers=2, d_model=64)
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainerConfig(steps=100, batch=8, seq_len=32, ckpt_dir=ckpt,
                           ckpt_every=50, log_every=20)
        trainer = Trainer(cfg, tc, device=args.device)
        result = trainer.run()
        print("--- loss curve ---")
        for row in result["history"]:
            print(f"step {row['step']:4d}  loss {row['loss']:.4f}")
        first, last = result["history"][0], result["history"][-1]
        if not last["loss"] < first["loss"]:
            raise RuntimeError("loss did not decrease!")
        print(f"\nloss fell {first['loss']:.3f} -> {last['loss']:.3f}; "
              f"checkpoints written to {ckpt}")

        # resume from the checkpoint and take a few more steps
        trainer2 = Trainer(cfg, TrainerConfig(steps=110, batch=8, seq_len=32,
                                              ckpt_dir=ckpt),
                           device=args.device)
        start = trainer2.maybe_restore()
        print(f"restored at step {start}; continuing to 110")
        trainer2.run()
        print("resume OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
