"""Training launcher of the port (counterpart of ``repro/launch/train.py``),
on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt CKPT_DIR [--resume]

``--smoke`` trains the arch's reduced config, without it the full one.
It prints the reference's lines: one per logged step (``step N loss X
(T ms)``) and a final ``final loss: ...  stragglers flagged: N``.

``--production`` (with ``--shape``, ``--multi-pod``, ``--setting``) is
the reference's dry-run of the 256/512-chip configuration; the port has
no dry-run yet (ROADMAP A16), so it exits with status 2 and says so.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--setting", default="guideline")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.production:
        print(f"--production: the port has no dry-run of the "
              f"{args.shape} configuration yet; it waits for ROADMAP A16 "
              "(launch/dryrun.py, launch/build.py)", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, reduced
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tc = TrainerConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                       ckpt_dir=args.ckpt)
    tr = Trainer(cfg, tc, device=args.device)
    if args.resume and args.ckpt:
        start = tr.maybe_restore()
        print(f"resumed from step {start}")
    result = tr.run()
    for row in result["history"]:
        print(f"step {row['step']:5d} loss {row['loss']:.4f} "
              f"({row['step_time_s']*1e3:.0f} ms)")
    print(f"final loss: {result['final_loss']:.4f}  "
          f"stragglers flagged: {len(result['stragglers'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
