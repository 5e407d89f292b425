"""Paper Fig. 1: time breakdown across the programming abstraction, for
eager PyTorch on the card (counterpart of ``benchmarks/fig01_breakdown.py``).

    python -m repro_torch.benchmarks.fig01_breakdown [--device cpu]

One ``forward_train`` loss on tokens [8, 64], as the reference's step.
Eager torch has no trace and no compile, so its programmability tax is
the first call's excess over a steady one: loading the kernels,
allocator growth, first-call dispatch.  ``fig01.first_step`` is that
first call, ``fig01.steady_step`` the mean of 20 later ones
with the tax amortized over 100 steps.  On the card internlm2-1.8b at
full width and depth (every attention layer launches
``flash_attention``); on the CPU its ``reduced()`` form, with the plain
attention.  Each call ends in a device synchronize.  The first step is
the first call only in a process of its own: after other work on the
card the kernels are loaded and the allocator has grown.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import forward_train, model_defs
from repro_torch.models.module import init_params

TOKENS = (8, 64)
ITERS = 20      # steady calls timed after one warm call, as the reference


def step_inputs(dev: torch.device) -> Tuple[ModelConfig, dict, dict]:
    """-> (cfg, params, batch) of the figure's step on ``dev``: seeded
    weights and tokens [8, 64] with their next-token labels."""
    cfg = get_config("internlm2-1.8b")
    if dev.type != "cuda":
        cfg = reduced(cfg)
    params = init_params(model_defs(cfg), 0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, TOKENS, generator=gen,
                           device=dev)
    return cfg, params, {"tokens": tokens,
                         "labels": torch.roll(tokens, -1, 1)}


def breakdown(cfg: ModelConfig, params: dict, batch: dict,
              dev: torch.device) -> dict:
    """Times the first, one warm and ``ITERS`` steady ``forward_train``
    calls and emits the figure's two rows."""

    def step() -> torch.Tensor:
        loss, _ = forward_train(params, cfg, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return loss

    with torch.no_grad():
        t0 = time.perf_counter()
        loss = step()
        t_first = time.perf_counter() - t0
        step()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        t_steady = (time.perf_counter() - t0) / ITERS
    tax = max(t_first - t_steady, 0.0)
    pct = 100 * tax / (tax + 100 * t_steady)
    emit("fig01.first_step", t_first * 1e6,
         f"one-time,excess_us={tax * 1e6:.1f}")
    emit("fig01.steady_step", t_steady * 1e6,
         f"amortized_tax_pct_100steps={pct:.1f}")
    loss = float(loss)
    return dict(first_step_s=t_first, steady_step_s=t_steady,
                one_time_s=tax, amortized_tax_pct_100steps=pct, loss=loss,
                loss_finite=math.isfinite(loss), forwards=ITERS + 2,
                arch=cfg.name, layers=cfg.num_layers, tokens=list(TOKENS),
                device=str(dev))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return breakdown(*step_inputs(dev), dev)

if __name__ == "__main__":
    main()
