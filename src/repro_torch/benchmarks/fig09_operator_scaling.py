"""Paper Fig. 9/10: MatMul scaling and the data-preparation overhead, on
the card.

    python -m repro_torch.benchmarks.fig09_operator_scaling \
        [--device cuda] [--sizes 256,512,1024,2048]

For square MatMuls of growing size, compare the bare library product on
an already-prepared fp32 x against the framework operator that must
first run the data preparation (upcast of an int8 x + per-row scale,
materialized separately: ``matmul1``, the paper's MatMul1).  The prep
overhead fraction shrinks as O(n^2)/O(n^3), matching the paper's Amdahl
analysis; the derived column reports it.  Both sides run in fp32 with
TF32 off.  No hand-written kernel runs here, as none runs in the
reference's ``benchmarks/fig09_operator_scaling.py``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.benchmarks.common import emit, time_fn
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_matmul.ref import matmul1, prep


def make_inputs(n: int, device: torch.device, seed: int = 0):
    """int8 x [n,n] in [-127, 127), fp32 w [n,n] ~ N(0, 1) and fp32 row
    scales [n,1] ~ |N(0, 1)|, from one seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x8 = torch.randint(-127, 127, (n, n), generator=gen, device=device,
                       dtype=torch.int8)
    w = torch.randn(n, n, generator=gen, device=device)
    sc = torch.randn(n, 1, generator=gen, device=device).abs()
    return x8, w, sc


def _op(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return matmul1(a, b, s, out_dtype=torch.float32)


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--sizes", default="256,512,1024,2048",
                    help="comma-separated square sizes n")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    results = {}
    for n in (int(s) for s in args.sizes.split(",")):
        x8, w, sc = make_inputs(n, dev)
        xf = prep(x8, sc)
        t_bare = time_fn(torch.matmul, xf, w, device=dev)  # TF32 off
        t_op = time_fn(_op, x8, w, sc, device=dev)
        overhead = max(t_op - t_bare, 0.0)
        emit(f"fig09.matmul_{n}", t_op * 1e6,
             f"kernel_us={t_bare * 1e6:.1f},prep_overhead_pct="
             f"{100 * overhead / t_op:.1f}")
        results[n] = {"op_us": t_op * 1e6, "bare_us": t_bare * 1e6}
    return results


if __name__ == "__main__":
    main()
