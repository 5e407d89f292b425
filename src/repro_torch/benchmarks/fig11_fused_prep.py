"""Paper Fig. 11/12: parallelizing data preparation (MatMul2) — on the
card, fusing the prep into the consumer kernel removes the round trip of
the prepared matrix through device memory.

    python -m repro_torch.benchmarks.fig11_fused_prep [--device cuda] \
        [--n 1024]

Measured two ways, on fig09's inputs (int8 x, fp32 w, fp32 row scales):

  * time: "fused" is ``fused_matmul`` (the hand-written CUDA kernel on
    the card: upcast and row scale per tile, inside the product);
    "unfused" is ``matmul1``: ``prep`` then ``torch.matmul``, with the
    prepared fp32 x materialized between them.  Both in fp32, TF32 off.
  * structurally: bytes each program must move, counted from the shapes
    (each input read once, each output written once), since torch has no
    ``cost_analysis``.  Unfused: prep reads x (n^2) and the scales (4n)
    and writes the prepared x (4n^2), then the product reads it and w and
    writes out (12n^2): ``unfused_bytes``.  Fused: x, the scales, w and
    out once: ``fused_bytes``, 47.0% fewer at n = 1024.

On XLA:CPU the reference's "fused" jit does not fuse the prep into the
dot: its ``cost_analysis`` reports 17n^2 bytes there too, and 0% saved.
Its unfused sum equals ``unfused_bytes`` exactly.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.benchmarks.common import emit, time_fn
from repro_torch.benchmarks.fig09_operator_scaling import make_inputs
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_matmul.ops import fused_matmul
from repro_torch.kernels.fused_matmul.ref import matmul1


def unfused_bytes(n: int) -> int:
    """prep: x (int8) and the scales read, the fp32 copy written
    (5n^2 + 4n); the product: the copy and w read, out written (12n^2)."""
    return 17 * n * n + 4 * n


def fused_bytes(n: int) -> int:
    """int8 x, fp32 scales, fp32 w and fp32 out, each once."""
    return 9 * n * n + 4 * n


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=1024, help="square size n")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n
    x8, w, sc = make_inputs(n, dev)
    fused_calls = 0

    def fused(a, b, s):
        nonlocal fused_calls
        fused_calls += 1
        return fused_matmul(a, b, s, out_dtype=torch.float32)

    def unfused(a, b, s):
        return matmul1(a, b, s, out_dtype=torch.float32)

    t_fused = time_fn(fused, x8, w, sc, device=dev)
    t_unfused = time_fn(unfused, x8, w, sc, device=dev)
    b_fused, b_unfused = fused_bytes(n), unfused_bytes(n)
    emit("fig11.fused_prep", t_fused * 1e6,
         f"speedup={t_unfused / t_fused:.2f}x,bytes_saved_pct="
         f"{100 * (1 - b_fused / b_unfused):.1f}")
    emit("fig11.unfused_prep", t_unfused * 1e6, f"bytes={b_unfused:.3e}")
    return {"fused_us": t_fused * 1e6, "unfused_us": t_unfused * 1e6,
            "speedup": t_unfused / t_fused, "bytes_fused": b_fused,
            "bytes_unfused": b_unfused, "fused_calls": fused_calls}


if __name__ == "__main__":
    main()
