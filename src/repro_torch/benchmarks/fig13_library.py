"""Paper Fig. 13: math-library GEMM comparison (MKL vs MKL-DNN vs Eigen),
the port's analogue (counterpart of ``benchmarks/fig13_library.py``).

    python -m repro_torch.benchmarks.fig13_library [--device cpu]

Three fp32 GEMMs of n x n at each size of ``SIZES``, with the derived GFLOP/s:
``torch.matmul`` on the device (cuBLAS on the card, TF32 off: the port's
fp32 numerics), ``numpy.dot`` on the host (its BLAS), and a naive
broadcast-multiply-reduce on the device (n <= 512), which no library
call serves.  Device times by CUDA events on the card, host times by
``perf_counter``; medians of 10 calls after 2.  No kernel of the port is
involved: the figure compares libraries.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, time_fn
from repro_torch.device import resolve_device

SIZES = (256, 512, 1024)
NAIVE_MAX_N = 512


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    host = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    rows = []
    for n in SIZES:
        an = torch.randn(n, n, generator=gen).numpy()
        bn = torch.randn(n, n, generator=gen).numpy()
        a, b = torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev)
        flops = 2 * n ** 3
        times = {
            f"fig13.torch_{n}": time_fn(torch.matmul, a, b, device=dev),
            f"fig13.numpy_{n}": time_fn(np.dot, an, bn, device=host)}
        if n <= NAIVE_MAX_N:
            times[f"fig13.naive_{n}"] = time_fn(
                lambda x, y: (x[:, :, None] * y[None, :, :]).sum(dim=1),
                a, b, device=dev)
        for name, t in times.items():
            emit(name, t * 1e6, f"gflops={flops / t / 1e9:.1f}")
            rows.append(dict(name=name, n=n, seconds=t,
                             gflops=flops / t / 1e9))
    return rows


if __name__ == "__main__":
    main()
