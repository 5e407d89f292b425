"""Shared benchmark helpers: timing and CSV output, as the reference's
``benchmarks/common.py`` prints them."""

from __future__ import annotations

import time
from typing import Callable, List

import torch


def time_fn(fn: Callable, *args, device: torch.device, warmup: int = 2,
            iters: int = 10) -> float:
    """Median seconds per call after ``warmup`` calls.  On a CUDA device
    each call lies between two CUDA events (device time, the result
    consumed by the event's wait); on the CPU, ``perf_counter``."""
    for _ in range(warmup):
        fn(*args)
    times: List[float] = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")
