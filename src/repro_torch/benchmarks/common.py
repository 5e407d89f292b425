"""Shared benchmark helpers: timing, CSV output, the serve workloads'
teardown check and JSON trajectories, as the reference's
``benchmarks/common.py`` has them."""

from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, Dict, List, Union

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


def assert_clean_teardown(eng, requests=(), label: str = "workload") -> int:
    """End-of-workload invariants every serve workload must satisfy
    before its numbers enter the record: zero leaked page references
    (``Engine.leaked_pages``), a drained admission queue, no slot still
    holding a request, and every tracked request in a terminal status.
    Returns the leak count (0 on success)."""
    from repro_torch.serve.scheduler import RequestStatus

    leaked = eng.leaked_pages()
    assert leaked == 0, f"{label}: {leaked} page refs leaked at teardown"
    assert not eng.queue, (
        f"{label}: {len(eng.queue)} requests still queued at teardown")
    live = [r.rid for r in eng._slot_req if r is not None]
    assert not live, f"{label}: slots still live at teardown: {live}"
    bad = [(r.rid, r.status) for r in requests
           if r.status not in RequestStatus.TERMINAL]
    assert not bad, f"{label}: non-terminal requests at teardown: {bad}"
    return leaked


def write_bench_json(path: Union[str, pathlib.Path],
                     record: Dict) -> pathlib.Path:
    """Append ``record`` (stamped with wall time) to the trajectory file
    ``{"runs": [...]}`` at ``path``, so successive runs accumulate a
    history.  An unreadable file is kept beside it as ``.corrupt``."""
    path = pathlib.Path(path)
    data = {"runs": []}
    if path.exists():
        loaded = None
        try:
            loaded = json.loads(path.read_text())
        except (ValueError, OSError):
            pass
        if isinstance(loaded, dict) and \
                isinstance(loaded.get("runs", []), list):
            data = loaded
        else:
            bak = path.with_suffix(".corrupt")
            path.rename(bak)
            print(f"# {path.name} unreadable; preserved as {bak.name}")
    data.setdefault("runs", []).append({"ts": time.time(), **record})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return path


def merge_into_last_run(path: Union[str, pathlib.Path],
                        record: Dict) -> pathlib.Path:
    """Merge ``record`` into the last run of the trajectory file at
    ``path``, for workloads that live in another benchmark module but
    belong to the same run (fig04's ``--slo-mix`` and ``--trace-report``
    extend fig14's serve record).  Appends a fresh run when the file has
    none."""
    path = pathlib.Path(path)
    data = None
    if path.exists():
        try:
            data = json.loads(path.read_text())
        except (ValueError, OSError):
            data = None
    if not (isinstance(data, dict) and isinstance(data.get("runs"), list)
            and data["runs"]):
        return write_bench_json(path, record)
    data["runs"][-1].update(record)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return path
