"""Data-parallel serving: ``Engine(rules=...)`` on SPMD ranks, one process
a rank, each holding ``slots / N`` slots and its own range of every pool's
pages (``serve/engine``'s "Data-parallel serving").

    torchrun --nproc-per-node N -m repro_torch.examples.serve_sharded
    torchrun --nproc-per-node 2 -m repro_torch.examples.serve_sharded --device cpu

On the cards by default (rank ``r`` on ``cuda:<LOCAL_RANK>``, joined over
NCCL); ``--device cpu`` joins over gloo and runs the plain versions.
Reduced internlm2-1.8b unless ``--full`` (full width: ~7.6 GB of fp32
weights a rank, which every rank holds).  ``--init-method`` replaces
torchrun's ``env://`` rendezvous (with ``--rank`` and ``--world-size``).
Every rank submits the same 12 requests and holds the same tokens; rank
0 prints them, and each rank its share of the slots and pages.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_defs
from repro_torch.models.module import init_params
from repro_torch.parallel import sharding as sh
from repro_torch.serve.engine import Engine, Request


def main(argv: Optional[List[str]] = None) -> Dict[int, List[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full width (default: the reduced config)")
    ap.add_argument("--device", default=None,
                    help="cpu (gloo), or the card (NCCL; default)")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    cpu = args.device == "cpu"
    rank = mesh_lib.join_process_group(
        "gloo" if cpu else "nccl", rank=args.rank,
        world_size=args.world_size, init_method=args.init_method)
    try:
        world = dist.get_world_size()
        mesh = mesh_lib.device_mesh((world,), ("data",),
                                    device_type="cpu" if cpu else "cuda")
        dev = resolve_device(args.device)
        cfg = get_config("internlm2-1.8b")
        if not args.full:
            cfg = reduced(cfg)
        params = init_params(model_defs(cfg), 0, device=dev)
        rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                         mesh=mesh)
        eng = Engine(cfg, params, slots=8, max_len=256, device=dev,
                     rules=rules)
        # every other prompt opens with one 24-token head: prefix hits
        head = [(5 * j) % (cfg.vocab_size - 1) + 1 for j in range(24)]
        for i in range(12):
            tail = [(7 * i + j) % (cfg.vocab_size - 1) + 1
                    for j in range(1 + i % 5)]
            eng.submit(Request(rid=i, prompt=(head if i % 2 == 0 else [])
                               + tail, max_new_tokens=16))
        t0 = time.perf_counter()
        done = {r.rid: list(r.out_tokens) for r in eng.run(10 ** 6)}
        dt = time.perf_counter() - t0
        if rank == 0:
            for rid in sorted(done):
                print(f"req {rid}: {done[rid]}")
            print(f"{len(done)} requests / "
                  f"{sum(map(len, done.values()))} tokens in {dt:.2f}s on "
                  f"{mesh_lib.describe(mesh)}; prefix hits "
                  f"{eng.prefix_stats()['prefix_hits']}; fallbacks "
                  f"{rules.fallbacks}")
        share = eng.memory_stats()["rank"]
        print(f"rank {rank}: slots {share['slots']}, pages "
              f"{share['num_pages']}, pool bytes {share['paged_kv_bytes']}")
        return done
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
