"""Sharded training: the tuner's plan as SPMD ranks, one process a rank,
a ``Trainer`` built inside ``axis_rules(make_rules(plan, mesh))`` on a
``("data", "model")`` ``DeviceMesh`` (``train/trainer``'s "Sharded").

    torchrun --nproc-per-node N -m repro_torch.examples.train_sharded
    torchrun --nproc-per-node 4 -m repro_torch.examples.train_sharded \\
        --device cpu --model 2 --setting tf --seq-shard

On the cards by default (rank ``r`` on ``cuda:<LOCAL_RANK>``, joined over
NCCL); ``--device cpu`` joins over gloo and runs the plain versions.
Reduced internlm2-1.8b at B 4 x S 64 unless ``--full`` (full width, B 4
x S 1024: ~7.2 GB of fp32 weights a rank before sharding).  ``--model``
ranks form the model axis, the rest the data axis; ``--setting`` picks
the tuner's plan for that mesh, and ``--fsdp``, ``--seq-shard`` and
``--cp`` switch its variants on.  ``--init-method`` replaces torchrun's
``env://`` rendezvous (with ``--rank`` and ``--world-size``).  Rank 0
prints each step's global loss and gradient norm and the ms a step.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tuner
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import sharding as sh
from repro_torch.train.trainer import Trainer, TrainerConfig

SETTINGS = {"guideline": tuner.guideline_plan, "tf": tuner.tf_setting,
            "intel": tuner.intel_setting}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full width (default: the reduced config)")
    ap.add_argument("--device", default=None,
                    help="cpu (gloo), or the card (NCCL; default)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the model axis (the rest: data)")
    ap.add_argument("--setting", choices=sorted(SETTINGS),
                    default="guideline")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--cp", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
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
        if world % args.model:
            raise ValueError(f"--model {args.model} does not divide "
                             f"{world} ranks")
        data = world // args.model
        mesh = mesh_lib.device_mesh((data, args.model), ("data", "model"),
                                    device_type="cpu" if cpu else "cuda")
        cfg = get_config("internlm2-1.8b")
        b, s = 4, 1024
        if not args.full:
            cfg, s = reduced(cfg), 64
        plan = SETTINGS[args.setting](cfg, ShapeConfig("train", "train",
                                                       s, b),
                                      model_axis=args.model, data_axis=data)
        plan = dataclasses.replace(plan, fsdp=plan.fsdp or args.fsdp,
                                   seq_shard=args.seq_shard, cp=args.cp)
        rules = tuner.make_rules(plan, mesh)
        tc = TrainerConfig(steps=args.steps, batch=b, seq_len=s,
                           log_every=1)
        with sh.axis_rules(rules):
            tr = Trainer(cfg, tc, device=resolve_device(args.device))
        hist = tr.run()["history"]
        if rank == 0:
            for row in hist:
                print(f"step {row['step']}: loss {row['loss']:.6f} "
                      f"grad_norm {row['grad_norm']:.6f} "
                      f"{row['step_time_s'] * 1e3:.1f} ms")
            print(f"{mesh_lib.describe(mesh)} plan {plan.name} fsdp "
                  f"{plan.fsdp} seq_shard {plan.seq_shard} cp {plan.cp}; "
                  f"fallbacks {rules.fallbacks}")
        return hist
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
