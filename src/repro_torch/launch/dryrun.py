"""Multi-pod dry-run of the port (counterpart of ``repro/launch/dryrun.py``):
count every live (architecture x input-shape) cell on the 16x16
single-pod mesh and the 2x16x16 multi-pod mesh, and dump the roofline
inputs to ``results/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --multi-pod --setting guideline

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's analyses.  The port runs one device's share of
the step on ``meta`` tensors (``launch/build``), counts it op by op
(``analysis/count``), lists the plan's collectives
(``analysis/collectives``) and prices the three terms on the H100's data
sheet (``analysis/roofline``).  Nothing touches a device: a cell takes
seconds on the CPU.  Each row keeps the reference's fields, with
``count_s`` in place of ``lower_s`` and ``compile_s``, the counter's
breakdown by family (``by_family``) and the local view (``view``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import collectives as coll
from repro_torch.analysis import roofline
from repro_torch.configs import live_cells
from repro_torch.launch import build as buildlib

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
ORDER = {"decode_32k": 0, "long_500k": 1, "prefill_32k": 2, "train_4k": 3}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             setting: str = "guideline", factored: bool = False,
             save: bool = True, verbose: bool = True,
             results: Optional[Path] = None) -> dict:
    t0 = time.time()
    built = buildlib.build(arch, shape_name, setting=setting,
                           multi_pod=multi_pod, factored=factored)
    mesh_name = ("multi" if multi_pod else "single") + \
        ("-factored" if factored and built.plan.pools > 1 else "")
    chips = 512 if multi_pod else 256

    counter, mem = built.count()
    colls = coll.step_collectives(built.cfg, built.shape, built.plan,
                                  built.rules)
    t_count = time.time() - t0
    roof = roofline.analyze(
        built.cfg, built.shape, arch=arch, mesh_name=mesh_name,
        setting=setting, chips=chips,
        cost=counter.cost(), collectives=colls, memory_stats=mem,
        note=built.notes)
    row = roof.row()
    row.update({
        "plan": {"pools": built.plan.pools, "intra": built.plan.intra,
                 "data": built.plan.data, "fsdp": built.plan.fsdp,
                 "seq_shard": built.plan.seq_shard,
                 "pod_mode": built.plan.pod_mode},
        "count_s": round(t_count, 2),
        "memory_analysis": roofline.memory_stats_dict(mem),
        "sharding_fallbacks": sorted(set(built.rules.fallbacks)),
        "by_family": counter.families(),
        "elementwise": counter.elementwise,
        "view": built.view,
        "param_bytes_per_device": built.param_bytes,
        "ok": True,
    })
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name} x {row['setting']}] "
              f"count={t_count:.1f}s "
              f"mem/dev={row['memory_per_device_bytes']/2**30:.2f}GiB "
              f"flops/dev={row['flops_per_device']:.3e} "
              f"wire/dev={row['wire_bytes_per_device']/2**20:.1f}MiB "
              f"dominant={row['dominant']} frac={row['roofline_frac']:.3f}",
              flush=True)
        print(f"  memory_analysis: {row['memory_analysis']}", flush=True)
    if save:
        out = Path(results) if results is not None else RESULTS
        out.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_name}__{row['setting']}.json"
        with open(out / name, "w") as f:
            json.dump(row, f, indent=1)
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--setting", default="guideline",
                    choices=("guideline", "tf", "intel"))
    ap.add_argument("--factored", action="store_true",
                    help="use the tuner's factored (data,pool,intra) mesh")
    ap.add_argument("--all", action="store_true",
                    help="every live cell on both meshes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--results", default=None,
                    help=f"output directory (default {RESULTS})")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    results = Path(args.results) if args.results else RESULTS
    print("devices: none (meta tensors; one device's share of each cell)")
    cells = live_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    # cheap cells first so partial runs cover the most ground
    cells = sorted(cells, key=lambda c: ORDER.get(c[1], 9))
    t0 = time.time()
    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            out = results / (f"{arch}__{shape_name}__{mesh_name}__"
                             f"{args.setting}.json")
            if args.skip_existing and out.exists():
                continue
            try:
                run_cell(arch, shape_name, multi_pod=mp,
                         setting=args.setting, factored=args.factored,
                         results=results)
            except Exception as e:  # noqa: BLE001 - report all cell failures
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"FAIL [{arch} x {shape_name} x {mesh_name}]: {e}")
                traceback.print_exc(limit=4)
    print(f"\n{len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed in {time.time() - t0:.1f} s")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
