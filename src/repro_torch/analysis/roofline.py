"""Three-term roofline of a counted step (counterpart of
``repro/analysis/roofline.py``, the same arithmetic):

    compute_s    = FLOPs_per_device / peak_FLOP/s
    memory_s     = bytes_per_device / HBM_bw
    collective_s = wire_bytes_per_device / link_bw

plus MODEL_FLOPS = 6*N_active*D (2*N_active*D inference) and the
MODEL_FLOPS / counted-FLOPs usefulness ratio.  The FLOPs and bytes come
from ``analysis/count.StepCounter`` (the reference reads XLA's
``cost_analysis()``), the wire bytes from ``analysis/collectives`` (the
reference parses the HLO), and ``hw`` defaults to the port's card,
``core/cost_model.H100`` (its data sheet's dense bf16 rate).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.analysis import collectives as coll
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import cost_model


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    setting: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / (counted FLOPs * chips)
    step_s: float
    roofline_frac: float         # min-possible / estimated step time
    memory_per_device_bytes: float = 0.0
    collectives: Optional[Dict] = None
    note: str = ""

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(cfg: ModelConfig, shape: ShapeConfig, *, arch: str,
            mesh_name: str, setting: str, chips: int,
            cost: Dict, collectives: List[coll.Collective],
            memory_stats: Optional[Dict] = None,
            hw: cost_model.Hardware = cost_model.H100,
            note: str = "") -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    colls = coll.summarize(collectives)
    wire = colls["total_wire_bytes"]

    compute_s = flops / hw.peak_flops
    memory_s = byts / hw.hbm_bw
    collective_s = wire / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    model_fl = cost_model.model_flops(cfg, shape) + \
        cost_model.attention_flops(cfg, shape)
    useful = model_fl / max(flops * chips, 1.0)

    # step estimate: max(compute, memory) + collectives (no-overlap,
    # conservative); roofline fraction = ideal compute-only time over it,
    # with *useful* flops as the numerator so padding/remat waste counts
    # against us.
    step_s = max(compute_s, memory_s) + collective_s
    ideal = (model_fl / chips) / hw.peak_flops
    frac = ideal / step_s if step_s > 0 else 0.0

    mem_bytes = 0.0
    if memory_stats:
        mem_bytes = (memory_stats.get("argument_size_in_bytes", 0)
                     + memory_stats.get("output_size_in_bytes", 0)
                     + memory_stats.get("temp_size_in_bytes", 0)
                     - memory_stats.get("alias_size_in_bytes", 0))

    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, setting=setting,
        chips=chips, flops_per_device=flops, bytes_per_device=byts,
        wire_bytes_per_device=wire, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_flops_global=model_fl, useful_ratio=useful, step_s=step_s,
        roofline_frac=frac, memory_per_device_bytes=mem_bytes,
        collectives=colls, note=note)


def memory_stats_dict(ma) -> Dict:
    """The ``*_size_in_bytes`` keys of a memory analysis (an object with
    those attributes, or a dict such as ``StepCounter.memory_stats``)."""
    keys = ("generated_code_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "alias_size_in_bytes",
            "temp_size_in_bytes")
    if isinstance(ma, dict):
        return {k: int(ma.get(k, 0)) for k in keys}
    return {k: int(getattr(ma, k, 0)) for k in keys}


def save(path: str, roof: Roofline) -> None:
    with open(path, "w") as f:
        json.dump(roof.row(), f, indent=1)


__all__ = ["Roofline", "analyze", "memory_stats_dict", "save"]
