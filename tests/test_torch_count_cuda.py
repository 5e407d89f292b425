"""PyTorch port, on the card only: a training step counted while the
card runs it equals the same step counted on ``meta`` tensors through
``launch/build`` with a one-device plan (``analysis/count``).  Every test
skips without a CUDA device where the kernels build and launch; on the
card run

    python -m pytest -q tests/test_torch_count_cuda.py

For reduced internlm2, dbrx, zamba2 and rwkv6 (each kernel of the
training path: flash forward and its backward's products, moe_gmm and
its backward's, both scans and their backward kernels), one
``Trainer.train_step`` at B 2 x S 64, fp32: FLOPs equal, bytes within
0.1% (any op whose bytes differ is named), each kernel's recorded calls
equal its launch counts over the step.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.count import StepCounter  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as mops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wops  # noqa: E402
from repro_torch.launch import build  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

BYTES_RTOL = 1e-3
KERNELS = {"flash_attention": (fa, "launches"),
           "flash_attention_bwd": (fa, "bwd_launches"),
           "moe_gmm": (gmm, "launches"), "moe_gmm_bwd": (gmm, "bwd_launches"),
           "mamba2_scan": (mops, "launches"),
           "mamba2_scan_bwd": (mops, "bwd_launches"),
           "rwkv6_wkv": (wops, "launches"),
           "rwkv6_wkv_bwd": (wops, "bwd_launches")}


def _dev():
    if not all(m.supported() for m in (fa, gmm, mops, wops)):
        pytest.skip("needs a CUDA device where the kernels build and "
                    "launch (ops.supported() is False)")
    return resolve_device("cuda")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b",
                                  "zamba2-7b", "rwkv6-7b"])
def test_card_count_equals_meta_count(arch):
    dev = _dev()
    cfg = reduced(get_config(arch))
    tr = Trainer(cfg, TrainerConfig(steps=3, batch=2, seq_len=64),
                 device=dev)
    batch = to_device(tr.data.batch_at(0), dev)
    before = {k: getattr(mod, attr) for k, (mod, attr) in KERNELS.items()}
    with StepCounter() as card:
        tr.train_step(batch)
        torch.cuda.synchronize()
    launched = {k: getattr(mod, attr) - before[k]
                for k, (mod, attr) in KERNELS.items()}
    plan, mesh = build.one_device()
    meta, _ = build.build(cfg, ShapeConfig("t", "train", 64, 2), plan=plan,
                          mesh=mesh, param_dtype=torch.float32).count()
    assert card.flops == meta.flops
    diff = {op: (rec["bytes"], meta.ops().get(op, {}).get("bytes"))
            for op, rec in card.ops().items()
            if rec["bytes"] != meta.ops().get(op, {}).get("bytes")}
    assert abs(card.bytes - meta.bytes) <= BYTES_RTOL * meta.bytes, diff
    fam = card.families()
    for name, n in launched.items():
        assert fam.get(name, {}).get("calls", 0) == n, name
        assert meta.families().get(name, {}).get("calls", 0) == n, name
