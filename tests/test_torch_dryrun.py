"""The port's dry-run (``repro_torch.launch.build`` and ``dryrun``), its
figures and the production launcher, on the CPU with ``meta`` tensors:

* per-device parameter bytes of ``build(...)`` equal the bytes of the
  reference ``Rules.spec_for`` shard shapes of the JAX package's
  ``model_defs`` on the same rule table and mesh descriptor, for a
  dense, an MoE and a recurrent cell (the MoE one on the multi-pod
  mesh);
* the local view: GQA kept when the model axis replicates the KV heads,
  ``fsdp`` computing at the whole ``d_model``;
* ``forward_train``'s FLOPs counted on ``meta`` at ``reduced()``
  internlm2, dbrx and zamba2 on one device, held against
  ``jax.jit(forward_train).lower(...).compile().cost_analysis()`` on the
  CPU.  The port counts matrix products only, and the kernels' work from
  their formulas: flash skips masked scores, the scans count their
  chunked products (64-step chunks; XLA's chunked form takes 8), and
  XLA counts elementwise ops its own way.  Measured at B 2 x S 64 and
  B 4 x S 128: the port's count 0.83-0.94 of XLA's; with the masked
  scores and one flop an elementwise output element added, 0.966-0.986.
  The gates: 0.80 <= port / XLA <= 1 and 0.95 <= adjusted / XLA <= 1;
* ``run_cell`` on two full-width cells (internlm2-1.8b train_4k on the
  single-pod mesh, dbrx-132b decode_32k on the multi-pod one): ``ok``,
  sane fields, each kernel called once a layer (moe_gmm three times);
* ``dryrun.main`` over two cells into a temporary directory, then
  ``fig16_multipod`` and ``roofline_report`` over it;
* ``launch.train --production`` exits 0 with the cell's line;
* a one-device ``build`` counts its training step op for op as
  ``Trainer.train_step`` does (both on ``meta``): the CPU side of the
  card's gate (``tests/test_torch_count_cuda.py``, ``chip_smoke.py``'s
  roofline phase).
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import forward_train as jforward_train  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.analysis.count import StepCounter  # noqa: E402
from repro_torch.benchmarks import fig16_multipod as fig16  # noqa: E402
from repro_torch.benchmarks import roofline_report  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import (ATTN, SHARED_ATTN,  # noqa: E402
                                      ShapeConfig)
from repro_torch.core import tuner  # noqa: E402
from repro_torch.kernels.flash_attention.ops import live_scores  # noqa: E402
from repro_torch.launch import build, dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import forward_train, model_defs  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

FLOPS_RAW = (0.80, 1.0)        # port / XLA
FLOPS_ADJUSTED = (0.95, 1.0)   # (port + masked scores + elementwise) / XLA


def _reference_param_bytes(arch, built):
    """Per-device bytes of the JAX package's params under the reference
    ``Rules`` on the built table and descriptor (bf16, fp32 where a
    ``ParamDef`` says so)."""
    r = jsh.Rules(table=dict(built.rules.table), mesh=None)
    r.mesh = built.mesh
    total = 0
    for d in jax.tree.leaves(jmodel_defs(jget_config(arch)),
                             is_leaf=jmodule.is_def):
        spec = tuple(r.spec_for(d.axes, d.shape))
        n = 1
        for i, dim in enumerate(d.shape):
            n *= dim // (r.mesh_size(spec[i]) if i < len(spec) else 1)
        total += n * np.dtype(d.dtype or jnp.bfloat16).itemsize
    return total


@pytest.mark.parametrize("arch,shape,multi", [
    ("internlm2-1.8b", "train_4k", False), ("dbrx-132b", "train_4k", True),
    ("zamba2-7b", "decode_32k", False)])
def test_param_bytes_equal_the_reference_shards(arch, shape, multi):
    built = build.build(arch, shape, multi_pod=multi)
    assert built.mesh.sizes == ((2, 16, 16) if multi else (16, 16))
    assert built.param_bytes == _reference_param_bytes(arch, built)
    # the shards are smaller than the whole model, and fit its share
    whole = sum(math.prod(d.shape) for d in jax.tree.leaves(
        jmodel_defs(jget_config(arch)), is_leaf=jmodule.is_def))
    assert built.param_bytes < 2 * whole


def test_local_view_keeps_gqa_and_d_model():
    desc = mesh_lib.make_production_mesh()
    for arch, heads, kv in (("internlm2-1.8b", 1, 1),
                            ("mistral-large-123b", 6, 1),
                            ("gemma2-2b", 8, 4)):      # 8 heads: replicated
        cfg = get_config(arch)
        plan = tuner.Plan("tp", data=16, pools=1, intra=16, fsdp=True)
        local, defs, view = build.local_view(cfg, tuner.make_rules(plan,
                                                                   desc))
        assert (local.num_heads, local.num_kv_heads) == (heads, kv)
        assert local.d_model == cfg.d_model and \
            local.resolved_head_dim == cfg.resolved_head_dim
        assert view["heads"] == heads
        assert defs["layers"][0]["mixer"]["wq"].shape == \
            (cfg.d_model, heads, cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b",
                                  "zamba2-7b"])
@pytest.mark.parametrize("b,s", [(2, 64), (4, 128)])
def test_forward_flops_against_xla(arch, b, s):
    jcfg = jreduced(jget_config(arch))
    params = jmodule.abstract_params(jmodel_defs(jcfg), jnp.float32)
    spec = jax.ShapeDtypeStruct((b, s), jnp.int32)
    cost = jax.jit(lambda p, bt: jforward_train(p, jcfg, bt)[0]).lower(
        params, {"tokens": spec, "labels": spec}).compile().cost_analysis()
    xla = (cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"]

    cfg = reduced(get_config(arch))
    tp = build._meta_tree(model_defs(cfg), torch.float32, False)
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    with torch.no_grad(), StepCounter() as c:
        forward_train(tp, cfg, {"tokens": tok, "labels": tok})
    masked = sum(4 * cfg.resolved_head_dim * cfg.num_heads * b
                 * (s * s - live_scores(s, s, True, blk.window))
                 for blk in cfg.blocks if blk.mixer in (ATTN, SHARED_ATTN))
    raw = c.flops / xla
    adjusted = (c.flops + masked + c.elementwise) / xla
    assert FLOPS_RAW[0] <= raw <= FLOPS_RAW[1], raw
    assert FLOPS_ADJUSTED[0] <= adjusted <= FLOPS_ADJUSTED[1], adjusted


def _sane(row, chips):
    assert row["ok"] and row["chips"] == chips
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert 0 < row["useful_ratio"] <= 1.05
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["step_s"] >= max(row["compute_s"], row["memory_s"])
    assert 0 < row["roofline_frac"] <= 1
    mem = row["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert row["memory_per_device_bytes"] > 0
    assert row["collectives"]["num_collectives"] > 0
    assert row["count_s"] >= 0


def test_run_cell_full_width(tmp_path):
    row = dryrun.run_cell("internlm2-1.8b", "train_4k", multi_pod=False,
                          results=tmp_path, verbose=False)
    _sane(row, 256)
    fam = row["by_family"]
    assert fam["flash_attention"]["calls"] == 24
    assert fam["flash_attention_bwd"]["calls"] == 24
    assert row["view"]["heads"] == 1 and row["view"]["kv_heads"] == 1
    saved = json.loads((tmp_path / "internlm2-1.8b__train_4k__single__"
                        "guideline.json").read_text())
    assert saved["flops_per_device"] == row["flops_per_device"]

    row = dryrun.run_cell("dbrx-132b", "decode_32k", multi_pod=True,
                          save=False, verbose=False)
    _sane(row, 512)
    assert row["by_family"]["moe_gmm"]["calls"] == 3 * 40
    assert "flash_attention" not in row["by_family"]
    assert row["plan"]["pod_mode"] in ("dp", "mp")


def test_dryrun_main_then_the_figures(tmp_path, capsys):
    argv = ["--arch", "internlm2-1.8b", "--shape", "decode_32k",
            "--both-meshes", "--results", str(tmp_path)]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "2 ok, 0 failed" in out
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    rows = fig16.main(["--results", str(tmp_path)])
    measured = [r for r in rows if r["name"].startswith("fig16.measured.")]
    assert [r["name"] for r in measured] == \
        ["fig16.measured.internlm2-1.8b.decode_32k"]
    assert math.isfinite(measured[0]["wire_ratio"])
    table = tmp_path / "table.md"
    rows = roofline_report.main(["--results", str(tmp_path), "--out",
                                 str(table)])
    assert len(rows) == 2
    text = table.read_text()
    assert text.count("| internlm2-1.8b | decode_32k |") == 2
    assert "adj_coll" not in text


def test_production_launcher(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert launch_train.main(["--arch", "internlm2-1.8b", "--production",
                              "--shape", "prefill_32k"]) == 0
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("[internlm2-1.8b x prefill_32k x single x "
                           "guideline] count=")
    assert (tmp_path / "internlm2-1.8b__prefill_32k__single__"
            "guideline.json").exists()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b",
                                  "zamba2-7b", "rwkv6-7b"])
def test_one_device_build_counts_like_the_trainer(arch):
    """The card's gate compares ``Trainer.train_step`` counted on the
    card with ``build``'s step counted on ``meta``; here both run on
    ``meta``, and every op's count must be the same."""
    cfg = reduced(get_config(arch))
    plan, mesh = build.one_device()
    meta, _ = build.build(cfg, ShapeConfig("t", "train", 64, 2), plan=plan,
                          mesh=mesh, param_dtype=torch.float32).count()
    params = build._meta_tree(model_defs(cfg), torch.float32, True)
    tr = Trainer(cfg, TrainerConfig(steps=3, batch=2, seq_len=64),
                 device="meta", params=params)
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in tr.data.batch_at(0).items()}
    with StepCounter() as c:
        tr.train_step(batch)
    assert c.ops() == meta.ops()
    assert c.families() == meta.families()
